"""A pure-Python msgpack encoder for flax checkpoint files.

The counterpart of ``train/msgpack_reader.py``: ``msgpack_serialize(tree)``
returns the bytes ``flax.serialization.msgpack_serialize`` writes for the
same tree of string-keyed dicts and numpy arrays, without ``msgpack`` or
``flax``, which the machine with the card lacks:

  * every map is written with its keys sorted, as flax's serializer leaves
    them (it copies the tree with ``jax.tree_util.tree_map`` first, which
    sorts dict keys); an empty map (optax's ``EmptyState``) is ``{}``;
  * every array leaf, 0-d ones included, is ext code 1 whose payload is the
    msgpack array ``(shape, dtype name, C-order bytes)``;
  * integers, strings, binaries, arrays, maps and ext headers take
    msgpack's smallest encoding, as msgpack-python picks it; floats are
    doubles.

What the reader refuses, the writer refuses: numpy scalars (flax's ext 3),
complex numbers (ext 2), bfloat16 leaves and arrays above 1 GiB (flax's
chunked form). ``numpy_scalars=True`` writes a numpy scalar as flax does
(ext 3, the payload of the 0-d array), as ``msgpack_restore`` reads it
with the same flag.
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["msgpack_serialize"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
# flax writes an array above this many bytes as a chunked dict
MAX_CHUNK_SIZE = 2 ** 30


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes):
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((byte, struct format, largest n)) whose width holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, largest in codes:
        if n <= largest:
            out += struct.pack(">B" + fmt, code, n)
            return
    raise ValueError(f"msgpack length {n} is too large")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARRAY = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF), (0xC9, "I", 0xFFFFFFFF))


def _int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0 <= v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < 0:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < 0:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < 0:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _header(out, n, None, 0, _EXT)
    out += struct.pack("b", code)
    out += data


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError("Object and structured dtypes are not supported "
                         "for serialization of ndarrays.")
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        raise ValueError(f"{a.dtype} leaves are not supported")
    if a.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            f"An array of {a.nbytes} bytes would be written in flax's "
            f"chunked form (above {MAX_CHUNK_SIZE} bytes), which the "
            f"reader does not support.")
    out = bytearray([0x93])            # the triple (shape, dtype, data)
    _pack(out, list(a.shape))
    _pack(out, a.dtype.name)
    _pack(out, a.tobytes("C"))
    return bytes(out)


def _pack(out: bytearray, obj, scalars: bool = False):
    # exact types, as flax's packer checks them (strict_types=True): a
    # numpy scalar is not a float, a tuple is not a list
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _int(out, obj)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xA0, 0x1F, _STR)
        out += raw
    elif t in (bytes, bytearray):
        _header(out, len(obj), None, 0, _BIN)
        out += obj
    elif t is list:
        _header(out, len(obj), 0x90, 0x0F, _ARRAY)
        for v in obj:
            _pack(out, v, scalars)
    elif t is dict:
        _header(out, len(obj), 0x80, 0x0F, _MAP)
        for key in sorted(obj):
            _pack(out, key)
            _pack(out, obj[key], scalars)
    elif t is np.ndarray:
        _ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif scalars and isinstance(obj, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(
            f"Cannot serialize {t.__name__} (a checkpoint tree holds dicts "
            f"with string keys, lists, Python scalars and numpy arrays; "
            f"numpy scalars and complex numbers are not written)")


def msgpack_serialize(tree, numpy_scalars: bool = False) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` writes for a
    state tree: nested dicts (string keys) of numpy arrays, lists and
    Python scalars (and numpy scalars, with ``numpy_scalars=True``)."""
    out = bytearray()
    _pack(out, tree, numpy_scalars)
    return bytes(out)
