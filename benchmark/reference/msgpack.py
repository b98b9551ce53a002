"""The benchmark's frozen copy of a pure-Python msgpack decoder for flax
checkpoint files (``<base>_state.msgpack``).

flax's ``msgpack_serialize`` writes nested maps with string keys whose
leaves are msgpack ext values; an ndarray leaf is ext code 1, whose payload
is itself a msgpack array ``(shape, dtype name, raw C-order buffer)``. This
module decodes that format with numpy alone and returns what
``flax.serialization.msgpack_restore`` returns: dicts, lists, Python scalars
and read-only numpy arrays. flax's other leaf encodings and its chunked
arrays raise. The reference reads the checkpoint through this copy, so it
takes no decoded weights from the program under test.
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["msgpack_restore", "unpackb"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    """Decodes one msgpack value at a time from a bytes buffer."""

    def __init__(self, data: bytes, ext_hook):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def _take(self, n: int) -> memoryview:
        start = self.pos
        end = start + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        self.pos = end
        return self.buf[start:end]

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        return self.ext_hook(code, bytes(self._take(n)))

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:                      # positive fixint
            return b
        if b >= 0xE0:                      # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b == 0xC4:
            return bytes(self._take(self._unpack(">B")))
        if b == 0xC5:
            return bytes(self._take(self._unpack(">H")))
        if b == 0xC6:
            return bytes(self._take(self._unpack(">I")))
        if b == 0xC7:
            return self._ext(self._unpack(">B"))
        if b == 0xC8:
            return self._ext(self._unpack(">H"))
        if b == 0xC9:
            return self._ext(self._unpack(">I"))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self._unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self._unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:              # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4))
        if b == 0xD9:
            return self._str(self._unpack(">B"))
        if b == 0xDA:
            return self._str(self._unpack(">H"))
        if b == 0xDB:
            return self._str(self._unpack(">I"))
        if b == 0xDC:
            return self._array(self._unpack(">H"))
        if b == 0xDD:
            return self._array(self._unpack(">I"))
        if b == 0xDE:
            return self._map(self._unpack(">H"))
        if b == 0xDF:
            return self._map(self._unpack(">I"))
        raise ValueError(f"Unknown msgpack type byte 0x{b:02x} at offset "
                         f"{self.pos - 1}")


def _no_ext(code, data):
    raise ValueError(f"Unexpected msgpack ext type {code}")


def unpackb(data: bytes, ext_hook=_no_ext):
    """Decode one msgpack value that fills ``data`` exactly."""
    reader = _Reader(data, ext_hook)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes "
                         f"after the msgpack value")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
        shape, order="C")


def _flax_ext_hook(code: int, data: bytes, numpy_scalars: bool = False):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if numpy_scalars and code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"Unsupported flax msgpack ext type {code} (only "
                     f"ndarray leaves, ext {_EXT_NDARRAY}, are read)")


def _reject_chunked(tree):
    if isinstance(tree, dict):
        if _CHUNKED_KEY in tree:
            raise ValueError(
                "Checkpoint holds a flax chunked array (a leaf above 1 GiB); "
                "this reader does not support the chunked form.")
        for v in tree.values():
            _reject_chunked(v)


def msgpack_restore(encoded: bytes, numpy_scalars: bool = False):
    """Decode a flax ``msgpack_serialize`` blob into nested Python
    containers with numpy array leaves (``flax.serialization.msgpack_restore``
    without flax). ``numpy_scalars=True`` also reads flax's numpy-scalar
    leaves (ext 3) into numpy scalars."""
    tree = unpackb(encoded, ext_hook=lambda code, data: _flax_ext_hook(
        code, data, numpy_scalars))
    _reject_chunked(tree)
    return tree
