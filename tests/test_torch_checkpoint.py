"""The port's checkpoint reader against flax and the JAX package.

The port decodes flax's msgpack checkpoints with its own pure-Python reader
(baryon_painter_tpu_torch/train/msgpack_reader.py), because the machine with
the card has neither msgpack nor flax. Every committed checkpoint must decode
to the identical tree (keys, order, dtypes, shapes, bits) that
flax.serialization.msgpack_restore yields; the msgpack types are exercised
one by one against the msgpack package's own decoder. Equality is exact:
decoding moves bytes and does no arithmetic.
"""
import dataclasses
import glob
import os

import flax.serialization
import msgpack
import numpy as np
import pytest

from baryon_painter_tpu.train import checkpoint as jax_ckpt
from baryon_painter_tpu_torch.train import checkpoint as ckpt
from baryon_painter_tpu_torch.train.msgpack_reader import (msgpack_restore,
                                                           unpackb)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_FILES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "trained_models", "**", "*_state.msgpack"),
        recursive=True))


def _assert_same_tree(a, b, path="state"):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
        return
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(b, dict):
        assert list(a) == list(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_every_committed_checkpoint_is_found():
    # the five CVAE goldens' checkpoints and both CGANs at least
    assert len(STATE_FILES) >= 7, STATE_FILES


@pytest.mark.parametrize("rel", STATE_FILES)
def test_reader_matches_flax_on_committed_checkpoint(rel):
    with open(os.path.join(REPO, rel), "rb") as f:
        data = f.read()
    _assert_same_tree(msgpack_restore(data),
                      flax.serialization.msgpack_restore(data))


def _ext_as_tuple(code, data):
    return ("ext", code, bytes(data))


@pytest.mark.parametrize("value", [
    # ints: positive/negative fixint, uint8..64, int8..64
    0, 127, -1, -32, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63,
    # floats, nil, bools
    1.5, -2.25e-300, None, True, False,
    # fixstr, str8, str16, str32
    "", "a" * 31, "b" * 32, "c" * 256, "d" * 65536, "ünïcødé",
    # bin8, bin16, bin32
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536,
    # fixarray, array16, array32
    [], list(range(15)), list(range(16)), list(range(65536)),
    # fixmap, map16, map32
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(65536)},
    # fixext 1/2/4/8/16, ext8/16/32
    msgpack.ExtType(5, b"x"), msgpack.ExtType(5, b"xy"),
    msgpack.ExtType(5, b"x" * 4), msgpack.ExtType(5, b"x" * 8),
    msgpack.ExtType(5, b"x" * 16), msgpack.ExtType(7, b"x" * 3),
    msgpack.ExtType(7, b"x" * 256), msgpack.ExtType(7, b"x" * 65536),
    # nesting
    {"a": [1, {"b": b"c", "d": [None, 2.0]}], "e": msgpack.ExtType(1, b"")},
], ids=lambda v: type(v).__name__)
def test_unpackb_matches_msgpack_on_every_type(value):
    data = msgpack.packb(value, use_bin_type=True)
    want = msgpack.unpackb(data, raw=False, strict_map_key=False,
                           ext_hook=_ext_as_tuple)
    assert unpackb(data, ext_hook=_ext_as_tuple) == want


def test_single_precision_float_decodes_as_msgpack_does():
    data = msgpack.packb(np.float32(0.1).item(), use_single_float=True)
    assert data[0] == 0xCA
    assert unpackb(data) == msgpack.unpackb(data)


def test_flax_array_leaves_of_every_shape_and_dtype():
    tree = {"step": np.asarray(7, np.int32), "count": 3, "flag": True,
            "arr": np.arange(6, dtype=np.int64).reshape(2, 3),
            "half": np.ones((2, 2), np.float16),
            "empty": np.zeros((0, 4), np.float32), "nested": {"x": [1, 2]}}
    data = flax.serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack_restore(data),
                      flax.serialization.msgpack_restore(data))


@pytest.mark.parametrize("leaf", [np.float32(0.5), 1.0 + 2.0j],
                         ids=["numpy_scalar", "complex"])
def test_other_flax_leaf_encodings_are_refused(leaf):
    data = flax.serialization.msgpack_serialize({"leaf": leaf})
    with pytest.raises(ValueError, match="ext type"):
        msgpack_restore(data)


def test_chunked_arrays_are_refused():
    data = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                "shape": {"0": 2}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack_restore(data)


@pytest.mark.parametrize("data", [b"", b"\x92\x01", b"\xc1", b"\x01\x02"],
                         ids=["empty", "truncated", "reserved", "trailing"])
def test_malformed_data_raises(data):
    with pytest.raises(ValueError):
        unpackb(data)


def test_load_checkpoint_matches_jax_reader():
    base = os.path.join(REPO, "trained_models/CVAE/fiducial-512/model")
    state, meta = ckpt.load_checkpoint(base)
    jstate, jmeta = jax_ckpt.load_checkpoint(base)
    assert "opt_state" not in state and "opt_state" in jstate
    assert meta == jmeta
    for key in ("params", "batch_stats", "step"):
        _assert_same_tree(state[key], jstate[key], key)


def test_transforms_from_meta_matches_jax():
    base = os.path.join(REPO, "trained_models/CVAE/physical-512-lt-wip/model")
    _, meta = ckpt.load_checkpoint(base)
    tfs, stats = ckpt.transforms_from_meta(meta, device="cpu")
    jtfs, jstats = jax_ckpt.transforms_from_meta(meta)
    assert set(tfs) == set(jtfs)
    for field in tfs:
        assert dataclasses.asdict(tfs[field]) == dataclasses.asdict(
            jtfs[field])
        for attr in ("z_grid", "mean", "var"):
            np.testing.assert_array_equal(
                getattr(stats[field], attr).numpy(),
                np.asarray(getattr(jstats[field], attr)))
