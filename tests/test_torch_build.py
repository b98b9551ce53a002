"""The kernel build (baryon_painter_tpu_torch/ops/_build.py) without a card.

nvcc exists only on the machine with the card, so these tests stand a small
script in for it: they check that the library is named by a hash of the
sources, that it appears under its final name only after a successful
build (written to a temporary name, then moved), that no temporary or lock
file is left behind by a failed or timed-out build, and that the failure
carries nvcc's own message. That the real nvcc builds the real source is
shown on the card by chip_smoke.py.
"""
import os
import stat
import time

import pytest

from baryon_painter_tpu_torch.ops import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("extern \"C\" int f() { return 0; }\n")
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    return tmp_path


def _fake_nvcc(tmp_path, monkeypatch, body):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    return nvcc


# writes the file named after -o, as nvcc does
_WRITE_OUTPUT = ('while [ "$#" -gt 0 ]; do\n'
                 '  if [ "$1" = "-o" ]; then echo lib > "$2"; fi; shift\n'
                 'done\necho "ptxas info: Used 90 registers" >&2\n')


def test_library_name_follows_the_sources(tree):
    first = _build.library_path()
    assert first.parent == tree / "build"
    assert first.name.startswith("libbpt_kernels_") and first.suffix == ".so"
    assert _build.library_path() == first
    (tree / "csrc" / "k.cu").write_text("// changed\n")
    assert _build.library_path() != first


def test_successful_build_moves_the_library_into_place(tree, monkeypatch):
    _fake_nvcc(tree, monkeypatch, _WRITE_OUTPUT)
    res = _build.build_library()
    assert res["path"] == _build.library_path() and res["path"].exists()
    assert "registers" in res["log"]
    assert os.listdir(tree / "build") == [res["path"].name]
    # a second call finds the library and does not rebuild
    again = _build.build_library()
    assert again["seconds"] == 0.0 and again["path"] == res["path"]


def test_failed_build_raises_with_nvcc_message_and_leaves_nothing(
        tree, monkeypatch):
    _fake_nvcc(tree, monkeypatch, 'echo "k.cu(1): error: boom" >&2\n'
                                     'exit 2\n')
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_library()
    assert os.listdir(tree / "build") == []


def test_build_that_outlives_its_limit_raises_and_kills_the_build(
        tree, monkeypatch):
    """The stand-in forks a child that would outlive it, as nvcc's cicc and
    ptxas do; the timeout must end both, and promptly."""
    _fake_nvcc(tree, monkeypatch, "sleep 30 &\nwait\n")
    monkeypatch.setattr(_build, "BUILD_TIMEOUT_S", 0.5)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not finish"):
        _build.build_library()
    assert time.perf_counter() - t0 < 10
    assert os.listdir(tree / "build") == []


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_flags_target_hopper_and_use_no_torch_headers():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for src in _build.SOURCE_DIR.glob("*.cu"):
        text = src.read_text()
        includes = [l for l in text.splitlines() if l.startswith("#include")]
        assert includes and all("torch" not in l and "ATen" not in l
                                and "c10" not in l for l in includes), src
        assert 'extern "C"' in text, src
