"""The kernel build (baryon_painter_tpu_torch/ops/_build.py) without a card.

nvcc exists only on the machine with the card, so these tests stand a small
script in for it: they check that the library is named by a hash of all the
sources, that each source is compiled by its own nvcc, all at once, before
one link, that the library appears under its final name only after a
successful build (written to a temporary name, then moved), that no
temporary or lock file is left behind by a failed or timed-out build, and
that the failure carries nvcc's own message. That the real nvcc builds the real source is
shown on the card by chip_smoke.py.
"""
import os
import stat
import time

import pytest

from baryon_painter_tpu_torch.ops import _build


SOURCES = ("a.cu", "b.cu", "k.cu")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in SOURCES:
        (src / name).write_text(f"extern \"C\" int f_{name[0]}() "
                                f"{{ return 0; }}\n")
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
    seen = {first}
    for name in SOURCES:          # a change to any one source renames it
        (tree / "csrc" / name).write_text(f"// changed {name}\n")
        assert _build.library_path() not in seen
        seen.add(_build.library_path())


def test_successful_build_moves_the_library_into_place(tree, monkeypatch):
    _fake_nvcc(tree, monkeypatch, _WRITE_OUTPUT)
    res = _build.build_library()
    assert res["path"] == _build.library_path() and res["path"].exists()
    assert "registers" in res["log"]
    assert os.listdir(tree / "build") == [res["path"].name]
    # a second call finds the library and does not rebuild
    again = _build.build_library()
    assert again["seconds"] == 0.0 and again["path"] == res["path"]


def test_each_source_has_its_own_nvcc_started_together_then_one_link(
        tree, monkeypatch):
    """The stand-in logs each call; the compiles sleep so that they overlap
    only if they were started together."""
    log = tree / "calls"
    _fake_nvcc(tree, monkeypatch,
               f'echo "$@" >> {log}\n'
               'case "$*" in *" -c "*) sleep 1;; esac\n' + _WRITE_OUTPUT)
    t0 = time.perf_counter()
    _build.build_library()
    assert time.perf_counter() - t0 < 2.5      # three 1 s compiles, at once
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[1]
                  for c in compiles) == list(SOURCES)
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    link = calls[-1]
    assert "-shared" in link and " -c " not in link
    assert sorted(a.rsplit("/", 1)[1] for a in link.split()
                  if a.endswith(".o")) == ["a.o", "b.o", "k.o"]


def test_a_failing_second_source_fails_the_build_and_leaves_nothing(
        tree, monkeypatch):
    _fake_nvcc(tree, monkeypatch,
               'case "$*" in *b.cu*) echo "b.cu(1): error: broken" >&2; '
               'exit 2;; esac\n' + _WRITE_OUTPUT)
    with pytest.raises(RuntimeError, match="b.cu.*broken"):
        _build.build_library()
    assert os.listdir(tree / "build") == []


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
