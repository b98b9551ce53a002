"""Build and load the package's CUDA kernels: nvcc into a plain-C shared
library, loaded with ctypes.

Every ``csrc/*.cu`` is compiled in one ``nvcc`` call for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <dir>/libbpt_kernels_<hash>.so csrc/*.cu

The sources include no PyTorch header, so the build takes seconds. The
library's name carries a hash of the sources and flags, so a stale library is
never loaded; it is written under a temporary name and moved into place with
``os.replace``, so no lock file exists and an interrupted build leaves
nothing that a later build would wait on. The build directory (``_build/``
beside this package's sources) is listed in ``.gitignore``.

The build runs at first use, never at import: the CPU tests import every
module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["SOURCE_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc",
           "library_path", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600


def _sources() -> list:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built.")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbpt_kernels_{h.hexdigest()[:16]}.so"


def build_library(force: bool = False) -> dict:
    """Compile ``csrc/*.cu`` into the library unless it exists (or
    ``force``). Returns ``{"path", "seconds", "log"}``; ``log`` is nvcc's
    stderr, with ptxas' register and spill report. Raises with that log if
    nvcc fails or outlives ``BUILD_TIMEOUT_S``."""
    path = library_path()
    if path.exists() and not force:
        return {"path": path, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    try:
        # own process group: on a timeout, nvcc's children (cicc, ptxas)
        # are killed with it
        with subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) as proc:
            try:
                out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                out, err = proc.communicate()
                raise RuntimeError(
                    f"nvcc did not finish in {BUILD_TIMEOUT_S} s:\n"
                    f"{' '.join(cmd)}\n{err}") from None
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                f"{err}{out}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": path, "seconds": time.perf_counter() - t0, "log": err}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every exported
    function's argument and result types."""
    lib = ctypes.CDLL(str(build_library()["path"]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bpt_res_block_infer.argtypes = [p, p, p, p, p, p, p, p,
                                        i, i, i, i, f, f, i, p]
    lib.bpt_res_block_infer.restype = ctypes.c_int
    lib.bpt_error_string.argtypes = [ctypes.c_int]
    lib.bpt_error_string.restype = ctypes.c_char_p
    return lib
