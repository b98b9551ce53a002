"""Build and load the package's CUDA kernels: nvcc into a plain-C shared
library, loaded with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc -c``, all
started together, and the objects are linked into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <tmp>/<name>.o   (each, at once)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o <dir>/libbpt_kernels_<hash>.so <tmp>/*.o

The sources include no PyTorch header, so the build takes seconds. The
library's name carries a hash of all the sources and the flags, so a stale
library is never loaded; it is written under a temporary name and moved into
place with ``os.replace``, so no lock file exists and an interrupted build
leaves nothing that a later build would wait on. The build directory
(``_build/`` beside this package's sources) is listed in ``.gitignore``.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
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


def _run(cmds, timeout: float):
    """Run the commands at once, each in its own process group (so a
    timeout also ends nvcc's children, cicc and ptxas); wait for all.
    Returns their stderr texts; raises with the failing command's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for cmd in cmds]
    deadline = time.monotonic() + timeout
    errs, failure = [], None
    try:
        for cmd, proc in zip(cmds, procs):
            try:
                out, err = proc.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failure = failure or (f"nvcc did not finish in {timeout} s:"
                                      f"\n{' '.join(cmd)}")
                continue
            errs.append(err)
            if proc.returncode != 0 and failure is None:
                failure = (f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{err}{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    if failure is not None:
        raise RuntimeError(failure)
    return errs


def build_library(force: bool = False) -> dict:
    """Compile ``csrc/*.cu`` into the library unless it exists (or
    ``force``): one nvcc per source in parallel, then one link. Returns
    ``{"path", "seconds", "log"}``; ``log`` is nvcc's stderr, with ptxas'
    register and spill report. Raises with nvcc's message if a compile or
    the link fails or outlives ``BUILD_TIMEOUT_S``."""
    path = library_path()
    if path.exists() and not force:
        return {"path": path, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    sources = [s for s in _sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=path.name + ".",
                                     dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in sources]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                    for s, o in zip(sources, objs)], BUILD_TIMEOUT_S)
        lib = os.path.join(tmp, path.name)
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]],
                    BUILD_TIMEOUT_S)
        os.replace(lib, path)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": "".join(log)}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every exported
    function's argument and result types (the set-up span
    ``setup.library``, whose ``built`` is 1 where nvcc ran)."""
    from baryon_painter_tpu_torch.utils import profiling
    with profiling.setup_span("setup.library") as sp:
        build = build_library()
        lib = ctypes.CDLL(str(build["path"]))
        sp.attrs["built"] = int(build["seconds"] > 0)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # x, weights, s1, b1, s2, b2, out, n, h, w, c, slopes, dtype, stream
    lib.bpt_res_block_infer.argtypes = [p] * 7 + [i, i, i, i, f, f, i, p]
    lib.bpt_res_block_infer.restype = ctypes.c_int
    lib.bpt_gather_tiles.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.bpt_gather_tiles.restype = ctypes.c_int
    # K3: pointers, then n, h, w (the chain's blocks, dw1's splits), dtype,
    # stream
    for name, n_ptr, n_int in (("u1_gemm", 3, 4), ("chain_fwd", 5, 4),
                               ("chain_bwd", 9, 5), ("dx", 3, 4),
                               ("dw1", 3, 5)):
        fn = getattr(lib, f"bpt_head_{name}")
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    lib.bpt_head_grid.argtypes = [i] * 5   # which, n, h, w, dtype
    lib.bpt_head_grid.restype = ctypes.c_int
    lib.bpt_head_stack_smem.argtypes = [i, i]   # which, dtype
    lib.bpt_head_stack_smem.restype = ctypes.c_int
    lib.bpt_res_block_smem.argtypes = [i, i]
    lib.bpt_res_block_smem.restype = ctypes.c_int
    # n, cin, h, w, x's pitch, cout, k, s, dtype
    dims = [i] * 9
    for name, n_ptr in (("stats", 5), ("bwd1", 9)):
        fn = getattr(lib, f"bpt_conv_bn_{name}")
        fn.argtypes = [p] * n_ptr + dims + [p]
        fn.restype = ctypes.c_int
    # u, a, b, y, n, c, hw, dtype
    lib.bpt_conv_bn_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
    # u, y, dy, a, mean, inv, s1n, s2n, du, n, c, ho, wo, pitch, dtype
    lib.bpt_conv_bn_du.argtypes = [p] * 9 + [i] * 6 + [p]
    # du, wk, dx, n, cin, h, w, cout, du's pitch, k, s, dtype
    lib.bpt_conv_bn_dx.argtypes = [p] * 3 + [i] * 9 + [p]
    # x, du, dwp, n, cin, h, w, x's pitch, cout, du's pitch, k, s, splits,
    # dtype
    lib.bpt_conv_bn_dw.argtypes = [p] * 3 + [i] * 11 + [p]
    lib.bpt_conv_bn_bwd1_tiles.argtypes = [i] * 5   # h, w, cout, k, s
    # n, cin, h, w, cout, k, s, dtype
    lib.bpt_conv_bn_bwd2_splits.argtypes = [i] * 8
    # n, cin, h, w, cout, k, s, which, dtype
    lib.bpt_conv_bn_nt.argtypes = [i] * 9
    lib.bpt_conv_bn_bwd_smem.argtypes = [i] * 9
    for name in ("stats", "bwd1", "fwd", "du", "dx", "dw", "bwd1_tiles",
                 "bwd2_splits", "nt", "bwd_smem"):
        getattr(lib, f"bpt_conv_bn_{name}").restype = ctypes.c_int
    lib.bpt_error_string.argtypes = [ctypes.c_int]
    lib.bpt_error_string.restype = ctypes.c_char_p
    return lib
