#!/usr/bin/env python3
"""Where K3's time goes, on the card: K3-fwd and K3-bwd of a checkout's
``csrc/head_stack.cu`` at the training shape (24, 512, 512), K3-fwd also
at the paint shape (16, 512, 512) without u1, in f32 and bf16.

    python3 scripts/k3_phase_trace_torch.py [--root DIR] [--out FILE]

``--root`` is the checkout whose source is traced (default: this one; for
another commit unpack ``git archive`` of it into a directory that
``.gitignore`` lists). The script knows two designs of the source and
picks the one whose anchors it finds:

- ``fused`` (one launch a call: a block computes the 7x7 GEMMs and the
  CUDA-core chain of a tile, the backward per tile and head): the source is
  built once more with ``clock64()`` stamps, and warp 0's first thread of
  each block sums the cycles of each phase over the block's tiles (the
  forward: the weights, x's staging, the u1 GEMM, a1 and u1's stores,
  conv5, conv3 and y's stores; the backward: set-up, u1 and dy's staging,
  u2, du2 with dw3, du1 with dw2, dx, x's staging, dw1, the partials).
  Prints each phase's mean cycles and microseconds per block and its
  share of the block's time.
- ``split`` (one launch a pass: the forward's u1 GEMM and chain, the
  backward's chain, dx and dw1): each pass is launched alone through its C
  entry point and timed with CUDA events, so a pass is a phase; the GEMM
  passes are also built with stamps (waiting on the ring, the products,
  the epilogue) as the fused design's.

Each stamp is inserted before or after an anchor, a line of the source's
code (never a comment); a source without one of its design's anchors
raises (``tests/test_torch_head_stack_gemm.py`` checks the anchors on the
CPU). Prints one JSON line per (kernel, dtype, shape) and writes them all
to ``--out``. Needs nvcc and a CUDA device; imports only torch, numpy and
the port.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# per block: 12 phase sums, then the global timer at the start and at the
# last store, the SM and the block's total cycles
WORDS = 16
_HEADER = (
    "__device__ unsigned long long bpt_trace[65536 * 16];\n"
    "__shared__ long long bpt_acc[12];\n"
    "__shared__ long long bpt_last;\n"
    "__shared__ long long bpt_first;\n"
    "__shared__ unsigned long long bpt_g0;\n"
    "#define BPT_BEGIN() do { if (threadIdx.x == 0) { \\\n"
    "  for (int i_ = 0; i_ < 12; ++i_) bpt_acc[i_] = 0; \\\n"
    "  unsigned long long g_; \\\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); \\\n"
    "  bpt_g0 = g_; bpt_last = bpt_first = clock64(); } } while (0)\n"
    "#define BPT_MARK(k) do { if (threadIdx.x == 0) { \\\n"
    "  const long long t_ = clock64(); bpt_acc[k] += t_ - bpt_last; \\\n"
    "  bpt_last = t_; } } while (0)\n"
    "#define BPT_STORE(blk) do { if (threadIdx.x == 0) { \\\n"
    "  unsigned long long* o_ = bpt_trace + (size_t)(blk) * 16; \\\n"
    "  for (int i_ = 0; i_ < 12; ++i_) o_[i_] = bpt_acc[i_]; \\\n"
    "  unsigned long long g_; unsigned int s_; \\\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); \\\n"
    "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s_)); \\\n"
    "  o_[12] = bpt_g0; o_[13] = g_; o_[14] = s_; \\\n"
    "  o_[15] = clock64() - bpt_first; } } while (0)\n")
_READ = ("int bpt_trace_read(void* host, int n) {\n"
         "  return (int)cudaMemcpyFromSymbol(host, bpt_trace, "
         "(size_t)n * 8);\n}\n")
_BWD_BLK = ("((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
            " + blockIdx.x")

# The fused design (one launch a call): (anchor, text, where, copies)
FUSED_PHASES = {
    "fwd": ["weights", "stage_x", "u1_gemm", "a1_u1_stores", "conv5",
            "conv3_y_stores"],
    "bwd": ["setup", "stage_u1_dy", "u2", "du2_dw3", "du1_dw2", "dx",
            "stage_x", "dw1", "partials"]}
FUSED_ANCHORS = [
    ("namespace {\n", _HEADER, "after", 1),
    ('extern "C" {\n', _READ, "after", 1),
    # K3-fwd
    ("  float* xs = reinterpret_cast<float*>(smem_raw);    "
     "// x, staged by type\n", "  BPT_BEGIN();\n", "after", 1),
    ("  fwd_stage_weights(ws, wu);\n", "  BPT_MARK(0);\n", "after", 1),
    ("    __syncthreads();  // x (and, at the first tile, the weights) "
     "staged\n", "    BPT_MARK(1);\n", "after", 1),
    ("    __syncthreads();  // every warp is done with xs: a1 goes over it\n",
     "    BPT_MARK(2);\n", "after", 1),
    ("    __syncthreads();  // a1 staged\n", "    BPT_MARK(3);\n", "after",
     1),
    ("    __syncthreads();  // a2 staged; a1s (xs) free for the next tile\n",
     "    BPT_MARK(4);\n", "after", 1),
    ("        y[(((size_t)n * kHeads + h) * H + gy) * W + gx] = "
     "from_f32<T>(acc);\n    }\n",
     "    BPT_MARK(5);\n    BPT_STORE(blockIdx.x);\n", "after", 1),
    # K3-bwd
    ("  float* smem = reinterpret_cast<float*>(smem_raw);\n",
     "  BPT_BEGIN();\n", "after", 1),
    ("  float dal2r[kHeads] = {0.f, 0.f};\n", "  BPT_MARK(0);\n", "after",
     1),
    ("      __syncthreads();  // u1, dy; previous head done\n",
     "      BPT_MARK(1);\n", "after", 1),
    ("        u2s[p] = inside(ty0 - 5 + py, tx0 - 5 + px, H, W) ? acc : "
     "0.f;\n      }\n      __syncthreads();", "\n      BPT_MARK(2);",
     "after", 1),
    ("        add_to_head(dw3r, h, s);\n      }\n      __syncthreads();",
     "\n      BPT_MARK(3);", "after", 1),
    ("        add_to_head(dw2r, h, s);\n      }\n", "      BPT_MARK(4);\n",
     "after", 1),
    ("  stage_x(xn, xs, kBX, kPX, ty0 - 3, tx0 - 3, H, W);\n"
     "  __syncthreads();\n", ("  BPT_MARK(5);\n", "  BPT_MARK(6);\n"),
     "around", 1),
    ("  bf16* x0 = reinterpret_cast<bf16*>(xsm);\n", "  BPT_MARK(5);\n",
     "before", 1),
    ("      reinterpret_cast<unsigned short*>(x1)[ci * kPD1B + p + 1] = c;"
     "\n    }\n  }\n  __syncthreads();\n", "  BPT_MARK(6);\n", "after", 1),
    ("        *d = (first ? 0.f : *d) + part[jj][e];\n      }\n    }\n  }\n",
     "  BPT_MARK(7);\n", "after", 2),
    ("    dalp[blk * kHeads * 2 + hj] = s;\n  }\n",
     f"  BPT_MARK(8);\n  BPT_STORE({_BWD_BLK});\n", "after", 1),
]

# The split design (one launch a pass): the stamps of each pass's kernel,
# thread 0 (a consumer in the GEMMs) summing over the block's tiles
SPLIT_PHASES = {
    "u1": ["wait_window", "products", "epilogue"],
    "dx": ["wait_window", "products", "epilogue"],
    "dw1": ["wait_chunk", "transpose_du1", "products", "partials"],
    "chain_fwd": ["stage_a1", "conv5", "conv3_y"],
    "chain_bwd": ["stage_a1_dy", "u2", "du2_dw3", "du1", "dw2",
                  "partials"]}
SPLIT_ANCHORS = [
    ("namespace {\n", _HEADER, "after", 1),
    ('extern "C" {\n', _READ, "after", 1),
    # the pixel GEMMs (u1, dx)
    ("  const int mi = lane >> 3;\n  const int gl = lane >> 2;\n",
     "  BPT_BEGIN();\n", "before", 1),
    ("    mbar_wait(ring.full(s), (it / g.stages) & 1);\n"
     "    first_fragment<T, MT>(f, fetch);\n",
     ("    BPT_MARK(2);\n", "    BPT_MARK(0);\n"), "around", 1),
    ("              h0[m][q] = *reinterpret_cast<const uint32_t*>(&b);\n"
     "            }\n      }\n    }\n    release(ring, s, lane);\n",
     "    BPT_MARK(1);\n", "after", 1),
    ("                __floats2bfloat162_rn(v0, v1);\n          }\n"
     "        }\n      }\n    }\n  }\n",
     "  BPT_MARK(2);\n  BPT_STORE(blockIdx.x);\n", "after", 1),
    # dw1
    ("  float sum[REG][8];\n", "  BPT_BEGIN();\n", "after", 1),
    ("    mbar_wait(ring.full(s), (i / g.stages) & 1);\n",
     "    BPT_MARK(0);\n", "after", 1),
    ("    fence_proxy_async();   // the tiles' writes, before wgmma reads "
     "them\n    named_barrier(1, kConsumers);\n", "    BPT_MARK(1);\n",
     "after", 1),
    ("        sts32(a, __float_as_uint(__uint_as_float(lds32(a)) + part[0][e]));"
     "\n      }\n    }\n", "    BPT_MARK(2);\n", "after", 1),
    ("            make_float2(v[4 * j + 2 * hh], v[4 * j + 2 * hh + 1]);\n"
     "    }\n  }\n", "  BPT_MARK(3);\n  BPT_STORE(blockIdx.x);\n", "after",
     1),
    # the forward chain
    ("  const float* u1n = u1 + (size_t)n * H * W * kN1;\n"
     "  constexpr int kStageIt = cdiv(kFA1H * kFA1W, kChainThreads);\n",
     "  BPT_BEGIN();\n", "before", 1),
    ("        a1s[(4 * q + e) * kFA1P + p] = rnd<T>(prelu(v[e], al[2 * (q >> "
     "1)]));\n    }\n  }\n  __syncthreads();\n", "  BPT_MARK(0);\n",
     "after", 1),
    ("          in ? rnd<T>(prelu(acc[o], al[2 * h + 1])) : 0.f;\n    }\n"
     "  }\n  __syncthreads();\n", "  BPT_MARK(1);\n", "after", 1),
    ("      *d = __float2bfloat16_rn(acc);\n    }\n  }\n",
     "  BPT_MARK(2);\n  BPT_STORE(blockIdx.x);\n", "after", 1),
    # the backward chain
    ("  const int tiles = N * tiles_x * tiles_y;\n"
     "  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n",
     "  BPT_BEGIN();\n", "before", 1),
    ("        if (p < kBDYH * kBDYW) dys[p] = dyv[i];\n      }\n"
     "      __syncthreads();\n", "      BPT_MARK(0);\n", "after", 1),
    ("              inside(ty0 - 2 + py, tx0 - 2 + px + o, H, W) ? acc[o] : "
     "0.f;\n      }\n      __syncthreads();\n", "      BPT_MARK(1);\n",
     "after", 1),
    ("        add_to_head(dw3r, h, s);\n      }\n      __syncthreads();\n",
     "      BPT_MARK(2);\n", "after", 1),
    ("          store4(du1 + pix * kN1 + kC1 * h + c0, d);\n        }\n"
     "      }\n", "      BPT_MARK(3);\n", "after", 1),
    ("          if (lane < 8) dw2w[(warp * kHeads + h) * kW2 + k * kC1 + c] "
     "+= v;\n        }\n      }\n", "      BPT_MARK(4);\n", "after", 1),
    ("    dalp[(size_t)blockIdx.x * kHeads * 2 + hj] = s;\n  }\n",
     "  BPT_MARK(5);\n  BPT_STORE(blockIdx.x);\n", "after", 1),
]

SHAPES = {"train": (24, 512, 512), "paint": (16, 512, 512)}


def design(src: str) -> str:
    """``fused`` or ``split``: the design whose anchors the source holds."""
    if "head_fwd_kernel" in src and "bwd_gemms" in src:
        return "fused"
    if "bpt_head_u1_gemm" in src:
        return "split"
    raise ValueError("K3's source is of no design this script knows")


def instrumented(src: str, anchors=None) -> str:
    """The source with the stamps; raises if an anchor is missing or not
    there as often as the design has it."""
    anchors = FUSED_ANCHORS if anchors is None else anchors
    for anchor, text, where, copies in anchors:
        if src.count(anchor) != copies:
            raise ValueError(f"K3's source has {src.count(anchor)} copies "
                             f"of the anchor {anchor!r}, not {copies}")
        if text is None:
            continue
        if where == "before":
            new = text + anchor
        elif where == "after":
            new = anchor + text
        else:
            new = text[0] + anchor + text[1]
        src = src.replace(anchor, new)
    return src


def build(tmp: Path, source: Path, anchors=None) -> ctypes.CDLL:
    from baryon_painter_tpu_torch.ops import _build
    (tmp / "head_stack_trace.cu").write_text(
        instrumented(source.read_text(), anchors))
    for header in source.parent.glob("*.cuh"):   # ptx.cuh, hopper.cuh
        (tmp / header.name).write_text(header.read_text())
    so = tmp / "libk3trace.so"
    subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                    str(tmp / "head_stack_trace.cu")], check=True,
                   timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(so))
    lib.bpt_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _blocks_record(lib, blocks: int, names: list) -> dict:
    buf = np.zeros(blocks * WORDS, np.uint64)
    if lib.bpt_trace_read(buf.ctypes.data, blocks * WORDS):
        raise RuntimeError("reading the stamps failed")
    t = buf.reshape(blocks, WORDS).astype(np.float64)
    ns = t[:, 13] - t[:, 12]
    ghz = float(np.median(t[:, 15] / np.maximum(ns, 1)))
    cyc = t[:, :len(names)]
    total = t[:, 15]
    return {"blocks": blocks, "sms": int(len(np.unique(t[:, 14]))),
            "sm_clock_ghz": ghz,
            "block_us_mean": float(total.mean() / ghz / 1e3),
            "phase_us_mean": dict(zip(names, map(
                float, cyc.mean(0) / ghz / 1e3))),
            "phase_share": dict(zip(names, map(
                float, cyc.sum(0) / total.sum())))}


def _events_ms(fn, iters: int = 3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace_fused(lib, dtype_name: str, case: str) -> list:
    """The fused design's K3-fwd (and at the training shape K3-bwd) as the
    parent's wrapper launches them, with its stamps."""
    import torch
    from baryon_painter_tpu_torch import smoke
    dtype = getattr(torch, dtype_name)
    n, h, w = SHAPES[case]
    x, w1, w2, w3, al, dy = smoke.head_inputs(n, h, w, "cuda")
    x, dy = x.to(dtype).contiguous(), dy.to(dtype).contiguous()
    rnd = (lambda v: v) if dtype == torch.float32 else (
        lambda v: v.to(dtype).float())
    wu = w1.permute(0, 4, 1, 2, 3).reshape(16, 784).to(dtype).contiguous()
    wdx = w1.permute(3, 1, 2, 0, 4).reshape(16, 784).to(dtype).contiguous()
    w2r, w3r = rnd(w2).contiguous(), rnd(w3).contiguous()
    y = torch.empty((n, 2, h, w), dtype=dtype, device="cuda")
    keep = case == "train"
    u1 = torch.empty((n, h, w, 16), device="cuda") if keep else None
    code = 0 if dtype == torch.float32 else 1
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bpt_head_stack_fwd.argtypes = [p] * 7 + [i, i, i, i, p]
    lib.bpt_head_stack_bwd.argtypes = [p] * 12 + [i, i, i, i, p]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()

    def fwd():
        err = lib.bpt_head_stack_fwd(x.data_ptr(), wu.data_ptr(),
                                     w2r.data_ptr(), w3r.data_ptr(),
                                     al.data_ptr(), y.data_ptr(), ptr(u1), n,
                                     h, w, code, stream())
        if err:
            raise RuntimeError(f"K3-fwd launch failed ({err})")

    ms = _events_ms(fwd)
    props = torch.cuda.get_device_properties(0)
    tiles = n * -(-h // 16) * -(-w // 16)
    per_sm = 2
    grid = min(tiles, props.multi_processor_count * per_sm)
    out = [{"kernel": "k3_fwd", "design": "fused", "dtype": dtype_name,
            "shape": [n, h, w], "keep_u1": keep, "launch_ms": ms,
            **_blocks_record(lib, grid, FUSED_PHASES["fwd"])}]
    if not keep:
        return out
    blocks = n * -(-h // 16) * -(-(-(-w // 16)) // 16)
    dx = torch.empty_like(x)
    part = lambda *s: torch.empty((blocks,) + s, device="cuda")
    dw1p, dw2p, dw3p, dalp = (part(2, 7, 7, 16, 8), part(2, 5, 5, 8, 1),
                              part(2, 3, 3, 1, 1), part(2, 2))

    def bwd():
        err = lib.bpt_head_stack_bwd(
            x.data_ptr(), u1.data_ptr(), wdx.data_ptr(), w2r.data_ptr(),
            w3r.data_ptr(), al.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw1p.data_ptr(), dw2p.data_ptr(), dw3p.data_ptr(),
            dalp.data_ptr(), n, h, w, code, stream())
        if err:
            raise RuntimeError(f"K3-bwd launch failed ({err})")

    ms = _events_ms(bwd)
    out.append({"kernel": "k3_bwd", "design": "fused", "dtype": dtype_name,
                "shape": [n, h, w], "launch_ms": ms,
                **_blocks_record(lib, blocks, FUSED_PHASES["bwd"])})
    return out


def trace_split(lib, dtype_name: str, case: str) -> list:
    """The split design's passes at ``case``'s shape: the forward's u1 GEMM
    and chain (u1 kept at the training shape, written to a scratch tensor
    at the paint shape, as the wrapper does), at the training shape also
    the backward's chain, dx and dw1; each pass alone, timed with the
    package's own library, its phases from the stamped one."""
    import torch
    from baryon_painter_tpu_torch import smoke
    from baryon_painter_tpu_torch.ops import _build
    from baryon_painter_tpu_torch.ops import head_stack as k3
    dtype = getattr(torch, dtype_name)
    n, h, w = SHAPES[case]
    code = 0 if dtype == torch.float32 else 1
    x, w1, w2, w3, al, dy = smoke.head_inputs(n, h, w, "cuda")
    x, dy = x.to(dtype).contiguous(), dy.to(dtype).contiguous()
    r = k3.rounder(dtype)
    w2r, w3r = r(w2).contiguous(), r(w3).contiguous()
    wu, wdx = k3.gemm_weights(w1, dtype)
    u1 = torch.empty((n, h, w, 16), device="cuda")
    y = torch.empty((n, 2, h, w), dtype=dtype, device="cuda")
    own = _build.load_library()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    # each pass's blocks, as the library launches them
    grid = lambda which: own.bpt_head_grid(which, n, h, w, code)
    passes = [("u1", "bpt_head_u1_gemm", (x, wu, u1), (), grid(0)),
              ("chain_fwd", "bpt_head_chain_fwd", (u1, w2r, w3r, al, y), (),
               grid(1))]
    if case == "train":
        blocks, splits = grid(2), grid(4)
        du1, dx = torch.empty_like(x), torch.empty_like(x)
        part = lambda *s: torch.empty(s, device="cuda")
        dw2p, dw3p, dalp = (part(blocks, 2, 25, 8), part(blocks, 2, 9),
                            part(blocks, 2, 2))
        dw1p = part(splits, 2, 49, 16, 8)
        passes += [("chain_bwd", "bpt_head_chain_bwd",
                    (u1, dy, w2r, w3r, al, du1, dw2p, dw3p, dalp), (blocks,),
                    blocks),
                   ("dx", "bpt_head_dx", (du1, wdx, dx), (), grid(3)),
                   ("dw1", "bpt_head_dw1", (x, du1, dw1p), (splits,),
                    splits)]
    out = []
    for name, fn, tensors, extra, grid in passes:
        for which in (own, lib):
            f = getattr(which, fn)
            f.argtypes = ([ctypes.c_void_p] * len(tensors)
                          + [ctypes.c_int] * (4 + len(extra))
                          + [ctypes.c_void_p])

        def launch(which):
            err = getattr(which, fn)(*(t.data_ptr() for t in tensors), n, h,
                                     w, *extra, code, stream())
            if err:
                raise RuntimeError(f"{fn} failed ({err})")

        ms = _events_ms(lambda: launch(own))
        launch(lib)
        torch.cuda.synchronize()
        out.append({"kernel": "k3_fwd" if name in ("u1", "chain_fwd")
                    else "k3_bwd", "pass": name, "design": "split",
                    "dtype": dtype_name, "shape": [n, h, w],
                    "keep_u1": case == "train", "launch_ms": ms,
                    **_blocks_record(lib, grid, SPLIT_PHASES[name])})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="the checkout whose csrc/head_stack.cu is traced")
    ap.add_argument("--out", default=None,
                    help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k3_phase_trace_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    source = root / "baryon_painter_tpu_torch" / "csrc" / "head_stack.cu"
    kind = design(source.read_text())
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        if kind == "fused":
            lib = build(Path(tmp), source)
            runs = [(d, c) for d in ("float32", "bfloat16")
                    for c in ("train", "paint")]
            for dtype_name, case in runs:
                for rec in trace_fused(lib, dtype_name, case):
                    rec.update(card=card, root=str(root))
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
        else:
            lib = build(Path(tmp), source, SPLIT_ANCHORS)
            runs = [(d, c) for d in ("float32", "bfloat16")
                    for c in ("train", "paint")]
            for dtype_name, case in runs:
                for rec in trace_split(lib, dtype_name, case):
                    rec.update(card=card, root=str(root))
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
