"""What the compiler made of the tensor-core kernels: K1 (csrc/res_block.cu,
f32 and bf16), K3 (csrc/head_stack.cu, f32 and bf16: K3-fwd's u1 GEMM and
chain, K3-bwd's chain, dx and dw1) and K4 (csrc/conv_bn.cu, f32 and bf16:
the u GEMM of stats and bwd1, dx, dW, and fwd's pass).

    python -m baryon_painter_tpu_torch.kernel_report

Builds the kernel library afresh (nvcc with ``-Xptxas -v``), then prints for
each of those kernels' instantiations (K1 and K3's five launches in f32
and bf16; K4's stats, bwd1, dx and dW in f32 and bf16, and fwd's two
kernels): ptxas' registers and spills,
the number of tensor-core instructions in its SASS (from ``cuobjdump
-sass``: ``HMMA``, the mma.sync products, and ``HGMMA``, Hopper's wgmma)
by variant (``HMMA.1688.F32.TF32``, ``HMMA.16816.F32.BF16``,
``HGMMA.64x128x16.F32.BF16``, ...) with one of them quoted, the TMA
loads (``UTMALDG``) it issues, and each launch's
shared memory per block in bytes (K1 at C = 128, K3's launches at any
shape, K4's
GEMMs at the four fused sites of the fiducial training step; stats and
bwd1 share one mainloop and one shared memory size). The last line is the
same as JSON. Needs nvcc and cuobjdump (the CUDA toolkit); no card.
"""
from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops import _build

# K4's kernels take their element type first: f (float) or t (bf16, held
# as its 16 bits in a uint16_t), then N (the block's columns)
_KERNEL = re.compile(r"(dx_kernel|dw_kernel)I([ft])Li(\d+)E")
# K4's u GEMM: <T, N, STATS>, named stats_kernel or bwd1_kernel
_U_GEMM = re.compile(r"u_gemm_kernelI([ft])Li(\d+)ELb([01])E")
_DU = re.compile(r"du_kernelI([ft])E")
_K1 = re.compile(r"res_block_kernelI(f|13__nv_bfloat16)E")
# K3's kernels: the pixel GEMMs <T, KIND> (KIND 0 the u1 GEMM, 1 dx), dw1
# and the two chains <T>
_K3 = re.compile(r"head_(gemm|dw1|chain_fwd|chain_bwd)_kernelI"
                 r"(f|13__nv_bfloat16)(?:Li([01])E)?E")
_K3_NAME = {"gemm0": "u1", "gemm1": "dx", "dw1": "dw1",
            "chain_fwd": "chain_fwd", "chain_bwd": "chain_bwd"}
_BN_RELU = re.compile(r"bn_relu_(bf16_)?kernel")
_K4_TYPE = {"f": "float", "t": "bf16"}


def _name(mangled: str):
    m = _K1.search(mangled)
    if m is not None:
        return "res_block_kernel<" + ("float" if m.group(1) == "f"
                                      else "bf16") + ">"
    m = _K3.search(mangled)
    if m is not None:
        kind, t, which = m.groups()
        return (f"head_{_K3_NAME[kind + (which or '')]}_kernel<"
                + ("float" if t == "f" else "bf16") + ">")
    m = _BN_RELU.search(mangled)
    if m is not None:
        return "bn_relu_bf16_kernel" if m.group(1) else "bn_relu_kernel"
    m = _U_GEMM.search(mangled)
    if m is not None:
        t, nt, stats = m.groups()
        return (f"{'stats' if stats == '1' else 'bwd1'}_kernel"
                f"<{_K4_TYPE[t]},{nt}>")
    m = _DU.search(mangled)
    if m is not None:
        return f"du_kernel<{_K4_TYPE[m.group(1)]}>"
    m = _KERNEL.search(mangled)
    if m is None:
        return None
    kind, t, nt = m.groups()
    return f"{kind}<{_K4_TYPE[t]},{nt}>"


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _name(m.group(1))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def ptxas_warnings(log: str) -> list:
    """ptxas' warnings and performance notes (e.g. C7518: wgmma products
    serialized), each with the kernel it names where it is one of the
    report's."""
    out = []
    for line in log.splitlines():
        if "warning" not in line.lower() and "Performance Loss" not in line:
            continue
        m = re.search(r"function '(\S+)'", line)
        name = _name(m.group(1)) if m else None
        text = re.sub(r"^ptxas (info|warning)\s*:\s*", "", line.strip())
        out.append(f"{name}: {text}" if name else text)
    return out


def sass_report(library: Path) -> dict:
    """{kernel: {"hmma", "hgmma", "tma_loads", "variants", "example"}} from
    ``cuobjdump -sass``: the count of mma.sync products (``HMMA``), of
    wgmma products (``HGMMA``) and of TMA loads (``UTMALDG``), the count of
    each tensor-core variant (its opcode with its shape and types, e.g.
    ``HMMA.1688.F32.TF32``, ``HGMMA.64x128x8.F32.TF32``) and one quoted."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    return sass_counts(sass)


def sass_counts(sass: str) -> dict:
    """``sass_report``'s counts from the text of ``cuobjdump -sass``."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _name(m.group(1))
            if name:
                out[name] = {"hmma": 0, "hgmma": 0, "tma_loads": 0,
                             "variants": {}, "example": None}
            continue
        if not name:
            continue
        if re.search(r"\bUTMALDG\b", line):
            out[name]["tma_loads"] += 1
        m = re.search(r"\b((H|HG)MMA[^;]*);", line)
        if m:
            out[name]["hgmma" if m.group(2) == "HG" else "hmma"] += 1
            op = m.group(1).split()[0]
            out[name]["variants"][op] = out[name]["variants"].get(op, 0) + 1
            if out[name]["example"] is None:
                out[name]["example"] = " ".join(m.group(1).split())
    return out


def smem_report() -> dict:
    """Shared memory per block (bytes, as the launches request it): K1 at
    C = 128, K3's five launches (the u1 GEMM, the forward chain, the
    backward chain, dx, dw1), each in f32 and bf16, and the stats, bwd1, dx
    and dW launches of K4 at the fused sites, in f32 and bf16, each under
    the instantiation it launches (stats and bwd1 run the same mainloop, so
    they ask for the same; fwd and du use none)."""
    lib = _build.load_library()
    c = smoke.K1_SHAPE[-1]
    out = {"res_block_kernel<float>": lib.bpt_res_block_smem(c, 0),
           "res_block_kernel<bf16>": lib.bpt_res_block_smem(c, 1)}
    for which, kind in enumerate(("u1", "chain_fwd", "chain_bwd", "dx",
                                  "dw1")):
        for code, t in ((0, "float"), (1, "bf16")):
            out[f"head_{kind}_kernel<{t}>"] = lib.bpt_head_stack_smem(which,
                                                                      code)
    for name, site in smoke.K4_SITES.items():
        s = site["stride"] if site["transposed"] else 1
        h = smoke.k4_site_shape(site, smoke.TRAIN_BATCH,
                                smoke.TRAIN_TILE)["h"]
        for code, label in ((0, name), (1, f"{name} bf16")):
            t = "float" if code == 0 else "bf16"
            args = (smoke.TRAIN_BATCH, site["cin"], h, h, site["cout"],
                    site["k"], s)
            out[label] = {}
            for which, kind in ((0, "stats"), (0, "bwd1"), (1, "dx"),
                                (2, "dw")):
                # the instantiation the launch runs: N as the library
                # picks it
                nt = lib.bpt_conv_bn_nt(*args, which, code)
                out[label][f"{kind}_kernel<{t},{nt}>"] = \
                    lib.bpt_conv_bn_bwd_smem(*args, which, code)
    return out


def main():
    build = _build.build_library(force=True)
    record = {"build_s": build["seconds"],
              "ptxas": ptxas_report(build["log"]),
              "ptxas_warnings": ptxas_warnings(build["log"]),
              "sass": sass_report(build["path"]),
              "smem_bytes": smem_report()}
    for k in sorted(record["sass"]):
        p = record["ptxas"].get(k, {})
        q = record["sass"][k]
        print(f"{k:24s} registers {p.get('registers')}, spill stores "
              f"{p.get('spill_stores')} B, HMMA {q['hmma']}, HGMMA "
              f"{q['hgmma']}, TMA loads {q['tma_loads']} {q['variants']}: "
              f"{q['example']}")
    for w in record["ptxas_warnings"]:
        print(f"ptxas: {w}")
    for site, v in record["smem_bytes"].items():
        if isinstance(v, int):
            print(f"{site}: shared memory per block {v} B")
        else:
            print(f"K4 site {site}: shared memory per block " + ", ".join(
                f"{k} {b} B" for k, b in v.items()))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
