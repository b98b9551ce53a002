"""The kernel report's parsers (baryon_painter_tpu_torch/kernel_report.py) on
text in the form nvcc's ``-Xptxas -v`` and ``cuobjdump -sass`` print it:
which kernel a mangled name is, registers and spills, and the count of
mma.sync products (HMMA), wgmma products (HGMMA) and TMA loads (UTMALDG) a
kernel's SASS holds. The report itself needs the CUDA toolkit and runs on
the machine with the card.
"""
import pytest

from baryon_painter_tpu_torch import kernel_report

# K1's two instantiations as nvcc mangles them (the tensor maps first)
K1_F32 = ("_ZN57_INTERNAL_res_block_cu_12345678_9_res_block_cu_abcdef12"
          "16res_block_kernelIfEEv14CUtensorMap_stS1_PKT_PKfS6_S6_S6_PS2_"
          "iiiiff")
K1_BF16 = ("_ZN57_INTERNAL_res_block_cu_12345678_9_res_block_cu_abcdef12"
           "16res_block_kernelI13__nv_bfloat16EEv14CUtensorMap_stS2_PKT_"
           "PKfS7_S7_S7_PS3_iiiiff")
# K3's kernels: the pixel GEMMs <T, KIND> (0 the u1 GEMM, 1 dx), dw1 and
# the chains <T>
K3_U1 = ("_ZN12_GLOBAL__N_116head_gemm_kernelIfLi0EEEv14CUtensorMap_S1_"
         "NS_7GemmGeoEiiiPv")
K3_DX = ("_ZN12_GLOBAL__N_116head_gemm_kernelI13__nv_bfloat16Li1EEEv14"
         "CUtensorMap_S2_NS_7GemmGeoEiiiPv")
K3_DW1 = "_ZN12_GLOBAL__N_115head_dw1_kernelIfEEv14CUtensorMap_S1_NS_5DwGeoEPf"
K3_CHAIN = ("_ZN12_GLOBAL__N_121head_chain_bwd_kernelI13__nv_bfloat16EEvPKfPK"
            "T_S3_S3_S3_PS4_PfS8_S8_iii")
# K4's GEMMs: <T, N> (the u GEMM <T, N, STATS>), T = f (float) or t (bf16
# as uint16_t), and bwd2's du pass <T>
K4_PREFIX = "_ZN43_GLOBAL__N__ae3193cd_10_conv_bn_cu_fc4f734f"
K4_STATS = K4_PREFIX + "13u_gemm_kernelIfLi16ELb1EEEv14CUtensorMap_S1_"
K4_BWD1 = K4_PREFIX + "13u_gemm_kernelItLi64ELb0EEEv14CUtensorMap_S1_"
K4_DX = K4_PREFIX + "9dx_kernelIfLi8EEEv14CUtensorMap_S1_NS_6PixGeoEiPT_"
K4_DW = K4_PREFIX + "9dw_kernelItLi32EEEv14CUtensorMap_S1_NS_5DwGeoEPf"
K4_DU = K4_PREFIX + "9du_kernelItEEvPKfPKT_S5_NS_8DuConstsEPS3_iiii"


@pytest.mark.parametrize("mangled,name", [
    (K1_F32, "res_block_kernel<float>"),
    (K1_BF16, "res_block_kernel<bf16>"),
    (K3_U1, "head_u1_kernel<float>"),
    (K3_DX, "head_dx_kernel<bf16>"),
    (K3_DW1, "head_dw1_kernel<float>"),
    (K3_CHAIN, "head_chain_bwd_kernel<bf16>"),
    (K4_STATS, "stats_kernel<float,16>"),
    (K4_BWD1, "bwd1_kernel<bf16,64>"),
    (K4_DX, "dx_kernel<float,8>"),
    (K4_DW, "dw_kernel<bf16,32>"),
    (K4_DU, "du_kernel<bf16>"),
    ("_Z12other_kernelPf", None)])
def test_names(mangled, name):
    assert kernel_report._name(mangled) == name


def test_ptxas_report_reads_registers_and_spills():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{K1_BF16}' for 'sm_90a'",
        "ptxas info    : Function properties for " + K1_BF16,
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 154 registers, used 0 barriers, 624 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{K1_F32}' for 'sm_90a'",
        "    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers"])
    rep = kernel_report.ptxas_report(log)
    assert rep["res_block_kernel<bf16>"] == {
        "spill_stores": 0, "spill_loads": 0, "registers": 154}
    assert rep["res_block_kernel<float>"] == {
        "spill_stores": 16, "spill_loads": 12, "registers": 168}


def test_sass_counts_hmma_hgmma_and_tma_loads():
    sass = "\n".join([
        f"\t\tFunction : {K1_F32}",
        "        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;",
        "        /*0110*/                   UTMALDG.4D [UR16], [UR6] ;",
        "        /*0200*/                   HGMMA.64x128x8.F32.TF32 R24, "
        "R104, gdesc[UR4], R24 ;",
        "        /*0210*/                   HGMMA.64x128x8.F32.TF32 R24, "
        "R108, gdesc[UR8], R24, gsb0 ;",
        "        /*0300*/                   UTMAPF.L2.4D [UR4] ;",
        f"\t\tFunction : {K1_BF16}",
        "        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;",
        "        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, "
        "R104, gdesc[UR4], R24, gsb0 ;",
        f"\t\tFunction : {K3_U1}",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, "
        "R4 ;",
        "        /*0110*/                   HMMA.1688.F32.TF32 R4, R8, R14, "
        "R4 ;",
        "\t\tFunction : _Z12other_kernelPf",
        "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, "
        "R4 ;"])
    got = kernel_report.sass_counts(sass)
    assert set(got) == {"res_block_kernel<float>", "res_block_kernel<bf16>",
                        "head_u1_kernel<float>"}
    f32 = got["res_block_kernel<float>"]
    assert (f32["hmma"], f32["hgmma"], f32["tma_loads"]) == (0, 2, 2)
    assert f32["variants"] == {"HGMMA.64x128x8.F32.TF32": 2}
    assert f32["example"].startswith("HGMMA.64x128x8.F32.TF32 R24, R104")
    bf16 = got["res_block_kernel<bf16>"]
    assert (bf16["hmma"], bf16["hgmma"], bf16["tma_loads"]) == (0, 1, 1)
    k3 = got["head_u1_kernel<float>"]
    assert (k3["hmma"], k3["hgmma"], k3["tma_loads"]) == (2, 0, 0)
    assert k3["variants"] == {"HMMA.1688.F32.TF32": 2}


def test_ptxas_warnings_name_the_kernel():
    log = "\n".join([
        "ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to program dependence on "
        f"compiler-inserted WG.DP in divergent path in the function '{K1_F32}'",
        f"ptxas info    : Compiling entry function '{K1_F32}' for 'sm_90a'",
        "ptxas warning : Registers are spilled to local memory in function "
        "'_Z12other_kernelPf', 8 bytes spill stores, 8 bytes spill loads"])
    got = kernel_report.ptxas_warnings(log)
    assert len(got) == 2
    assert got[0].startswith("res_block_kernel<float>: (C7518) Potential")
    assert got[1].startswith("Registers are spilled")


def test_phase_trace_anchors_are_in_k1s_source():
    """scripts/k1_phase_trace_torch.py stamps K1's phases at anchor lines
    of csrc/res_block.cu: each anchor is a line of code (not a comment) and
    there once, the stamped copy records all eight words of a block, and
    the tile it counts blocks by is the source's (8 x 16 f32, 12 x 16
    bf16)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "k1_phase_trace_torch.py"
    spec = importlib.util.spec_from_file_location("k1_phase_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for anchor, _, _ in mod.ANCHORS:
        assert not anchor.lstrip().startswith("//"), anchor
    text = mod.SOURCE.read_text()
    src = mod.instrumented(text)
    for k in range(8):
        assert f"bpt_trace[bid * 8 + {k}] =" in src
    assert src.count("bpt_trace_read") == 1
    with pytest.raises(ValueError, match="anchor"):
        mod.instrumented(text.replace("  if (!active) return;\n", ""))
    assert mod.tile(text, "float32") == (8, 16)
    assert mod.tile(text, "bfloat16") == (12, 16)
