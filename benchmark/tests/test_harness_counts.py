"""The frozen operation and byte counts against the port's own
(``smoke.k1_bound``, ``k3_bounds``, ``k4_bounds``, ``K4_SITES``) and
against sums by hand of the architectures' convolutions."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.counts import kernels, models  # noqa: E402

CVAE = json.loads((ROOT / "benchmark/configs/cvae_fiducial_512.json")
                  .read_text())
CGAN = json.loads((ROOT / "benchmark/configs/cgan_fiducial_512.json")
                  .read_text())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_counts(dtype):
    import torch
    from baryon_painter_tpu_torch import smoke
    n, h, w, c = 16, 64, 64, 128
    ops, nbytes = kernels.k1(n, h, w, c, dtype)
    assert ops == 2 * 2 * n * h * w * c * c * 9
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    port = smoke.k1_bound((n, h, w, c), tdtype)
    assert ops == port["flops"] and nbytes == port["bytes"]


def test_k3_counts_are_the_heads_math():
    from baryon_painter_tpu_torch import smoke
    n, h, w = 24, 512, 512
    fwd_ops, fwd_bytes = kernels.k3_fwd(n, h, w, "float32")
    # both heads' 7x7, 5x5 and 3x3 convolutions, once a pixel
    assert fwd_ops == 2 * n * h * w * smoke._HEAD_FWD_OPS
    bwd_ops, _ = kernels.k3_bwd(n, h, w, "float32")
    # the input and weight gradients of each conv, without the smoke's
    # recomputed u2 (the bound counts no recomputed work)
    assert bwd_ops == 2 * fwd_ops
    assert bwd_ops == 2 * n * h * w * (smoke._HEAD_BWD_OPS
                                       - 2 * 5 * 5 * 8)
    # no kept u1 in the bytes: x, y and the f32 weights
    assert fwd_bytes == n * h * w * 18 * 4 + 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8
                                                  + 3 * 3 + 2) * 4


def test_k4_sites_are_the_ports():
    from baryon_painter_tpu_torch import smoke
    sites = models.cvae_k4_sites(CVAE["architecture"], 512)
    port = [smoke.K4_SITES[k] for k in "ABCD"]
    assert [(s["kind"] == "transp", s["cin"], s["cout"], s["k"], s["s"],
             s["h"]) for s in sites] == [
        (p["transposed"], p["cin"], p["cout"], p["k"], p["stride"], p["h"])
        for p in port]
    for site, p in zip(sites, port):
        (fwd, _), (bwd, _) = kernels.k4_site(site, 24, "float32")
        conv = smoke.k4_bounds(p, 24, 512)["conv_flops"]
        out = 24 * site["ho"] * site["wo"] * site["cout"]
        assert fwd == conv + 3 * out and bwd == 2 * conv + 8 * out


def _conv(cin, cout, k, hout):
    return 2.0 * cin * cout * k * k * hout * hout


def _transp(cin, cout, k, hin):
    return 2.0 * cin * cout * k * k * hin * hin


def test_cvae_paint_flops_by_hand():
    t = 512
    prior = (_conv(2, 8, 4, t // 2) + _conv(8, 16, 8, t // 8)
             + _conv(16, 32, 8, t // 32) + _conv(32, 2, 5, t // 32))
    p_z_in = (_transp(1, 1, 4, t // 32) + _transp(1, 1, 8, t // 16)
              + _transp(1, 1, 8, t // 4))
    trunk = (_conv(3, 16, 5, t) + _conv(16, 32, 4, t // 2)
             + _conv(32, 64, 4, t // 4) + _conv(64, 128, 4, t // 8)
             + 4 * 2 * _conv(128, 128, 3, t // 8)
             + _transp(128, 64, 4, t // 8) + _transp(64, 32, 4, t // 4)
             + _transp(32, 16, 4, t // 2))
    heads = 2 * (_conv(16, 8, 7, t) + _conv(8, 1, 5, t) + _conv(1, 1, 3, t))
    assert models.cvae_paint_flops(CVAE["architecture"], t) == (
        prior + p_z_in + trunk + heads)
    down = _conv(8, 16, 8, t // 8) + _conv(16, 32, 8, t // 32)
    recognition = (_conv(1, 8, 4, t // 2) + down          # q_x_in
                   + _conv(2, 8, 4, t // 2) + down        # q_y_in
                   + _conv(64, 2, 5, t // 32))            # q_x_y_out
    assert models.cvae_train_forward_flops(CVAE["architecture"], t) == (
        recognition + prior + p_z_in + trunk + heads)


def test_cgan_paint_flops_by_hand():
    t = 512
    body = (_conv(2, 32, 9, t) + _conv(32, 64, 3, t // 2)
            + _conv(64, 128, 3, t // 4) + 9 * 2 * _conv(128, 128, 3, t // 4)
            + _transp(128, 64, 3, t // 4) + _transp(64, 32, 3, t // 2))
    head = _conv(32, 1, 9, t)
    assert models.cgan_paint_flops(CGAN["generator"], t) == body + head
    assert models.paint_res_blocks(CGAN, t) == [(128, 128, 128)] * 9
    assert models.paint_res_blocks(CVAE, t) == [(128, 64, 64)] * 4


def test_peaks_are_the_published_ones():
    p = kernels.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"float32": 495e12 / 3, "bfloat16": 989e12,
                 "hbm_bytes_per_s": 3.35e12}
    assert kernels.peaks("some other card") is None
