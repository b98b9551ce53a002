"""chip_smoke.py's phases 20d and 22 (``baryon_painter_tpu_torch/smoke.py``)
on the CPU, at small sizes: the same control flow as on the card, with the
kernels' plain versions and no launch counted.

- 20d (``gate_bf16``): its cases name the 35 committed bf16 readings it
  decides (``smoke.gate_bf16("cpu")`` runs it whole on the CPU, in
  minutes);
- 22b (``validate_figures``): both trainers' ``validate`` draws and saves
  the figures, and the painted batch's P(k) errors on the "card" (here the
  CPU) equal the CPU's;
- 22c (``stats_twin``): the statistics twin reads exactly 0 between two
  equal runs' logs and exits 0, and raises on two that differ;
- 22d (``loader_batches``): ``BatchLoader(raw=False)`` equals
  ``get_batch``.
"""
import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_35_open_readings_are_listed():
    n = sum(len(kinds) for per_z in smoke.GATE_BF16_OPEN.values()
            for kinds in per_z.values())
    assert n == 35
    for prefix, _, _, zs in smoke.GATE_BF16_CASES:
        assert set(smoke.GATE_BF16_OPEN[prefix]) <= set(zs)


def test_validate_figures_on_the_cpu():
    ds = smoke.training_data(tile=32)
    out = smoke.validate_figures("cpu", ds, batch=2)
    assert out["matplotlib"]
    for label in ("cvae", "cgan"):
        r = out[label]
        assert r["figures"] == ["auto_power_spectrum", "cross_power_spectrum",
                                "log_histogram", "sample"]
        assert all(r["figure_bytes"].values())
        assert r["pk_card_vs_cpu"] == {"auto": 0.0, "cross": 0.0}


def _stats_file(rows):
    lines = ["# Batch nr, sample nr, ELBO, KL_term"]
    lines += [f"{i} {24 * (i + 1)} {float(v)!r} 0.5 "
              for i, v in enumerate(rows)]
    return ("\n".join(lines) + "\n").encode()


def test_stats_twin_on_equal_and_unequal_logs():
    rows = list(-5e4 + 4.9e4 * (1 - np.exp(-np.linspace(0, 3, 300))))
    same = {"resumed": _stats_file(rows), "uninterrupted": _stats_file(rows)}
    out = smoke.stats_twin({"stats_files": same})
    assert out["absolute_max_deviation"] == 0.0
    other = dict(same, resumed=_stats_file([v + 1.0 for v in rows]))
    with pytest.raises(AssertionError, match="stats twin"):
        smoke.stats_twin({"stats_files": other})


def test_loader_batches_on_the_cpu():
    out = smoke.loader_batches(smoke.training_data(tile=32))
    assert out["equal"] and out["shape"] == (2, smoke.LOADER_BATCH, 1, 32,
                                             32)


def test_tooling_launches_reach_the_kernels_record():
    entries = [{"name": n, "dtype": d} for n in ("gather_tiles",
               "head_stack_fwd", "head_stack_bwd", "res_block_infer")
               for d in ("float32", "bfloat16")]
    tooling = {"profile": {"launches": {"k2": 4, "k3_fwd": 6, "k3_bwd": 4},
                           "trace_kernels": {"k2": 4, "k3_fwd": 6,
                                             "k3_bwd": 4}},
               "validate": {"cvae": {"sample_launches": {"k3_fwd": 1}}}}
    smoke._add_tooling_launches(entries, tooling)
    got = {(e["name"], e["dtype"]): {k: v for k, v in e.items()
                                     if k not in ("name", "dtype")}
           for e in entries}
    assert got[("gather_tiles", "float32")] == {
        "profile_run_launches": 4, "profile_trace_launches": 4}
    assert got[("head_stack_fwd", "float32")] == {
        "profile_run_launches": 6, "profile_trace_launches": 6,
        "validate_launches": 1}
    assert got[("res_block_infer", "float32")] == {}
    assert all(v == {} for (n, d), v in got.items() if d == "bfloat16")


@pytest.mark.parametrize("kernel", sorted(smoke.TRACE_KERNELS))
def test_trace_kernels_are_launched_by_named_calls(kernel):
    """22a compares each traced kernel with the wrapper calls that launch
    it: every symbol has its calls, each a key of the launch counts, and the
    symbols are told apart by name."""
    calls = smoke.TRACE_CALLS[kernel]
    assert calls and set(calls) <= set(smoke._launches())
    others = [v for k, v in smoke.TRACE_KERNELS.items() if k != kernel]
    assert not any(smoke.TRACE_KERNELS[kernel] in v or v in
                   smoke.TRACE_KERNELS[kernel] for v in others)


def test_k3_cuda_launches_are_held_to_one_a_call():
    """K3's passes as its wrappers count them: reset with the calls, and a
    pass launched more or fewer times than its wrapper was called fails."""
    smoke._reset_launches()
    cuda = smoke._cuda_launches()
    assert cuda == {"k3_fwd": {"bpt_head_u1_gemm": 0, "bpt_head_chain_fwd": 0},
                    "k3_bwd": {"bpt_head_chain_bwd": 0, "bpt_head_dx": 0,
                               "bpt_head_dw1": 0}}
    calls = {"k3_fwd": 3, "k3_bwd": 2}
    ok = {k: dict.fromkeys(v, calls[k]) for k, v in cuda.items()}
    smoke._expect_cuda_launches("ok", calls, ok)
    for key, name in (("k3_fwd", "bpt_head_u1_gemm"),
                      ("k3_bwd", "bpt_head_dw1")):
        for off in (-1, 1):
            bad = {k: dict(v) for k, v in ok.items()}
            bad[key][name] += off
            with pytest.raises(AssertionError, match="K3's CUDA launches"):
                smoke._expect_cuda_launches("bad", calls, bad)
