"""``scripts/gate_variance_torch.py`` against ``scripts/gate_variance.py``.

Both scripts paint the gate's validation tiles of a committed checkpoint
(its meta's ``fidelity_dataset`` geometry), score the gate metric on the
full sample and bootstrap it. Here, on the CPU:

* the CGAN ``fiducial`` (256^2, no noise), ``--n-tiles 8 --redshifts 0
  --n-boot 20``: in f32 every number of the JSON line within 5e-4 of the
  JAX script's; in bf16 (chaotic: ROADMAP.md section 3) the per-bin
  ratios within the JAX package's own f32 -> bf16 distance of them, and
  every number within max(5e-4, the JAX package's own |f32 - bf16| for
  that number, that per-bin distance) of the JAX script's bf16 number
  (the numbers are medians and moments over the bins, which move no
  further than the bins do; ``p_worst_gt_gate`` counts subsets over the
  gate, so its bound is the share of the JAX subsets whose worst value
  lies within that distance of the gate);
* the CVAE ``fiducial-resize`` through the twin's ``gate_variance`` at the
  JAX package's prior noise, f32, every number within 5e-4;
* the bootstrap draws the same indices as the JAX script in each run;
* a meta without ``fidelity_dataset`` is refused, and the twin runs in a
  subprocess in which JAX, flax and msgpack cannot be imported.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from golden_utils import REPO

CGAN = "trained_models/CGAN/fiducial/model"
CVAE = "trained_models/CVAE/fiducial-resize/model"
SMALL = ["--n-tiles", "8", "--redshifts", "0", "--n-boot", "20"]
F32_TOL = 5e-4
# a number of the JSON line rounded to 4 digits moves by up to 1e-4 more
ROUND = 1e-4
LIPSCHITZ_KEYS = ("auto_full", "cross_full", "auto_boot_mean",
                  "auto_boot_sigma", "cross_boot_sigma", "worst_boot_sigma")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_script():
    return _load("gate_variance")


@pytest.fixture(scope="module")
def twin():
    return _load("gate_variance_torch")


class _RecordingRng:
    """A numpy Generator that records the index arrays ``integers`` draws
    (the bootstrap's subsets)."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def integers(self, *a, **kw):
        out = self._rng.integers(*a, **kw)
        self._log.append(np.asarray(out))
        return out

    def __getattr__(self, name):
        return getattr(self._rng, name)


@contextlib.contextmanager
def _recorded(mp, spectra=None):
    """Records every bootstrap subset (the draws of ``default_rng(12345)``)
    and, given a list, the spectra either package computes, as numpy
    (spectra, mode counts); writes each synthetic stack set once (both
    packages write the same files)."""
    import baryon_painter_tpu.data.synthetic as jsyn
    import baryon_painter_tpu.power_spectrum as jps
    import baryon_painter_tpu_torch.data.synthetic as tsyn
    import baryon_painter_tpu_torch.power_spectrum as tps
    boots, made = [], {}
    real = np.random.default_rng

    def default_rng(seed=None):
        rng = real(seed)
        return _RecordingRng(rng, boots) if seed == 12345 else rng

    def once(make):
        def wrapped(root, **kw):
            key = (root, json.dumps(kw, sort_keys=True, default=str))
            if key not in made:
                made[key] = make(root, **kw)
            return made[key]
        return wrapped

    mp.setattr(np.random, "default_rng", default_rng)
    mp.setattr(jsyn, "make_synthetic_stacks", once(jsyn.make_synthetic_stacks))
    mp.setattr(tsyn, "make_synthetic_stacks", once(tsyn.make_synthetic_stacks))
    for module in (jps, tps) if spectra is not None else ():
        def recording(*a, _pk=module.pseudo_pofk_2d, **kw):
            out = _pk(*a, **kw)
            spectra.append(tuple(np.asarray(getattr(x, "cpu", lambda: x)())
                                 for x in (out[0], out[3])))
            return out
        mp.setattr(module, "pseudo_pofk_2d", recording)
    yield boots


def _jax_line(jax_script, mp, argv, spectra=None):
    with mp.context() as m, _recorded(m, spectra) as boots:
        m.setattr(sys, "argv", ["gate_variance.py"] + argv)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            jax_script.main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), boots


def _twin_line(twin, mp, argv, spectra=None):
    with mp.context() as m, _recorded(m, spectra) as boots:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rec = twin.main(argv + ["--device", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == rec
    return rec, boots


def _numbers(rec):
    """Every number of a JSON line: the top-level ones, and per redshift
    each of ``per_z`` (the interval as two)."""
    out = {k: v for k, v in rec.items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)}
    for z, r in rec["per_z"].items():
        for k, v in r.items():
            if isinstance(v, list):
                out.update({f"{z}/{k}/{i}": x for i, x in enumerate(v)})
            else:
                out[f"{z}/{k}"] = v
    return out


def _same_keys(got, want):
    assert set(got) == set(want)
    for k in ("metric", "n_tiles_full", "eval_n", "n_boot", "dtype", "gate",
              "binding_z"):
        assert got[k] == want[k], k
    assert got["checkpoint"] == want["checkpoint"]
    assert set(got["per_z"]) == set(want["per_z"])
    for z in want["per_z"]:
        assert set(got["per_z"][z]) == set(want["per_z"][z])


def _same_boots(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _ratios(spectra, sel):
    """The per-bin auto and cross ratios of the tiles ``sel`` (JAX's
    recorded spectra of one redshift: truth, truth x DM, painted, painted
    x DM)."""
    (t, nm), (ct, _), (p, _), (cp, _) = spectra
    occ = nm > 0
    t, ct, p, cp = t[:, occ], ct[:, occ], p[:, occ], cp[:, occ]
    return np.concatenate([p[sel].mean(0) / t[sel].mean(0),
                           cp[sel].mean(0) / ct[sel].mean(0)])


@pytest.fixture(scope="module")
def cgan_lines(jax_script, twin, tmp_path_factory):
    """Both scripts on the CGAN in f32 and bf16, with the bootstrap's
    subsets and the JAX package's spectra."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for leg in ("f32", "model"):
            workdir = str(tmp_path_factory.mktemp(f"cgan_{leg}"))
            argv = ["--checkpoint", CGAN, "--workdir", workdir,
                    "--dtype", leg] + SMALL
            spectra, tspectra = [], []
            out["jax", leg] = _jax_line(jax_script, mp, argv,
                                        spectra) + (spectra,)
            out["twin", leg] = _twin_line(twin, mp, argv,
                                          tspectra) + (tspectra,)
    return out


def test_cgan_f32_line_matches_jax(cgan_lines):
    want, jboots, _ = cgan_lines["jax", "f32"]
    got, tboots, _ = cgan_lines["twin", "f32"]
    _same_keys(got, want)
    _same_boots(tboots, jboots)
    g, w = _numbers(got), _numbers(want)
    for k in w:
        assert abs(g[k] - w[k]) <= F32_TOL, (k, g[k], w[k])


def test_cgan_bf16_line_within_jax_own_distance(cgan_lines):
    want, jboots, jspec = cgan_lines["jax", "model"]
    w32, _, jspec32 = cgan_lines["jax", "f32"]
    got, tboots, tspec = cgan_lines["twin", "model"]
    _same_keys(got, want)
    _same_boots(tboots, jboots)
    # the JAX package's own f32 -> bf16 distance of the per-bin ratios,
    # over the full sample and every bootstrap subset
    subsets = [slice(None)] + list(jboots)
    delta = max(np.abs(_ratios(jspec, s) - _ratios(jspec32, s)).max()
                for s in subsets)
    # the port's bf16 ratios no further from JAX's bf16 than that
    for s in subsets:
        assert np.abs(_ratios(tspec, s) - _ratios(jspec, s)).max() <= delta
    g, w, w32n = _numbers(got), _numbers(want), _numbers(w32)
    for k in w:
        name = k.split("/")[1] if "/" in k else k
        if name == "p_worst_gt_gate":
            continue
        if name in LIPSCHITZ_KEYS + ("auto_boot_p5_p95",) or k in (
                "binding_full", "binding_sigma_at_eval_n"):
            limit = max(F32_TOL, abs(w[k] - w32n[k]), delta) + ROUND
            assert abs(g[k] - w[k]) <= limit, (k, g[k], w[k], limit)
        else:
            assert g[k] == w[k], k
    # p: only the subsets whose worst value lies within delta of the gate
    # can cross it
    z = next(iter(want["per_z"]))
    full = _ratios(jspec, slice(None))
    assert full.shape[0] % 2 == 0
    worst = []
    for s in jboots:
        r = np.abs(_ratios(jspec, s) - 1).reshape(2, -1)
        worst.append(np.median(r, axis=1).max())
    near = float(np.mean(np.abs(np.asarray(worst) - want["gate"]) <= delta))
    p_limit = max(abs(want["per_z"][z]["p_worst_gt_gate"]
                      - w32["per_z"][z]["p_worst_gt_gate"]), near)
    assert abs(got["per_z"][z]["p_worst_gt_gate"]
               - want["per_z"][z]["p_worst_gt_gate"]) <= p_limit


def _jax_prior_noise(base, n, dtype=None):
    """The noise the JAX painter draws under PRNGKey(0) for ``n`` tiles of
    the checkpoint's tile, (n, h, w)."""
    import jax

    from baryon_painter_tpu.painter import CVAEPainter
    p = CVAEPainter(base, dtype=dtype)
    cz, h, w = p.meta["model_architecture"]["dim_z"]
    key = p.model.apply(p.variables, method=lambda m: m.make_rng("sample"),
                        rngs={"sample": jax.random.PRNGKey(0)})
    eps = jax.random.normal(key, (1, n, h, w, cz), dtype or np.float32)
    return np.array(eps[0, ..., 0], np.float32)


def test_cvae_f32_at_jax_noise_matches_jax(jax_script, twin, tmp_path,
                                           monkeypatch):
    workdir = str(tmp_path)
    argv = ["--checkpoint", CVAE, "--workdir", workdir, "--dtype",
            "f32"] + SMALL
    want, jboots = _jax_line(jax_script, monkeypatch, argv)
    args = twin.parse_args(argv + ["--device", "cpu"])
    meta, geom = twin.read_meta(CVAE)
    with monkeypatch.context() as mp:
        with _recorded(mp) as tboots:
            ds = twin.validation_set(workdir, meta, geom)
            painter = twin.make_painter(CVAE, meta, "f32", "cpu")
            out_z = twin.gate_variance(
                painter, ds, (0.0,), n_tiles=8, n_boot=20,
                eps=_jax_prior_noise(CVAE, 8))
    got = twin.record(args, out_z)
    _same_keys(got, want)
    _same_boots(tboots, jboots)
    g, w = _numbers(got), _numbers(want)
    for k in w:
        assert abs(g[k] - w[k]) <= F32_TOL, (k, g[k], w[k])


def test_meta_without_geometry_is_refused(twin):
    with pytest.raises(SystemExit, match="fidelity_dataset"):
        twin.main(["--checkpoint", os.path.join(
            REPO, "trained_models/CVAE/fiducial-512/model"), "--device",
            "cpu"])


_BLOCKED = """
import importlib.abc, runpy, sys
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "optax", "baryon_painter_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["gate_variance_torch.py"] + sys.argv[1:]
runpy.run_path("scripts/gate_variance_torch.py", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
"""


def test_cli_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--checkpoint", CGAN, "--workdir",
         str(tmp_path), "--n-tiles", "2", "--redshifts", "0", "--n-boot",
         "5", "--dtype", "f32", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "gate_eval_variance"
    assert rec["n_tiles_full"] == 2 and rec["n_boot"] == 5
    assert "peak device memory" in out.stderr
