"""The CVAE's parameter report and its other helpers in the port against the
JAX package's (JAX ``models/cvae.py:281-345``).

On the committed fiducial checkpoint, ``count_parameters`` gives the JAX
count exactly, of the port's model and of the checkpoint's JAX-layout
``params``, and ``print_model_statistics`` prints the JAX package's text
line for line, under flax's paths (``p_y_z_in/Conv2d_0/kernel``).
``sample_prior`` draws the latent ``sample_P`` paints with (noise ``eps``
or an explicit ``torch.Generator``), and ``stats_from_outputs`` flattens
``forward``'s output as the JAX package flattens its own.
"""
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.train import checkpoint as jckpt
from baryon_painter_tpu_torch.convert import from_jax_variables
from baryon_painter_tpu_torch.models import cvae as tcvae
from baryon_painter_tpu_torch.train import checkpoint as tckpt
from golden_utils import REPO

BASE = os.path.join(REPO, "trained_models", "CVAE", "fiducial-512", "model")


@pytest.fixture(scope="module")
def fiducial():
    state, meta = tckpt.load_checkpoint(BASE)
    model = from_jax_variables({"params": state["params"],
                                "batch_stats": state["batch_stats"]},
                               meta["model_architecture"])
    jstate, _ = jckpt.load_checkpoint(BASE)
    return model, state, jstate


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def test_count_parameters(fiducial):
    model, state, jstate = fiducial
    want = jcvae.count_parameters(jstate["params"])
    assert want == 1669444
    assert tcvae.count_parameters(model) == want
    assert tcvae.count_parameters(state["params"]) == want


@pytest.mark.parametrize("percentile", [0.9, 0.5, 1.0])
def test_print_model_statistics_line_for_line(fiducial, percentile):
    model, state, jstate = fiducial
    want_total, want = _printed(jcvae.print_model_statistics,
                                jstate["params"], percentile)
    for source in (model, state["params"]):
        total, got = _printed(tcvae.print_model_statistics, source,
                              percentile)
        assert total == want_total
        assert got.splitlines() == want.splitlines()
    assert "p_y_z_in/ResidualBlock_3/SpecSequential_0/Conv2d_1/kernel" in got


def test_sample_prior_is_sample_p_latent(fiducial):
    model, _, _ = fiducial
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.uniform(-1, 1, (2, 1, 64, 64)).astype(
        np.float32))
    z = torch.tensor([0.0, 1.0])
    with torch.no_grad():
        eps = torch.randn((2, 1, 2, 2), generator=torch.Generator()
                          .manual_seed(4))
        latent = model.sample_prior(y, z, eps=eps)
        mu, log_var = model.prior(y, z)
        torch.testing.assert_close(
            latent, mu + eps * (torch.exp(log_var / 2) + model.min_z_var),
            rtol=0, atol=0)
        drawn = model.sample_prior(y, z, generator=torch.Generator()
                                   .manual_seed(4))
        torch.testing.assert_close(drawn, latent, rtol=0, atol=0)
        torch.testing.assert_close(model.sample_P(y, z, eps=eps),
                                   model.sample_P(y, z, z=latent),
                                   rtol=0, atol=0)


def test_stats_from_outputs_matches_jax():
    out = {"elbo": np.float32(-12.5), "kl": np.float32(3.25),
           "log_likelihood": np.array([-9.0], np.float32),
           "log_likelihood_fixed_var": np.array([-8.5], np.float32),
           "log_likelihood_free_var": np.array([-9.25], np.float32)}
    want = jcvae.stats_from_outputs(jax.tree.map(jax.numpy.asarray, out))
    got = tcvae.stats_from_outputs({k: torch.as_tensor(v)
                                    for k, v in out.items()})
    assert got == want == (-12.5, -3.25, -9.0, -8.5, -9.25)
    short = {k: out[k] for k in ("elbo", "kl", "log_likelihood")}
    assert tcvae.stats_from_outputs(short) == jcvae.stats_from_outputs(short)
