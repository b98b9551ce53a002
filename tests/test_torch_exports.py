"""The port's top-level names are the JAX package's: every name of the JAX
package's lazy exports, and the ``transforms`` module, resolves in the
port to the port's own object; a bare ``import baryon_painter_tpu_torch``
imports no torch."""
import subprocess
import sys

import pytest

import baryon_painter_tpu
import baryon_painter_tpu_torch

from golden_utils import REPO


@pytest.mark.parametrize("name", sorted(baryon_painter_tpu._LAZY)
                         + ["transforms"])
def test_jax_top_level_name_resolves_in_the_port(name):
    obj = getattr(baryon_painter_tpu_torch, name)
    module = getattr(obj, "__module__", None) or obj.__name__
    assert module.startswith("baryon_painter_tpu_torch."), (name, module)
    assert getattr(obj, "__name__", "").split(".")[-1] == name


def test_the_jax_packages_names_import_together():
    from baryon_painter_tpu_torch import (BahamasTileDataset, CVAE,  # noqa
                                          create_y_map, process_slics,
                                          pseudo_pofk_2d, transforms)
    assert transforms.RangeCompress.__module__ == \
        "baryon_painter_tpu_torch.transforms"


def test_unknown_name_raises():
    with pytest.raises(AttributeError, match="no attribute"):
        baryon_painter_tpu_torch.not_a_name


def test_bare_import_imports_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, baryon_painter_tpu_torch; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('torch', 'numpy', 'jax')))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
