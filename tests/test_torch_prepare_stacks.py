"""``scripts/prepare_stacks.py`` feeds the port: tiny make_sheets-format
binaries (n_grid 32, n_sheet 8, two volumes, two redshifts, a slicing
scheme through ``--scheme-json``) are turned into stacks, and the port's
``BahamasTileDataset.get_raw_batch`` reads them bit for bit as the JAX
package's does, at the same indices."""
import json
import os
import runpy
import sys

import numpy as np
import pytest

from golden_utils import REPO

N_GRID, N_SHEET = 32, 8
SCHEME = {"v1": {"x": [[0, 3], [3, 6], [6, 8]],
                 "y": [[0, 3], [3, 6], [6, 8]]},
          "v2": {"x": [[0, 2], [2, 4], [4, 6], [6, 8]]}}
# snapshots of the redshifts (prepare_stacks.Z_TO_SNAP)
SNAPS = {0.0: 32, 1.0: 26}


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = tmp_path_factory.mktemp("sheets")
    rng = np.random.default_rng(0)
    for volume in SCHEME:
        for snap in SNAPS.values():
            for field in ("dm", "pressure"):
                # Fortran layout (3, n_sheet, m, m): first index fastest
                sheets = rng.lognormal(0.0, 1.0, (3, N_SHEET, N_GRID,
                                                  N_GRID)).astype("<f4")
                sheets.T.tofile(root / f"{volume}_snap{snap}_{field}_sheets")
    with open(root / "scheme.json", "w") as f:
        json.dump(SCHEME, f)
    out = root / "stacks"
    argv = sys.argv
    sys.argv = ["prepare_stacks.py", "--sheets-path", str(root),
                "--output-path", str(out), "--fields", "dm", "pressure",
                "--redshifts", *map(str, SNAPS), "--n-sheet", str(N_SHEET),
                "--n-grid", str(N_GRID), "--scheme-json",
                str(root / "scheme.json")]
    try:
        runpy.run_path(os.path.join(REPO, "scripts", "prepare_stacks.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    return str(out)


@pytest.mark.parametrize("permutations", [False, True],
                         ids=["plain", "permuted"])
def test_port_reads_the_stacks_as_jax_does(stacks, permutations):
    from baryon_painter_tpu.data.dataset import \
        BahamasTileDataset as JaxDataset
    from baryon_painter_tpu.data.dataset import \
        load_file_info as jax_load_file_info
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    info = os.path.join(stacks, "train_files_info.pickle")
    kw = dict(root_path=stacks, n_tile=2, redshifts=list(SNAPS),
              tile_permutations=permutations)
    jd = JaxDataset(files=jax_load_file_info(info), **kw)
    td = BahamasTileDataset(files=load_file_info(info), **kw)
    assert len(td) == len(jd) > 0
    assert td.redshifts == jd.redshifts
    idx = np.random.default_rng(1).choice(len(jd), 24, replace=False)
    want, got = jd.get_raw_batch(idx), td.get_raw_batch(idx)
    for key in ("input", "labels", "z"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    assert np.asarray(got["input"]).shape == (24, N_GRID // 2, N_GRID // 2)
