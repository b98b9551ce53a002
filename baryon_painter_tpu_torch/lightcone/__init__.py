"""SLICS lightcone pipeline: tiling, batched painting, y-map assembly."""

from baryon_painter_tpu_torch.lightcone.tiling import (  # noqa: F401
    generate_tiling, get_tile, make_weight_map)
from baryon_painter_tpu_torch.lightcone.pipeline import (  # noqa: F401
    process_slics)
from baryon_painter_tpu_torch.lightcone.ymap import create_y_map  # noqa: F401
