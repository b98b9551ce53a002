"""SLICS plane painting: batched tiles, blending on the device.

Port of ``baryon_painter_tpu/lightcone/pipeline.py`` (the reference's
process_SLICS, process_SLICS.py:128-226). All tiles of a shell are
extracted, resampled, painted and blended as device batches:

  extract (periodic gather) -> B-spline zoom -> CVAE decode (batched)
  -> Gaussian-weight blend (in-order slice adds)

on the painter's device (``painter.device``). File I/O stays in
``lightcone/io.py``. ``seamless=True`` paints each delta shell as one
whole plane instead (``paint_plane_seamless``, ``parallel/spatial.py``).

With a ``DeviceMesh`` (``parallel/mesh.py``) each tile batch is split over
the mesh's devices (the batch size rounded up to a multiple of the mesh's
size), each shard painted by the painter's copy on its device, and the
results gathered onto the painter's device in tile order for the blend;
the CVAE's prior noise is drawn for the whole batch with the painter's
generator and sliced, so the sharded paint is the unsharded one. The
seamless path passes the mesh on to ``spatial.paint_plane``; the massplane
shell's single tile is painted unsharded, as in the JAX package.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from baryon_painter_tpu_torch.lightcone import io as slics_io
from baryon_painter_tpu_torch.lightcone.tiling import (generate_tiling,
                                                       get_tile,
                                                       make_weight_map,
                                                       tile_origin_pixels)
from baryon_painter_tpu_torch.ops.resample import resize_spline
from baryon_painter_tpu_torch.parallel.mesh import DeviceMesh, replicate
from baryon_painter_tpu_torch.utils.platform import to_device

__all__ = ["paint_plane", "paint_plane_seamless",
           "paint_plane_from_massplane", "process_slics", "blend_tiles",
           "paint_batch_sharded", "StageTimes"]


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"painting takes a DeviceMesh (one process, several "
                        f"devices), got {type(mesh).__name__}")


def paint_batch_sharded(painter, tiles, zs, mesh: DeviceMesh, eps=None):
    """``painter.paint_batch(tiles, zs)`` split over ``mesh``'s devices:
    rows ``mesh.split(N)`` painted by the painter's copy on each device
    (``parallel.mesh.replicate``), every shard launched before any result
    is gathered, then the shards gathered onto the painter's device in
    order. A CVAE's prior noise is ``eps`` (N, Cz, h, w), else drawn for
    all N tiles with the painter's generator (``CVAEPainter.latent_noise``),
    and sliced."""
    from baryon_painter_tpu_torch.painter import CVAEPainter
    _check_mesh(mesh)
    copies = replicate(painter, mesh)
    if isinstance(painter, CVAEPainter) and eps is None:
        eps = painter.latent_noise(tiles.shape[0], tuple(tiles.shape[1:]))
    elif not isinstance(painter, CVAEPainter):
        eps = None
    shards = []
    for dev, (lo, hi) in zip(mesh.devices, mesh.split(tiles.shape[0])):
        if hi == lo:
            continue
        kw = {} if eps is None else {
            "eps": torch.as_tensor(eps)[lo:hi].to(dev)}
        shards.append(copies[dev].paint_batch(tiles[lo:hi].to(dev),
                                              zs[lo:hi].to(dev), **kw))
    return torch.cat([t.to(painter.device) for t in shards])


class StageTimes:
    """Stage boundaries of a lightcone run, for the record.

    ``mark(stage)`` records a CUDA event on the current stream (the host
    clock on the CPU). ``process_slics`` marks ``setup`` at its start and,
    per shell, ``upload`` (the wait for the shell's file, its copy to the
    card and its normalisation), ``zoom`` (extraction and zoom), ``paint``
    and ``blend`` (weights, blend and normalisation; the massplane shell's
    centre crop). ``intervals()`` waits for the device and returns each
    mark with the ms since the previous one: on the card the stream's time,
    idle gaps included.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._marks = []
        self.mark("start")

    def mark(self, stage: str):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        else:
            event = time.perf_counter()
        self._marks.append((stage, event))

    def intervals(self) -> list:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            ms = lambda a, b: a.elapsed_time(b)
        else:
            ms = lambda a, b: (b - a) * 1e3
        return [(stage, ms(prev, event)) for (_, prev), (stage, event)
                in zip(self._marks, self._marks[1:])]


def _mark(stage_times: Optional[StageTimes], stage: str):
    if stage_times is not None:
        stage_times.mark(stage)


def blend_tiles(tiles, weights, origins, plane_size: int):
    """Accumulate sum(w*tile) and sum(w) onto a plane canvas.

    tiles: (N, T, T); weights: (N, T, T); origins: (N, 2) integer pixel
    origins (tiles never cross the canvas edge by construction of
    generate_tiling). Returns (painted_plane, weight_plane).

    The tiles are added one at a time, in order, as the JAX package's scan
    adds them: a scatter-add (``index_add_``) would sum overlaps in another
    order on each run (atomics on CUDA).
    """
    plane = torch.zeros((plane_size, plane_size), dtype=tiles.dtype,
                        device=tiles.device)
    wplane = torch.zeros_like(plane)
    origins = (origins.tolist() if isinstance(origins, torch.Tensor)
               else np.asarray(origins).tolist())
    h, w_ = tiles.shape[-2:]
    for tile, w, (o0, o1) in zip(tiles, weights, origins):
        plane[o0:o0 + h, o1:o1 + w_] += w * tile
        wplane[o0:o0 + h, o1:o1 + w_] += w
    return plane, wplane


def _extract_tiles_device(plane, origin_pairs_frac, tile_relative_size):
    """Gather (periodic) tiles at native resolution, on the plane's device.

    plane: (n, n) tensor; origin_pairs_frac: sequence of (ox, oy) relative
    origins; returns (len(pairs), n_nat, n_nat). Origins round (matching
    tiling._origin_px): truncation would misalign extraction against blend
    placement by one pixel on some plane sizes."""
    n = plane.shape[0]
    n_nat = int(n * tile_relative_size)
    o = np.rint(np.asarray(origin_pairs_frac) * n).astype(np.int64)  # (k, 2)
    rows = (o[:, 0:1] + np.arange(n_nat)[None, :]) % n  # (k, n_nat)
    cols = (o[:, 1:2] + np.arange(n_nat)[None, :]) % n
    rows, cols = to_device(rows, plane.device), to_device(cols, plane.device)
    return plane[rows[:, :, None], cols[:, None, :]]


def _output(x, device_output: bool):
    return x if device_output else x.cpu().numpy()


def paint_plane(painter, delta, z_slice: float,
                tile_size: float, delta_size: float, n_pixel_tile: int,
                min_tile_overlap: float = 0.5,
                falloff: float = 0.05, sigma: float = 0.5,
                paint_batch_size: int = 16,
                zoom_order: int = 3,
                regularise: bool = False,
                regularise_std: Optional[float] = None,
                collect_problematic: bool = False,
                mesh=None,
                device_output: bool = False,
                stage_times: Optional[StageTimes] = None):
    """Paint one high-z shell: overlap-tile the plane, batch-paint, blend.

    Mirrors the reference's high-z branch (process_SLICS.py:177-220) on the
    painter's device. The last paint chunk is painted as it is (fewer than
    ``paint_batch_size`` tiles), not padded. Returns the painted plane
    (numpy, or a tensor with ``device_output``), and with
    ``collect_problematic`` also the list of (z, zoomed tile, painted tile)
    whose painted pixels lie more than ``regularise_std`` standard
    deviations (ddof 0) from the tile's mean; ``regularise`` gives those
    pixels zero weight. With a ``DeviceMesh`` each paint chunk is split over
    its devices (``paint_batch_sharded``; ``paint_batch_size`` rounded up
    to a multiple of the mesh's size).
    """
    _check_mesh(mesh)
    device = painter.device
    paint = painter.paint_batch
    if mesh is not None:
        paint_batch_size = -(-paint_batch_size // mesh.size) * mesh.size
        paint = lambda t, z: paint_batch_sharded(painter, t, z, mesh)
    n_pixel_plane = int(delta_size / tile_size * n_pixel_tile)
    origins, _ = generate_tiling(n_pixel_plane, n_pixel_tile,
                                 min_tile_overlap)
    origin_px = tile_origin_pixels(origins, n_pixel_plane, n_pixel_tile)

    # Everything below stays on the device until the final blended plane:
    # gather -> B-spline zoom -> batched paint -> weight/regularise -> blend.
    delta_dev = to_device(delta, device, torch.float32)
    frac = tile_size / delta_size
    n_nat = int(delta_dev.shape[0] * frac)
    pairs = [(ox, oy) for ox in origins for oy in origins]
    n_tiles = len(pairs)

    # batched resample native -> model resolution (the reference zooms per
    # tile with scipy order 3 'reflect': process_SLICS.py:205), in chunks:
    # the prefilter's intermediates are ~6x the f32 tile, so a chunk holds
    # about 1 GiB of them whatever the tile size
    k_zoom = max(1, min(n_tiles, (1 << 30) // max(1, n_nat * n_nat * 4 * 6)))
    tiles = torch.cat([
        resize_spline(_extract_tiles_device(delta_dev, pairs[lo:lo + k_zoom],
                                            frac),
                      (n_pixel_tile, n_pixel_tile), order=zoom_order,
                      mode="reflect")
        for lo in range(0, n_tiles, k_zoom)])
    _mark(stage_times, "zoom")

    painted = torch.cat([
        paint(tiles[lo:lo + paint_batch_size], torch.full(
            (min(paint_batch_size, n_tiles - lo),), float(z_slice),
            dtype=torch.float32, device=device))
        for lo in range(0, n_tiles, paint_batch_size)])
    _mark(stage_times, "paint")

    w = to_device(make_weight_map((n_pixel_tile, n_pixel_tile),
                                  falloff=falloff, sigma=sigma),
                  device, torch.float32)
    weights = w.expand_as(painted)

    problematic = []
    if regularise_std is not None:
        mean = painted.mean(dim=(1, 2), keepdim=True)
        std = painted.std(dim=(1, 2), keepdim=True, correction=0)
        outlier = (painted - mean).abs() > std * regularise_std
        if collect_problematic:
            bad = outlier.flatten(1).any(dim=1).cpu().numpy()
            for i in np.nonzero(bad)[0]:
                problematic.append((z_slice, tiles[i].cpu().numpy(),
                                    painted[i].cpu().numpy()))
        if regularise:
            weights = torch.where(outlier, 0.0, weights)

    grid = np.array([(x, y) for x in origin_px for y in origin_px],
                    dtype=np.int64)
    plane, wplane = blend_tiles(painted, weights, grid, n_pixel_plane)
    result = plane / wplane
    _mark(stage_times, "blend")
    result = _output(result, device_output)
    if collect_problematic:
        return result, problematic
    return result


def paint_plane_seamless(painter, delta, z_slice: float, tile_size: float,
                         delta_size: float, n_pixel_tile: int,
                         zoom_order: int = 3, mesh=None,
                         generator: Optional[torch.Generator] = None,
                         z_mode: str = "sample", device_output: bool = False,
                         stage_times: Optional[StageTimes] = None):
    """Paint one high-z shell seam-free: zoom the whole plane to the model's
    resolution once (periodic, ``mode="wrap"``: the plane is a slice of a
    periodic box, and the paint wraps at the same edges) and paint it in
    one fully convolutional pass (``parallel/spatial.paint_plane``; the
    CVAE's noise from ``generator``). No tiles, no weight maps, every pixel
    painted once plus the halo; with a ``DeviceMesh`` row-sharded over its
    devices. Stages marked: ``zoom``, ``paint``."""
    from baryon_painter_tpu_torch.parallel import spatial
    _check_mesh(mesh)
    n_pixel_plane = int(delta_size / tile_size * n_pixel_tile)
    plane = to_device(delta, painter.device, torch.float32)
    if tuple(plane.shape) != (n_pixel_plane, n_pixel_plane):
        plane = resize_spline(plane[None], (n_pixel_plane, n_pixel_plane),
                              order=zoom_order, mode="wrap")[0]
    _mark(stage_times, "zoom")
    out = spatial.paint_plane(painter, plane, z_slice, mesh=mesh,
                              generator=generator, z_mode=z_mode)
    _mark(stage_times, "paint")
    return _output(out, device_output)


def paint_plane_from_massplane(painter, massplane, shift, z_slice: float,
                               tile_size: float, delta_size: float,
                               n_pixel_tile: int,
                               massplane_size: float = slics_io.MASSPLANE_SIZE,
                               subtract_minimum: bool = False,
                               zoom_order: int = 3,
                               pre_extracted: bool = False,
                               device_output: bool = False,
                               stage_times: Optional[StageTimes] = None):
    """Low-z branch: the tile is bigger than the delta plane
    (process_SLICS.py:150-176). Extract an expanded tile from the mass
    plane, paint it, crop back to the delta footprint.

    ``pre_extracted=True``: ``massplane`` already IS the expanded tile
    (process_slics crops the ``tile_size/massplane_size`` window from the
    raw 12288^2 plane on the host, so only that window crosses to the
    card; the same wrap arithmetic, bit-identical values)."""
    if pre_extracted:
        tile = massplane
    else:
        tile = get_tile(massplane, shift,
                        tile_relative_size=delta_size / massplane_size,
                        expansion_factor=tile_size / delta_size)
    device = painter.device
    tile = to_device(tile, device, torch.float32)
    if subtract_minimum:
        tile = tile - tile.min()
    tile = resize_spline(tile[None], (n_pixel_tile, n_pixel_tile),
                         order=zoom_order, mode="mirror")
    _mark(stage_times, "zoom")
    painted = painter.paint_batch(tile, torch.full(
        (1,), float(z_slice), dtype=torch.float32, device=device))[0]
    _mark(stage_times, "paint")
    frac = delta_size / tile_size
    out = get_tile(painted, ((1 - frac) / 2, (1 - frac) / 2),
                   tile_relative_size=frac)
    _mark(stage_times, "blend")
    return _output(out, device_output)


def process_slics(painter, tile_size: float, n_pixel_tile: int,
                  LOS: int, z_SLICS: Sequence[float],
                  delta_size: Sequence[float],
                  delta_path: str, massplane_path: str, shifts_path: str,
                  z_slice: Sequence[float],
                  min_tiling_overlap: float = 0.5,
                  verbose: bool = True,
                  SLICS_density: bool = False,
                  regularise: bool = False,
                  regularise_std: Optional[float] = None,
                  return_problematic_tiles: bool = False,
                  paint_batch_size: int = 16,
                  n_pixel_delta: int = slics_io.N_PIXEL_DELTA,
                  n_pixel_massplane: int = slics_io.N_PIXEL_MASSPLANE,
                  massplane_size: float = slics_io.MASSPLANE_SIZE,
                  mesh=None,
                  transfer_dtype=None,
                  seamless: bool = False,
                  device_output: bool = False,
                  stage_times: Optional[StageTimes] = None,
                  ) -> List:
    """Full multi-shell pipeline; the reference's call contract
    (process_SLICS.py:128-226), on the painter's device.

    * ``transfer_dtype``: e.g. ``torch.bfloat16`` halves the host-to-device
      bytes of the 240 MB delta planes; the plane is rounded on the host
      and promoted to f32 on the card, before the +96 of its normalisation.
    * ``device_output``: return the painted planes as tensors on the device
      (``create_y_map`` takes them as they are) instead of numpy.
    * ``stage_times``: a ``StageTimes`` to mark each shell's stages in.

    While shell i paints, one worker thread reads shell i+1's file into
    host memory (pinned, on the card); the copy to the device is issued
    from this thread, on its stream. ``seamless=True`` paints each delta
    shell as one whole plane (``paint_plane_seamless``), its CVAE noise
    from a ``torch.Generator`` seeded with 1000 * LOS + the shell's index
    (JAX keys the shell with ``PRNGKey(1000 * LOS + i)``): a line of sight
    is reproducible, though not JAX's draw. It paints without the fused
    residual blocks, as in JAX. ``mesh``: a ``DeviceMesh`` over which every
    delta shell's tile batches (or seamless plane) are sharded; the
    painter is copied to each of its devices once.
    """
    if seamless and (regularise or return_problematic_tiles):
        raise ValueError("seamless painting has no tiles to regularise; "
                         "use the tiled path for regularise/"
                         "return_problematic_tiles")
    if seamless and getattr(painter, "_fused_inference", False):
        raise ValueError("seamless painting with fused_inference is not "
                         "supported; use fused for the tiled path only")
    if len(z_SLICS) != len(z_slice):
        raise ValueError("Shapes of z_SLICS and z_slice need to match!")
    _check_mesh(mesh)
    if mesh is not None:
        replicate(painter, mesh)
    _mark(stage_times, "setup")
    device = painter.device
    pin = device.type == "cuda"

    def host(a, cast: bool = True):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if cast and transfer_dtype is not None:
            t = t.to(transfer_dtype)  # rounded on the host: fewer bytes
        return t.pin_memory() if pin else t

    shifts_box = [None]  # parsed once, by the (single) I/O worker

    def load_shell(i):
        """Read shell i into host memory (the worker thread: no device
        work)."""
        z_shell = z_SLICS[i]
        if delta_size[i] < tile_size:
            mp_file = slics_io.massplane_filename(massplane_path, z_shell,
                                                  LOS, i)
            raw = slics_io.load_massplane_raw(mp_file, n_pixel_massplane)
            if shifts_box[0] is None:
                shifts_box[0] = slics_io.load_random_shifts(shifts_path, LOS)
            # Host-side crop before upload: only the expanded paint tile
            # crosses to the card (the same get_tile wrap arithmetic).
            tile = get_tile(raw.T, shifts_box[0][i],
                            tile_relative_size=delta_size[i] / massplane_size,
                            expansion_factor=tile_size / delta_size[i])
            return "massplane", host(tile)
        if SLICS_density:
            plane = slics_io.load_density_fits(
                slics_io.density_filename(delta_path, z_shell, LOS))
            return "density", host(plane, cast=False)
        raw = slics_io.load_delta_plane_raw(
            slics_io.delta_filename(delta_path, z_shell, LOS), n_pixel_delta)
        return "delta", host(raw)

    def upload(kind, raw):
        """The raw file bytes to the device, then transpose and normalise
        there."""
        x = raw.to(device, non_blocking=True).float()
        if kind == "delta":
            return ((x + 96.0) * slics_io.SLICS_NORM).t().contiguous()
        if kind == "massplane":
            return x * slics_io.SLICS_NORM
        return x

    painted_planes = []
    problematic = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(load_shell, 0)
        for i, z_shell in enumerate(z_SLICS):
            if verbose:
                print(f"Processing z={z_shell:.3f}")
            kind, raw = future.result()
            if i + 1 < len(z_SLICS):
                future = pool.submit(load_shell, i + 1)
            plane = upload(kind, raw)
            del raw
            _mark(stage_times, "upload")
            if kind == "massplane":
                painted_planes.append(paint_plane_from_massplane(
                    painter, plane, None, z_slice[i],
                    tile_size, delta_size[i], n_pixel_tile,
                    massplane_size=massplane_size,
                    subtract_minimum=SLICS_density,
                    pre_extracted=True, device_output=device_output,
                    stage_times=stage_times))
                continue
            if seamless:
                gen = torch.Generator(device=device)
                gen.manual_seed(1000 * LOS + i)
                painted_planes.append(paint_plane_seamless(
                    painter, plane, z_slice[i], tile_size, delta_size[i],
                    n_pixel_tile, mesh=mesh, generator=gen,
                    device_output=device_output, stage_times=stage_times))
                continue
            out = paint_plane(painter, plane, z_slice[i], tile_size,
                              delta_size[i], n_pixel_tile,
                              min_tile_overlap=min_tiling_overlap,
                              paint_batch_size=paint_batch_size,
                              mesh=mesh, regularise=regularise,
                              regularise_std=regularise_std,
                              collect_problematic=return_problematic_tiles,
                              device_output=device_output,
                              stage_times=stage_times)
            if return_problematic_tiles:
                out, probs = out
                problematic.extend(probs)
            painted_planes.append(out)

    if return_problematic_tiles:
        return painted_planes, problematic
    return painted_planes
