"""Seam-free whole-plane painting, on one device or row-sharded over a
``DeviceMesh``.

Port of ``baryon_painter_tpu/parallel/spatial.py``. The
painters are fully convolutional, so a SLICS plane can be painted in one
pass instead of as overlapping tiles blended with weight maps: the plane is
extended periodically by the network's receptive-field margin (the halo),
painted, and cropped back. A halo that covers the receptive field of every
output pixel makes the crop equal to a periodic paint of the plane.

Both the halo and the plane are rounded up to the alignment granularity f
of the paint path (``latent_downsample``: the latent grid's factor for the
CVAE, 32 for the fiducial; 4 for the CGAN generator), so strided
convolutions see the same lattice whatever the halo. The CVAE's prior
noise is drawn once on the global (Q/f, Wq/f, c_z) latent grid and
extended periodically by halo/f, so painting at two halos draws the same
latent everywhere.

With a ``DeviceMesh`` (``parallel/mesh.py``) of n devices the plane's rows
are split into n slabs of a multiple of f rows, each painted by the
painter's copy on its device with its halo (the JAX package's
``shard_map`` paint). The one process holds the whole plane on the
painter's device, so each device gets its halo-extended slab of the
periodic plane by mod indexing from there (the JAX package's gather path;
its ``lax.ppermute`` ring serves devices that hold only their own slab,
which the port's do not). The noise is drawn once for the whole plane and
sliced per slab, so the sharded and unsharded paints see the same noise.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from baryon_painter_tpu_torch.models.cgan import cgan_generator_spec
from baryon_painter_tpu_torch.utils.platform import f32_convolutions, to_device

__all__ = ["spec_receptive_margin", "required_halo", "latent_downsample",
           "paint_plane", "calibrate_halo"]



# --------------------------------------------------------------------- #
# receptive-field accounting over the layer-spec DSL (models/dsl.py)

def spec_receptive_margin(spec, f: float = 1.0):
    """Upper bound of the one-sided receptive-field margin of a spec stack.

    Walks the layer spec tracking ``f``, the input-pixel footprint of one
    feature at the current layer's input, and adds each layer's one-sided
    reach in input pixels. A conv output at ``o`` reads inputs
    ``[o*s - p, o*s - p + k - 1]``, so its reach is ``max(p, k - 1 - p)``
    (the DSL's scale-4 convs are even-kernel asymmetric: k=8, p=2 reach 5):

      * conv k, s, p:        margin += max(p, k-1-p) * f;        f *= s
      * transp conv k, s, p: margin += ceil(max(p, k-1-p)/s) * f; f /= s
      * upsample nearest s:  f /= s
      * residual block:      margin += margin(inner)  (stride 1)
      * batch norm (eval), activations: pointwise

    Returns ``(margin in input pixels, f_out)``; a linear layer raises.
    """
    margin = 0.0
    if spec is None:
        return margin, f
    for layer in spec:
        name = layer[0]
        lname = name.lower() if isinstance(name, str) else name
        config = layer[1] if len(layer) > 1 else None
        if lname == "conv":
            k = config["kernel_size"]
            s = config.get("stride", 1)
            p = config.get("padding", (k - 1) // 2)
            margin += max(p, k - 1 - p) * f
            f *= s
        elif lname == "transp conv":
            k = config["kernel_size"]
            s = config.get("stride", 1)
            p = config.get("padding", (k - 1) // 2)
            margin += math.ceil(max(p, k - 1 - p) / s) * f
            f /= s
        elif lname == "upsample nearest":
            f /= config["scale"]
        elif lname == "residual block":
            inner, _act = config
            m_in, f_in = spec_receptive_margin(inner, f)
            if f_in != f:
                raise ValueError("residual block inner spec changes "
                                 "resolution; cannot bound its halo")
            margin += m_in
        elif lname in ("batchnorm", "relu", "leaky relu", "prelu", "tanh",
                       "sigmoid", "softplus", "flatten", "unflatten"):
            pass
        elif lname == "linear":
            raise ValueError("spatial painting requires a fully "
                             "convolutional network; found a linear layer")
        else:
            raise ValueError(f"Unknown spec layer {name!r} in receptive-"
                             "field walk")
    return margin, f


def latent_downsample(architecture: dict) -> int:
    """Alignment granularity of the paint path: the CVAE's latent-grid
    factor (dim_y / dim_z, 32 for the fiducial), 4 for the CGAN generator
    (two stride-2 downs)."""
    if "dim_z" in architecture:
        return int(architecture["dim_y"][1]) // int(architecture["dim_z"][1])
    return 4


def required_halo(architecture: dict, model_kind: str = "cvae") -> int:
    """One-sided input halo (pixels) for seam-free painting, rounded up to
    the alignment granularity (``latent_downsample``)."""
    if model_kind == "cvae":
        # two branches feed the decoder trunk p_y_z_in at full resolution:
        # z: y -> prior_z_y -> z -> p_z_in; y: y -> p_y_in (identity when
        # None); the reach is the larger branch + the trunk + the worst head
        m_z = 0.0
        f = 1.0
        for key in ("prior_z_y", "p_z_in"):
            dm, f = spec_receptive_margin(architecture.get(key), f)
            m_z += dm
        m_y, _ = spec_receptive_margin(architecture.get("p_y_in"), 1.0)
        m, f_t = spec_receptive_margin(architecture.get("p_y_z_in"), 1.0)
        m += max(m_z, m_y)
        m += max(spec_receptive_margin(h, f_t)[0]
                 for h in architecture["p_y_z_out"])
    elif model_kind == "cgan":
        body, head = cgan_generator_spec(
            architecture.get("in_channels", 2),
            architecture.get("n_res_blocks", 9),
            architecture.get("upsample", "transpose"))
        m, f = spec_receptive_margin(body, 1.0)
        m += spec_receptive_margin(head, f)[0]
    else:
        raise ValueError(f"Unknown model kind {model_kind!r}")
    f_align = latent_downsample(architecture)
    return int(math.ceil(m / f_align)) * f_align


# --------------------------------------------------------------------- #
# the painted slab

def _kind(painter) -> str:
    from baryon_painter_tpu_torch.painter import CGANPainter
    return "cgan" if isinstance(painter, CGANPainter) else "cvae"


def _architecture(painter) -> dict:
    return painter.meta["model_architecture"]


def _cvae_slab(painter, slab, zs, eps, z_mode, transform, inverse_transform):
    """The CVAE's paint of one extended slab (H, W); ``eps`` (1, c_z, h, w)
    on the slab's latent grid in 'sample' mode."""
    model = painter.model
    in_field, out_field = painter.input_field, painter.label_fields[0]
    y = slab[None]
    if transform:
        y = painter.transforms[in_field].forward(y, painter.stats[in_field],
                                                 zs)
    y = y[:, None] if y.ndim == 3 else y
    y = y.contiguous(memory_format=torch.channels_last)
    z_mu, z_log_var = model.prior(y, zs)
    if z_mode == "mean":
        z = z_mu
    elif z_mode == "zero":
        z = torch.zeros_like(z_mu)
    elif z_mode == "sample":
        z = model.sample_z(z_mu, z_log_var, eps.to(z_mu.dtype))
    else:
        raise ValueError(f"Unknown z_mode {z_mode!r}")
    pred = model.sample_P(y, zs, z=z)
    if pred.shape[1] != 1:
        raise ValueError("paint_plane supports single-channel output fields; "
                         f"the model emitted {pred.shape[1]}")
    pred = pred[:, 0]
    if inverse_transform:
        pred = painter.transforms[out_field].inverse(
            pred, painter.stats[out_field], zs)
    return pred[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _periodic_extend(x, pad_r: int, pad_c: int):
    """x's first two axes extended periodically by mod indexing (valid for
    pads beyond the array's own size)."""
    r = torch.arange(-pad_r, x.shape[0] + pad_r, device=x.device) % x.shape[0]
    c = torch.arange(-pad_c, x.shape[1] + pad_c, device=x.device) % x.shape[1]
    return x[r[:, None], c[None, :]]


def latent_noise_shape(painter, plane_shape) -> tuple:
    """The global latent grid (Q/f, Wq/f, c_z) of a CVAE paint of a plane
    of ``plane_shape``: where ``paint_plane`` draws its noise, in the JAX
    package's layout."""
    arch = _architecture(painter)
    f = latent_downsample(arch)
    return (_round_up(plane_shape[0], f) // f,
            _round_up(plane_shape[1], f) // f, int(arch["dim_z"][0]))


# --------------------------------------------------------------------- #
# the public entry point

def _paint_slab(painter, ext, zs, eps_ext, kind, z_mode, transform,
                inverse_transform):
    """One extended slab (rows, cols) painted on its painter's device;
    ``eps_ext`` its latent noise (rows/f, cols/f, c_z) in 'sample' mode."""
    if kind == "cgan":
        return painter._paint_batch(ext[None], zs, transform,
                                    inverse_transform)[0]
    if eps_ext is not None:
        eps_ext = eps_ext.permute(2, 0, 1)[None]
    return _cvae_slab(painter, ext, zs, eps_ext, z_mode, transform,
                      inverse_transform)


def _mesh_slabs(plane, eps, n: int, halo: int, f: int):
    """The n halo-extended slabs of the (Q, Wq)-periodic ``plane`` (and of
    its noise ``eps``, or None), gathered by mod indexing, each keeping
    ``Hl`` rows, ``ceil(Q / n)`` rounded up to f: (slabs, eps slabs, Hl).
    Where n f does not divide Q the last slab wraps; its repeated rows
    fall off the crop."""
    Q = plane.shape[0]
    hf = halo // f
    Hl = _round_up(-(-Q // n), f)
    dev = plane.device
    cols = torch.arange(-halo, plane.shape[1] + halo, device=dev
                        ) % plane.shape[1]
    slabs, eps_slabs = [], []
    for j in range(n):
        rows = torch.arange(j * Hl - halo, (j + 1) * Hl + halo,
                            device=dev) % Q
        slabs.append(plane[rows[:, None], cols[None, :]])
        if eps is None:
            eps_slabs.append(None)
            continue
        zr = torch.arange(j * (Hl // f) - hf, (j + 1) * (Hl // f) + hf,
                          device=dev) % eps.shape[0]
        zc = torch.arange(-hf, eps.shape[1] + hf, device=dev) % eps.shape[1]
        eps_slabs.append(eps[zr[:, None], zc[None, :]])
    return slabs, eps_slabs, Hl


@torch.inference_mode()
def paint_plane(painter, plane, z: float, mesh=None,
                halo: Optional[int] = None, z_mode: str = "sample",
                generator: Optional[torch.Generator] = None, eps=None,
                transform: bool = True, inverse_transform: bool = True):
    """Paint a whole (H, W) plane seam-free, on the painter's device or
    row-sharded over a ``DeviceMesh``.

    ``painter``: a ``CVAEPainter`` or ``CGANPainter``. ``plane``: (H, W) in
    the painter's input-field units at its training resolution (resample
    first). ``z``: the plane's redshift. ``halo``: the one-sided margin in
    pixels (default ``required_halo``), rounded up to the granularity f.
    The plane is treated as (Q, Wq)-periodic, Q and Wq rounded up to f.
    In 'sample' mode the CVAE's noise ``eps`` is (Q/f, Wq/f, c_z), as the
    JAX package draws it (``latent_noise_shape``); without it the noise is
    drawn on that grid from ``generator``, else the painter's own, on the
    painter's device. ``mesh``: a ``DeviceMesh`` whose devices each paint
    one slab of rows (module docstring; the painter is copied to each
    device once). Returns the painted (H, W) plane as a tensor on the
    painter's device.
    """
    from baryon_painter_tpu_torch.parallel.mesh import (DeviceMesh,
                                                        replicate)
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"paint_plane takes a DeviceMesh, got "
                        f"{type(mesh).__name__}")
    kind = _kind(painter)
    arch = _architecture(painter)
    f = latent_downsample(arch)
    if halo is None:
        halo = required_halo(arch, kind)
    halo = _round_up(max(int(halo), f), f)
    device = painter.device

    plane = to_device(plane, device, torch.float32)
    if plane.ndim != 2:
        raise ValueError(f"paint_plane expects a 2-D plane, got "
                         f"{tuple(plane.shape)}")
    H, W = plane.shape
    Q, Wq = _round_up(H, f), _round_up(W, f)
    if (Q, Wq) != (H, W):
        r = torch.arange(Q, device=device) % H
        c = torch.arange(Wq, device=device) % W
        plane = plane[r[:, None], c[None, :]]
    zs = torch.full((1,), float(z), dtype=torch.float32, device=device)

    if kind == "cvae" and z_mode == "sample":
        shape = latent_noise_shape(painter, (H, W))
        if eps is None:
            eps = torch.randn(shape, dtype=torch.float32, device=device,
                              generator=(generator if generator is not None
                                         else painter._generator))
        eps = to_device(eps, device, torch.float32)
        if tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, the latent "
                             f"grid {shape}")
    else:
        eps = None
    hf = halo // f
    paint = lambda p, ext, e, zz: _paint_slab(
        p, ext, zz, e, kind, z_mode, transform, inverse_transform)

    with f32_convolutions():
        if mesh is None:
            ext = _periodic_extend(plane, halo, halo)
            e = None if eps is None else _periodic_extend(eps, hf, hf)
            out = paint(painter, ext, e, zs)
            return out[halo:-halo, halo:-halo][:H, :W]
        copies = replicate(painter, mesh)
        slabs, eps_slabs, _ = _mesh_slabs(plane, eps, mesh.size, halo, f)
        outs = [paint(copies[d], ext.to(d), None if e is None else e.to(d),
                      zs.to(d))[halo:-halo, halo:-halo]
                for d, ext, e in zip(mesh.devices, slabs, eps_slabs)]
        out = torch.cat([t.to(device) for t in outs])
    return out[:H, :W]


def calibrate_halo(painter, z: float = 0.5, tol: float = 1e-4,
                   probe: Optional[np.ndarray] = None,
                   generator: Optional[torch.Generator] = None) -> int:
    """The smallest aligned halo whose paint of a probe plane matches the
    paint at ``required_halo`` within ``tol`` of its largest value.

    ``required_halo`` is an upper bound (a transposed conv's reach is
    rounded up per layer); the halo sets the extra rows a whole-plane
    paint pays. The probe (positive lognormal values at the field's mean
    amplitude, rows > 2 * the bound, from numpy's seed 0 as in the JAX
    package) is painted at the bound, then a binary search over multiples
    of f finds the smallest halo that agrees; the CVAE's noise is drawn
    once (from ``generator``, else the painter's) and shared by every
    paint. Returns a multiple of the alignment granularity.
    """
    kind = _kind(painter)
    arch = _architecture(painter)
    f = latent_downsample(arch)
    h_ref = required_halo(arch, kind)
    rows = _round_up(2 * h_ref + 4 * f, f)
    if probe is None:
        nprng = np.random.default_rng(0)
        mean0 = float(painter.stats[painter.input_field].at_z(z)[0])
        probe = np.abs(nprng.lognormal(0.0, 1.0, size=(rows, 2 * f))
                       * max(abs(mean0), 1e-3))
    eps = None
    if kind == "cvae":
        eps = torch.randn(latent_noise_shape(painter, np.shape(probe)),
                          dtype=torch.float32, device=painter.device,
                          generator=(generator if generator is not None
                                     else painter._generator))

    def paint(h):
        return paint_plane(painter, probe, z, halo=h, eps=eps).float().cpu(
            ).numpy()

    ref = paint(h_ref)
    scale = float(np.abs(ref).max()) or 1.0

    def ok(h):
        return float(np.abs(paint(h) - ref).max()) / scale <= tol

    lo, hi = 0, h_ref // f  # in units of f
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if ok(mid * f):
            hi = mid
        else:
            lo = mid
    return hi * f
