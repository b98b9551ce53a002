"""B-spline resampling (``scipy.ndimage.zoom``'s semantics) in PyTorch.

Port of ``baryon_painter_tpu/ops/resample.py``. The lightcone zooms every
native-resolution tile to the model's 512^2 with cubic B-splines (reflect),
the massplane tile with mirror, and the Compton-y map resamples each painted
plane with quintic ones (mirror): inverse-B-spline prefiltering with the
exact infinite-extension boundary (a truncated FIR by default, the exact FFT
deconvolution as its reference), then separable B-spline evaluation with
scipy's ``grid_mode=False`` coordinate map (``mode="wrap"``: scipy's
``grid-wrap``, ``grid_mode=True``).

Everything runs on the input tensor's device, in f32, with cuDNN's and
matmul's TF32 off (``utils/platform.f32_convolutions``): in TF32 the FIR
prefilter and the spline ``einsum`` would be about 1e-3 off.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from baryon_painter_tpu_torch.utils.platform import (device_of,
                                                     f32_convolutions,
                                                     to_device)

__all__ = ["zoom", "resize_spline", "spline_filter_1d"]

_MODES = ("mirror", "reflect", "wrap")

# Discrete B-spline kernels b[k] = B_order(k) (the values the prefilter must
# deconvolve; e.g. cubic: B3(-1,0,1) = 1/6, 4/6, 1/6).
_BSPLINE_TAPS = {
    2: np.array([1.0, 6.0, 1.0]) / 8.0,
    3: np.array([1.0, 4.0, 1.0]) / 6.0,
    4: np.array([1.0, 76.0, 230.0, 76.0, 1.0]) / 384.0,
    5: np.array([1.0, 26.0, 66.0, 26.0, 1.0]) / 120.0,
}

# Half-width of the truncated inverse-B-spline FIR (per order). The inverse
# filter 1/B(z) has impulse response sums of |pole|^|k| terms; the slowest
# pole sets the decay. K is chosen so |pole_max|^(K+1) < 1e-9 — truncation
# error below f32 roundoff of the exact (FFT) deconvolution.
_FIR_HALF_WIDTH = {2: 12, 3: 16, 4: 22, 5: 26}


def _check_mode(mode: str):
    if mode not in _MODES:
        raise ValueError(f"mode '{mode}' not supported "
                         "(use 'mirror', 'reflect' or 'wrap').")


def _extend(x, mode: str):
    """Extend the last axis into one full period of the boundary mode."""
    _check_mode(mode)
    if mode == "mirror":  # period 2N-2: [x0..xN-1, xN-2..x1]
        return torch.cat([x, x[..., 1:-1].flip(-1)], dim=-1)
    if mode == "reflect":  # period 2N: [x0..xN-1, xN-1..x0]
        return torch.cat([x, x.flip(-1)], dim=-1)
    return x  # wrap: genuinely periodic, period N is the signal itself


@functools.lru_cache(maxsize=None)
def _fir_inverse_taps(order: int) -> np.ndarray:
    """Truncated impulse response of the inverse B-spline filter 1/B(z).

    Computed numerically as the circular deconvolution kernel on a period
    far longer than the decay length (the poles decay geometrically, so
    h[|k|>K] is below 1e-9 of h[0] for the K table above).
    """
    P = 1 << 13
    taps = _BSPLINE_TAPS[order]
    r = len(taps) // 2
    kernel = np.zeros(P)
    for k in range(-r, r + 1):
        kernel[k % P] += taps[k + r]
    h = np.fft.irfft(1.0 / np.fft.rfft(kernel))
    K = _FIR_HALF_WIDTH[order]
    out = h[np.arange(-K, K + 1) % P]
    if not abs(h[K + 1]) < 1e-8 * abs(out[K]):
        raise AssertionError("FIR half-width too small")
    return out


def _extension_index(n: int, pad: int, mode: str) -> np.ndarray:
    """Host-side index map of samples -pad .. n+pad-1 of the boundary
    mode's periodic extension into the signal's n samples."""
    raw = np.arange(-pad, n + pad)
    if mode == "mirror":
        p = 2 * n - 2
        m = np.abs(raw) % p
        return np.minimum(m, p - m)
    if mode == "reflect":
        p = 2 * n
        m = raw % p
        return np.where(m < n, m, p - 1 - m)
    _check_mode(mode)
    return raw % n


def _spline_filter_fir(x, order: int, mode: str):
    """Truncated-FIR inverse-spline filtering along the LAST axis.

    Pads the signal by K samples of its mirror/reflect/wrap periodic
    extension (a static gather), then runs one valid 1-D convolution with
    the symmetric truncated inverse kernel — identical to the circular
    deconvolution up to |pole|^(K+1) ~ 1e-9, with no complex intermediates
    and no FFT of an awkward length (a 7050-pixel tile row).
    """
    n = x.shape[-1]
    if n == 1:
        return x  # the periodic extension is constant; B(z) sums to 1
    K = _FIR_HALF_WIDTH[order]
    idx = to_device(_extension_index(n, K, mode), x.device)
    h = to_device(_fir_inverse_taps(order), x.device, torch.float32)
    xp = x.float()[..., idx]
    lead = xp.shape[:-1]
    with f32_convolutions():
        out = F.conv1d(xp.reshape(-1, 1, n + 2 * K), h.view(1, 1, -1))
    return out.reshape(lead + (n,)).to(x.dtype)


def spline_filter_1d(x, order: int, mode: str = "mirror", axis: int = -1,
                     impl: str = "auto"):
    """B-spline prefilter along one axis (``scipy.ndimage.spline_filter1d``).

    The mirror/reflect extension of the signal is periodic (period 2N-2 or
    2N), and the infinite-extension prefilter on a periodic signal is exactly
    a circular deconvolution by the sampled B-spline kernel — scipy's
    boundary initialisation is that extension's steady state.

    ``impl``: ``"fir"`` (and ``"auto"``), the truncated-FIR convolution of
    ``_spline_filter_fir``; ``"fft"``, the exact circular deconvolution
    ``irfft(rfft(extend(x)) / rfft(b, P))[:N]``, the FIR's reference.
    """
    if order < 2:
        return x
    x = x.movedim(axis, -1)
    if impl in ("auto", "fir"):
        return _spline_filter_fir(x, order, mode).movedim(-1, axis)
    if impl != "fft":
        raise ValueError(f"impl {impl!r} (use 'auto', 'fir' or 'fft')")
    n = x.shape[-1]
    xt = _extend(x, mode)
    p = xt.shape[-1]
    taps = _BSPLINE_TAPS[order]
    r = len(taps) // 2
    kernel = np.zeros(p)
    for k in range(-r, r + 1):
        kernel[k % p] += taps[k + r]
    denom = to_device(np.fft.rfft(kernel).real, x.device, torch.float32)
    ft = torch.fft.rfft(xt.float(), dim=-1)
    out = torch.fft.irfft(ft / denom, n=p, dim=-1)[..., :n]
    return out.to(x.dtype).movedim(-1, axis)


def _bspline_weights(t, order: int):
    """B-spline kernel values at offsets; t in [0,1) is the fractional part.

    Returns weights of shape t.shape + (order+1,) for taps
    floor(x) - (order-1)//2 + arange(order+1).
    """
    if order == 0:
        return torch.ones(t.shape + (1,), dtype=t.dtype, device=t.device)
    if order == 1:
        return torch.stack([1 - t, t], dim=-1)
    if order == 3:
        # taps at distances: t+1, t, 1-t, 2-t
        t2, t3 = t * t, t * t * t
        w0 = (1 - t) ** 3 / 6.0
        w1 = (3 * t3 - 6 * t2 + 4) / 6.0
        w2 = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
        w3 = t3 / 6.0
        return torch.stack([w0, w1, w2, w3], dim=-1)
    if order == 5:
        # quintic B-spline B5 at |x| in [0,3), piecewise (Unser)
        offs = torch.arange(-2, 4, dtype=t.dtype, device=t.device)
        au = (t[..., None] - offs).abs()
        au2, au3, au4, au5 = au ** 2, au ** 3, au ** 4, au ** 5
        f1 = 11.0 / 20.0 - au2 / 2.0 + au4 / 4.0 - au5 / 12.0
        f2 = (17.0 / 40.0 + 5.0 * au / 8.0 - 7.0 * au2 / 4.0
              + 5.0 * au3 / 4.0 - 3.0 * au4 / 8.0 + au5 / 24.0)
        f3 = (3.0 - au) ** 5 / 120.0
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
        return torch.where(au < 1, f1, torch.where(
            au < 2, f2, torch.where(au < 3, f3, zero)))
    raise NotImplementedError(f"order {order}")


def _map_indices(idx: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Host-side boundary map of integer sample positions into [0, n)."""
    if mode == "mirror":
        p = 2 * n - 2 if n > 1 else 1
        m = np.abs(idx) % p
        return np.minimum(m, p - m)
    if mode == "reflect":
        p = 2 * n
        m = idx % p
        return np.where(m < n, m, p - 1 - m)
    _check_mode(mode)
    return idx % n


def _resample_axis(c, out_n: int, order: int, mode: str, axis: int):
    """Evaluate the spline (coefficients c) at zoom coordinates along axis."""
    c = c.movedim(axis, -1)
    n = c.shape[-1]
    # Coordinates are static: computed host-side in float64 as scipy does.
    # f32 coordinate roundoff flips nearest-neighbour picks (an f32 product
    # can land exactly on .5 where the f64 value is just below) and skews
    # spline fractions near exact knots.
    if mode == "wrap":
        # periodic resampling: cell-centred map, scipy's grid_mode=True
        # ('grid-wrap'): in = (out + 0.5) * n/out_n - 0.5; indices wrap
        coords64 = ((np.arange(out_n, dtype=np.float64) + 0.5)
                    * (n / out_n) - 0.5)
        base64 = np.floor(coords64).astype(np.int64)
    else:
        scale = (n - 1) / (out_n - 1) if out_n > 1 and n > 1 else 0.0
        coords64 = np.arange(out_n, dtype=np.float64) * scale
        base64 = np.floor(coords64).astype(np.int64)
        # keep base such that frac in [0,1); at the exact right edge clamp
        if order >= 1:
            base64 = np.clip(base64, 0, max(n - 2, 0))
    t = to_device(coords64 - base64, c.device, torch.float32)
    w = _bspline_weights(t, order)  # (out_n, taps)
    if order == 0:
        # scipy's nearest is floor(x + 0.5) in double precision; rounding
        # half to even, or f32 coordinates, would diverge from it
        idx = np.floor(coords64 + 0.5).astype(np.int64)[:, None]
    else:
        first = -((order - 1) // 2)
        idx = base64[:, None] + (first + np.arange(order + 1))[None, :]
    idx = to_device(_map_indices(idx, n, mode), c.device)
    gathered = c[..., idx]  # (..., out_n, taps)
    with f32_convolutions():
        out = torch.einsum("...ot,ot->...o", gathered, w)
    return out.movedim(-1, axis)


def resize_spline(x, out_shape, order: int = 3, mode: str = "mirror",
                  prefilter: bool = True, prefilter_impl: str = "auto",
                  device=None):
    """Resample the last two axes of ``x`` to ``out_shape`` (H, W), in f32.

    Matches ``scipy.ndimage.zoom`` with ``grid_mode=False``: output
    coordinate o maps to input coordinate o*(in-1)/(out-1). ``x`` is a
    tensor (computed on its device) or an array (on ``device``, default
    the card).
    """
    if order not in (0, 1, 3, 5):
        raise NotImplementedError(f"order {order} (supported: 0, 1, 3, 5)")
    _check_mode(mode)
    c = to_device(x, device_of(x, device)).float()
    out_h, out_w = out_shape
    if prefilter and order >= 2:
        c = spline_filter_1d(c, order, mode, axis=-1, impl=prefilter_impl)
        c = spline_filter_1d(c, order, mode, axis=-2, impl=prefilter_impl)
    c = _resample_axis(c, out_w, order, mode, axis=-1)
    return _resample_axis(c, out_h, order, mode, axis=-2)


def zoom(x, zoom_factor, order: int = 3, mode: str = "mirror", device=None):
    """``scipy.ndimage.zoom`` over the last two axes."""
    h, w = x.shape[-2], x.shape[-1]
    if np.isscalar(zoom_factor):
        zf = (float(zoom_factor), float(zoom_factor))
    else:
        zf = tuple(float(z) for z in zoom_factor)
    out_shape = (int(round(h * zf[0])), int(round(w * zf[1])))
    return resize_spline(x, out_shape, order=order, mode=mode, device=device)
