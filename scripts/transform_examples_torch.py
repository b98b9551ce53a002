#!/usr/bin/env python
"""Demonstration of the field transforms, in the PyTorch port.

The twin of ``scripts/transform_examples.py``, with its flags (and
``--device``), its ``report.json`` and its stdout JSON line. For a
synthetic lognormal density field (numpy, ``--seed``) it applies each of
the six invertible range-compression modes of the port's
``transforms.py`` on the card, reports each mode's forward range and its
forward -> inverse round-trip error, and splits the field into
``SplitScale(n_scale=3)``'s scales and recomposes it. The figures (each
mode's raw and transformed histograms, the scales) need matplotlib:
without it (the H100 machine has none) none is drawn, ``figures`` is
empty and one line on stderr says so.

    python scripts/transform_examples_torch.py --out <dir> [--device cpu]

Imports only torch, numpy and the port (matplotlib for the figures).
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# mode-appropriate k values (the fiducial shift-log uses k=4; the
# two-parameter modes take tuples), the JAX script's
MODE_KS = {
    "log": 4.0,
    "shift-log": 4.0,
    "shift-log-2p": (1.0, 4.0),
    "log-tanh": 4.0,
    "x/(1+x)": (2.0, 1.0),
    "1/x": 1.0,
}


def _matplotlib():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def examples(n: int = 256, seed: int = 0, device=None):
    """The field (numpy), each mode's forward map and round-trip error on
    ``device``, and the split-scale decomposition: (field, results,
    forward fields by mode, split-scale parts), the arrays as numpy."""
    import torch

    from baryon_painter_tpu_torch.transforms import (FieldStats,
                                                     RangeCompress,
                                                     SplitScale)
    from baryon_painter_tpu_torch.utils.platform import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    # lognormal-ish positive field, same character as a density stack
    field = np.exp(1.2 * rng.standard_normal((n, n))).astype(np.float32)
    stats = FieldStats(
        z_grid=torch.tensor([0.0, 1.0], device=device),
        mean=torch.full((2,), float(field.mean()), device=device),
        var=torch.full((2,), float(field.var()), device=device))
    z = 0.5
    x = torch.as_tensor(field, device=device)
    results, fwds = {}, {}
    for mode, k in MODE_KS.items():
        tf = RangeCompress(mode, k)
        fwd_t = tf.forward(x, stats, z)
        back = tf.inverse(fwd_t, stats, z).cpu().numpy()
        fwd = fwd_t.cpu().numpy()
        err = float(np.max(np.abs(back - field) / (np.abs(field) + 1e-6)))
        results[mode] = {"roundtrip_max_rel_err": err,
                         "fwd_range": [float(fwd.min()), float(fwd.max())]}
        fwds[mode] = fwd
    # split-scale decomposition + exact recomposition
    ss = SplitScale(n_scale=3)
    parts_t = ss.forward(x[None])
    recomposed = ss.inverse(parts_t)[0].cpu().numpy()
    parts = parts_t.cpu().numpy()
    ss_err = float(np.max(np.abs(recomposed - field)
                          / (np.abs(field) + 1e-6)))
    results["split-scale"] = {"n_scale": 3,
                              "recompose_max_rel_err": ss_err}
    return field, results, fwds, parts


def figures(out: str, field, results, fwds, parts) -> list:
    """The JAX script's two figures in ``out``; their names, or [] without
    matplotlib."""
    plt = _matplotlib()
    if plt is None:
        print("matplotlib is not installed; no figures are drawn",
              file=sys.stderr, flush=True)
        return []
    fig, axes = plt.subplots(2, len(MODE_KS), figsize=(3 * len(MODE_KS), 5),
                             squeeze=False)
    for i, mode in enumerate(MODE_KS):
        err = results[mode]["roundtrip_max_rel_err"]
        axes[0][i].hist(np.log10(field.reshape(-1)), bins=80, color="C0")
        axes[0][i].set_title(f"log10(x)  —  {mode}", fontsize=9)
        axes[1][i].hist(fwds[mode].reshape(-1), bins=80, color="C1")
        axes[1][i].set_title(f"T(x), roundtrip {err:.1e}", fontsize=9)
    fig.tight_layout()
    png = os.path.join(out, "range_compress_modes.png")
    fig.savefig(png, dpi=110)
    plt.close(fig)

    fig, axes = plt.subplots(1, parts.shape[1] + 1,
                             figsize=(3 * (parts.shape[1] + 1), 3))
    axes[0].imshow(np.log10(field), cmap="magma")
    axes[0].set_title("log10 original", fontsize=9)
    for c in range(parts.shape[1]):
        axes[c + 1].imshow(parts[0, c], cmap="magma")
        axes[c + 1].set_title(f"scale {c}", fontsize=9)
    for ax in axes:
        ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    png2 = os.path.join(out, "split_scale.png")
    fig.savefig(png2, dpi=110)
    plt.close(fig)
    return [os.path.basename(png), os.path.basename(png2)]


def main(argv=None):
    """Run the twin; returns the report (also written and printed)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(),
                                        "bpt_transform_examples"),
                   help="output directory for the PNGs + JSON")
    p.add_argument("--n", type=int, default=256, help="field size (n x n)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    field, results, fwds, parts = examples(args.n, args.seed, args.device)
    report = {"metric": "transform_examples", "out": args.out,
              "figures": figures(args.out, field, results, fwds, parts),
              "modes": results}
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
