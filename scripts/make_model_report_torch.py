"""Generate the markdown report of a trained model, in the PyTorch port.

The twin of ``scripts/make_model_report.py``: for every model directory
under ``trained_models/`` (or those named) it compiles, from the committed
artifacts alone (no model evaluation, host only, seconds):

- loss trajectories (ELBO/KL + the spectral fine-tune phase) from the
  reference-format ``training_stats*.txt`` files -> ``loss_curves.png``,
- the per-redshift P(k) gate table from ``fidelity_report.json``,
- parameter counts from the checkpoint msgpack (the port's reader),
- links to the sample / power-spectrum / histogram figures produced at
  train time,

into ``<model_dir>/report.md``, byte for byte the JAX script's. The loss
curves need matplotlib: without it (the H100 machine has none) the panel
is left out of the report and one line on stderr says so.

    python scripts/make_model_report_torch.py [model_dir ...]

Imports only numpy and the port (matplotlib for the loss curves).
"""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _param_count(state_path):
    """Total parameter / variable scalar count from the raw msgpack tree
    (no model build needed; a checkpoint stores plain array trees)."""
    from baryon_painter_tpu_torch.train.msgpack_reader import msgpack_restore
    with open(state_path, "rb") as f:
        tree = msgpack_restore(f.read(), numpy_scalars=True)

    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        arr = np.asarray(node)
        return int(arr.size) if arr.dtype != object else 0

    # Trainer checkpoints carry optimizer/step state too; count only the
    # model's own collections when present.
    keys = [k for k in ("params", "batch_stats", "g_params", "g_stats")
            if isinstance(tree, dict) and k in tree]
    if keys:
        return {k: count(tree[k]) for k in keys}
    return {"total": count(tree)}


def _load_stats(path):
    """Parse a reference-format stats file -> (terms, samples, columns).

    The torn-row-tolerant parser (a crash can leave a partial final line);
    a header-only file yields empty arrays instead of an error so report
    generation skips the panel."""
    from baryon_painter_tpu_torch.train.stats_compare import load_stats_file
    try:
        return load_stats_file(path)
    except ValueError:
        with open(path) as f:
            header = f.readline()
        terms = [t.strip() for t in header.lstrip("# ").split(",")[2:]]
        return terms, np.zeros(0), np.zeros((0, len(terms)))


def _mavg(x, w=100):
    if len(x) == 0:
        return np.asarray(x, np.float64)
    from baryon_painter_tpu_torch.train.stats_compare import _moving_average
    return _moving_average(x, w)


def _layout_note():
    """The loss section's note on the stats files' layout, word for word
    the JAX script's (which names the reference's own fiducial stats
    file), taken from that script's source so that the two reports
    cannot drift apart."""
    import ast
    with open(os.path.join(REPO, "scripts", "make_model_report.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith(" (same '# Batch nr")):
            return node.value
    raise RuntimeError("scripts/make_model_report.py holds no layout note")


def _matplotlib():
    """matplotlib's pyplot on the Agg backend, or None without it."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_losses(model_dir, stats_files):
    """``loss_curves.png`` from the stats files; None when no file has a
    panel to draw or matplotlib is missing (one line on stderr then)."""
    panels = []
    for path in stats_files:
        terms, samples, cols = _load_stats(path)
        phase = ("spectral fine-tune" if path.endswith("_pkft.txt")
                 else "base training")
        for term in ("ELBO", "KL_term", "pk_loss", "loss_G", "loss_D"):
            if term in terms and len(samples):
                # header-only files (crash before the first flush) contribute
                # zero-length columns; a panel for them would crash vals.max()
                panels.append((phase, term, samples,
                               cols[:, terms.index(term)]))
    if not panels:
        return None
    plt = _matplotlib()
    if plt is None:
        print(f"{model_dir}: matplotlib is not installed; the loss-curves "
              f"panel is left out of the report", file=sys.stderr,
              flush=True)
        return None
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 3),
                             squeeze=False)
    for ax, (phase, term, samples, vals) in zip(axes[0], panels):
        ax.plot(samples, vals, alpha=0.3, lw=0.7)
        ax.plot(samples, _mavg(vals), lw=1.5)
        ax.set_xlabel("samples")
        ax.set_title(f"{term} — {phase}", fontsize=10)
        if np.all(vals > 0) and vals.max() / max(vals.min(), 1e-30) > 50:
            ax.set_yscale("log")
    fig.tight_layout()
    out = os.path.join(model_dir, "loss_curves.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def make_report(model_dir):
    model_dir = model_dir.rstrip("/")
    name = os.path.relpath(model_dir, os.path.join(REPO, "trained_models"))
    fid_path = os.path.join(model_dir, "fidelity_report.json")
    meta_path = os.path.join(model_dir, "model_meta.json")
    state_path = os.path.join(model_dir, "model_state.msgpack")
    if not os.path.exists(meta_path):
        print(f"skip {model_dir}: no model_meta.json")
        return

    with open(meta_path) as f:
        meta = json.load(f)
    fid = None
    if os.path.exists(fid_path):
        with open(fid_path) as f:
            fid = json.load(f)

    lines = [f"# {name} — model report", ""]
    kind = meta.get("model_kind", "cvae").upper()
    arch = meta.get("model_architecture", {})
    lines += [f"Model kind: **{kind}**. Tile size "
              f"{meta.get('tile_size', '?')} px, tile_L "
              f"{meta.get('tile_L', '?')} Mpc/h, input field "
              f"`{meta.get('input_field', '?')}`, label fields "
              f"`{meta.get('label_fields', '?')}`.", ""]
    if os.path.exists(state_path):
        counts = _param_count(state_path)
        total = sum(counts.values())
        detail = ", ".join(f"{k}: {v:,}" for k, v in counts.items())
        lines += [f"Checkpoint scalars: **{total:,}** ({detail}).", ""]
    if isinstance(arch, dict) and arch:
        keys = [k for k in ("dim_x", "dim_y", "dim_z", "n_res_blocks",
                            "upsample", "in_channels") if k in arch]
        if keys:
            lines += ["Architecture: "
                      + ", ".join(f"`{k}={arch[k]}`" for k in keys), ""]

    # Fidelity gate table (the JAX script's text, unchanged)
    if fid is not None:
        lines += ["## P(k) fidelity gate (5% per redshift)", "",
                  "Painted-vs-truth fractional P(k) errors on held-out "
                  "synthetic validation stacks, re-evaluable with "
                  "`scripts/fidelity_check.py --eval-only --checkpoint "
                  f"{os.path.relpath(model_dir, REPO)}/model` "
                  "(see trained_models/README.md).", ""]
        by_dtype = fid.get("per_z_by_dtype") or {"": fid.get("per_z", {})}
        per_z = fid.get("per_z", {})
        hdr = " | ".join(f"auto {l}".strip() + " | " + f"cross {l}".strip()
                         for l in by_dtype)
        lines += [f"| z | {hdr} | pass |",
                  "|---|" + "---|" * (2 * len(by_dtype)) + "---|"]
        for z in sorted(per_z, key=float):
            cells = []
            worst = 0.0
            for label in by_dtype:
                a, c = by_dtype[label][z]["auto"], by_dtype[label][z]["cross"]
                cells += [f"{a:.3f}", f"{c:.3f}"]
                worst = max(worst, a, c)
            # strict <, matching the gate's pass_5pct: a 0.050 row must not
            # read "yes" under a FAIL verdict
            ok = "yes" if worst < 0.05 else "NO"
            lines.append(f"| {z} | " + " | ".join(cells) + f" | {ok} |")
        verdict = "PASS" if fid.get("pass_5pct") else "FAIL"
        worst_all = max((max(v["auto"], v["cross"])
                         for d in by_dtype.values() for v in d.values()),
                        default=float("nan"))
        dtype_note = (" across paint dtypes "
                      + "/".join(by_dtype) if len(by_dtype) > 1 else "")
        lines += ["", f"Gate verdict: **{verdict}** "
                  f"(worst per-z value {worst_all:.3f}{dtype_note}).", ""]

    # Loss curves
    stats_files = sorted(
        os.path.join(model_dir, f) for f in os.listdir(model_dir)
        if f.startswith("training_stats") and f.endswith(".txt"))
    png = plot_losses(model_dir, stats_files)
    if png:
        lines += ["## Loss trajectories", "",
                  "Reference-format stats files: "
                  + ", ".join(f"`{os.path.basename(p)}`" for p in stats_files)
                  + _layout_note(), "",
                  f"![loss curves]({os.path.basename(png)})", ""]

    figs = sorted(f for f in os.listdir(model_dir)
                  if f.endswith(".png") and f != "loss_curves.png")
    if figs:
        lines += ["## Validation figures", ""]
        lines += [f"![{f}]({f})" for f in figs]
        lines += [""]

    out = os.path.join(model_dir, "report.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}")


def main():
    dirs = sys.argv[1:]
    if not dirs:
        root = os.path.join(REPO, "trained_models")
        dirs = [os.path.join(root, fam, run)
                for fam in sorted(os.listdir(root))
                if os.path.isdir(os.path.join(root, fam))
                for run in sorted(os.listdir(os.path.join(root, fam)))
                if os.path.isdir(os.path.join(root, fam, run))]
    for d in dirs:
        make_report(d)


if __name__ == "__main__":
    main()
