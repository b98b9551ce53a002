"""Compare training-stats trajectories against reference-published logs.

The reference ships its fiducial training history as a text log
(``trained_models/CVAE/fiducial-512/training_stats.txt``, format defined at
painter.py:462-463: ``# Batch nr, sample nr, <terms>`` header + whitespace
rows). Our :class:`~baryon_painter_tpu_torch.train.stats.TrainingStats` writes the
same format, so convergence trajectories are directly diffable.

This module loads two such files, aligns them on *sample count* (the
reference's unit of training time — pepochs are sample counts,
trained_models/README.md:142), smooths with the same moving-average window
TrainingStats uses, and reports fractional deviations at log-spaced
checkpoints. Two modes:

- ``absolute``: fractional difference of the smoothed term values at matched
  sample counts, normalized by the reference magnitude. Meaningful only when
  both runs trained on the *same data* (same loss scale) — e.g. our trainer
  on real BAHAMAS stacks vs the published log, or two of our runs across
  rounds (regression tracking).
- ``shape``: both trajectories are affinely normalized to [0, 1] over the
  compared span ((v - best) / (start - best)), which compares *convergence
  profiles* independent of loss scale — usable even across datasets (our
  synthetic-stack runs vs the BAHAMAS-trained reference).

Used by ``scripts/compare_reference_stats_torch.py`` (CLI with an
optional pass/fail band).

A copy of ``baryon_painter_tpu/train/stats_compare.py`` (numpy only): the
port imports nothing of the JAX package, whose ``__init__`` imports jax.
"""
from __future__ import annotations

import numpy as np

from baryon_painter_tpu_torch.train.stats import parse_stats_file

__all__ = ["load_stats_file", "compare_trajectories"]


def load_stats_file(path):
    """Parse a reference-format stats file.

    Returns ``(terms, samples, values)`` where ``terms`` is the ordered list
    of column names after the two index columns, ``samples`` is the int array
    of cumulative sample counts, and ``values`` is a (n_rows, n_terms) float
    array. Delegates to :func:`~baryon_painter_tpu_torch.train.stats.parse_stats_file`
    (the same parser resume uses), then requires at least one complete row.
    """
    terms, samples, rows = parse_stats_file(path)
    if not rows:
        raise ValueError(f"{path} has a header but no complete data rows.")
    return terms, np.asarray(samples), np.asarray(rows)


def _moving_average(x, window):
    if window <= 1:
        return np.asarray(x, float)
    c = np.cumsum(np.concatenate([[0.0], x]))
    n = np.arange(1, len(x) + 1)
    w = np.minimum(n, window)
    return (c[n] - c[n - w]) / w


def _select_term(terms, values, term):
    if term in terms:
        return values[:, terms.index(term)]
    # tolerate per-field suffix differences (log_likelihood_pressure_0 in the
    # reference vs log_likelihood_0 here): match on the longest common prefix
    candidates = [i for i, t in enumerate(terms)
                  if t.startswith(term) or term.startswith(t)]
    if len(candidates) == 1:
        return values[:, candidates[0]]
    raise KeyError(f"term {term!r} not found (have {terms}; "
                   f"prefix candidates: {[terms[i] for i in candidates]})")


def compare_trajectories(ref_path, our_path, term="ELBO", our_term=None,
                         mode="shape", n_checkpoints=20, smooth_window=100,
                         per_sample=False):
    """Align two stats logs on sample count and measure their deviation.

    Checkpoints are log-spaced over the overlapping sample range. Returns a
    dict with per-checkpoint values for both runs and the deviation series:
    in ``absolute`` mode ``|ours - ref| / max(|ref|)``; in ``shape`` mode the
    absolute difference of the two [0, 1]-normalized convergence profiles.

    ``per_sample=True`` divides each run's term by its ``batch_size`` column
    when present (the reference logs batch totals; trained_models/README.md
    quotes per-sample ELBO), enabling like-for-like absolute comparison
    across different batch schedules.
    """
    ref_terms, ref_s, ref_v = load_stats_file(ref_path)
    our_terms, our_s, our_v = load_stats_file(our_path)
    ref_y = _select_term(ref_terms, ref_v, term)
    our_y = _select_term(our_terms, our_v, our_term or term)
    if per_sample:
        for terms_i, v_i, name in ((ref_terms, ref_v, "reference"),
                                   (our_terms, our_v, "ours")):
            if "batch_size" not in terms_i:
                raise ValueError(
                    f"per_sample=True but the {name} log has no batch_size "
                    f"column (terms: {terms_i})")
        ref_y = ref_y / _select_term(ref_terms, ref_v, "batch_size")
        our_y = our_y / _select_term(our_terms, our_v, "batch_size")

    ref_y = _moving_average(ref_y, smooth_window)
    our_y = _moving_average(our_y, smooth_window)

    lo = max(ref_s[0], our_s[0])
    hi = min(ref_s[-1], our_s[-1])
    if hi <= lo:
        raise ValueError(
            f"no overlapping sample range: reference [{ref_s[0]}, {ref_s[-1]}]"
            f" vs ours [{our_s[0]}, {our_s[-1]}]")
    checkpoints = np.unique(np.geomspace(lo, hi, n_checkpoints).astype(int))
    ref_c = np.interp(checkpoints, ref_s, ref_y)
    our_c = np.interp(checkpoints, our_s, our_y)

    if mode == "shape":
        def normalize(c):
            span = c.max() - c.min()
            if span == 0:
                return np.zeros_like(c)
            return (c - c.min()) / span
        deviation = np.abs(normalize(our_c) - normalize(ref_c))
    elif mode == "absolute":
        scale = np.max(np.abs(ref_c))
        deviation = np.abs(our_c - ref_c) / (scale if scale else 1.0)
    else:
        raise ValueError(f"unknown mode {mode!r} (use 'shape' or 'absolute')")

    return {
        "mode": mode,
        "term": term,
        "samples": checkpoints.tolist(),
        "reference": ref_c.tolist(),
        "ours": our_c.tolist(),
        "deviation": deviation.tolist(),
        "max_deviation": float(deviation.max()),
        "final_deviation": float(deviation[-1]),
        "overlap": [int(lo), int(hi)],
    }
