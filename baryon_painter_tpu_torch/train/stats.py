"""Training statistics bookkeeping.

Re-implements the reference's ``TrainingStats`` (painter.py:447-545): ordered
loss terms with full history + moving averages, buffered text-file dumps in
the SAME file format (header '# Batch nr, sample nr, <terms>'; rows
'<batch> <sample> <values...>' — see trained_models/CVAE/fiducial-512/
training_stats.txt), and console pretty-printing. Plotting is decoupled
(SURVEY §2 quirk 5): ``plot_loss`` imports matplotlib lazily.

A copy of ``baryon_painter_tpu/train/stats.py`` (pure Python and
numpy): the port imports nothing of the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import collections
import os
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["TrainingStats", "parse_stats_file"]


def parse_stats_file(path: str):
    """Parse a reference-format stats file into ``(terms, samples, rows)``.

    ``terms`` is the ordered column-name list after the two index columns;
    ``samples`` the cumulative sample counts; ``rows`` the per-row value
    lists. Torn trailing rows (crash artifacts) are skipped. A header-only
    file (crash before the first flush) parses to zero rows.

    The single parser for the on-disk format — used both by resume
    (:meth:`TrainingStats._resume_from_file`) and by the trajectory
    comparator (the JAX package's ``train/stats_compare.py``), so the two
    can never drift apart.
    """
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines or not lines[0].startswith("#"):
        raise ValueError(f"{path} is not a stats file (no '#' header).")
    terms = [t.strip() for t in lines[0].lstrip("# ").split(",")[2:]]
    samples, rows = [], []
    for line in lines[1:]:
        parts = line.split()
        if len(parts) != 2 + len(terms):
            continue
        samples.append(int(float(parts[1])))
        rows.append([float(v) for v in parts[2:]])
    return terms, samples, rows


class TrainingStats:
    def __init__(self, loss_terms: Sequence[str] = (),
                 moving_average_window: int = 100,
                 dump_to_file_frequency: int = 10,
                 stats_filename: Optional[str] = None,
                 resume: bool = False,
                 resume_up_to: Optional[int] = None):
        """``resume=True`` re-loads an existing stats file into the history
        (batch numbering, moving averages and file rows continue seamlessly)
        instead of truncating it — required for resumed training runs.

        ``resume_up_to``: drop resumed rows whose sample count exceeds this
        value (and rewrite the file without them). A crashed run flushes
        rows past its last checkpoint; replaying from the checkpoint would
        otherwise duplicate that orphaned segment in the history and the
        moving averages."""
        self.mavg_window = moving_average_window
        self.n_batches = 0
        self.n_processed_samples: List[int] = []
        self.last_dump_to_file = 0
        self.dump_to_file_frequency = dump_to_file_frequency

        self.loss_terms = collections.OrderedDict(
            (term, {"all": [], "mavg": []}) for term in loss_terms)

        self.stats_filename = stats_filename
        if stats_filename is not None:
            if resume and os.path.exists(stats_filename):
                self._resume_from_file(stats_filename, resume_up_to)
            else:
                with open(stats_filename, "w") as f:
                    f.write("# Batch nr, sample nr, {}\n".format(
                        ", ".join(loss_terms)))

    def _resume_from_file(self, filename: str,
                          up_to: Optional[int] = None):
        header_terms, samples, rows = parse_stats_file(filename)
        if header_terms != list(self.loss_terms):
            raise ValueError(
                f"Stats file {filename} terms {header_terms} do not match "
                f"the current run's {list(self.loss_terms)}.")
        dropped = 0
        for n_sample, vals in zip(samples, rows):
            if up_to is not None and n_sample > up_to:
                dropped += 1
                continue
            self._push(n_sample, vals)
        self.last_dump_to_file = self.n_batches
        if dropped:
            # rewrite without the orphaned tail (rows a crashed run flushed
            # past its last checkpoint) so replaying cannot duplicate them
            with open(filename, "w") as f:
                f.write("# Batch nr, sample nr, {}\n".format(
                    ", ".join(self.loss_terms)))
                for s in range(self.n_batches):
                    f.write(self.get_str(s) + "\n")

    def _push(self, n_sample: int, values):
        self.n_batches += 1
        self.n_processed_samples.append(int(n_sample))
        for value, term in zip(values, self.loss_terms.values()):
            term["all"].append(float(value))
            window = min(self.n_batches, self.mavg_window)
            term["mavg"].append(float(np.mean(term["all"][-window:])))

    def push_loss(self, n_sample: int, *args):
        if len(args) != len(self.loss_terms):
            raise ValueError(
                f"Expected {len(self.loss_terms)} loss values, got {len(args)}.")
        self._push(n_sample, args)
        if (self.n_batches - self.dump_to_file_frequency >= self.last_dump_to_file
                and self.stats_filename is not None):
            self.flush_to_file()

    def flush_to_file(self):
        if self.stats_filename is None:
            return
        with open(self.stats_filename, "a") as f:
            for s in range(self.last_dump_to_file, self.n_batches):
                f.write(self.get_str(s) + "\n")
        self.last_dump_to_file = self.n_batches

    def get_str(self, idx: int = -1) -> str:
        batch = idx if idx >= 0 else self.n_batches + idx + 1
        s = f"{batch} {self.n_processed_samples[idx]} "
        s += " ".join(str(term["all"][idx]) for term in self.loss_terms.values())
        return s

    def get_pretty_str(self, n_col: int = 1) -> str:
        s = ""
        width = max(len(k) for k in self.loss_terms)
        per_row = 0
        for key, term in self.loss_terms.items():
            s += "{key:<{width}s}: {value:8.3e}     ".format(
                key=key, width=width, value=term["mavg"][-1])
            per_row += 1
            if per_row >= n_col:
                s += "\n"
                per_row = 0
        return s

    def plot_loss(self, loss_term="ELBO", window_size=200, burn_in=100):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 2, figsize=(8, 3))
        fig.subplots_adjust(wspace=0.3)
        n = self.n_batches
        n_sample = self.n_processed_samples
        loss = self.loss_terms[loss_term]["all"]
        mavg = self.loss_terms[loss_term]["mavg"]

        lo = max(0, n - window_size)
        ax[1].plot(n_sample[lo:], loss[lo:], alpha=0.5, label=loss_term)
        ax[1].plot(n_sample[lo:], mavg[lo:], label=f"{loss_term} mavg")
        ax[1].legend()
        ax[1].set_xlabel("Number of samples")
        ax[1].set_ylabel(loss_term)

        xs, ys, ms = n_sample, loss, mavg
        if n > burn_in:
            xs, ys, ms = xs[burn_in:], ys[burn_in:], ms[burn_in:]
        if len(ys) > 500:
            step = len(ys) // 500
            xs, ys, ms = xs[::step], ys[::step], ms[::step]
        ax[0].semilogy(xs, np.abs(ys), alpha=0.5, label=loss_term)
        ax[0].semilogy(xs, np.abs(ms), label=f"{loss_term} mavg")
        ax[0].legend()
        ax[0].set_xlabel("Number of samples")
        ax[0].set_ylabel(loss_term)
        return fig, ax
