#!/usr/bin/env python
"""Fiducial CVAE training CLI of the PyTorch port (one CUDA device).

The twin of ``scripts/train_cvae.py``, with its flags and defaults:
shift-log (k=4) transforms, 11 redshifts, train/validation split by stack
offset, adaptive batch ramp 4->24 and step lr decay, 256 pepochs of 1568
samples; ``--synthetic`` trains against generated stacks:

    BPT_FUSED_HEADS=1 python scripts/train_cvae_torch.py --synthetic \\
        --output-path run --device-data
    python scripts/train_cvae_torch.py --synthetic --output-path run \\
        --device-data --resume-from run/checkpoint_sample0000020000

``--device-data`` keeps the stacks on the card and gathers each batch there
(K2); ``BPT_FUSED_HEADS=1`` runs the output heads through K3 and
``BPT_FUSED_TRAIN_CONV=1`` the train-mode conv + batch norm + ReLU triples
through K4, as the JAX package's switches do; ``--dtype bfloat16`` trains
in bf16. ``--pk-loss-weight W`` (with ``--pk-loss-per-z``) adds the
spectral fine-tuning term, written into the run config. ``--config`` reads a run-config JSON (``train/run_config.py``)
either package wrote; ``--resume-from`` continues a checkpoint of either
package. Runs on the card unless ``--device cpu``. Imports only torch,
numpy and the port.

At the JAX CLI's validation pepochs the run saves its figures
(``validate``: sample with variance, auto and cross P(k), log histogram)
as ``<output-path>/<plot_type>_pepoch<N>.png``; they need matplotlib, and
without it the run says so in one line at its start and goes on without
them (``validation_stats.txt`` is written either way). ``--profile
LOG_DIR`` wraps ``train()`` in a ``torch.profiler`` trace of the host and
the card (``utils/profiling.device_trace``), written as
``LOG_DIR/trace.json`` (chrome://tracing or Perfetto).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FIDUCIAL_REDSHIFTS = [0.0, 0.125, 0.25, 0.375, 0.5, 0.75, 1.0, 1.25, 1.5,
                      1.75, 2.0]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-path", help="directory with stacks + files-info pickle")
    p.add_argument("--files-info", default="train_files_info.pickle")
    p.add_argument("--synthetic", action="store_true",
                   help="generate synthetic stacks instead of loading BAHAMAS")
    p.add_argument("--synthetic-grid", type=int, default=256)
    p.add_argument("--output-path", required=True)
    p.add_argument("--tile-size", type=int, default=None,
                   help="override tile size (default: n_grid // n_tile)")
    p.add_argument("--n-tile", type=int, default=4)
    p.add_argument("--n-training-stack", type=int, default=11)
    p.add_argument("--n-validation-stack", type=int, default=3)
    p.add_argument("--n-pepoch", type=int, default=256)
    p.add_argument("--pepoch-size", type=int, default=1568)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--n-res-blocks", type=int, default=4)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device-data", action="store_true",
                   help="keep the stacks on the device and gather each "
                        "batch there (K2)")
    p.add_argument("--resume-from",
                   help="checkpoint base path to resume training from "
                        "(restores params, batch stats, optimizer state, "
                        "loop progress, data-rng state and step counter)")
    p.add_argument("--config",
                   help="declarative run-config JSON (train/run_config.py); "
                        "covers architecture + transforms + schedules + "
                        "trainer scalars; CLI flags override its values")
    p.add_argument("--profile", metavar="LOG_DIR", default=None,
                   help="wrap training in a torch.profiler trace of the "
                        "host and the card, written to LOG_DIR/trace.json")
    p.add_argument("--adaptive-lr", default=None,
                   choices=["fiducial", "avoid_plateau"],
                   help="lr schedule: 'fiducial' = step decay; "
                        "'avoid_plateau' = ReduceLROnPlateau on the "
                        "training-ELBO moving average, resumed from "
                        "checkpoints mid-plateau")
    p.add_argument("--pk-loss-weight", type=float, default=None,
                   help="spectral auxiliary loss weight (see "
                        "TrainConfig.pk_loss_weight)")
    p.add_argument("--pk-loss-per-z", action="store_true",
                   help="per-redshift masked spectral loss instead of a "
                        "pooled batch-mean (TrainConfig.pk_loss_per_z); "
                        "the P(k) gate is per-z, a pooled loss can trade "
                        "redshifts off against each other")
    p.add_argument("--clip-grad", type=float, default=None,
                   help="global-norm gradient clip, 0/None = off "
                        "(TrainConfig.clip_grad_norm)")
    p.add_argument("--keep-last-checkpoints", type=int, default=0,
                   help="rotate periodic checkpoints, keeping only the "
                        "newest N (0 = keep all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def _datasets(args, transforms):
    """(training, validation) datasets: BAHAMAS stacks from --data-path, or
    synthetic stacks written under the output path."""
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    if args.synthetic:
        data_path = os.path.join(args.output_path, "synthetic_data")
        info = make_synthetic_stacks(
            data_path, n_stack=args.n_training_stack + args.n_validation_stack,
            n_grid=args.synthetic_grid, redshifts=tuple(FIDUCIAL_REDSHIFTS),
            seed=args.seed, name="train")
    else:
        if not args.data_path:
            raise SystemExit("--data-path is required without --synthetic")
        data_path = args.data_path
        info = os.path.join(data_path, args.files_info)
    common = dict(files=load_file_info(info), root_path=data_path,
                  redshifts=FIDUCIAL_REDSHIFTS, label_fields=["pressure"],
                  n_tile=args.n_tile, transforms=transforms,
                  tile_permutations=True, scale_to_SLICS=True)
    training = BahamasTileDataset(n_stack=args.n_training_stack,
                                  stack_offset=args.n_validation_stack,
                                  **common)
    validation = BahamasTileDataset(data=training.data,
                                    n_stack=args.n_validation_stack,
                                    stack_offset=0, **{
                                        k: v for k, v in common.items()
                                        if k not in ("files", "root_path")})
    return training, validation


def build(args, datasets=None):
    """The trainer of a parsed command line, and its run config.
    ``datasets`` ((training, validation)) replaces the data the flags
    name, as a caller that holds the stacks already passes them."""
    import torch

    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.run_config import RunConfig
    from baryon_painter_tpu_torch.train.trainer import CVAETrainer
    from baryon_painter_tpu_torch.transforms import transform_from_dict

    run_cfg = RunConfig.load(args.config) if args.config else None
    if run_cfg is not None and run_cfg.transforms:
        transforms = run_cfg.build_transforms()
    else:
        transforms = {
            f: transform_from_dict({"type": "range_compress",
                                    "mode": "shift-log", "k": 4.0,
                                    "eps": 1e-4})
            for f in ("dm", "pressure")}
    training, validation = datasets or _datasets(args, transforms)

    tile = args.tile_size or training.tile_size
    if run_cfg is not None and run_cfg.architecture:
        arch = run_cfg.architecture
    else:
        arch = fiducial_cvae_architecture(tile_size=tile,
                                          n_res_blocks=args.n_res_blocks)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None

    if run_cfg is None:
        # the declarative config of this run (fiducial schedules as
        # specs), written to run_config.json and every checkpoint's meta
        run_cfg = RunConfig(
            architecture=arch,
            transforms={f: t.to_dict() for f, t in transforms.items()},
            schedules={"batch_size_schedule": {"kind": "fiducial_batch"},
                       "lr_schedule": {"kind": "fiducial_lr"}},
            train=dict(validation_loss_frequency=72,
                       validation_loss_batch_size=24,
                       checkpoint_frequency=20000,
                       statistics_report_frequency=400,
                       mavg_window_size=50))
    overrides = dict(learning_rate=args.learning_rate,
                     n_pepoch=args.n_pepoch, pepoch_size=args.pepoch_size,
                     output_path=args.output_path, seed=args.seed,
                     keep_last_checkpoints=args.keep_last_checkpoints,
                     verbose=args.verbose)
    if args.pk_loss_weight is not None:
        overrides["pk_loss_weight"] = args.pk_loss_weight
        run_cfg.train["pk_loss_weight"] = args.pk_loss_weight
    if args.pk_loss_per_z:
        overrides["pk_loss_per_z"] = True
        run_cfg.train["pk_loss_per_z"] = True
    if args.clip_grad is not None:
        overrides["clip_grad_norm"] = args.clip_grad
        run_cfg.train["clip_grad_norm"] = args.clip_grad
    if args.adaptive_lr is not None:
        run_cfg.schedules["lr_schedule"] = (
            {"kind": "fiducial_lr"} if args.adaptive_lr == "fiducial"
            else {"kind": "avoid_plateau"})
    cfg = run_cfg.build_train_config(**overrides)

    os.makedirs(args.output_path, exist_ok=True)
    run_cfg.save(os.path.join(args.output_path, "run_config.json"))
    model = CVAE(arch, dtype=dtype,
                 fused_heads=os.environ.get("BPT_FUSED_HEADS") == "1",
                 fused_train_conv=(
                     os.environ.get("BPT_FUSED_TRAIN_CONV") == "1"))
    trainer = CVAETrainer(model, training, test_data=validation, config=cfg,
                          device_data=args.device_data, device=args.device)
    trainer.run_config = run_cfg
    return trainer, run_cfg


# the JAX CLI's validation pepochs (scripts/train_cvae.py)
VALIDATION_PEPOCHS = (0, 1, 2, 5, 10, 15, 20, 30, 40, 50, 60, 70, 80, 90,
                      100, 120, 140, 160, 180, 200, 230)


def on_validation(output_path):
    """The JAX CLI's figures at a validation pepoch, under its file names;
    None (and one line saying so) without matplotlib."""
    from baryon_painter_tpu_torch.utils.validation_plotting import \
        require_matplotlib
    try:
        require_matplotlib()
    except ImportError:
        print("validation figures are not drawn: matplotlib is not "
              "installed (validation_stats.txt is written)")
        return None

    def draw(tr, pepoch):
        import matplotlib.pyplot as plt
        figs = tr.validate(validation_batch_size=8, plot_sample_var=True,
                           plot_power_spectra=["auto", "cross"],
                           plot_histogram=["log"], save_plots=True,
                           filename_template=os.path.join(
                               output_path,
                               f"{{plot_type}}_pepoch{pepoch}.png"))
        for fig in figs.values():
            plt.close(fig)
    return draw


def run(argv=None, datasets=None) -> dict:
    """Parse ``argv``, build the trainer, restore ``--resume-from`` and
    train, with the figures at the validation pepochs and, with
    ``--profile``, inside the trace. Returns the trainer, both statistics
    objects, the seconds ``train()`` took (host clock, after the final
    checkpoint is written), the seconds of the whole block with the
    profiler's start, stop and trace export (``block_seconds``) and the
    trace's path (or None)."""
    from baryon_painter_tpu_torch.utils.profiling import (TRACE_FILE,
                                                          device_trace)
    args = parse_args(argv)
    trainer, _ = build(args, datasets)
    if args.resume_from:
        trainer.restore(args.resume_from)
        print(f"resumed from {args.resume_from} at step "
              f"{trainer.steps}")
    draw = on_validation(args.output_path)
    t_block = time.perf_counter()
    with device_trace(args.profile):
        t0 = time.perf_counter()
        tstats, vstats = trainer.train(
            validation_pepochs=VALIDATION_PEPOCHS if draw else (),
            on_validation=draw)
        seconds = time.perf_counter() - t0
    block_seconds = time.perf_counter() - t_block
    trace = None
    if args.profile:
        trace = os.path.join(args.profile, TRACE_FILE)
        print(f"device trace written to {trace} (chrome://tracing or "
              f"Perfetto)")
    print(f"done: {tstats.n_processed_samples[-1]} samples; final ELBO mavg "
          f"{tstats.loss_terms['ELBO']['mavg'][-1]:.4e}")
    return {"trainer": trainer, "training_stats": tstats,
            "validation_stats": vstats, "seconds": seconds,
            "block_seconds": block_seconds, "trace": trace}


def main():
    run()


if __name__ == "__main__":
    main()
