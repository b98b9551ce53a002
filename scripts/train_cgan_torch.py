#!/usr/bin/env python
"""CGAN training CLI of the PyTorch port (one CUDA device).

The twin of ``scripts/train_cgan.py``, with its flags and defaults (the
reference hyperparameters, trained_models/README.md:130-139: lr 5e-5, Adam
(0.5, 0.999), lambda_perceptual 2.5, lr decay 0.85 per 1568-sample pepoch,
batch 6; shift-log (k=4) transforms; ``--synthetic`` trains against 4
generated stacks at redshifts 0, 0.5, 1 and 2):

    python scripts/train_cgan_torch.py --synthetic --output-path run \\
        --device-data
    python scripts/train_cgan_torch.py --synthetic --output-path run \\
        --device-data --resume-from run/checkpoint_sample0000020000

``--device-data`` keeps the stacks on the card and gathers each batch there
(K2, one launch a step). The generator and the discriminator train in f32
with spectral norm, as the JAX CLI trains them. Beyond the JAX CLI's flags:
``--resume-from`` continues a checkpoint of either package (its progress
and data RNG too), and ``--pepoch-size``, ``--learning-rate``,
``--checkpoint-frequency``, ``--validation-loss-frequency`` and
``--validation-loss-batch-size`` set the ``CGANTrainConfig`` fields the JAX
CLI leaves at their defaults (the defaults here are those). Runs on the
card unless ``--device cpu``. Imports only torch, numpy and the port.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SYNTHETIC_REDSHIFTS = (0.0, 0.5, 1.0, 2.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-path")
    p.add_argument("--files-info", default="train_files_info.pickle")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-grid", type=int, default=256)
    p.add_argument("--output-path", required=True)
    p.add_argument("--n-tile", type=int, default=4,
                   help="tiles per stack side; tile size n_grid/n_tile must "
                        "be >= 32 for the discriminator")
    p.add_argument("--n-pepoch", type=int, default=96)
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--n-res-blocks", type=int, default=9)
    p.add_argument("--lambda-perceptual", type=float, default=2.5)
    p.add_argument("--device-data", action="store_true",
                   help="keep the stacks on the device and gather each "
                        "batch there (K2)")
    p.add_argument("--keep-last-checkpoints", type=int, default=0,
                   help="rotate periodic checkpoints, keeping only the "
                        "newest N (0 = keep all, the reference behavior)")
    p.add_argument("--clip-grad", type=float, default=0.0,
                   help="global-norm gradient clip for G and D, 0 = off "
                        "(CGANTrainConfig.clip_grad_norm)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--resume-from",
                   help="checkpoint base path to continue from (both "
                        "networks, their Adam states, the step, the loop's "
                        "progress and data RNG)")
    p.add_argument("--pepoch-size", type=int, default=1568)
    p.add_argument("--learning-rate", type=float, default=5e-5)
    p.add_argument("--checkpoint-frequency", type=int, default=20000)
    p.add_argument("--validation-loss-frequency", type=int, default=0,
                   help="samples between validation losses on the "
                        "validation set (0 = off, as the JAX CLI runs)")
    p.add_argument("--validation-loss-batch-size", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def _dataset(args):
    """The training dataset of the JAX CLI: BAHAMAS stacks from
    --data-path, or synthetic stacks written under the output path."""
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu_torch.transforms import RangeCompress
    if args.synthetic:
        data_path = os.path.join(args.output_path, "synthetic_data")
        info = make_synthetic_stacks(data_path, n_stack=4,
                                     n_grid=args.synthetic_grid,
                                     redshifts=SYNTHETIC_REDSHIFTS,
                                     seed=args.seed, name="train")
    else:
        if not args.data_path:
            raise SystemExit("--data-path is required without --synthetic")
        data_path = args.data_path
        info = os.path.join(data_path, args.files_info)
    return BahamasTileDataset(
        files=load_file_info(info), root_path=data_path,
        label_fields=["pressure"], n_tile=args.n_tile,
        tile_permutations=True,
        transforms={"dm": RangeCompress("shift-log", 4.0, eps=1e-4),
                    "pressure": RangeCompress("shift-log", 4.0, eps=1e-4)})


def build(args, datasets=None):
    """The trainer of a parsed command line. ``datasets`` ((training,
    validation)) replaces the data the flags name, as a caller that holds
    the stacks already passes them; without it there is no validation
    set, as in the JAX CLI."""
    from baryon_painter_tpu_torch.models.cgan import (CGANDiscriminator,
                                                      CGANGenerator)
    from baryon_painter_tpu_torch.train.cgan import (CGANTrainConfig,
                                                     CGANTrainer)
    training, validation = datasets or (_dataset(args), None)
    cfg = CGANTrainConfig(
        batch_size=args.batch_size, n_pepoch=args.n_pepoch,
        pepoch_size=args.pepoch_size, learning_rate=args.learning_rate,
        lambda_perceptual=args.lambda_perceptual,
        output_path=args.output_path, seed=args.seed,
        keep_last_checkpoints=args.keep_last_checkpoints,
        checkpoint_frequency=args.checkpoint_frequency,
        validation_loss_frequency=args.validation_loss_frequency,
        validation_loss_batch_size=args.validation_loss_batch_size,
        clip_grad_norm=args.clip_grad, verbose=args.verbose)
    return CGANTrainer(
        training, test_data=validation, config=cfg,
        generator=CGANGenerator(n_res_blocks=args.n_res_blocks,
                                spectral_norm=True),
        discriminator=CGANDiscriminator(), device_data=args.device_data,
        device=args.device)


def run(argv=None, datasets=None) -> dict:
    """Parse ``argv``, build the trainer, restore ``--resume-from`` and
    train. Returns the trainer, both statistics objects and the seconds
    ``train()`` took (host clock, after the final checkpoint is written)."""
    args = parse_args(argv)
    trainer = build(args, datasets)
    if args.resume_from:
        trainer.restore(args.resume_from)
        print(f"resumed from {args.resume_from} at step {trainer.steps}")
    t0 = time.perf_counter()
    stats, val_stats = trainer.train()
    seconds = time.perf_counter() - t0
    print(f"done: {stats.n_processed_samples[-1]} samples; "
          f"loss_D mavg {stats.loss_terms['loss_D']['mavg'][-1]:.4f}")
    return {"trainer": trainer, "training_stats": stats,
            "validation_stats": val_stats, "seconds": seconds}


def main():
    run()


if __name__ == "__main__":
    main()
