#!/usr/bin/env python
"""Physics-fidelity check of the PyTorch port: gate a painter on its P(k).

The twin of ``scripts/fidelity_check.py``, with its flags and its JSON
report: synthetic stacks whose pressure is physically coupled to the DM
(P ~ rho^1.5; ``--physical`` for the BAHAMAS-like statistics) are written
under ``--workdir``, the CVAE is trained on them (ELBO, then spectral
fine-tuning with ``--pk-loss-weight``) or a checkpoint is restored, and
validation tiles (the first stack, held out) are painted with the prior and
scored by the median over k bins of the auto- and cross-P(k) fractional
errors, per redshift and per compute dtype ("f32" pinned, and "model",
bf16, with ``--gate-dtype both``). One JSON line on stdout, everything else
on stderr:

    python scripts/fidelity_check_torch.py --tile 512 \\
        --redshifts 0,0.125,0.25,0.375,0.5,0.75,1,1.25,1.5,1.75,2 \\
        --eval-only --checkpoint trained_models/CVAE/fiducial-512/model
    python scripts/fidelity_check_torch.py --model cgan --eval-only \\
        --checkpoint trained_models/CGAN/fiducial/model
    python scripts/fidelity_check_torch.py --tile 32 --redshifts 0,1 \\
        --n-stack 2 --n-samples 40 --batch 4 --scan 5 --device cpu

``--eval-only --checkpoint`` takes the architecture, the transforms and
the CGAN's upsample mode from the checkpoint's meta (read with the port's
msgpack reader). The paint runs on the card through K1 (the fused
residual blocks) and, for the CVAE, K3 (the fused heads); the truth
spectra of each (redshift, seed, tile count)
are computed once and kept on the device. The training leg trains the
CVAE through K2 (the stack cache) and, with ``BPT_FUSED_HEADS=1``, K3, or
the CGAN (``--model cgan``, f32, as the JAX script trains it) through K2,
from scratch or from a checkpoint (``--resume``, ``--reinit-d SEED`` with a
fresh discriminator; ``--adv-weight``, ``--perc-weight``,
``--feature-matching``, ``--freeze-bn``, ``--clip-grad``,
``--pk-loss-weight``; the CGAN's lr decays 0.85 per 1568 samples unless
the spectral term is on), and writes ``training_stats_<model>[_pkft].txt``
(the spectral fine-tune adds a ``pk_loss`` column) beside the checkpoint;
``--eval-every`` scores the gate during training and keeps the best state
(``--select-within-run``: not seeded with the restored state's score). The
CGAN's gate paints its trainer's live generator through
``CGANPainter.from_trainer`` and K1.

The prior's noise is drawn from a ``torch.Generator`` seeded ``--seed``
(``pk_errors``' ``eps_seed``), so a score is not the JAX package's draw
(``jax.random.PRNGKey``); ``scripts/fidelity_spread_torch.py`` measures how
far the score moves with that draw.

``--save-figures`` saves the trainer's validation figures (``validate``:
samples, auto P(k), log histogram) as ``<workdir>/<model>_<plot_type>.png``
before the final scores, as the JAX script does; with ``--eval-only`` a
trainer is built from the checkpoint for them (the CVAE's heads through K3
with ``BPT_FUSED_HEADS=1``). They need matplotlib: without it the flag
raises an ImportError at once. Imports only torch, numpy and the port
(matplotlib for ``--save-figures``).
"""
import argparse
import copy
import json
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

N_K_BIN = 12

# Per-(dataset, z, seed, n, device) cache of everything the gate reads
# that does not change between evaluations: the DM batch on the device, the
# truth auto/cross spectra (binned means) and the truth's summary scalars.
# Every evaluation paints the same validation tiles (the sampling is seeded).
_PK_TRUTH_CACHE = {}


def _truth(ds, n_sample, seed, z, device):
    import torch

    from baryon_painter_tpu_torch.power_spectrum import pseudo_pofk_2d
    key = (id(ds), z, seed, n_sample, str(device))
    cached = _PK_TRUTH_CACHE.get(key)
    if cached is None:
        rng = np.random.default_rng(seed)
        idx = ds.sample_indices(rng, n_sample, z=z)
        batch = ds.get_raw_batch(idx)
        dm = torch.as_tensor(batch["input"], dtype=torch.float32,
                             device=device)
        truth = torch.as_tensor(batch["labels"][0], dtype=torch.float32,
                                device=device)
        pk_t, _, _, nm = pseudo_pofk_2d(truth, L=ds.tile_L, n_k_bin=N_K_BIN)
        pk_ct, *_ = pseudo_pofk_2d(truth, dm, L=ds.tile_L, n_k_bin=N_K_BIN)
        occ = nm > 0
        cached = {
            "dm": dm,
            "zs": torch.as_tensor(batch["z"], dtype=torch.float32,
                                  device=device),
            "occ": occ,
            "pk_t": pk_t.mean(0)[occ],
            "pk_ct": pk_ct.mean(0)[occ],
            "truth_max": float(truth.max()),
            "truth_mean": float(truth.double().mean()),
            "truth_std": float(truth.double().std(unbiased=False)),
        }
        _PK_TRUTH_CACHE[key] = cached
    return cached


def pk_errors(painter, ds, n_sample=48, seed=0, z=None, eps_seed=None,
              eps=None):
    """P(k) fractional errors of painted-vs-truth validation tiles: the
    tiles of (``ds``, ``z``, ``seed``, ``n_sample``) painted by ``painter``
    in one call, the prior's noise ``eps`` when given, else drawn from a
    generator seeded ``eps_seed`` (default ``seed``) on the painter's
    device (a CGAN draws none). Returns the medians over the k bins of
    |P_painted / P_truth - 1| (auto) and of the cross-spectrum with the DM,
    and diagnostics (mean and std ratios, the tail-clipped auto error).
    Everything stays on the device (paint, clip, FFT spectra); only the
    binned errors cross to the host."""
    import torch

    from baryon_painter_tpu_torch.power_spectrum import pseudo_pofk_2d
    device = painter.device
    cached = _truth(ds, n_sample, seed, z, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed if eps_seed is None else eps_seed)
    painted = painter.paint_batch(cached["dm"], cached["zs"],
                                  generator=gen, eps=eps).float()
    occ = cached["occ"]
    pk = lambda a, b=None: pseudo_pofk_2d(a, b, L=ds.tile_L,
                                          n_k_bin=N_K_BIN)[0].mean(0)[occ]
    med = lambda t: float(np.median(t.double().cpu().numpy()))
    auto = (pk(painted) / cached["pk_t"] - 1).abs()
    # tail-clipped variant: the painted pixels capped at the truth's max
    auto_cl = (pk(painted.clamp(max=cached["truth_max"])) / cached["pk_t"]
               - 1).abs()
    cross = (pk(painted, cached["dm"]) / cached["pk_ct"] - 1).abs()
    p64 = painted.double()
    diag = {"mean_ratio": float(p64.mean()) / cached["truth_mean"],
            "std_ratio": (float(p64.std(unbiased=False))
                          / cached["truth_std"]),
            "auto_clipped": med(auto_cl)}
    return med(auto), med(cross), diag


def allocate_batch_shares(batch, shares, zs):
    """Largest-remainder allocation of `batch` samples over per-z `shares`.

    Exact for the static CLI contract (batch % sum(shares) == 0 gives
    per-share integer quotas), and well-defined for the dynamic
    '--z-boost auto' case where the share total need not divide the batch.
    Every z gets at least one sample: the per-z masked batch-mean P(k)
    loss (TrainConfig.pk_loss_per_z) needs every redshift represented in
    every step's batch.
    """
    if batch < len(zs):
        raise ValueError(f"batch {batch} < {len(zs)} redshifts: the per-z "
                         f"spectral loss needs every z in every batch")
    total = sum(shares[z] for z in zs)
    raw = {z: batch * shares[z] / total for z in zs}
    counts = {z: int(raw[z]) for z in zs}
    rem = batch - sum(counts.values())
    for z in sorted(zs, key=lambda w: raw[w] - counts[w], reverse=True)[:rem]:
        counts[z] += 1
    for z in zs:
        if counts[z] == 0:
            donor = max(zs, key=lambda w: counts[w])
            counts[donor] -= 1
            counts[z] = 1
    return counts


def validate_fine_tune_args(args, zs):
    """Parse-time validation of the spectral fine-tune flag combination;
    returns (shares, auto_boost). Depends only on argv-derived values, so
    a bad combination fails before any data, model or device work."""
    stratify = args.pk_loss_weight > 0
    # "--z-boost 0:2,0.5:1" gives redshift 0 two batch shares per share of
    # every other z; gate selection still scores all redshifts
    shares = {z: 1 for z in zs}
    auto_boost = 0
    if args.z_boost:
        if args.z_boost.split(":")[0] == "auto":
            # re-targeted to the binding redshift(s) at every eval
            try:
                auto_boost = (int(args.z_boost.split(":", 1)[1])
                              if ":" in args.z_boost else 2)
            except ValueError:
                raise SystemExit(
                    f"--z-boost {args.z_boost!r}: 'auto' takes a single "
                    f"integer share count ('auto' or 'auto:K'); it cannot "
                    f"be mixed with static z:share entries")
            if auto_boost < 2:
                raise SystemExit("--z-boost auto:K needs K >= 2 "
                                 "(K=1 is a no-op)")
            if not args.eval_every:
                raise SystemExit("--z-boost auto re-targets at each eval; "
                                 "it needs --eval-every")
        else:
            for part in args.z_boost.split(","):
                zstr, w = part.split(":")
                zval = float(zstr)
                if zval not in shares:
                    raise SystemExit(f"--z-boost: z={zstr} not in "
                                     f"--redshifts")
                shares[zval] = int(w)
    n_shares = sum(shares.values())
    if stratify and not auto_boost and args.batch % n_shares:
        raise SystemExit(f"--batch {args.batch} must be divisible by the "
                         f"total z shares ({n_shares}) for the per-z "
                         f"spectral loss")
    if stratify and args.batch < len(zs):
        raise SystemExit(f"--batch {args.batch} < {len(zs)} redshifts: the "
                         f"per-z spectral loss needs every z in every batch")
    if args.z_boost and not stratify:
        raise SystemExit("--z-boost only takes effect with the stratified "
                         "spectral fine-tune (--pk-loss-weight > 0); "
                         "without it batches are sampled uniformly and the "
                         "flag would be silently ignored")
    return shares, auto_boost


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="cvae", choices=["cvae", "cgan"])
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--redshifts", default="0,0.5,1",
                   help="comma-separated training/eval redshifts")
    p.add_argument("--n-stack", type=int, default=4,
                   help="synthetic stacks per (field, z, depth); the first "
                        "is held out for validation")
    p.add_argument("--n-samples", type=int, default=30000)
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--scan", type=int, default=25)
    p.add_argument("--lr", type=float, default=None,
                   help="base learning rate (default: 1e-3 for the CVAE)")
    p.add_argument("--beta-kl", type=float, default=1.0)
    p.add_argument("--alpha-var", type=float, default=1.0)
    p.add_argument("--pressure-noise", type=float, default=0.1)
    p.add_argument("--physical", action="store_true",
                   help="the BAHAMAS-like synthetic statistics (powerlaw-"
                        "lognormal density, growth-like z evolution, "
                        "smoothed pressure with correlated scatter)")
    p.add_argument("--upsample", default="transpose",
                   choices=["transpose", "resize"])
    p.add_argument("--dm-transform", default="shift-log:4",
                   help="range-compression spec 'mode:k' (or 'mode:k1,k2')")
    p.add_argument("--pressure-transform", default="shift-log:4",
                   help="like --dm-transform, for the pressure field; on "
                        "--resume/--eval-only the checkpoint meta's "
                        "transforms override both flags")
    p.add_argument("--pk-loss-weight", type=float, default=0.0,
                   help="weight of the spectral auxiliary loss "
                        "(TrainConfig.pk_loss_weight); useful values are "
                        "~1e4-1e6")
    p.add_argument("--train-dtype", default="bf16", choices=["bf16", "f32"],
                   help="compute dtype of the training model; the 'model' "
                        "gate leg paints in it")
    p.add_argument("--gate-dtype", default="both",
                   choices=["model", "f32", "both"],
                   help="compute dtype(s) the gate paints with: 'model' "
                        "(bf16), 'f32' (pinned f32), 'both' (score and "
                        "select on the worst)")
    p.add_argument("--adv-weight", type=float, default=1.0,
                   help="CGAN: weight of the adversarial term "
                        "(CGANTrainConfig.adversarial_weight; 0 = the "
                        "calibration mode)")
    p.add_argument("--perc-weight", type=float, default=2.5,
                   help="CGAN: lambda_perceptual")
    p.add_argument("--z-boost", default=None,
                   help="z:shares batch weighting for the spectral "
                        "fine-tune, e.g. '0:2', or 'auto'/'auto:K'")
    p.add_argument("--feature-matching", action="store_true",
                   help="CGAN: feature matching for G's adversarial term")
    p.add_argument("--reinit-d", type=int, default=None, metavar="SEED",
                   help="CGAN --resume only: re-initialise the "
                        "discriminator (and its Adam) after the restore")
    p.add_argument("--freeze-bn", action="store_true",
                   help="keep the batch-norm running statistics at their "
                        "restored values (TrainConfig.freeze_bn_stats)")
    p.add_argument("--clip-grad", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=None,
                   help="where the synthetic stacks and the checkpoint go "
                        "(default: bpt_fidelity in the temporary directory)")
    p.add_argument("--resume", action="store_true",
                   help="restore the checkpoint from a previous run")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate the per-z gate every N training steps "
                        "and keep the best-scoring state")
    p.add_argument("--select-within-run", action="store_true",
                   help="with --resume --eval-every: do not seed the "
                        "selection with the restored state's score")
    p.add_argument("--eval-tiles", type=int, default=48,
                   help="validation tiles per redshift for each gate eval")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the checkpoint and report the P(k) errors "
                        "without training (implies --resume)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint base path to restore (default: "
                        "<workdir>/fidelity_model_<model>)")
    p.add_argument("--save-figures", action="store_true",
                   help="save the validation figures (sample, P(k), "
                        "histogram) into --workdir (needs matplotlib)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.lr is None:
        args.lr = 1e-3 if args.model == "cvae" else 5e-5
    if args.workdir is None:
        import tempfile
        args.workdir = os.path.join(tempfile.gettempdir(), "bpt_fidelity")
    return args


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_transform(spec):
    from baryon_painter_tpu_torch.transforms import RangeCompress
    mode, _, kstr = spec.partition(":")
    if not kstr:
        raise SystemExit(f"transform spec {spec!r}: expected 'mode:k'")
    k = (tuple(float(x) for x in kstr.split(","))
         if "," in kstr else float(kstr))
    return RangeCompress(mode, k, eps=1e-4)


def datasets(args, transforms):
    """(training, validation) datasets on the synthetic stacks of the
    flags: the first stack held out for validation."""
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    physical_kw = (dict(spectrum="powerlaw", sigma0=1.2, pressure_smooth=2.0,
                        pressure_noise_corr=2.0) if args.physical else {})
    info = make_synthetic_stacks(args.workdir, n_stack=args.n_stack,
                                 n_grid=2 * args.tile,
                                 redshifts=redshifts_of(args),
                                 seed=args.seed, name="fid",
                                 pressure_noise=args.pressure_noise,
                                 **physical_kw)
    train_ds = BahamasTileDataset(files=load_file_info(info),
                                  root_path=args.workdir, n_tile=2,
                                  n_stack=args.n_stack - 1, stack_offset=1,
                                  tile_permutations=True,
                                  transforms=transforms)
    val_ds = BahamasTileDataset(data=train_ds.data, n_stack=1,
                                stack_offset=0, n_tile=2,
                                tile_permutations=True,
                                transforms=transforms)
    return train_ds, val_ds


def redshifts_of(args):
    return tuple(float(s) for s in args.redshifts.split(","))


def _has_transpose(tree):
    return any("ConvTranspose" in k
               or (isinstance(v, dict) and _has_transpose(v))
               for k, v in tree.items())


def restored_meta(args, ckpt_base):
    """The checkpoint's meta when restoring (else None): its transforms
    override the flags' and, for the CGAN, its upsample mode (or, in a
    meta without one, the mode its state's kernels show) overrides
    ``--upsample``."""
    from baryon_painter_tpu_torch.train import checkpoint as ckpt
    if not ((args.resume or args.eval_only)
            and os.path.exists(ckpt_base + "_meta.json")):
        return None
    with open(ckpt_base + "_meta.json") as f:
        meta = json.load(f)
    arch = meta.get("model_architecture")
    if args.model == "cgan" and arch is not None:
        if "upsample" in arch:
            sniffed = arch["upsample"]
        elif os.path.exists(ckpt_base + "_state.msgpack"):
            state, _ = ckpt.load_checkpoint(ckpt_base)
            sniffed = ("transpose"
                       if _has_transpose(state.get("g_params", state))
                       else "resize")
        else:
            sniffed = args.upsample
        if sniffed != args.upsample:
            _log(f"note: checkpoint generator is upsample={sniffed!r}; "
                 f"overriding --upsample")
            args.upsample = sniffed
    return meta


def gate_legs(args, model_dtype):
    """The (label, painter dtype) legs of ``--gate-dtype``: "f32" pinned
    f32 (the JAX script's 'highest' precision), "model" the model's
    dtype. With an f32 model the legs paint alike and "both" keeps f32."""
    legs = {"model": [("model", model_dtype)], "f32": [("f32", None)],
            "both": [("f32", None), ("model", model_dtype)]}[args.gate_dtype]
    if len(legs) > 1 and model_dtype is None:
        legs = legs[:1]
    return legs


def setup(args, data=None):
    """What a gate run works on, as a namespace: the synthetic datasets of
    ``args`` (``train_ds``, ``val_ds``; ``data`` passes them in instead,
    as a caller that holds them already does), the model restored or built
    (the checkpoint's meta sets the architecture, transforms and CGAN
    upsample mode; ``trainer``), the painter factory ``make_painter(dtype)``
    over the model's current weights (``fused=False``: the library's
    convolutions in place of K1 and K3) and the gate's dtype ``legs``. With
    ``--eval-only`` no trainer is built: the painters take the
    checkpoint's weights and the training set's transform statistics, as
    the JAX script's painter does through its trainer."""
    import torch

    from baryon_painter_tpu_torch.convert import to_jax_variables
    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.models.cgan import CGANGenerator
    from baryon_painter_tpu_torch.painter import CGANPainter, CVAEPainter
    from baryon_painter_tpu_torch.train import checkpoint as ckpt
    from baryon_painter_tpu_torch.train.cgan import (CGANTrainConfig,
                                                     CGANTrainer)
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    from baryon_painter_tpu_torch.transforms import transform_from_dict
    from baryon_painter_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    _log(f"device: {device}"
         + (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))
    ckpt_base = (args.checkpoint if args.checkpoint is not None
                 else os.path.join(args.workdir,
                                   f"fidelity_model_{args.model}"))
    transforms = {"dm": parse_transform(args.dm_transform),
                  "pressure": parse_transform(args.pressure_transform)}
    meta = restored_meta(args, ckpt_base)
    if meta is not None and meta.get("transforms"):
        restored = {f: transform_from_dict(d)
                    for f, d in meta["transforms"].items()}
        if restored != transforms:
            _log(f"note: using the checkpoint's transforms "
                 f"{ {f: t.to_dict() for f, t in restored.items()} } "
                 f"over the CLI flags")
        transforms = restored
    train_ds, val_ds = data or datasets(args, transforms)
    meta_arch = meta.get("model_architecture") if meta else None
    have_state = os.path.exists(ckpt_base + "_state.msgpack")
    if args.eval_only and not have_state:
        raise SystemExit(f"--eval-only: no checkpoint at {ckpt_base}")
    if (not (args.resume or args.eval_only) and args.checkpoint is not None
            and have_state):
        raise SystemExit(
            f"checkpoint {ckpt_base} exists; pass --resume to continue from "
            f"it or --eval-only to score it (refusing to overwrite with a "
            f"fresh-seed run)")
    trainer = None
    restoring = (args.resume or args.eval_only) and have_state
    if restoring and args.reinit_d is not None and (
            args.model != "cgan" or args.eval_only):
        raise SystemExit("--reinit-d needs --model cgan --resume")
    if args.model == "cvae":
        arch = (meta_arch if meta_arch is not None else
                fiducial_cvae_architecture(tile_size=args.tile,
                                           n_res_blocks=4,
                                           upsample=args.upsample))
        model_dtype = torch.bfloat16 if args.train_dtype == "bf16" else None
        if args.eval_only:
            state, _ = ckpt.load_checkpoint(ckpt_base)
            weights = {"params": state["params"],
                       "batch_stats": state.get("batch_stats", {})}
            variables = lambda: weights
            _log("restored checkpoint")
            if args.save_figures:
                # the figures' trainer (validate), on the checkpoint
                trainer = CVAETrainer(
                    CVAE(arch, dtype=model_dtype, fused_heads=os.environ.get(
                        "BPT_FUSED_HEADS") == "1"),
                    train_ds, test_data=val_ds,
                    config=TrainConfig(seed=args.seed), variables=weights,
                    device=device)
        else:
            trainer = CVAETrainer(
                CVAE(arch, dtype=model_dtype,
                     fused_heads=os.environ.get("BPT_FUSED_HEADS") == "1"),
                train_ds,
                config=TrainConfig(seed=args.seed,
                                   pk_loss_weight=args.pk_loss_weight,
                                   pk_loss_per_z=args.pk_loss_weight > 0,
                                   freeze_bn_stats=args.freeze_bn,
                                   clip_grad_norm=args.clip_grad),
                device_data=True, device=device)
            if args.resume and have_state:
                trainer.restore(ckpt_base)
                _log("restored checkpoint")
            variables = lambda: to_jax_variables(trainer.model)
        paint_meta = ckpt.meta_from_dataset(train_ds, arch)

        def make_painter(dtype, fused=True):
            return CVAEPainter(variables=variables(), meta=paint_meta,
                               fused_inference=fused, fused_heads=fused,
                               dtype=dtype, seed=args.seed, device=device)
    else:
        # the "model" leg paints the CGAN in bf16, as the committed reports
        # score it; the CGAN trains in f32
        model_dtype = torch.bfloat16
        gen_kw = {"upsample": args.upsample}
        if meta_arch is not None:
            gen_kw.update(in_channels=meta_arch.get("in_channels", 2),
                          n_res_blocks=meta_arch.get("n_res_blocks", 9))
        if args.eval_only:
            state, _ = ckpt.load_checkpoint(ckpt_base)
            arch = dict(meta_arch or {}, upsample=args.upsample)
            variables = {"params": state["g_params"],
                         "batch_stats": state.get("g_stats", {})}
            paint_meta = ckpt.meta_from_dataset(train_ds, arch,
                                                model_kind="cgan")
            _log("restored checkpoint")
            if args.save_figures:
                # the figures' trainer (validate), on the checkpoint
                trainer = CGANTrainer(
                    train_ds, test_data=val_ds,
                    generator=CGANGenerator(spectral_norm=True, **gen_kw),
                    config=CGANTrainConfig(seed=args.seed,
                                           batch_size=args.batch),
                    device=device)
                trainer.restore(ckpt_base)

            def make_painter(dtype, fused=True):
                return CGANPainter(variables=variables, meta=paint_meta,
                                   fused_inference=fused, dtype=dtype,
                                   device=device)
        else:
            trainer = CGANTrainer(
                train_ds, test_data=val_ds,
                generator=CGANGenerator(spectral_norm=True, **gen_kw),
                config=CGANTrainConfig(
                    seed=args.seed, batch_size=args.batch,
                    pk_loss_weight=args.pk_loss_weight,
                    pk_loss_per_z=args.pk_loss_weight > 0,
                    adversarial_weight=args.adv_weight,
                    lambda_perceptual=args.perc_weight,
                    feature_matching=args.feature_matching,
                    freeze_bn_stats=args.freeze_bn,
                    clip_grad_norm=args.clip_grad),
                device_data=True, device=device)
            if restoring:
                trainer.restore(ckpt_base)
                _log("restored checkpoint")
                if args.reinit_d is not None:
                    trainer.reinit_discriminator(args.reinit_d)
                    _log(f"discriminator re-initialised (seed "
                         f"{args.reinit_d})")

            def make_painter(dtype, fused=True):
                return CGANPainter.from_trainer(trainer, dtype=dtype,
                                                fused_inference=fused)

    return SimpleNamespace(train_ds=train_ds, val_ds=val_ds, trainer=trainer,
                           make_painter=make_painter, ckpt_base=ckpt_base,
                           have_state=have_state,
                           legs=gate_legs(args, model_dtype))


def main(argv=None, data=None):
    """Run the gate of ``argv``; ``data`` ((training, validation)
    datasets) replaces the synthetic stacks the flags describe, as
    ``setup`` takes it. Prints and returns the JSON report."""
    args = parse_args(argv)
    redshifts = redshifts_of(args)
    shares, auto_boost = validate_fine_tune_args(args, list(redshifts))
    if args.save_figures:
        from baryon_painter_tpu_torch.utils.validation_plotting import \
            require_matplotlib
        require_matplotlib()

    import torch

    from baryon_painter_tpu_torch.train.stats import TrainingStats

    g = setup(args, data)
    train_ds, val_ds, trainer = g.train_ds, g.val_ds, g.trainer
    make_painter, legs = g.make_painter, g.legs
    ckpt_base, have_state = g.ckpt_base, g.have_state
    painter = make_painter(legs[0][1])
    auto0, cross0, diag0 = pk_errors(painter, val_ds, seed=args.seed,
                                     n_sample=args.eval_tiles)
    _log(f"untrained: auto={auto0:.3f} cross={cross0:.3f} {diag0}")

    rng = np.random.default_rng(args.seed + 1)
    n_steps = 0 if args.eval_only else args.n_samples // args.batch
    zs = list(train_ds.redshifts)
    stratify = args.pk_loss_weight > 0

    def step_indices():
        if not stratify:
            return train_ds.sample_indices(rng, args.batch)
        counts = allocate_batch_shares(args.batch, shares, zs)
        return np.concatenate([train_ds.sample_indices(rng, counts[z], z=z)
                               for z in zs])

    cgan = args.model == "cgan"
    # the CGAN's statistics columns: the trainer's own, less its lr and
    # batch size
    terms = list(trainer.stats_labels()[:-2]) if (cgan and trainer) else None
    stats = None
    if not args.eval_only:
        labels = (list(terms) if cgan
                  else list(trainer.model.get_stats_labels()))
        # a file per phase: the fine-tune adds a column, and a resumed
        # TrainingStats needs an identical header
        suffix = "_pkft" if stratify else ""
        if stratify:
            labels.append("pk_loss")
        stats_file = os.path.join(args.workdir,
                                  f"training_stats_{args.model}{suffix}.txt")
        stats = TrainingStats(labels, dump_to_file_frequency=200,
                              stats_filename=stats_file,
                              resume=args.resume
                              and os.path.exists(stats_file))
    sample_base = (stats.n_processed_samples[-1]
                   if stats is not None and stats.n_processed_samples else 0)

    def record(m, k, done):
        if stats is None:
            return
        if cgan:
            parts = [m[key].reshape(k, -1) for key in terms]
        else:
            parts = [m["elbo"].reshape(k, -1), -m["kl"].reshape(k, -1),
                     m["log_likelihood"].reshape(k, -1)]
        if "log_likelihood_fixed_var" in m:
            parts += [m["log_likelihood_fixed_var"].reshape(k, -1),
                      m["log_likelihood_free_var"].reshape(k, -1)]
        if stratify:
            parts.append(m["pk_loss"].reshape(k, -1))
        rows = torch.cat([p.detach().float() for p in parts],
                         dim=1).cpu().numpy()
        for i in range(k):
            stats.push_loss(sample_base + (done + i + 1) * args.batch,
                            *[float(v) for v in rows[i]])

    def gate_metric(return_per_z=False):
        """max over gate dtypes and z of max(auto, cross)."""
        worst, per_z = 0.0, {}
        for _, dt in legs:
            p = make_painter(dt)
            for z in val_ds.redshifts:
                az, cz, _ = pk_errors(p, val_ds, seed=args.seed, z=z,
                                      n_sample=args.eval_tiles)
                per_z[z] = max(per_z.get(z, 0.0), az, cz)
                worst = max(worst, az, cz)
        return (worst, per_z) if return_per_z else worst

    def retarget_boost(per_z, worst):
        binding = {z for z, v in per_z.items() if v >= 0.8 * worst}
        new = {z: (auto_boost if z in binding else 1) for z in zs}
        if new == shares:
            return ""
        shares.update(new)
        return "  boost-> " + ",".join(f"z={z:g}" for z in sorted(binding))

    def snapshot():
        if cgan:
            return trainer.state_tree()
        opt = trainer.optimizer
        return copy.deepcopy({
            "model": trainer.model.state_dict(), "mu": opt.mu, "nu": opt.nu,
            "count": opt.count, "step": trainer.steps})

    @torch.no_grad()
    def load_snapshot(s):
        if cgan:
            trainer._load_state(s)
            return
        trainer.model.load_state_dict(s["model"])
        for dst, src in zip(trainer.optimizer.mu + trainer.optimizer.nu,
                            s["mu"] + s["nu"]):
            dst.copy_(src)
        trainer.optimizer.count = s["count"]
        trainer._host_step = s["step"]

    dataset_geometry = {
        "tile": args.tile, "redshifts": args.redshifts,
        "n_stack": args.n_stack, "physical": bool(args.physical),
        "pressure_noise": args.pressure_noise, "seed": args.seed}

    def save_with_geometry(base):
        trainer.save(base)
        fn = base + "_meta.json"
        with open(fn) as f:
            meta_d = json.load(f)
        meta_d["fidelity_dataset"] = dataset_geometry
        with open(fn, "w") as f:
            json.dump(meta_d, f, indent=1)

    best = (float("inf"), None)
    if (args.eval_every and args.resume and n_steps
            and not args.select_within_run and have_state):
        worst0, per_z0 = gate_metric(return_per_z=True)
        best = (worst0, snapshot())
        mark0 = retarget_boost(per_z0, worst0) if auto_boost else ""
        _log(f"  eval @ start: gate = {best[0]:.4f} (selection floor)"
             f"{mark0}")

    def maybe_eval(done):
        nonlocal best
        if not args.eval_every or done % args.eval_every >= args.scan:
            return
        worst, per_z = gate_metric(return_per_z=True)
        mark = ""
        if worst < best[0]:
            best = (worst, snapshot())
            save_with_geometry(ckpt_base + "_best")
            mark = "  <- best (saved)"
        if auto_boost:
            mark += retarget_boost(per_z, worst)
        _log(f"  eval @ {done}: gate max_z max(auto,cross) = "
             f"{worst:.4f}{mark}")

    t0 = time.time()
    done = 0
    gn_window_max = 0.0
    while done < n_steps:
        k = min(args.scan, n_steps - done)
        idx = np.stack([step_indices() for _ in range(k)])
        if cgan:
            # lr 5e-5 decayed 0.85 per 1568-sample pepoch; with the
            # spectral fine-tune on, --lr as it is
            lr = (args.lr if stratify
                  else args.lr * 0.85 ** (done * args.batch // 1568))
            m = trainer.step_scan(idx, lr=lr)
            record(m, k, done)
            m = {"elbo": m["loss_G_adv"], "grad_norm": m["grad_norm"]}
        else:
            # fiducial-style step decay over the run
            lr = args.lr * (0.5 ** (4 * done // n_steps))
            m = trainer.step_scan(idx, lr=lr, alpha_var=args.alpha_var,
                                  beta_KL=args.beta_kl)
            record(m, k, done)
        done += k
        maybe_eval(done)
        gn_window_max = max(gn_window_max, float(m["grad_norm"].max()))
        if done % (args.scan * 8) < args.scan:
            rate = done * args.batch / (time.time() - t0)
            _log(f"step {done}/{n_steps} "
                 f"elbo={float(m['elbo'].reshape(-1)[-1]):.3e} "
                 f"|g|={float(m['grad_norm'].reshape(-1)[-1]):.2e} "
                 f"(window max {gn_window_max:.2e}) "
                 f"({rate:.0f} samples/s)")
            gn_window_max = 0.0

    if not args.eval_only:
        if args.eval_every and n_steps:
            final = gate_metric()
            _log(f"  eval @ end: gate = {final:.4f} "
                 f"(best seen {best[0]:.4f})")
            if best[1] is not None and best[0] < final:
                load_snapshot(best[1])
                _log("  restored best-gate parameters")
        save_with_geometry(ckpt_base)
        stats.flush_to_file()
    if args.save_figures:
        if trainer.test_data is None:
            trainer.test_data = val_ds
        trainer.validate(save_plots=True, filename_template=os.path.join(
            args.workdir, f"{args.model}_{{plot_type}}.png"))
        _log(f"figures saved in {args.workdir}")
    painter = make_painter(legs[0][1])
    auto1, cross1, diag1 = pk_errors(painter, val_ds, seed=args.seed,
                                     n_sample=args.eval_tiles)
    # the gate is per redshift, and under --gate-dtype both it must hold
    # for every compute dtype
    per_z_by_dtype = {}
    for label, dt in legs:
        p = painter if dt == legs[0][1] else make_painter(dt)
        d = {}
        for z in val_ds.redshifts:
            az, cz, _ = pk_errors(p, val_ds, seed=args.seed, z=z,
                                  n_sample=args.eval_tiles)
            d[f"{z:g}"] = {"auto": round(az, 4), "cross": round(cz, 4)}
        per_z_by_dtype[label] = d
    per_z = per_z_by_dtype[legs[0][0]]
    dt = time.time() - t0
    report = {
        "metric": "pk_fractional_error_after_training",
        "model": args.model,
        "auto_untrained": round(auto0, 4), "cross_untrained": round(cross0, 4),
        "auto": round(auto1, 4), "cross": round(cross1, 4),
        "n_samples": 0 if args.eval_only else args.n_samples,
        "tile": args.tile,
        "physical_stats": bool(args.physical),
        "train_seconds": 0.0 if args.eval_only else round(dt, 1),
        "samples_per_sec": (0.0 if args.eval_only
                            else round(args.n_samples / dt, 1)),
        "auto_clipped": round(diag1["auto_clipped"], 4),
        "mean_ratio": round(diag1["mean_ratio"], 4),
        "std_ratio": round(diag1["std_ratio"], 4),
        "gate_dtype": args.gate_dtype,
        "per_z": per_z,
        **({"per_z_by_dtype": per_z_by_dtype} if len(legs) > 1 else {}),
        "pass_5pct": bool(all(v["auto"] < 0.05 and v["cross"] < 0.05
                              for d in per_z_by_dtype.values()
                              for v in d.values())),
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
