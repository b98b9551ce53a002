#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100 is the target).

    python3 chip_smoke.py

Builds the kernels (K1, the fused residual block; K2, the training tile
gather; K3, the fused output heads forward and backward; K4, the fused
train-mode conv + batch norm + ReLU; csrc/*.cu) with
nvcc, holds each against its plain PyTorch version (K3-fwd also on the u1 it
keeps for K3-bwd in training), and drives the port's
two main paths on the card: painting the committed 512^2 golden through
``CVAEPainter(fused_inference=True)`` (K1 must launch exactly 4 times, and
with ``fused_heads=True`` K3-fwd once more), and training the fiducial CVAE
at batch 24 on synthetic stacks with the batch gathered on the card through
K2 and the heads through K3 (exactly one launch of each per step; painting
keeps no u1), with the step's peak device memory and a kernels-vs-plain
training step; then K4 (the fused train-mode conv + batch
norm + ReLU, four kernels) against its plain version at its four sites, the
same training with K4 too (exactly 4 launches of each K4 kernel per step)
and its kernels-vs-plain step, and the golden repainted with PyTorch's
default TF32 setting; then the bf16 configuration (the JAX package's
default compute dtype): K3-fwd and K3-bwd in bf16 against their plain bf16
versions, training in bf16 (exactly one K2 and one bf16 K3-fwd and K3-bwd
launch per step) with a kernels-vs-plain bf16 step, and the golden input
painted in bf16 (exactly 4 bf16 K1 and 1 bf16 K3-fwd launches) against the
committed JAX bf16 paint (tests/goldens/bf16_paint_reference.npz), then
timed; then K4 in bf16 against its plain bf16 version at its four sites,
training in bf16 with K4 (exactly 4 bf16 launches of each K4 kernel per
step, beside one K2 and one bf16 K3-fwd and K3-bwd) and a kernels-vs-plain
bf16 step with K4, beside how far the plain bf16 step moves when only its
sites' sums change order; then the f32 and bf16 kernels steps (K4 off and
on) against the whole-model f64 step under cuDNN's default algorithms, as
the training CLI runs them; then a synthetic SLICS line of sight at real sizes
(three shells, a 12288^2 massplane) through the lightcone CLI's own code
(scripts/create_lightcone_torch.py): the resampler against scipy at the
lightcone's sizes with TF32 on, the f32 lightcone with the kernels against
cuDNN's, and the CLI's default, bf16 with K1 and K3 (exactly 24 bf16 K1 and
6 bf16 K3-fwd launches), held to the bf16 cuDNN lightcone on the y map's
angular power spectrum, then timed stage by stage; then the CGAN painter
(phase 17): K1 against its plain version at the CGAN's shapes and slope
0.2, both CGAN goldens repainted through
``CGANPainter(fused_inference=True)`` (exactly 9 K1 launches a paint
call), the bf16 CGAN paint (exactly 9 bf16 K1 launches) against the
committed JAX bf16 paint (tests/goldens/bf16_cgan_paint_reference.npz),
the CGAN's paint timed at 16 tiles of 512^2 with K1 and with cuDNN's
blocks, and the lightcone CLI with ``--model-type CGAN --fused-paint``
(exactly 9 K1 launches a paint call) against the same run with plain
convolutions; then seamless whole-plane painting (phase 18): the halo
against twice it, a 1024^2 plane with cuDNN against plain convolutions,
and the lightcone CLI with ``--seamless``, timed; then the training run
(phase 19) through the training CLI's code (scripts/train_cvae_torch.py) at
full width with K2 and K3: ``train()`` over 3 pepochs of 96 samples with
validation, statistics, periodic checkpoints (exactly one K2, K3-fwd and
K3-bwd launch a step), timed against ``step_indices`` over the same
steps, a resume from the first checkpoint equal to the uninterrupted run,
the final checkpoint painted through ``load_painter`` and K1 (exactly 4
launches), and a bf16 run with K3 and K4 (4 bf16 launches of each K4
kernel a step) resumed bit for bit; then the P(k) fidelity gate (phase
20) through the gate's CLI code (scripts/fidelity_check_torch.py
``--eval-only``): the committed fiducial CVAE at 512^2 on 3 of its 11
redshifts (K1 4 and K3-fwd 1 launches a paint call) and the committed CGAN
(K1 9 a call), 48 tiles a redshift: the kernels' scores against plain
convolutions', the f32 scores at the JAX package's prior noise and over
noise seeds against the committed reports, the bf16 scores against the
JAX package's bf16 on the CPU (baryon_painter_tpu_torch/data/
gate_reference.npz; the CVAEs' also against its bf16 through its own fused
blocks and heads), and the committed reports' bf16 scores printed
beside the port's (both CGANs, fiducial and fiducial-adv); and the
spectral fine-tuning step at
batch 24 from the fiducial weights (exactly one K2, two K3-fwd and two
K3-bwd launches a step) in f32 and bf16, timed, against its plain version;
then CGAN training (phase 21) at full width from the committed
fiducial-adv state (G, D, both Adams) on the 512^2 stacks at batch 6, f32:
the step timed with its peak memory (exactly one K2 launch a step), the
f32 step against the same step in f64 and a K2 step against a
plain-gather step, one step in each mode (feature matching, calibration,
frozen statistics, the spectral term, a fresh discriminator), ``train()``
through the CGAN training CLI's code (scripts/train_cgan_torch.py) timed
beside ``step_indices`` and resumed bit for bit, the trained generator
painted through ``CGANPainter.from_trainer`` and K1 (exactly 9 launches a
call), and the gate twin's CGAN training leg; then the meshes (phase 23,
``baryon_painter_tpu_torch/smoke_mesh.py``): the training step under a
one-rank NCCL mesh equal bit for bit to the step without one, the same
step on two ranks sharing the card over gloo through the z-sharded stack
cache (12 rows a rank) held to the f64 step, each rank with the launches
of one step, the lightcone's tile batches sharded over two copies of the
painter on the card (K1 4 launches a shard), and a 1024^2 plane painted
over meshes of 2 (the halo ring) and 3 (the gather path), both against
the unsharded runs; then the last user-facing script twins (phase 24,
``baryon_painter_tpu_torch/smoke_scripts.py``): the gate's bootstrap
(``scripts/gate_variance_torch.py``) painting 192 tiles of 512^2 a
redshift in one call through K1 and K3-fwd (bf16, exactly 4 K1 and 1
K3-fwd launches a call) on phase 20d's stacks of the physical-512-lt-wip
CVAE, against the same calls with the kernels off; the per-bin P(k)
diagnostic (``scripts/pk_diagnose_torch.py``) of a bf16 trainer
checkpoint through K1 and K3-fwd; the transforms' examples on the card
against the CPU; and the promotion of that checkpoint
(``scripts/promote_checkpoint_torch.py``) with its re-evaluation on the
card.
Everything is timed.
The phases live in ``baryon_painter_tpu_torch/smoke.py``; each prints one
line with its seconds. The last lines are the kernels record (JSON), the
card's name and power limit as nvidia-smi gives them, and the result (JSON).
Any failed phase raises and the script exits non-zero; without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.

Imports only torch, numpy and the port.
"""
import json
import sys
import time


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    try:
        from baryon_painter_tpu_torch import smoke, smoke_mesh, smoke_scripts
    except ImportError as e:
        print(f"chip_smoke: the baryon_painter_tpu_torch package is not "
              f"importable here ({e}); run from the repository root",
              file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    env = smoke.environment(device)
    card = env["nvidia_smi"]
    smoke.build_kernels(device)
    checks = smoke.check_kernels(device)
    paint = smoke.paint_golden(device)
    timing = smoke.time_main_path(device, paint["painter"], card=card)
    dataset = smoke.training_data()
    gather = smoke.check_gather(device, dataset)
    heads = smoke.check_heads(device)
    training = smoke.train(device, dataset, card=card)
    smoke.train_parity(device, dataset)
    fused_paint = smoke.paint_fused_heads(device, card=card,
                                          heads_unfused_ms=timing["paint_ms"])
    conv_bn = smoke.check_conv_bn(device, card=card)
    training_k4 = smoke.train(device, dataset, card=card,
                              fused_train_conv=True,
                              k4_off_ms=training["step_ms"])
    smoke.train_parity(device, dataset, fused_train_conv=True)
    smoke.paint_tf32(device)
    # bf16, the JAX package's default compute dtype
    heads_bf16 = smoke.check_heads(device, dtype=torch.bfloat16)
    training_bf16 = smoke.train(device, dataset, card=card,
                                dtype=torch.bfloat16,
                                f32_ms=training["step_ms"])
    smoke.train_parity_bf16(device, dataset)
    paint_bf16 = smoke.paint_bf16(device, card=card,
                                  f32_ms=fused_paint["paint_ms"])
    conv_bn_bf16 = smoke.check_conv_bn(device, card=card,
                                       dtype=torch.bfloat16)
    training_bf16_k4 = smoke.train(device, dataset, card=card,
                                   dtype=torch.bfloat16,
                                   fused_train_conv=True,
                                   k4_off_ms=training_bf16["step_ms"],
                                   f32_ms=training_k4["step_ms"])
    smoke.train_parity_bf16(device, dataset, fused_train_conv=True)
    # the kernels steps against f64 under cuDNN's default algorithms (15c)
    smoke.train_parity_f64(device, dataset, card=card)
    # the paint path's consumer: a SLICS lightcone through the lightcone
    # CLI, with the CVAE (16), the CGAN (17) and whole planes (18)
    with smoke.synthetic_lightcone(device) as data:
        lightcone = smoke.lightcone(
            device, data, card=card,
            paint_tiles_per_s=paint_bf16["tiles_per_s"])
        cgan = smoke.cgan(device, data, card=card)
        smoke.seamless(device, data, lightcone["bf16"]["cudnn"], card=card)
        # the meshes' painting on this LOS (23c) and a whole plane (23d)
        mesh_paint = smoke_mesh.lightcone_sharded(device, data)
        smoke_mesh.planes_sharded(device)
    # the training run through the training CLI's code (19)
    train_loop = smoke.train_loop(device, dataset, card=card)
    # 20d keeps the lt-wip CVAE's stacks for phase 24
    with smoke_scripts.gate_stacks() as keep:
        # the P(k) fidelity gate (20a, 20b, 20d) and the spectral step (20c)
        gate = smoke.gate(device, card=card, keep=keep)
        pk = smoke.pk_step(device, dataset, card=card,
                           f32_ms=training["step_ms"],
                           bf16_ms=training_bf16["step_ms"])
        # CGAN training (21), its gate leg on 20b's fiducial-adv stacks
        cgan_train = smoke.cgan_train(device, dataset, gate, card=card)
        # the run tooling (22): --profile, validate's figures, the stats
        # twin on phase 19's run, BatchLoader(raw=False)
        tooling = smoke.tooling(device, dataset, train_loop, card=card)
        # the meshes' training (23a: one rank over NCCL; 23b: two ranks on
        # the card over gloo)
        mesh_one = smoke_mesh.world_of_one(device, dataset)
        mesh_two = smoke_mesh.two_ranks(device, dataset, card=card)
        # the last user-facing script twins (24) on 20d's stacks
        scripts = smoke_scripts.scripts(device, keep=keep, card=card)
    print(f"total {time.perf_counter() - t_start:.3f} s (card: {card})",
          flush=True)
    record = smoke.kernels_record(
        checks, paint, timing, gather, heads, training, conv_bn, training_k4,
        heads_bf16=heads_bf16, paint_bf16=paint_bf16,
        training_bf16=training_bf16, conv_bn_bf16=conv_bn_bf16,
        training_bf16_k4=training_bf16_k4, lightcone=lightcone, cgan=cgan,
        train_loop=train_loop, gate_run=gate, pk=pk,
        cgan_train=cgan_train, tooling=tooling,
        mesh={"paint": mesh_paint, "one": mesh_one, "two": mesh_two})
    smoke_scripts.add_launches(record, scripts)
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
