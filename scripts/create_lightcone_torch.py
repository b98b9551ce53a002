#!/usr/bin/env python
"""SLICS lightcone painting CLI of the PyTorch port.

The twin of ``scripts/create_lightcone.py``, with its flags and defaults:
paints the SLICS shells of one line of sight with a committed CVAE
(``--CVAE-path``; bf16 by default, ``--fused-paint`` for K1's fused residual
blocks, ``BPT_FUSED_HEADS=1`` for K3's fused output heads) or CGAN
(``--model-type CGAN --CGAN-path``; f32 by default, ``--fused-paint`` folds
its spectral norm and runs its residual blocks through K1), tiled or, with
``--seamless``, each delta shell as one whole plane; assembles the
Compton-y map (``--output-file``, .npy) and, with ``--kappa-path``, its
cross angular power spectrum with the SLICS convergence map
(``<output-file>_y_x_kappa.npz``):

    python scripts/create_lightcone_torch.py --CVAE-path \
        trained_models/CVAE/fiducial-512 --SLICS-base-path <dir> \
        --SLICS-LOS 74 --output-file y_map --fused-paint

``<dir>`` holds ``delta/``, ``massplanes/`` and ``random_shifts/`` as the
SLICS release lays them out. Runs on the card unless ``--device cpu``.
``--mesh-devices N`` shards every shell's tile batches (or, with
``--seamless``, its plane's rows) over the first N cards and raises when
there are fewer. Imports only torch, numpy and the port.
"""
import argparse
import glob
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-type", default="CVAE",
                        choices=["CVAE", "CGAN"])
    parser.add_argument("--CVAE-path")
    parser.add_argument("--CGAN-path")
    parser.add_argument("--SLICS-base-path", required=True)
    parser.add_argument("--SLICS-LOS", required=True)
    parser.add_argument("--n-plane", default=15, type=int)
    parser.add_argument("--tile-overlap", default=0.2, type=float)
    parser.add_argument("--output-resolution", default=7745 // 5, type=int)
    parser.add_argument("--drop-planes")
    parser.add_argument("--output-file", required=True)
    parser.add_argument("--output-file-planes")
    parser.add_argument("--paint-batch-size", default=16, type=int)
    parser.add_argument("--mesh-devices", default=0, type=int,
                        help="shard the tile batches (seamless: the plane's "
                             "rows) over the first N cards; raises when "
                             "there are fewer")
    parser.add_argument("--paint-dtype", default=None,
                        choices=["bf16", "f32"],
                        help="compute dtype for painting; default bf16 for "
                             "the CVAE, f32 for the CGAN: the dtypes their "
                             "fidelity gates were scored in")
    parser.add_argument("--fused-paint", action="store_true",
                        help="paint the canonical residual blocks through "
                             "the fused residual-block kernel (K1); the CGAN's "
                             "spectral norm is folded into its weights")
    parser.add_argument("--seamless", action="store_true",
                        help="paint each delta shell as one fully "
                             "convolutional pass over the whole zoomed plane "
                             "instead of overlap-tiling and blending: no "
                             "seams, every pixel painted once")
    parser.add_argument("--bf16-transfer", action="store_true",
                        help="ship SLICS planes to the device as bfloat16 "
                             "(halves host-to-device bytes; promoted to f32 "
                             "on the device)")
    parser.add_argument("--kappa-path", default=None,
                        help="directory of SLICS convergence maps "
                             "(kappa_<survey>_tomo<i>.dat_LOS<los>); when "
                             "given, also compute the y x kappa pseudo-Cl "
                             "cross-spectrum and save it to "
                             "<output-file>_y_x_kappa.npz")
    parser.add_argument("--kappa-survey", default="KiDS450")
    parser.add_argument("--kappa-tomo", default=0, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--n-pixel-delta", default=7745, type=int,
                        help="pixels a side of the delta planes and the "
                             "convergence map (SLICS: 7745; smaller for a "
                             "cut-down synthetic line of sight)")
    parser.add_argument("--n-pixel-massplane", default=4096 * 3, type=int,
                        help="pixels a side of the massplanes (SLICS: "
                             "12288)")
    return parser.parse_args(argv)


def run(argv=None, stage_times=None, mesh=None) -> dict:
    """The CLI on an argument list; returns what it wrote and painted:
    ``y_map`` (numpy), ``planes`` (the painted planes: tensors on the
    device, numpy with ``--output-file-planes``), ``z_SLICS`` and, with
    ``--kappa-path``, ``cl_y_kappa`` (cl, ell, cl_var, n_mode as numpy). ``stage_times`` (a
    ``lightcone.pipeline.StageTimes``) marks each shell's stages, then
    ``ymap`` and ``cl``. ``mesh``: a ``parallel.mesh.DeviceMesh`` to paint
    over in place of ``--mesh-devices``' (its devices may repeat)."""
    args = parse_args(argv)
    import torch

    from baryon_painter_tpu_torch.cosmology import SLICS_COSMOLOGY
    from baryon_painter_tpu_torch.lightcone import (create_y_map,
                                                    process_slics)
    from baryon_painter_tpu_torch.painter import CGANPainter, CVAEPainter

    if mesh is None and args.mesh_devices:
        from baryon_painter_tpu_torch.parallel.mesh import data_parallel_mesh
        mesh = data_parallel_mesh(args.mesh_devices)
    if mesh is not None:
        print(f"Sharding the paint over {mesh.size} devices.")
    if args.paint_dtype is None:
        args.paint_dtype = "bf16" if args.model_type == "CVAE" else "f32"
    paint_dtype = torch.bfloat16 if args.paint_dtype == "bf16" else None
    if args.model_type == "CVAE":
        print("Using CVAE.")
        painter = CVAEPainter(
            os.path.join(args.CVAE_path, "model"),
            fused_inference=args.fused_paint,
            fused_heads=os.environ.get("BPT_FUSED_HEADS") == "1",
            dtype=paint_dtype, device=args.device)
    else:
        print("Using CGAN.")
        painter = CGANPainter(os.path.join(args.CGAN_path, "model"),
                              fused_inference=args.fused_paint,
                              dtype=paint_dtype, device=args.device)

    LOS = int(args.SLICS_LOS)
    delta_path = os.path.join(args.SLICS_base_path, "delta")
    massplane_path = os.path.join(args.SLICS_base_path, "massplanes")
    shifts_path = os.path.join(args.SLICS_base_path, "random_shifts")

    delta_files = glob.glob(
        os.path.join(delta_path, f"*delta.dat_bicubic_LOS{LOS}"))
    if not delta_files:
        raise RuntimeError(f"LOS {LOS} isn't complete.")
    z_SLICS = np.array(sorted(
        float(os.path.split(f)[1].split("delta")[0]) for f in delta_files))
    print("SLICS redshifts:", z_SLICS)

    cosmo = SLICS_COSMOLOGY()
    h = cosmo.h
    d_A_SLICS = cosmo.comoving_angular_distance(z_SLICS) * h  # Mpc/h
    z_slice = np.array([cosmo.redshift_of_chi(252.5 / h * i)
                        for i in range(len(z_SLICS))])

    n_z = args.n_plane
    print(f"Painting {n_z} of {len(z_SLICS)} planes, "
          f"overlap {args.tile_overlap}.")

    painted_planes = process_slics(
        painter, tile_size=100.0, n_pixel_tile=512, LOS=LOS,
        z_SLICS=z_SLICS[:n_z],
        delta_size=d_A_SLICS[:n_z] * 10 / 180 * np.pi,
        delta_path=delta_path, massplane_path=massplane_path,
        shifts_path=shifts_path, z_slice=z_slice[:n_z],
        min_tiling_overlap=args.tile_overlap,
        paint_batch_size=args.paint_batch_size,
        n_pixel_delta=args.n_pixel_delta,
        n_pixel_massplane=args.n_pixel_massplane,
        transfer_dtype=torch.bfloat16 if args.bf16_transfer else None,
        seamless=args.seamless, mesh=mesh,
        # keep the painted planes on the device unless they are written to
        # disk: create_y_map computes on the device
        device_output=not args.output_file_planes,
        stage_times=stage_times)

    res = args.output_resolution
    y_map = create_y_map(painted_planes, z_SLICS[:n_z], resolution=res,
                         map_size=10.0, cosmo=cosmo, order=5,
                         device=painter.device)
    if stage_times is not None:
        stage_times.mark("ymap")
    np.save(args.output_file, y_map)
    if args.drop_planes is not None:
        n_drop = int(args.drop_planes)
        y_drop = create_y_map(painted_planes[n_drop:], z_SLICS[n_drop:n_z],
                              resolution=res, map_size=10.0, cosmo=cosmo,
                              order=5, device=painter.device)
        np.save(args.output_file + f"_drop_{n_drop}", y_drop)
    if args.output_file_planes is not None:
        with open(args.output_file_planes, "wb") as f:
            pickle.dump(painted_planes, f)
    out = {"y_map": y_map, "planes": painted_planes, "z_SLICS": z_SLICS[:n_z]}

    if args.kappa_path is not None:
        from baryon_painter_tpu_torch.angular_power import pseudo_cl_2d
        from baryon_painter_tpu_torch.lightcone.io import (kappa_filename,
                                                           load_kappa_map)
        from baryon_painter_tpu_torch.ops.resample import zoom
        kappa = torch.as_tensor(load_kappa_map(
            kappa_filename(args.kappa_path, LOS, args.kappa_survey,
                           args.kappa_tomo), n_pixel=args.n_pixel_delta),
            device=painter.device)
        if kappa.shape[0] != res:
            # bring kappa to the y-map grid (notebook-style decimation is a
            # special case; B-spline order 1 handles any ratio)
            kappa = zoom(kappa, res / kappa.shape[0], order=1)
        cl = tuple(v.cpu().numpy() for v in pseudo_cl_2d(
            torch.as_tensor(y_map, device=painter.device), kappa,
            theta_deg=10.0))
        if stage_times is not None:
            stage_times.mark("cl")
        path = args.output_file + "_y_x_kappa.npz"
        np.savez(path, cl=cl[0], ell=cl[1], cl_var=cl[2], n_mode=cl[3])
        print(f"y x kappa cross-Cl saved to {path}")
        out["cl_y_kappa"] = cl
    return out


def main():
    run()


if __name__ == "__main__":
    main()
