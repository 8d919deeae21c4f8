"""CLI twin of ``short_axis/eval_strain_sax.py`` — SA strain on the card.

The JAX CLI's flags (``ukbb_cardiac_tpu/cli/eval_strain_sax.py``) plus
``--device`` (default ``cuda``; without a card it raises unless
``--device cpu`` is given).  ``--par_dir`` works drop-in: a
``ffd_cine_2d_motion.cfg`` there is parsed into the registration config.
``--mesh_devices n`` (n > 1) splits each subject's registration pairs
over ``make_mesh(n, device=--device)``: n cards, or n CPU replicas with
``--device cpu``.

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.eval_strain_sax \
      --data_dir <dir> --output_csv <csv>
"""

from __future__ import annotations

import argparse
import os
import shutil

import pandas as pd

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.phenotype.qc import sa_pass_quality_control
from ukbb_cardiac_tpu_torch.phenotype.strain import (finish_sa_motion,
                                                     start_sa_motion_dispatch)
from ukbb_cardiac_tpu_torch.reg.register import RegConfig

COLUMNS = ([f"Ecc_AHA_{i} (%)" for i in range(1, 17)] + ["Ecc_Global (%)"] +
           [f"Err_AHA_{i} (%)" for i in range(1, 17)] + ["Err_Global (%)"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", metavar="dir_name", required=True)
    parser.add_argument("--output_csv", metavar="csv_name", required=True)
    parser.add_argument("--par_dir", metavar="dir_name", default="",
                        help="Directory of MIRTK parameter files; "
                             "ffd_cine_2d_motion.cfg (if present) is "
                             "parsed into the registration config.")
    parser.add_argument("--eval_dice", action="store_true",
                        help="Warp each frame's segmentation to ED and "
                             "record the Dice (the reference's dormant "
                             "self-check, cardiac_utils.py:944-967).")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="Split each subject's registration pair "
                             "population over this many devices of "
                             "--device (0 = one).")
    parser.add_argument("--start_idx", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None
    if args.mesh_devices > 1:
        from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh_devices, device=args.device)

    cfg = RegConfig.cine_2d_motion()
    par_path = os.path.join(args.par_dir, "ffd_cine_2d_motion.cfg")
    if args.par_dir and os.path.exists(par_path):
        from ukbb_cardiac_tpu_torch.reg.parcfg import load_par_cfg
        cfg, ignored = load_par_cfg(par_path, base=cfg)
        print(f"Loaded MIRTK parameters from {par_path}"
              + (f" (no equivalent here, ignored: {len(ignored)} keys)"
                 if ignored else ""))

    data_list = sorted(os.listdir(args.data_dir))
    end_idx = len(data_list) if args.end_idx == 0 else args.end_idx
    table, processed = [], []

    def finish_one(data, data_dir, motion_dir, ctx):
        finish_sa_motion(ctx, os.path.join(data_dir, "strain_sa"))
        if args.eval_dice:
            # keep the self-check table (the intermediate dir is removed)
            dice_src = os.path.join(motion_dir, "dice_cine_warp_ffd.csv")
            if os.path.exists(dice_src):
                shutil.move(dice_src,
                            os.path.join(data_dir, "dice_cine_warp_ffd.csv"))
        shutil.rmtree(motion_dir, ignore_errors=True)

        radial_csv = os.path.join(data_dir, "strain_sa_radial.csv")
        circum_csv = os.path.join(data_dir, "strain_sa_circum.csv")
        if os.path.exists(radial_csv) and os.path.exists(circum_csv):
            df_radial = pd.read_csv(radial_csv, index_col=0)
            df_circum = pd.read_csv(circum_csv, index_col=0)
            line = ([df_circum.iloc[i, :].min() for i in range(17)] +
                    [df_radial.iloc[i, :].max() for i in range(17)])
            table.append(line)
            processed.append(data)

    # one-deep pipeline: subject N's registration is queued on the card
    # while subject N-1's contours/VTKs/CSVs are processed on the host
    in_flight = None
    for data in data_list[args.start_idx:end_idx]:
        print(data)
        data_dir = os.path.join(args.data_dir, data)
        seg_sa_name = os.path.join(data_dir, "seg_sa_ED.nii.gz")
        if not os.path.exists(seg_sa_name):
            continue
        if not sa_pass_quality_control(seg_sa_name):
            continue

        motion_dir = os.path.join(data_dir, "cine_motion")
        os.makedirs(motion_dir, exist_ok=True)
        # a bad subject must not take the in-flight one's finished work
        # down with it: finish N-1 before surfacing N's failure.  A
        # RuntimeError (a failed kernel launch, a CUDA error) is not a bad
        # subject and stops the run.
        try:
            ctx = start_sa_motion_dispatch(data_dir, motion_dir, cfg=cfg,
                                           mesh=mesh,
                                           eval_dice=args.eval_dice,
                                           device=device)
        except RuntimeError:
            raise
        except Exception as exc:
            print(f"  {data}: dispatch failed ({exc!r}); skipping.")
            ctx = None
        if in_flight is not None:
            finish_one(*in_flight)
        if ctx is None:
            shutil.rmtree(motion_dir, ignore_errors=True)
            in_flight = None
        else:
            in_flight = (data, data_dir, motion_dir, ctx)
    if in_flight is not None:
        finish_one(*in_flight)

    pd.DataFrame(table, index=processed, columns=COLUMNS).to_csv(args.output_csv)


if __name__ == "__main__":
    main()
