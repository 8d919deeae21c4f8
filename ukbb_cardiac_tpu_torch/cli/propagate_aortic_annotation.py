"""CLI twin of ``data/propagate_aortic_annotation.py`` — propagate sparse
ED/ES aortic labels to all frames with the port's FFD registration on
the card.

The JAX CLI's flags (``ukbb_cardiac_tpu/cli/propagate_aortic_annotation
.py``) plus ``--device`` (default ``cuda``; without a card it raises
unless ``--device cpu`` is given).  ``--par_dir`` works drop-in: a
``ffd_aortic_motion.cfg`` there is parsed into the registration config.

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.propagate_aortic_annotation \
      --data_dir <dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.data.propagate_aortic import propagate_subject
from ukbb_cardiac_tpu_torch.parallel.fleet import run_fleet
from ukbb_cardiac_tpu_torch.reg.register import RegConfig


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", required=True,
                        help="Directory of subject subdirectories with "
                             "ao / label_ao / ao_{ED,ES} / label_ao_{ED,ES}.")
    parser.add_argument("--par_dir", metavar="dir_name", default="",
                        help="Directory of MIRTK parameter files; "
                             "ffd_aortic_motion.cfg (if present) is "
                             "parsed into the registration config.")
    parser.add_argument("--start_idx", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    data_list = sorted(os.listdir(args.data_dir))
    end_idx = len(data_list) if args.end_idx == 0 else args.end_idx
    subjects = [os.path.join(args.data_dir, d)
                for d in data_list[args.start_idx:end_idx]
                if os.path.isdir(os.path.join(args.data_dir, d))]
    cfg = RegConfig.aortic_motion()
    par_path = os.path.join(args.par_dir, "ffd_aortic_motion.cfg")
    if args.par_dir and os.path.exists(par_path):
        from ukbb_cardiac_tpu_torch.reg.parcfg import load_par_cfg
        cfg, _ = load_par_cfg(par_path, base=cfg)
        print(f"Loaded MIRTK parameters from {par_path}")
    return run_fleet(subjects,
                     lambda d: propagate_subject(d, cfg, device=device),
                     done_check=lambda d: os.path.exists(
                         os.path.join(d, "label_ao_prop.nii.gz")))


if __name__ == "__main__":
    main()
