"""CLI twin of ``common/train_network.py`` — SA/LA FCN training on the
card.

The JAX CLI's flags (``ukbb_cardiac_tpu/cli/train_network.py``) and its
two profiles on the port's trainer (``train/sa.py``), plus ``--device``
(default ``cuda``; without a card it raises unless ``--device cpu`` is
given).  ``--mesh_devices N`` above 1 trains data-parallel: the command
starts N processes itself, one per card (NCCL), or N CPU processes
(gloo) with ``--device cpu``; more than the machine's cards raises.

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.train_network \
      --dataset_dir <dir> [--profile reference] [--device cpu]
"""

from __future__ import annotations

import argparse

from ukbb_cardiac_tpu_torch.train.sa import (PRODUCTION_BATCH_SLICES,
                                       SATrainConfig, train)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--profile", choices=["production", "reference"],
                        default="production",
                        help="'production' (default): fixed-size slice "
                             "batches "
                             f"({PRODUCTION_BATCH_SLICES}), K-step "
                             "dispatch, device augmentation, bf16, "
                             "compact transfer, subject cache, and the "
                             "linear-scaled learning rate (1e-3*B/20) "
                             "unless --learning_rate is given.  "
                             "'reference': the reference's exact budget "
                             "(train_network.py:27-54, batch 2 subjects) "
                             "for checkpoint-parity training.  Explicit "
                             "flags override the profile either way.")
    parser.add_argument("--seq_name", choices=["sa", "la_2ch", "la_4ch"],
                        default="sa")
    parser.add_argument("--image_size", type=int, default=192)
    parser.add_argument("--train_batch_size", type=int, default=2)
    parser.add_argument("--validation_batch_size", type=int, default=2)
    parser.add_argument("--train_iteration", type=int, default=50000)
    parser.add_argument("--num_filter", type=int, default=16)
    parser.add_argument("--num_level", type=int, default=5)
    parser.add_argument("--learning_rate", type=float, default=None,
                        help="Default: 1e-3 (reference profile), or "
                             "linear-scaled 1e-3*batch_slices/20 "
                             "(production profile).")
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--checkpoint_dir", default="checkpoints")
    parser.add_argument("--log_dir", default="logs")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="Data-parallel ranks: 0 or 1 = one device; N "
                             "> 1 starts N processes, one per card (N CPU "
                             "processes with --device cpu).  The batch "
                             "must divide by N; the device slice pool is "
                             "then off unless --device_slices is given.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device_augment", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="Run the affine augmentation on the device, "
                             "inside the step, instead of on the host. "
                             "Default: on (production) / off (reference).")
    parser.add_argument("--batch_slices", type=int, default=None,
                        help="Fixed slices per batch via a slice pool "
                             "(static shape; 0 = reference per-subject "
                             "batches of varying slice count).  Default: "
                             f"{PRODUCTION_BATCH_SLICES} (production "
                             "profile) or 0 (reference profile).")
    parser.add_argument("--steps_per_dispatch", type=int, default=None,
                        help="Optimizer steps per call, the losses read "
                             "once per call (needs --batch_slices; pick a "
                             "divisor of the validation cadence).  "
                             "Default: 10 (production) or 1 (reference).")
    parser.add_argument("--resume_from", default="",
                        help="Checkpoint bundle to resume from.")
    parser.add_argument("--cache_gb", type=float, default=None,
                        help="LRU cache of decoded subjects, GiB "
                             "(0 = re-decode every draw, as the "
                             "reference does; 4 holds ~1000 subjects).  "
                             "Default: 4 (production) / 0 (reference).")
    parser.add_argument("--bf16", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="bf16 mixed-precision training (activations "
                             "bf16; params/BN/logits/loss f32).  "
                             "Default: on (production) / off (reference).")
    parser.add_argument("--compact_transfer", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="Ship batches as f16 images + uint8 labels "
                             "(2.7x fewer host->device bytes; labels "
                             "exact, images rounded ~5e-4).  Default: on "
                             "(production) / off (reference).")
    parser.add_argument("--device_slices", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="Device-resident slice pool: each subject-"
                             "frame goes to the device once and the step "
                             "gathers (slot, z) indices — steady-state "
                             "host-to-device traffic is bytes, not "
                             "megabytes.  Batch values match "
                             "--compact_transfer exactly.  Default: on "
                             "(production) / off (reference).")
    parser.add_argument("--pool_gb", type=float, default=2.0,
                        help="Device memory budget for the slice pool, "
                             "GiB.")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args(argv)

    prod = args.profile == "production"
    batch_slices = (args.batch_slices if args.batch_slices is not None
                    else (PRODUCTION_BATCH_SLICES if prod else 0))
    if args.learning_rate is not None:
        lr = args.learning_rate
    elif prod and batch_slices > 0:
        # linear-scaling rule vs the reference's ~20-slice batches
        lr = 1e-3 * batch_slices / 20.0
    else:
        lr = 1e-3
    device_augment = (args.device_augment
                      if args.device_augment is not None else prod)
    cfg = SATrainConfig(
        seq_name=args.seq_name, image_size=args.image_size,
        train_batch_size=args.train_batch_size,
        validation_batch_size=args.validation_batch_size,
        train_iteration=args.train_iteration, num_filter=args.num_filter,
        num_level=args.num_level, learning_rate=lr,
        dataset_dir=args.dataset_dir, checkpoint_dir=args.checkpoint_dir,
        log_dir=args.log_dir, seed=args.seed, mesh_devices=args.mesh_devices,
        device_augment=device_augment,
        batch_slices=batch_slices,
        steps_per_dispatch=(args.steps_per_dispatch
                            if args.steps_per_dispatch is not None
                            else (10 if prod and batch_slices > 0 else 1)),
        cache_gb=(args.cache_gb if args.cache_gb is not None
                  else (4.0 if prod else 0.0)),
        bf16=(args.bf16 if args.bf16 is not None else prod),
        compact_transfer=(args.compact_transfer
                          if args.compact_transfer is not None else prod),
        device_slices=(args.device_slices
                       if args.device_slices is not None
                       else (prod and batch_slices > 0 and device_augment
                             and args.mesh_devices <= 1)),
        pool_gb=args.pool_gb, device=args.device)
    return train(cfg, resume_from=args.resume_from or None)


if __name__ == "__main__":
    main()
