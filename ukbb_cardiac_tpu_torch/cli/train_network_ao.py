"""CLI twin of ``common/train_network_ao.py`` — aortic model training on
the card.

Every flag of the JAX CLI (``ukbb_cardiac_tpu/cli/train_network_ao.py``)
on the port's trainer (``train/ao.py``), plus ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu`` is given).
``--model_path`` takes an .npz bundle or a TF checkpoint prefix (converted
first by ``ckpt/tf_reader.py``, which needs tensorflow on the host), and
``--mesh_devices N`` above 1 trains data-parallel in N processes the
command starts itself, one per card (N CPU processes with ``--device
cpu``); ``--batch_windows`` must divide by N.

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.train_network_ao \
      --dataset_dir <dir> --model UNet [--device cpu]
  python -m ukbb_cardiac_tpu_torch.cli.train_network_ao \
      --dataset_dir <dir> --model UNet-LSTM --model_path <UNet bundle>
"""

from __future__ import annotations

import argparse

from ukbb_cardiac_tpu_torch.cli._common import add_bool_flag
from ukbb_cardiac_tpu_torch.train.ao import AoTrainConfig, train


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image_size", type=int, default=256,
                        help="Image size after cropping. NOTE: 256 for "
                             "aortic images to learn the boundary.")
    parser.add_argument("--train_batch_size", type=int, default=5)
    parser.add_argument("--validation_batch_size", type=int, default=5)
    parser.add_argument("--num_filter", type=int, default=16)
    parser.add_argument("--num_level", type=int, default=5)
    parser.add_argument("--num_hidden", type=int, default=16)
    parser.add_argument("--train_iteration", type=int, default=20000)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--reduce_lr_after", action="append", default=[],
                        help="Reduce the learning rate after this many "
                             "iterations.")
    parser.add_argument("--seq_name", choices=["ao"], default="ao")
    parser.add_argument("--model",
                        choices=["UNet", "UNet-LSTM", "Temporal-UNet"],
                        default="UNet")
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--log_dir", default="log")
    parser.add_argument("--checkpoint_dir", default="model")
    parser.add_argument("--model_path", default="",
                        help="Pre-trained UNet bundle (.npz), or a TF "
                             "checkpoint prefix to convert, for UNet-LSTM "
                             "phase 2.")
    add_bool_flag(parser, "z_score", True)
    add_bool_flag(parser, "bidirectional", True)
    add_bool_flag(parser, "seq2seq", True)
    parser.add_argument("--weight_R", type=int, default=5)
    parser.add_argument("--weight_r", type=float, default=0.0)
    add_bool_flag(parser, "joint_train", False)
    add_bool_flag(parser, "from_scratch", False)
    parser.add_argument("--cache_gb", type=float, default=0.0,
                        help="LRU cache of decoded cines, GiB (0 = off); "
                             "skips the per-draw gzip decode.")
    parser.add_argument("--compact_transfer", action="store_true",
                        help="Ship batches as f16 images + uint8 labels "
                             "(2.7x fewer host->device bytes).")
    parser.add_argument("--batch_windows", type=int, default=0,
                        help="Fixed time-windows per batch via a pool "
                             "sampler (static shapes; enables multi-step).")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Optimizer steps per call; requires "
                             "--batch_windows.")
    add_bool_flag(parser, "device_augment", False)
    add_bool_flag(parser, "bf16", False)
    add_bool_flag(parser, "device_windows", False)
    parser.add_argument("--pool_gb", type=float, default=2.0,
                        help="Device memory budget for --device_windows' "
                             "resident cine pool, GiB "
                             "(train/device_pool.py).")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="Data-parallel ranks: 0 or 1 = one device; N "
                             "> 1 starts N processes, one per card (N CPU "
                             "processes with --device cpu); needs "
                             "--batch_windows divisible by N.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args(argv)

    cfg = AoTrainConfig(
        seq_name=args.seq_name, model=args.model, image_size=args.image_size,
        train_batch_size=args.train_batch_size,
        validation_batch_size=args.validation_batch_size,
        num_filter=args.num_filter, num_level=args.num_level,
        num_hidden=args.num_hidden, train_iteration=args.train_iteration,
        learning_rate=args.learning_rate,
        reduce_lr_after=[int(x) for x in args.reduce_lr_after],
        dataset_dir=args.dataset_dir, checkpoint_dir=args.checkpoint_dir,
        log_dir=args.log_dir, model_path=args.model_path,
        z_score=args.z_score, bidirectional=args.bidirectional,
        seq2seq=args.seq2seq, weight_R=args.weight_R,
        weight_r=args.weight_r, joint_train=args.joint_train,
        from_scratch=args.from_scratch, cache_gb=args.cache_gb,
        compact_transfer=args.compact_transfer,
        batch_windows=args.batch_windows,
        steps_per_dispatch=args.steps_per_dispatch,
        device_augment=args.device_augment, bf16=args.bf16,
        device_windows=args.device_windows, pool_gb=args.pool_gb,
        mesh_devices=args.mesh_devices, seed=args.seed, device=args.device)
    return train(cfg)


if __name__ == "__main__":
    main()
