"""CLI twin of ``common/deploy_network_ao.py`` — aortic cine deploy on the
card.

The JAX CLI's flags (``ukbb_cardiac_tpu/cli/deploy_network_ao.py``) plus
``--device`` (default ``cuda``; without a card it raises unless
``--device cpu`` is given).  ``--window full`` runs the whole cine through
the U-Net and the ConvLSTM scan at once; ``--window compat`` reproduces
the reference's sliding circular window blending.  ``--model_path`` is an
.npz bundle or a TF checkpoint prefix, converted first by
``ckpt/tf_reader.py`` (tensorflow is needed on the converting host
only).  ``--trace_dir`` writes a ``torch.profiler`` trace of the deploy
(CPU and card) as a Chrome trace JSON (``utils/timing.py::
device_trace``).

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.deploy_network_ao \
      --data_dir <dir> --model_path <UNet-LSTM_ao.npz>
"""

from __future__ import annotations

import argparse

import torch

from ukbb_cardiac_tpu_torch.cli._common import add_bool_flag
from ukbb_cardiac_tpu_torch.infer.deploy_ao import deploy_dataset_ao
from ukbb_cardiac_tpu_torch.utils import device_trace
from ukbb_cardiac_tpu_torch.utils.cache import enable_compilation_cache


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seq_name", default="ao", help="Sequence name.")
    parser.add_argument("--data_dir", default="", required=False)
    parser.add_argument("--model_path", default="",
                        help="Path to the saved trained model (.npz bundle, "
                             "or a TF checkpoint prefix to convert).")
    add_bool_flag(parser, "process_seq", True, "Process a time sequence of images.")
    add_bool_flag(parser, "save_seg", True, "Save segmentation.")
    add_bool_flag(parser, "z_score", True, "Z-score intensity normalisation.")
    parser.add_argument("--weight_R", type=int, default=5,
                        help="Radius R of the temporal weighting window.")
    parser.add_argument("--weight_r", type=float, default=0.0,
                        help="Power r of the temporal weighting window.")
    parser.add_argument("--time_step", type=int, default=1,
                        help="Window stride in compat mode.")
    parser.add_argument("--window", choices=["full", "compat"], default="full",
                        help="'full': one scan over the whole cine; "
                             "'compat': the reference's sliding window.")
    add_bool_flag(parser, "bf16", False,
                  "bf16 activations (weights, BN and logits stay f32).")
    parser.add_argument("--trace_dir", default="",
                        help="Write a torch.profiler trace (CPU and card) "
                             "here as a Chrome trace JSON.")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args(argv)

    enable_compilation_cache()
    model_path = args.model_path
    if not model_path.endswith(".npz"):
        from ukbb_cardiac_tpu_torch.ckpt.tf_reader import \
            convert_tf_checkpoint
        model_path = convert_tf_checkpoint(model_path)

    with device_trace(args.trace_dir):
        deploy_dataset_ao(model_path, args.data_dir,
                          seq_name=args.seq_name, z_score=args.z_score,
                          save_seg=args.save_seg, window=args.window,
                          weight_R=args.weight_R, weight_r=args.weight_r,
                          time_step=args.time_step,
                          process_seq=args.process_seq,
                          compute_dtype=(torch.bfloat16 if args.bf16
                                         else None),
                          device=args.device)


if __name__ == "__main__":
    main()
