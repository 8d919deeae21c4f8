"""CLI twin of ``common/deploy_network.py`` — SA/LA segmentation deploy on
the card.

The JAX CLI's flags (``ukbb_cardiac_tpu/cli/deploy_network.py``) plus
``--device`` (default ``cuda``; without a card it raises unless
``--device cpu`` is given).  ``--model_path`` is an .npz bundle or a TF
checkpoint prefix, converted first by ``ckpt/tf_reader.py`` (tensorflow
is needed on the converting host only).  ``--trace_dir`` writes a
``torch.profiler`` trace of the deploy (CPU and card) as a Chrome trace
JSON (``utils/timing.py::device_trace``).

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.deploy_network \
      --seq_name sa --data_dir <dir> --model_path <bundle.npz>
"""

from __future__ import annotations

import argparse

import torch

from ukbb_cardiac_tpu_torch.cli._common import add_bool_flag
from ukbb_cardiac_tpu_torch.infer.deploy import deploy_dataset
from ukbb_cardiac_tpu_torch.utils import device_trace
from ukbb_cardiac_tpu_torch.utils.cache import enable_compilation_cache


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seq_name", choices=["sa", "la_2ch", "la_4ch"],
                        default="sa", help="Sequence name.")
    parser.add_argument("--data_dir", default="ukbb_cardiac_demo",
                        help="Path to the data set directory, under which images "
                             "are organised in subdirectories for each subject.")
    parser.add_argument("--model_path", default="",
                        help="Path to the saved trained model (.npz bundle, "
                             "or a TF checkpoint prefix to convert).")
    add_bool_flag(parser, "process_seq", True, "Process a time sequence of images.")
    add_bool_flag(parser, "save_seg", True, "Save segmentation.")
    add_bool_flag(parser, "seg4", False,
                  "Segment all the 4 chambers in long-axis 4 chamber view.")
    parser.add_argument("--chunk", type=int, default=64,
                        help="Slices per forward.")
    parser.add_argument("--trace_dir", default="",
                        help="Write a torch.profiler trace (CPU and card) "
                             "here as a Chrome trace JSON.")
    add_bool_flag(parser, "bf16", False,
                  "bf16 activations (weights, BN and logits stay f32).")
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
        deploy_dataset(model_path, args.data_dir, seq_name=args.seq_name,
                       process_seq=args.process_seq, save_seg=args.save_seg,
                       seg4=args.seg4, chunk=args.chunk,
                       compute_dtype=torch.bfloat16 if args.bf16 else None,
                       device=args.device)


if __name__ == "__main__":
    main()
