"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from ``ukbb_cardiac_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the build
   time and the compiler's register / spill lines;
2. holds each kernel against its plain PyTorch version at the main path's
   shapes and times the kernel, the plain version and a library yardstick
   with CUDA events (and prints the B-spline forward's sha256 at each):
   - the fused FCN head on a 64-slice chunk of 192x208 features from the
     trained ``FCN_sa`` encoder, float32 and bfloat16, with its nvcc time
     and registers, its tensor-core (3xTF32) bound beside the float32
     CUDA-core bound, and its coarse / head kernels' device times under
     torch.profiler;
   - the head with the trained LA bundles (2, 3 and 6 classes) at the LA
     deploys' (50, 192, 208);
   - the B-spline lattice → field synthesis and its adjoint at every
     shape of the strain paths: B = 150 SA pairs on the 96^2 bucket
     (24^2 / 6x6, 48^2 / 8x8, 96^2 / 13x13 at spacing 10, and the coarse
     levels densified at spacing 20 and 40) and B = 50 LA pairs on the
     128^2 bucket (32^2 / 7x7, 64^2 / 10x10, 128^2 / 16x16, and the same
     densifies), and the aortic label propagation's T - 2 = 98 pairs at
     its (not square) crop and lattice, spacing 10;
3. drives the main path as a user would: writes 3 phantom subjects
   (192, 208, 10, 50) int16, runs the port's SA deploy
   (``infer.deploy.deploy_dataset``) and ventricular-volume evaluation on
   the card, checks that the fused head launched, prints per-subject cine
   wall and device time, Dice against the phantom truth and
   LVEDV/LVESV/LVEF, and compares the card's labels with the port's CPU
   path on a reduced cine; then one cine on an engine: its first call
   (an eager run, then the captures of the engine's prep, chunk forward
   and pack programs, listed), one cine by stage, and the cine on the
   eager route and through the graphs in turns (host dispatch seconds,
   device spans, head launches, labels bitwise compared);
4. on the deployed segmentations, runs the wall-thickness CLI and the SA
   strain driver (``RegConfig.cine_2d_motion()``, warp-Dice on) for every
   subject on the card, checks that both B-spline kernels launched,
   prints per subject the strain wall and device span, pairs, crop,
   global Ecc/Err and warp-Dice, and compares the card's strain tables
   with the port's CPU path on a reduced subject (6 frames).  The
   registration and the field stages replay CUDA graphs
   (``reg/programs.py``): the first subject captures them (their capture
   seconds and memory printed), and the last subject's registration and
   fields run on the eager route and through the graphs (ms, device ops,
   idle share under torch.profiler; strain tables, warp-Dice and fields
   bitwise equal, or within the CPU bounds with the reason printed), and
   so do the point sampling and the warp-Dice (device and host ms, device
   ops and busy ms, outputs bitwise compared);
5. drives the cohort CLI (``cli.run_cohort``) in full mode — the SA
   chain, then the la_2ch / la_4ch / seg4 deploys with the trained LA
   bundles (2, 3 and 6 classes), atrial volumes, LA strain, and the
   aortic stage (the trained ``UNet-LSTM_ao`` bundle, ``--pressure_csv``)
   — on 3 full-size subjects (SA (192, 208, 10, 50), LA (192, 208, 1, 50),
   aortic (240, 196, 1, 100) int16), with 1 worker (the default), then
   with 3 on the shared default stream and on a stream per worker
   (shared, own, own, shared), then with 1 again once every shape's
   graphs are captured; prints for each run the cohort wall,
   subjects/s, median stage seconds and launches per subject, head
   launches by number of classes; checks every subject, the aggregate
   tables, LA Dice against the truth, LA labels and the atrial row of the
   port's CPU deploy against the card's, and the card's LA strain against
   the CPU's on a reduced subject, and every 3-worker run's tables
   against the 1-worker run's (equal); prints one subject's LA strain
   alone (graphs and the eager route, bitwise compared)
   (launches, device span) and, per LA bundle, a fresh engine's first
   call (eager run + captures, GC pauses), the cine on each route with 1
   worker and with 3 threads on the engine (host dispatch, device spans,
   labels bitwise compared), and a second fresh engine's first call
   (its programs then released, timed); every cohort run under a stack
   sampler that prints the host's stalls of 1 s or more with their
   stacks; then ``run_cohort_sa`` through one SA engine on 6 subjects of
   6 cine shapes (Z 8-13, matrices 180x192 to 204x208), one subject a
   call: after each new shape the engine's programs, bytes and drops
   under its bound, the registration's programs, memory_reserved, and
   host stalls; an engine bounded to a third of that on the same cines
   twice (labels bitwise the first engine's, drops counted), and both
   engines released (seconds, memory_reserved after);
6. the aortic stage: Dice of the cohort's aortic segs against the
   phantom truth, the device span per aortic cine (the first call
   captures the engine's programs, listed), the cine on each route in
   turns (host dispatch, device span, labels bitwise compared), the
   U-Net's and the ConvLSTM's device spans (CUDA events), the ConvLSTM
   on the eager route and as one graph (span, host time, device
   operations and busy share under torch.profiler, logits bitwise
   compared), and the card's labels and area row against the port's CPU
   path on a cine cut to 10 frames;
7. training: writes 8 phantom subjects' ED/ES pairs (192, 208, 10) with
   labels and 2 for validation, and runs ``cli.train_network.main`` on
   the card at the released FCN_sa architecture (5 levels, filters
   16-256, 4 classes, 192^2 crops) in the production profile (batches of
   128 slices, 10 steps per call, bf16, the device slice pool, 100
   iterations) and the reference profile (batches of 2 subjects, float32,
   host augmentation, 40 iterations), each through the trainer's CUDA
   graphs and then on the eager route from the same seed; prints for
   each run ms per step, slices/s, peak memory, the loop's wait on the
   loader, host dispatch per call, its programs' capture seconds and
   memory, TFLOP/s from ``conv_flops`` x 3, the losses by validation and
   the head kernel's launches in the validations; fails unless both
   losses are finite and fall and each profile's two routes wrote the
   same bundle (parameters, BN state, Adam leaves) and log bit for bit
   with as many head launches; holds one float32 step's gradients on
   the card to the CPU's; profiles one production step on the eager
   route (device time by kernel family); runs the production call (K =
   10 from the slice pool) and the reference step from the trained
   bundles on the eager route, through the graphs and eagerly again (a
   call's span and host dispatch, first-call seconds, device ops and
   idle share under torch.profiler, each program's capture seconds and
   memory; losses, parameters, BN buffers and Adam state bitwise, or
   within the eager route's own spread), the validation program on both
   routes (labels bitwise, head launches equal), and a checkpoint after
   two graphed production calls resumed for two more against four
   straight through (bitwise); deploys the trained bundle on the card
   through the head kernel;
8. a ResNet-FCN bundle at the FCN_sa widths from a seeded init, written
   by the port: card logits against the CPU's, its forward time per
   chunk, and ``segment_sequence_fused`` on the card through the head
   kernel;
9. the aortic trainer's slice: writes 3 bench-size aortic subjects
   (240, 196, 1, 100) int16 annotated at ED and ES and runs
   ``cli.propagate_aortic_annotation`` on the card (per subject wall,
   registration device span, pairs, crop, Dice against the truth; both
   B-spline kernels' launches), one registration at its shape replaying
   the graphs and on the eager route (span, device operations, idle
   share; fields bitwise compared), and holds the card's labels to the
   port's CPU path on a 10-frame cut; then ``cli.train_network_ao`` on the
   propagated labels at the released UNet-LSTM_ao widths, UNet and then
   UNet-LSTM restoring it, in the reference profile (batches of 5
   subjects, float32, host augmentation; the subject cache on) through
   the trainer's CUDA graphs and with the production options (fixed
   window batches, 10 steps per call, bf16, device augmentation, the
   device cine pool) through the graphs and on the eager route: ms per
   step, windows/s, loader wait, host dispatch per call, peak memory,
   the programs' capture seconds and memory, TFLOP/s; fails unless every
   loss falls, the production routes' bundles and logs are bitwise
   equal, one float32 step's card and CPU gradients
   agree and the trained bundle's card and CPU deploys agree; the U-Net's
   and the phase-2 UNet-LSTM's production calls and reference steps on
   both routes as in phase 7 (the ConvLSTM's scan forward and backward
   inside the graph), and their validation loss programs (bitwise);
10. ingestion: writes the cohort's 3 subjects as UK Biobank application
   zips of DICOMs with the port's writer (SA slices, LA 2/3/4-chamber,
   aortic; subject 0 with one SOF3, one JPEG-LS and one RLE series, the
   Python encoders run in a pool of processes while the uncompressed
   files are written; the seconds of each part), prints the native and
   Python decode rates, converts the zips with ``cli.convert_data``
   (seconds per subject), holds the converted voxels to the cines and
   the affines to the headers written, and runs ``cli.run_cohort`` in
   full mode with 1 worker on the converted tree: every subject and
   table, the kernels' launches, SA Dice >= 0.9 against the truth;
11. this slice: ``cli.demo_pipeline.main`` on the cohort's first 2
   subjects with the trained bundles and the pressure CSV on the card
   (wall, each stage's seconds, the kernels' launches; every seg and
   table; the volume, wall-thickness, atrial and aortic rows equal to the
   cohort phase's, strain within the CPU bounds; SA Dice >= 0.9);
   ``cli.deploy_network --trace_dir`` on one subject (the Chrome trace
   names ``head_kernel`` and ``coarse_kernel``; its size and the head's
   device time read from it); the both-directions SA strain
   (``inverse_consistent=False``, 294 pairs) on one subject beside the
   default scheme's Global Ecc/Err (the call that captures its graphs,
   one that replays them and the eager route: walls, bitwise compared),
   and card against CPU on a 6-frame cut
   within the CPU tests' bounds for it; ``cli.verify_checkpoint
   --fingerprint`` on the five bundles and ``--fingerprint_diff`` against
   the committed goldens (without TensorFlow the forward check exits 2, as
   the JAX CLI's); ``cli.perform_phenome_wide_association`` on a synthetic
   UK Biobank-shaped table (3,000 subjects x 500 fields x 101 IDPs;
   without matplotlib the same steps without the plot): seconds by step,
   M x N, the thresholds, the planted associations as the top hits.
   Phase 2 also holds both B-spline kernels at the both-directions batch
   (B = 294 at every level of the 96^2 bucket);
12. meshes: ``make_mesh(1)`` holds the card and a mesh of one card more
   than the machine has raises; ``InferenceEngine.segment_subjects_sharded``
   over ``make_mesh(["cuda:0", "cuda:0"])`` on the cohort's 3 SA cines
   and ``AorticEngine.segment_subjects_sharded`` on 2 of its aortic cines,
   labels byte-identical to the per-subject path (walls of both);
   ``run_cohort_sa(mesh=...)`` with 1 worker on the cohort's subjects
   (each subject's registration pairs in two shards): strain rows against
   phase 5's 1-worker rows, median strain stage seconds beside phase 5's,
   B-spline launches per subject; ``cli.eval_strain_sax --mesh_devices 1``
   on one subject;
13. data-parallel training (``train/distributed.py``) on the one card:
   the production SA profile (128-slice batches, bf16, the slice pool
   through ``make_pool_slice_multi_dp_step``) in a world of one NCCL rank
   (its step calls CUDA graphs with the gradient all-reduce captured)
   against the single-card trainer through its graphs and on the eager
   route (cuDNN deterministic in all three): params, BN state and Adam
   state bitwise equal, each run's route, host dispatch and programs
   printed; the DP pool step's call in a world of one NCCL rank in this
   process on both routes as in phase 7 (span, host dispatch, idle
   share, capture seconds and memory; bitwise under deterministic
   cuDNN); two gloo ranks on cuda:0 (NCCL refuses two ranks on one
   card; their steps run uncaptured, by design, the route printed and
   checked): one float32 step
   of the FCN_sa bundle at a global batch of 8 slices, gradients and BN
   state within GRAD_RTOL of the single-card step's, then 20 production
   SA iterations, then 10 UNet-LSTM iterations (8 windows, 4 a rank, from
   phase 9's U-Net) beside the single card's, losses falling; ms per
   step, slices or windows/s, peak memory by rank, spawn seconds, the
   head's launches in rank 0's validations (one-card figures, no
   multi-card speed); ``cli.train_network --mesh_devices 2`` raises,
   naming the card count.  Ranks are spawned processes, which import
   this file: its top level stays import-safe;
14. prints the card's name and power limit, one JSON line of kernel
   figures (the head's launches from the 1-worker cohort run, the
   ingestion phase's, the demo's, the mesh phase's and the
   data-parallel phase's, the B-spline
   kernels' likewise and from the propagation and the both-directions
   run, with their times at those shapes; launches on the registration
   path come from graph replays, each adding the launches its capture
   recorded, and from the first, eager call of each shape; the head's
   likewise from the engines' graphs), every captured program's capture
   seconds and memory (the module-level cache's, then each held engine's,
   and the total), and, last, ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --sort_probe`` instead times the first
``torch.sort`` of int16 cines at the sizes the run meets, eager and
captured, under torch.profiler (:func:`sort_probe`).

``python3 chip_smoke.py --forward_vs <tree>`` instead builds the B-spline
forward of another checkout ``<tree>`` (an earlier design, C interface
``B, Cx, Cy, X, Y, spacing, table, control, field, stream``) and holds
this tree's forward against it: sha256 of both at every phase-2 case,
and times in turns.

Any failure raises and exits non-zero before the last line.  Without a
card (``torch.cuda.is_available()`` false) it exits 1 at once.  The
weights are the repo's trained ``tests/fixtures/bench_weights/FCN_*.npz``
and ``UNet-LSTM_ao.npz`` bundles (full widths, 5 levels); the phantoms and
the kernels' test inputs come from fixed seeds.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import hashlib
import json
import linecache
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(ROOT, "tests", "fixtures", "bench_weights", "FCN_sa.npz")
MAIN_SHAPE = (192, 208, 10, 50)      # (X, Y, Z, T) of one SA cine
CHUNK = 64                           # slices per forward on the main path
N_SUBJECTS = 3
PEAK_F32_FLOPS = 67e12               # H100 SXM, float32 outside tensor cores
PEAK_TF32_FLOPS = 495e12             # H100 SXM, TF32 tensor cores, dense
PEAK_BYTES = 3.35e12                 # H100 SXM HBM3
KERNEL_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# B-spline synthesis: at most 20 float32 FMAs per value in another order;
# the adjoint sums up to (4s)^2 products per control
FIELD_ATOL, ADJOINT_ATOL = 1e-5, 1e-4
N_PAIRS = 150                        # 3 slices x 50 frames, inverse-consistent
N_LA_PAIRS = 50                      # one 4-chamber slice x 50 frames
N_PAIRS_BOTH = 3 * 2 * 49            # 3 slices x 2(T-1), both directions
LA_BUCKET = 128                      # the LA LV crop, bucketed to 64s
# (pairs, image side, lattice side, spacing) of every synthesis on the
# strain paths: SA on its 96^2 bucket, LA on 128^2; per pyramid level the
# Adam lattice (spacing 10, forward and adjoint), then the finished coarse
# levels densified at the finer ones (spacing 20 and 40)
BSPLINE_CASES = [
    (N_PAIRS, 24, 6, 10), (N_PAIRS, 48, 8, 10), (N_PAIRS, 96, 13, 10),
    (N_PAIRS, 48, 6, 20), (N_PAIRS, 96, 6, 40), (N_PAIRS, 96, 8, 20),
    (N_LA_PAIRS, 32, 7, 10), (N_LA_PAIRS, 64, 10, 10),
    (N_LA_PAIRS, LA_BUCKET, 16, 10), (N_LA_PAIRS, 64, 7, 20),
    (N_LA_PAIRS, LA_BUCKET, 7, 40), (N_LA_PAIRS, LA_BUCKET, 10, 20)]
# a shape with odd X*Y: whether a row's column pairs are 16-byte aligned
# flips from row to row and from pair to pair, so the forward's unaligned
# path (two 8-byte stores) runs at both row parities of every pair (the
# propagation's 100 x 57 has odd Y, but even X*Y)
VECTOR_CASE = (7, (23, 31), (8, 9), 5)
# the both-directions SA strain scheme at the SA bucket: every pyramid
# level's Adam lattice and the densifies (drawn after the cases above, so
# their inputs and sha256 stay the earlier slices')
BOTH_CASES = [(N_PAIRS_BOTH, (X, X), (C, C), s) for X, C, s in (
    (24, 6, 10), (48, 8, 10), (96, 13, 10), (48, 6, 20), (96, 6, 40),
    (96, 8, 20))]
# card vs CPU strain on a reduced subject: the bounds the CPU parity tests
# hold the port to against the JAX package (tests/test_torch_strain.py)
STRAIN_SEGMENT_ATOL, STRAIN_GLOBAL_ATOL, DICE_ATOL = 2.0, 0.5, 0.005
# the both-directions scheme's bounds (tests/test_torch_strain_both.py:
# twice the JAX package's own 2.58 pp drift per segment under 1e-7 noise;
# the default scheme's Global and warp-Dice bounds)
BOTH_SEGMENT_ATOL = 5.2
# the cohort: the trained LA bundles (2, 3 and 6 classes), the world
# affines of tests/test_cohort.py, and the LA strain bounds of
# tests/test_torch_la.py
WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "bench_weights")
LA_BUNDLES = {"la_2ch": "FCN_la_2ch.npz", "la_4ch": "FCN_la_4ch.npz",
              "seg4": "FCN_la_4ch_seg4.npz"}
AFFINE_SA = np.array([[-1.8, 0, 0, 80.0], [0, -1.8, 0, 90.0],
                      [0, 0, 10.0, -40.0], [0, 0, 0, 1.0]])
AFFINE_LA = np.array([[-1.8, 0, 0, 80.0], [0, 0, 10.0, 0.0],
                      [0, -1.8, 0, 90.0], [0, 0, 0, 1.0]])
LA_STRAIN_SEGMENT_ATOL, LA_STRAIN_GLOBAL_ATOL = 1.5, 0.3
ATRIAL_RTOL = 1e-6                   # the CPU tests' bound on atrial rows
# the aortic stage: the trained UNet-LSTM on the JAX package's bench cine
# (bench.py: ao_phantom(240, 196, 100, r_aa=18, r_da=12)), the aortic
# affine of tests/test_cohort.py, the CPU tests' bound on area rows
AO_BUNDLE = os.path.join(WEIGHTS, "UNet-LSTM_ao.npz")
AO_SHAPE = (240, 196, 1, 100)
AFFINE_AO = np.diag([-1.8, -1.8, 10.0, 1.0])
AREA_RTOL = 1e-6
COHORT_AFFINES = {"sa": AFFINE_SA, "la_4ch": AFFINE_LA, "la_2ch": AFFINE_LA,
                  "ao": AFFINE_AO}
# the ingestion phase: write_cohort's subjects as UK Biobank application
# zips (<eid>.zip, a folder of DICOMs per series: the SA slices, the LA 2-,
# 3- and 4-chamber views, the aortic series; the 3-chamber view carries the
# 2-chamber cine), converted by cli.convert_data, then cli.run_cohort in
# full mode with 1 worker on the converted tree.  Subject 0 carries one
# series in each compressed syntax: SOF3 JPEG lossless, JPEG-LS and RLE
# (encoded by the port's Python encoders in a pool of processes); the rest
# is explicit VR little endian.  Geometry: the DICOM headers that the
# conversion (LPS to RAS) turns into COHORT_AFFINES
INGEST_EID0 = 5000000
SOF3, JPEG_LS, RLE = ("1.2.840.10008.1.2.4.70", "1.2.840.10008.1.2.4.80",
                      "1.2.840.10008.1.2.5")
EXPLICIT_LE = "1.2.840.10008.1.2.1"
INGEST_COMPRESSED = {"CINE_segmented_LAX_2Ch": SOF3,
                     "CINE_segmented_LAX_4Ch": JPEG_LS,
                     "CINE_segmented_SAX_b2": RLE}
# (cine, image orientation (LPS), position of slice 0 (LPS)) per series
INGEST_GEOMETRY = {
    "sa": ("sa", (1, 0, 0, 0, 1, 0), (-80.0, -90.0, -40.0)),
    "la_2ch": ("la_2ch", (1, 0, 0, 0, 0, -1), (-80.0, 0.0, 90.0)),
    "la_3ch": ("la_2ch", (1, 0, 0, 0, 0, -1), (-80.0, 0.0, 90.0)),
    "la_4ch": ("la_4ch", (1, 0, 0, 0, 0, -1), (-80.0, 0.0, 90.0)),
    "ao": ("ao", (1, 0, 0, 0, 1, 0), (0.0, 0.0, 0.0))}
INGEST_FOLDERS = {"la_2ch": "CINE_segmented_LAX_2Ch",
                  "la_3ch": "CINE_segmented_LAX_3Ch",
                  "la_4ch": "CINE_segmented_LAX_4Ch",
                  "ao": "CINE_segmented_Ao_dist"}
# the training phase: the released FCN_sa architecture (5 levels, filters
# 16-256, 4 classes) on 192^2 crops of phantom ED/ES pairs; each
# profile's iterations (production: batches of 128 slices, 10 steps per
# call; reference: batches of 2 subjects); one float32 step's card and
# CPU gradients within GRAD_RTOL of each tensor's largest magnitude
TRAIN_SUBJECTS, VAL_SUBJECTS = 8, 2
TRAIN_SHAPE = (192, 208, 10)
TRAIN_CROP, TRAIN_BATCH = 192, 128    # the CLI's defaults
TRAIN_ITERS = {"production": 100, "reference": 40}
GRAD_BATCH, GRAD_RTOL = 8, 1e-3
# ResNet-FCN deploy: card logits within RESNET_RTOL of the largest CPU
# logit (the head kernel's 3xTF32 and cuDNN sum in another order)
RESNET_RTOL = 1e-4
# the aortic trainer's phase: the bench cine AO_SHAPE annotated at ED and
# ES (frames 0 and T/2, as bench_accuracy.py's aortic cohort), its vessel
# radii swinging by AO_PULSE over the cycle (the annotated frames share
# one radius, so a registration that does nothing copies their labels to
# every frame and is told apart only where the vessels move far), labels
# propagated with RegConfig.aortic_motion() (1 level, 100 Adam steps, NMI,
# spacing 10; T - 2 pairs) and held to the bounds the CPU tests set from
# the JAX package's own drift (tests/test_torch_propagate.py): the share
# of voxels and the mean per-frame Dice against the CPU's labels, the
# mean Dice against the truth over the propagated frames, and every
# frame's AAo Dice against the truth; then both trainer profiles at the
# released UNet-LSTM_ao widths on the propagated labels: the reference
# (batches of 5 subjects, float32, host augmentation) and the production
# options (fixed window batches, K steps per call, bf16, device
# augmentation, the device cine pool)
AO_TRAIN_SUBJECTS = 3
AO_ANNOTATED = (0, AO_SHAPE[3] // 2)
AO_PULSE = 0.45
PROP_MAX_DISAGREE, PROP_MIN_MEAN_DICE = 2 * 0.0131, 1 - 2 * (1 - 0.882)
PROP_MIN_TRUTH_DICE, PROP_MIN_DICE = 1 - 2 * (1 - 0.872), 0.75
PROP_CPU_T = 10                      # the reduced cine held to the CPU
AO_TRAIN_ITERS = {"reference": 20, "production": 40}
AO_BATCH_WINDOWS = {"UNet": 32, "UNet-LSTM": 8}
AO_K = 10
AO_SIZE_TRAIN = 256                  # the CLI's --image_size
PULSE_PRESSURE = "Central pulse pressure during PWA"
COHORT_STAGES = ("segment", "volumes", "wall_thickness", "strain",
                 "segment_la", "atrial_volumes", "strain_la", "aortic")
# aggregate CSVs of a full-mode cohort: (rows, columns) per table
COHORT_TABLES = {"table_ventricular_volume.csv": 12,
                 "table_wall_thickness.csv": 17,
                 "table_wall_thickness_max.csv": 17,
                 "table_strain_sax.csv": 34,
                 "table_atrial_volume.csv": 8,
                 "table_strain_lax.csv": 7,
                 "table_aortic_area.csv": 6}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events around a run of
    eager calls: includes any gap while the host issues the next one)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Mean device milliseconds per call: up to ``iters`` calls (fewer for
    a call slower than 1 ms) captured in one CUDA graph and replayed, so
    host launch time leaves no gaps between them (CUDA events around the
    replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
    end.synchronize()
    iters = max(3, min(iters, int(iters / max(start.elapsed_time(end), 1e-3))))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn, names) -> dict:
    """Device milliseconds of one call of ``fn`` under torch.profiler,
    summed per kernel whose name contains each of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for k in names:
                if k in e.key:
                    out[k] += e.self_device_time_total / 1e3
    return out


def route(name):
    """The programs' route for a block: ``"graphs"`` (the default: CUDA
    graphs captured once per shape and replayed, the registration's and
    the engines') or ``"eager"`` (the module-private comparison route, op
    by op)."""
    from ukbb_cardiac_tpu_torch.reg import programs

    return (programs._eager_route() if name == "eager"
            else contextlib.nullcontext())


def threaded_dispatches(card, what, dispatch, name, want, workers=3):
    """``workers`` threads each run ``dispatch()`` once at the same time
    on the ``name`` route (the cohort's workers sharing one engine):
    prints the wall and each cine's host dispatch and device span; fails
    unless every thread's labels are ``want`` bitwise."""
    results = [None] * workers

    def work(i):
        with route(name):
            results[i] = timed_dispatch(dispatch, sync=False)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(workers)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError(f"{what}: a worker did not finish")
    same = all(np.array_equal(r[0], want) for r in results)
    print(f"  {what}, {workers} workers, {name} route: wall {wall:.4f} s; "
          f"per cine dispatch "
          + "/".join(f"{r[1]:.4f}" for r in results) + " s, device span "
          + "/".join(f"{r[2]:.4f}" for r in results) + f" ms [{card}]; "
          f"labels {'bitwise equal to' if same else 'DIFFER from'} the "
          f"1-worker run's")
    if not same:
        raise AssertionError(f"{what}: {workers} workers' labels differ")


# the engines whose programs the last phase lists
HELD_ENGINES = []


@contextlib.contextmanager
def gc_pauses():
    """Collect the Python garbage collector's pauses (seconds, generation)
    inside the block, into the list it yields."""
    pauses, started = [], []

    def note(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((time.perf_counter() - started.pop(),
                           info["generation"]))

    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


class StallWatch:
    """Samples every thread's Python stack each ``every`` seconds inside
    the block and keeps the spans in which a thread stayed on one stack
    for ``at_least`` seconds or more (waits for other threads and for
    work queues aside), with the other threads' innermost frames while it
    lasted: where the host stalls, and in what call.  A sample walks the
    frames only (no formatting), so the sampler holds the GIL briefly;
    it needs the GIL, so its longest gap between samples tells a thread
    held in a call that released the GIL (short gaps) from one holding
    it."""

    IDLE = ("threading.py", "queue.py", "thread.py", "_base.py")

    def __init__(self, every: float = 0.05, at_least: float = 1.0):
        self.every, self.at_least = every, at_least
        self.spans = []   # (seconds, thread name, stack, others)
        self.gap = 0.0    # the longest interval between two samples
        self._stop = threading.Event()

    def __enter__(self):
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False

    def _sample(self):
        names = {}
        seen = {}     # thread id -> (stack, since, last seen)
        others = {}   # thread name -> innermost frame, at the last sample
        me = threading.get_ident()
        prev = time.perf_counter()
        while True:
            stopping = self._stop.wait(self.every)
            now = time.perf_counter()
            self.gap = max(self.gap, now - prev)
            prev = now
            frames = sys._current_frames()
            for t in threading.enumerate():
                names[t.ident] = t.name
            live = {}
            for tid, frame in frames.items():
                if tid == me or stopping:
                    continue
                stack = _frames(frame)
                old = seen.get(tid)
                live[tid] = ((old[0], old[1], now) if old and old[0] == stack
                             else (stack, now, now))
            for tid, (stack, since, last) in seen.items():
                if live.get(tid, (None,))[0] != stack:
                    name = names.get(tid, str(tid))
                    self._keep(name, stack, last - since,
                               {n: f for n, f in others.items() if n != name})
            seen = live
            others = {names.get(tid, str(tid)): st[0][-1]
                      for tid, st in live.items() if st[0]}
            if stopping:
                return

    def _keep(self, name, stack, seconds, others):
        if (seconds >= self.at_least and stack
                and not stack[-1][0].endswith(self.IDLE)):
            self.spans.append((seconds, name, stack, others))

    def report(self, what: str, top: int = 3) -> str:
        """The ``top`` longest stalls, one block each."""
        head = (f"(stacks sampled every {self.every} s; the sampler's "
                f"longest gap {self.gap:.3f} s)")
        if not self.spans:
            return (f"  {what}: no host stall of {self.at_least} s or more "
                    + head)
        lines = [f"  {what}: {len(self.spans)} host stall(s) of "
                 f"{self.at_least} s or more {head}; the longest:"]
        for seconds, name, stack, others in sorted(
                self.spans, key=lambda x: -x[0])[:top]:
            lines.append(f"    {seconds:.3f} s in thread {name}, innermost "
                         f"last:")
            lines += ["      " + _frame_line(f) for f in stack[-4:]]
            lines.append("      other threads meanwhile: " + ("; ".join(
                f"{n}: {_frame_line(f)}" for n, f in sorted(others.items()))
                or "none"))
        return "\n".join(lines)


def _frames(frame, limit: int = 6) -> tuple:
    """(file, line, function) of ``frame`` and its callers, at most
    ``limit``, the innermost last."""
    out = []
    while frame is not None and len(out) < limit:
        out.append((frame.f_code.co_filename, frame.f_lineno,
                    frame.f_code.co_name))
        frame = frame.f_back
    return tuple(reversed(out))


def _frame_line(f) -> str:
    path, line, name = f
    text = linecache.getline(path, line).strip()
    if path.startswith(ROOT + os.sep):
        path = os.path.relpath(path, ROOT)
    return f"{path}:{line} {name}: {text}"


def head_launches() -> int:
    from ukbb_cardiac_tpu_torch.models import fused_head as fh

    return fh.fused_head.launches


def timed_dispatch(dispatch, sync: bool = True):
    """``dispatch()`` (a PendingSegmentation) waited for: (labels, host
    seconds until it returned, device span ms, head launches counted
    meanwhile, GC pause seconds inside it).  ``sync``: wait for the card
    to be idle first."""
    if sync:
        torch.cuda.synchronize()
    before = head_launches()
    with gc_pauses() as pauses:
        t0 = time.perf_counter()
        pending = dispatch()
        host = time.perf_counter() - t0
        labels = pending.result()
    return (labels, host, pending.device_ms, head_launches() - before,
            sum(p for p, _ in pauses))


def dispatch_routes(card, what, dispatch,
                    order=("eager", "graphs", "graphs", "eager")):
    """``dispatch()`` on each route of ``order`` in turn: prints the host
    dispatch seconds, the device span and the head launches of each call;
    fails unless every call's labels and launches are the first's.
    Returns {route: [(host s, span ms), ...]}."""
    runs = []
    for name in order:
        with route(name):
            runs.append((name,) + timed_dispatch(dispatch))
    for name, _, host, span, n, gc_s in runs:
        print(f"  {what}, {name} route: dispatch {host:.4f} s, device span "
              f"{span:.4f} ms, head launches {n}, GC {gc_s:.4f} s [{card}]")
    same = all(np.array_equal(r[1], runs[0][1]) for r in runs)
    print(f"  {what}: labels of the graphs route "
          f"{'bitwise equal to' if same else 'DIFFER from'} the eager "
          f"route's, head launches "
          f"{'equal' if len({r[4] for r in runs}) == 1 else 'DIFFER'}")
    if not same or len({r[4] for r in runs}) != 1:
        raise AssertionError(f"{what}: the graphs route differs from the "
                             "eager route")
    out = {}
    for name, _, host, span, _, _ in runs:
        out.setdefault(name, []).append((host, span))
    return out


def profiled(fn):
    """``fn()`` under torch.profiler: (device operations, busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in kern),
            sum(getattr(e, "self_device_time_total", 0) for e in kern) / 1e3)


def describe_program(prog) -> str:
    """A captured program's key in brief: what it computes, the level or
    (Z, T) it was built for, its first input's shape."""
    tag = prog.key[0]
    extra = [str(t) for t in tag[1:] if isinstance(t, (bool, int))]
    return " ".join([tag[0]] + extra) + f" {tuple(prog.key[2][0])}"


def captured_programs(progs) -> str:
    """One line per captured program: capture seconds, the growth of
    memory_reserved over its capture, launches a replay adds (the head's
    or the B-spline kernels')."""
    return "\n".join(
        f"    {describe_program(p)}: capture {p.capture_s:.3f} s, "
        f"memory_reserved +{p.reserved / 2 ** 20:.1f} MiB, {p.replays} "
        f"replays, {sum(p.launches.counts.values())} kernel launches a "
        f"replay" for p in progs if p.graph is not None)


def tables_equal(a, b) -> bool:
    """Two dicts of DataFrames hold the same values bit for bit (NaN where
    NaN)."""
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and np.array_equal(
            a[k].values.astype(float), b[k].values.astype(float),
            equal_nan=True) for k in a)


# --- phantoms: the geometry of tests/phantom.py::sax_phantom ---------------

def _disk(X, Y, cx, cy, r):
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    return ((xx - cx) ** 2 + (yy - cy) ** 2) <= r * r


def sax_phantom(X, Y, Z, T, r_lv, wall, amp=0.3, noise=0.05, rng=None):
    """SA cine: LV disk, myocardial annulus, RV crescent, cyclic
    contraction (ED = frame 0).  Returns (image int16, seg int16)."""
    rng = rng or np.random.RandomState(0)
    cx, cy = X // 2, Y // 2
    scale = 1.0 - amp * np.sin(np.pi * np.arange(T) / float(T)) ** 2
    image = np.zeros((X, Y, Z, T), np.float32)
    seg = np.zeros((X, Y, Z, T), np.int16)
    for t in range(T):
        r = r_lv * scale[t]
        R = r + wall
        lv = _disk(X, Y, cx, cy, r)
        epi = _disk(X, Y, cx, cy, R)
        myo = epi & ~lv
        rv = _disk(X, Y, cx - (R + 4), cy, r * 0.9 + 3) & ~epi
        sl = np.zeros((X, Y), np.int16)
        sl[rv], sl[myo], sl[lv] = 3, 2, 1
        base = np.zeros((X, Y), np.float32)
        base[lv], base[myo], base[rv] = 800.0, 300.0, 700.0
        seg[:, :, :, t] = sl[:, :, None]
        img = base[:, :, None] + rng.randn(X, Y, Z).astype(np.float32) * (
            noise * 1000.0)
        image[:, :, :, t] = np.clip(img, 0, 1000)
    return np.round(image).astype(np.int16), seg


def write_subjects(data_dir, nifti):
    truth = {}
    X, Y, Z, T = MAIN_SHAPE
    for i in range(N_SUBJECTS):
        rng = np.random.RandomState(i)
        image, seg = sax_phantom(X, Y, Z, T, r_lv=0.1 * X, wall=0.039 * X,
                                 rng=rng)
        affine = np.diag([-1.8, -1.8, 10.0, 1.0])
        hdr = nifti.Nifti1Header()
        hdr.dim[0] = 4
        hdr.dim[1:5] = image.shape
        hdr.pixdim[1:5] = (1.8, 1.8, 10.0, 0.02)
        subject = f"{1000000 + i}"
        os.makedirs(os.path.join(data_dir, subject))
        nifti.save(nifti.Nifti1Image(image, affine, hdr),
                   os.path.join(data_dir, subject, "sa.nii.gz"))
        truth[subject] = (image, seg)
    return truth


def _la_scale(T, amp=0.3):
    """Atria fill as the ventricles contract: 2 - the SA contraction."""
    return 1.0 + amp * np.sin(np.pi * np.arange(T) / float(T)) ** 2


def la_phantom(X, Y, T, r_la, amp=0.3, noise=0.05, rng=None):
    """2-chamber LA cine, one slice (tests/phantom.py::la_phantom with
    n_class=2): the LA disk, largest mid-cycle.  Returns (image int16,
    seg int16) of shape (X, Y, 1, T)."""
    rng = rng or np.random.RandomState(1)
    cx, cy = X // 2, Y // 2
    scale = _la_scale(T, amp)
    image = np.zeros((X, Y, 1, T), np.float32)
    seg = np.zeros((X, Y, 1, T), np.int16)
    off = max(12, int(math.ceil(r_la * 2.0 * 0.6)))
    for t in range(T):
        la = _disk(X, Y, cx - off, cy, r_la * scale[t])
        seg[:, :, 0, t][la] = 1
        img = np.zeros((X, Y), np.float32)
        img[la] = 750.0
        img += rng.randn(X, Y).astype(np.float32) * noise * 1000.0
        image[:, :, 0, t] = np.clip(img, 0, 1000)
    return np.round(image).astype(np.int16), seg


def seg4_la_phantom(X, Y, T, zoom, amp=0.3, noise=0.05, rng=None):
    """4-chamber LA cine, one slice, with LV, Myo, RV, LA and RA (labels
    1-5; tests/phantom.py::seg4_la_phantom), every radius and offset
    scaled by ``zoom``.  Returns (image int16, seg int16)."""
    rng = rng or np.random.RandomState(2)
    cx, cy = X // 2, Y // 2
    scale = 2.0 - _la_scale(T, amp)
    image = np.zeros((X, Y, 1, T), np.float32)
    seg = np.zeros((X, Y, 1, T), np.int16)
    z = zoom
    for t in range(T):
        r = 11.0 * z * scale[t]
        lv = _disk(X, Y, cx - 10 * z, cy - 12 * z, r)
        epi = _disk(X, Y, cx - 10 * z, cy - 12 * z, r + 4 * z)
        rv = _disk(X, Y, cx + 14 * z, cy - 12 * z, r * 0.9) & ~epi
        la = _disk(X, Y, cx - 10 * z, cy + 16 * z,
                   8.0 * z * (2.0 - scale[t])) & ~epi
        ra = _disk(X, Y, cx + 14 * z, cy + 16 * z,
                   7.0 * z * (2.0 - scale[t])) & ~(epi | la | rv)
        sl = np.zeros((X, Y), np.int16)
        sl[rv], sl[epi & ~lv], sl[lv], sl[la], sl[ra] = 3, 2, 1, 4, 5
        seg[:, :, 0, t] = sl
        img = np.zeros((X, Y), np.float32)
        for lab, inten in ((1, 800), (2, 300), (3, 700), (4, 750), (5, 650)):
            img[sl == lab] = inten
        img += rng.randn(X, Y).astype(np.float32) * noise * 1000.0
        image[:, :, 0, t] = np.clip(img, 0, 1000)
    return np.round(image).astype(np.int16), seg


def ao_phantom(X, Y, T, r_aa, r_da, pulse_amp=0.15, noise=0.05, rng=None):
    """Aortic cine, one slice (tests/phantom.py::ao_phantom): pulsating
    ascending (label 1) and descending (label 2) aortic disks.  Returns
    (image int16, seg int16) of shape (X, Y, 1, T)."""
    rng = rng or np.random.RandomState(3)
    image = np.zeros((X, Y, 1, T), np.float32)
    seg = np.zeros((X, Y, 1, T), np.int16)
    pulse = 1.0 + pulse_amp * np.sin(2 * np.pi * np.arange(T) / T)
    peak = 1.0 + pulse_amp
    off_aa = max(14, int(math.ceil(r_aa * peak)) + 2)
    off_da = max(16, int(math.ceil(r_da * peak)) + 2)
    for t in range(T):
        aa = _disk(X, Y, X // 2 - off_aa, Y // 2, r_aa * pulse[t])
        da = _disk(X, Y, X // 2 + off_da, Y // 2, r_da * pulse[t])
        seg[:, :, 0, t][aa] = 1
        seg[:, :, 0, t][da & ~aa] = 2
        img = np.zeros((X, Y), np.float32)
        img[aa] = 900.0
        img[da] = 850.0
        img += rng.randn(X, Y).astype(np.float32) * noise * 1000.0
        image[:, :, 0, t] = np.clip(img, 0, 1000)
    return np.round(image).astype(np.int16), seg


def save_nifti(nifti, path, data, affine, dt=0.04):
    hdr = nifti.Nifti1Header()
    hdr.dim[0] = data.ndim
    hdr.dim[1:1 + data.ndim] = data.shape
    hdr.pixdim[1:4] = (1.8, 1.8, 10.0)
    if data.ndim == 4:
        hdr.pixdim[4] = dt
    nifti.save(nifti.Nifti1Image(data, affine, hdr), path)


def write_cohort(data_dir, nifti, T):
    """Complete subjects for the cohort (the construction of the JAX
    package's bench cohort): an SA cine (192, 208, 10, T) with r_lv 30,
    wall 10; one 4-chamber cine (zoom 2) that la_4ch and seg4 both read; a
    2-chamber cine (r_la 20); an aortic cine AO_SHAPE (r_aa 18, r_da 12);
    int16, world-consistent SA and LA affines; and the pressure CSV (two
    header rows, Vicorder fields 12678-2.0/2.1).  Returns
    {subject: {"la_2ch", "la_4ch", "seg4", "ao": truth labels}}."""
    truth = {}
    for i in range(N_SUBJECTS):
        subject = f"{2000000 + i}"
        d = os.path.join(data_dir, subject)
        os.makedirs(d)
        cines, truth[subject] = cohort_subject(i, T)
        for seq, cine in cines.items():
            save_nifti(nifti, os.path.join(d, f"{seq}.nii.gz"), cine,
                       COHORT_AFFINES[seq])
    write_pressures(os.path.join(os.path.dirname(data_dir), "bp.csv"),
                    sorted(truth))
    return truth


@functools.lru_cache(maxsize=None)
def cohort_subject(i, T):
    """The cines of :func:`write_cohort`'s subject ``i`` ({"sa", "la_4ch",
    "la_2ch", "ao"}: int16) and their truth labels ({"sa", "la_2ch",
    "la_4ch", "seg4", "ao"}).  Kept for the ingestion phase, which writes
    the same subjects again; read-only."""
    X, Y, Z = MAIN_SHAPE[:3]
    rng = np.random.RandomState(20 + i)
    sa, seg_sa = sax_phantom(X, Y, Z, T, r_lv=30.0, wall=10.0, rng=rng)
    la4, seg4 = seg4_la_phantom(X, Y, T, zoom=2.0, rng=rng)
    la2, seg2 = la_phantom(X, Y, T, r_la=20.0, rng=rng)
    ao, seg_ao = ao_phantom(*AO_SHAPE[:2], AO_SHAPE[3], r_aa=18.0, r_da=12.0,
                            rng=rng)
    seg_la4 = np.zeros_like(seg4)
    seg_la4[seg4 == 4], seg_la4[seg4 == 5] = 1, 2
    return ({"sa": sa, "la_4ch": la4, "la_2ch": la2, "ao": ao},
            {"sa": seg_sa, "la_2ch": seg2, "la_4ch": seg_la4, "seg4": seg4,
             "ao": seg_ao})


# the PheWAS phase: a synthetic UK Biobank-shaped table (two-row headers
# "<description>" / "<field>-<instance>.<array>", the confounder fields,
# the categories table's other fields in its order: continuous, ordinal
# with the -1 / -3 "do not know" codes, binary; 8 % missing) and IDPs
# driven by age and sex, with PHEWAS_PLANTED fields planted on IDPs
PHEWAS_CONFOUNDERS = [("Sex", "31-0.0"), ("Year of birth", "34-0.0"),
                      ("Month of birth", "52-0.0"),
                      ("Date of attending assessment centre", "53-2.0"),
                      ("Weight", "21002-2.0"),
                      ("Body mass index (BMI)", "21001-2.0")]
PHEWAS_PLANTED = 4


def phewas_tables(root, n_subjects, n_fields, n_idp, seed=0):
    """Write the IDP table and the non-imaging CSVs (the confounders in
    one, the fields in two more) of a synthetic cohort into ``root``;
    returns (IDP CSV, non-imaging CSVs, planted (IDP, field column)
    pairs).  Field IDs are the port's categories table's, so the
    Manhattan plot colours them by category."""
    import pandas as pd

    from ukbb_cardiac_tpu_torch.assoc.phewas import DEFAULT_CATEGORIES_TSV

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    n = n_subjects
    index = pd.Index(1000000 + np.arange(n), name="eid")
    sex = rng.randint(0, 2, n).astype(float)
    year = rng.randint(1940, 1971, n)
    month = rng.randint(1, 13, n)
    visit = rng.randint(0, 2500, n)
    dates = (np.datetime64("2014-06-01")
             + visit.astype("timedelta64[D]")).astype(str)
    weight = np.round(rng.normal(76, 14, n), 1)
    bmi = np.round(weight / (rng.normal(170, 9, n) / 100) ** 2, 4)
    age = (2014 - year) + visit / 365.25
    idp = (rng.randn(n, n_idp) + 0.05 * age[:, None]
           + 0.5 * sex[:, None] * rng.randn(1, n_idp))
    seen = {int(f.split("-")[0]) for _, f in PHEWAS_CONFOUNDERS} | {21003}
    fields = []
    with open(DEFAULT_CATEGORIES_TSV) as f:
        for line in f:
            if not line.startswith("#"):
                fid = int(line.split("\t")[1])
                if fid not in seen:
                    seen.add(fid)
                    fields.append(fid)
    fields = fields[:n_fields]
    vals = np.empty((n, len(fields)))
    for j, kind in enumerate(rng.randint(0, 3, len(fields))):
        if kind == 0:
            vals[:, j] = np.round(rng.normal(50, 10, n), 2)
        elif kind == 1:
            vals[:, j] = rng.choice([1, 2, 3, 4, -1, -3], n,
                                    p=[.3, .3, .2, .15, .03, .02])
        else:
            vals[:, j] = rng.rand(n) < rng.uniform(0.1, 0.5)
    vals[rng.rand(n, len(fields)) < 0.08] = np.nan
    planted = []
    for k in range(PHEWAS_PLANTED):
        j, i = 3 * k + 1, (7 * k) % n_idp
        vals[:, j] = np.round(50 + 10 * (idp[:, i] + rng.randn(n)), 2)
        planted.append((f"IDP {i}", f"{fields[j]}-2.0"))
    idp_path = os.path.join(root, "clinical_measures.csv")
    pd.DataFrame(idp, index=index, columns=[f"IDP {i}" for i in
                                            range(n_idp)]).to_csv(
        idp_path, float_format="%.6g")
    conf = pd.DataFrame(dict(enumerate((sex, year, month, dates, weight,
                                        bmi))), index=index)
    conf.columns = pd.MultiIndex.from_tuples(PHEWAS_CONFOUNDERS)
    paths = [os.path.join(root, "demographics.csv")]
    conf.to_csv(paths[0])
    cols = pd.MultiIndex.from_tuples([(f"Field {fid}", f"{fid}-2.0")
                                      for fid in fields])
    half = len(fields) // 2
    for part, sl in enumerate((slice(0, half), slice(half, None))):
        paths.append(os.path.join(root, f"category_{part}.csv"))
        pd.DataFrame(vals[:, sl], index=index, columns=cols[sl]).to_csv(
            paths[-1], float_format="%.6g")
    return idp_path, paths, planted


def write_pressures(path, subjects):
    """The pressure CSV of the aortic stage: two header rows, Vicorder
    fields 12678-2.0/2.1."""
    with open(path, "w") as f:
        f.write(f"eid,{PULSE_PRESSURE},{PULSE_PRESSURE}\n"
                ",12678-2.0,12678-2.1\n")
        for i, subject in enumerate(subjects):
            f.write(f"{subject},{40 + 2 * i},{42 + 2 * i}\n")


def write_ao_annotated(d, nifti, T, seed):
    """An aortic subject as the propagation takes it: the int16 cine
    (240, 196, 1, T) of :func:`ao_phantom` (r_aa 18, r_da 12), its
    sparse 4D label (ED and ES frames, 0 and T/2), the ED/ES stills and
    their labels.  Returns the truth (X, Y, 1, T)."""
    image, seg = ao_phantom(*AO_SHAPE[:2], T, r_aa=18.0, r_da=12.0,
                            pulse_amp=AO_PULSE,
                            rng=np.random.RandomState(seed))
    os.makedirs(d)
    save_nifti(nifti, os.path.join(d, "ao.nii.gz"), image, AFFINE_AO)
    ed, es = 0, T // 2
    label = np.zeros_like(seg)
    label[..., ed], label[..., es] = seg[..., ed], seg[..., es]
    save_nifti(nifti, os.path.join(d, "label_ao.nii.gz"), label, AFFINE_AO)
    for fr, t in (("ED", ed), ("ES", es)):
        save_nifti(nifti, os.path.join(d, f"ao_{fr}.nii.gz"), image[..., t],
                   AFFINE_AO)
        save_nifti(nifti, os.path.join(d, f"label_ao_{fr}.nii.gz"),
                   seg[..., t], AFFINE_AO)
    return seg


def propagation_case():
    """(pairs, crop (X, Y), lattice (Cx, Cy), spacing) of the propagation's
    registrations on :func:`write_ao_annotated`'s subjects: the crop is
    the annotated frames' bounding box + 10 (``auto_crop_image``)."""
    from ukbb_cardiac_tpu_torch.ops.crop import foreground_bbox
    from ukbb_cardiac_tpu_torch.reg.bspline import lattice_shape

    _, seg = ao_phantom(*AO_SHAPE[:2], AO_SHAPE[3], r_aa=18.0, r_da=12.0,
                        pulse_amp=AO_PULSE)
    x1, x2, y1, y2, _, _ = foreground_bbox(seg[..., list(AO_ANNOTATED)], 10)
    crop = (x2 - x1, y2 - y1)
    return (AO_SHAPE[3] - len(AO_ANNOTATED), crop, lattice_shape(crop, 10),
            10)


def dice(a, b, label):
    a, b = a == label, b == label
    return 2.0 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1)


def propagation_failures(got, truth, ref=None):
    """The propagation bounds (PROP_*) that the labels ``got`` miss:
    against the phantom ``truth`` and, where given, the labels ``ref`` of
    another run of the same subject."""
    T = truth.shape[-1]
    moving = [t for t in range(T) if t not in (0, T // 2)]
    failed = []
    if ref is not None:
        if np.mean(got != ref) > PROP_MAX_DISAGREE:
            failed.append("disagree")
        if np.mean([dice(got[..., t], ref[..., t], k) for t in range(T)
                    for k in (1, 2)]) < PROP_MIN_MEAN_DICE:
            failed.append("mean_dice")
    if np.mean([dice(got[..., t], truth[..., t], k) for t in moving
                for k in (1, 2)]) < PROP_MIN_TRUTH_DICE:
        failed.append("truth_dice")
    if min(dice(got[..., t], truth[..., t], 1) for t in range(T)) \
            <= PROP_MIN_DICE:
        failed.append("frame_dice")
    return failed


def idle_propagation(prop, nifti, d, T, seed):
    """The control: the subject of :func:`write_ao_annotated` propagated
    on the host with every registration field zero, which copies the
    annotated frames' labels to every frame.  Returns its labels."""
    real = prop.register_pairs
    prop.register_pairs = lambda crop, pairs, cfg, device: np.zeros(
        (len(pairs),) + crop.shape[:2] + (2,), np.float32)
    try:
        write_ao_annotated(d, nifti, T, seed)
        out = prop.propagate_subject(d, device="cpu")
    finally:
        prop.register_pairs = real
    return np.asarray(nifti.load(out).dataobj)


# --- phases ---------------------------------------------------------------

def build_phase(kernels):
    print("[1/14] build", flush=True)
    t0 = time.perf_counter()
    builds = kernels.build()
    print(f"  built {len(builds)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for b in builds.values():
        print(f"  {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.ptxas:
            print(f"    {line}")
    return builds


def head_bound(feats, n_class, same_dim, fc):
    """Least time of the head on this card for these inputs, for the
    kernel's algorithm (fc1 applied at each level's own resolution,
    csrc/fused_head.cu).  Returns (ms, 'operations' | 'bytes', f32_ms):
    - the tensor-core bound the kernel works against: its products as
      three TF32 products each (the 3xTF32 split) over the TF32 peak,
      beside the bilinear taps on the CUDA cores over the float32 peak
      (the two units run side by side), against bytes (features in once,
      logits out once) over the memory rate;
    - f32_ms, every FLOP on the CUDA cores over the float32 peak: the
      bound of a float32 design, printed beside it for comparison."""
    N, C0, X, Y = feats[0].shape
    pix = N * X * Y
    mma = 2 * pix * (C0 * same_dim + same_dim * fc     # level 0, fc1 slice
                     + fc * fc + fc * n_class)         # fc2, out
    taps = 0
    for f in feats[1:]:
        coarse = f.shape[0] * f.shape[2] * f.shape[3]
        mma += 2 * coarse * (f.shape[1] * same_dim      # projection
                             + same_dim * fc)           # fc1 slice
        taps += 2 * pix * 4 * fc                        # bilinear taps
    nbytes = sum(f.numel() * f.element_size() for f in feats) \
        + pix * n_class * 4
    t_ops = max(3 * mma / PEAK_TF32_FLOPS, taps / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    f32_ms = 1e3 * max((mma + taps) / PEAK_F32_FLOPS, t_bytes)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", f32_ms)


def ptxas_registers(build):
    """[(kernel<type>, registers, spill line)] from the compiler's -v
    lines (per entry: the name, then its spill line, then registers)."""
    out, name, spill = [], None, ""
    for line in build.ptxas:
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)I(\w+?)E", m.group(1))
            name = m.group(1) if not k else f"{k.group(1)}<" + (
                "bf16" if "bfloat16" in k.group(2) else "f32") + ">"
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
    return out


def head_vs_plain(fh, feats, head, dtype) -> float:
    """The head kernel against its plain version on the same features:
    max |kernel - plain| within KERNEL_ATOL, and argmax equal except at
    near-ties.  Returns the error; raises on a miss."""
    got = fh.fused_head(feats, head)
    torch.cuda.synchronize()
    ref = fh.fused_head_plain(feats, head)
    err = (got - ref).abs().max().item()
    if not math.isfinite(err) or err > KERNEL_ATOL[dtype]:
        raise AssertionError(f"fused_head {dtype}, {head.n_class} classes: "
                             f"max |kernel - plain| = {err} > "
                             f"{KERNEL_ATOL[dtype]}")
    differ = got.argmax(1) != ref.argmax(1)
    top2 = ref.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1])
    not_tie = int((differ & (margin > 2 * err)).sum())
    print(f"  {dtype}, {head.n_class} classes: max |kernel - plain| = "
          f"{err:.3e} (atol {KERNEL_ATOL[dtype]}); argmax differs at "
          f"{int(differ.sum())} of {differ.numel()} pixels, {not_tie} of "
          f"them not near-ties")
    if not_tie:
        raise AssertionError("argmax differs away from near-ties")
    return err


def kernel_phase(card, fh, tfcn, model, build):
    print("[2/14] fused head vs its plain version at the main path's shapes",
          flush=True)
    print(f"  fused_head.cu: nvcc {build.seconds:.2f} s; registers "
          + "; ".join(f"{k} {r} ({spill})"
                      for k, r, spill in ptxas_registers(build)))
    X, Y = MAIN_SHAPE[:2]
    image, _ = sax_phantom(X, Y, 2, CHUNK // 2, r_lv=0.1 * X, wall=0.039 * X,
                           rng=np.random.RandomState(7))
    slices = np.transpose(image, (3, 2, 0, 1)).reshape(CHUNK, X, Y, 1)
    x = torch.from_numpy(slices.astype(np.float32) / 1000.0).cuda()
    net, head = model.net, model.head
    result = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin = tfcn.nchw(x, dtype)
            feats = net.encode(xin)
            err = head_vs_plain(fh, feats, head, dtype)
            ms = cuda_ms(lambda: fh.fused_head(feats, head))
            plain_ms = cuda_ms(lambda: fh.fused_head_plain(feats, head))
            enc_ms = cuda_ms(lambda: net.encode(xin))
            bound_ms, bound_by, f32_ms = head_bound(
                feats, head.n_class, head.same_dim, head.W1.shape[1])
            print(f"  fused_head {dtype} at {tuple(feats[0].shape)}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}: 3xTF32 tensor cores), "
                  f"float32 CUDA-core bound {f32_ms:.4f} ms; share "
                  f"{100 * bound_ms / ms:.1f} %; cuDNN encoder "
                  f"{enc_ms:.4f} ms [{card}]")
            split = device_split(lambda: fh.fused_head(feats, head),
                                 ("coarse_kernel", "head_kernel"))
            print(f"  fused_head {dtype} under torch.profiler: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                  + f" of device time [{card}]")
            result[dtype] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    return result[torch.float32]


def la_head_phase(card, fh, tfcn, deploy):
    """The head with the trained LA bundles (2, 3 and 6 classes, padded to
    the kernel's 8 inside it) against its plain version at the LA
    deploys' shape: one forward of a (192, 208, 1, 50) cine's 50 frames."""
    X, Y, _, T = MAIN_SHAPE
    print(f"[2/14] fused head with the LA bundles vs its plain version at "
          f"({T}, {X}, {Y})", flush=True)
    rng = np.random.RandomState(9)
    cines = {"la_2ch": la_phantom(X, Y, T, r_la=20.0, rng=rng)[0]}
    cines["la_4ch"] = cines["seg4"] = seg4_la_phantom(X, Y, T, zoom=2.0,
                                                      rng=rng)[0]
    for key, path in LA_BUNDLES.items():
        model = deploy.load_segmentation_model(os.path.join(WEIGHTS, path),
                                               "cuda")
        slices = np.transpose(cines[key], (3, 2, 0, 1)).reshape(T, X, Y, 1)
        x = torch.from_numpy(slices.astype(np.float32) / 1000.0).cuda()
        with torch.inference_mode():
            feats = model.net.encode(tfcn.nchw(x, torch.float32))
            print(f"  {key}:", end="")
            head_vs_plain(fh, feats, model.head, torch.float32)
            ms = cuda_ms(lambda: fh.fused_head(feats, model.head))
            plain_ms = cuda_ms(lambda: fh.fused_head_plain(feats, model.head))
        print(f"  {key} at {tuple(feats[0].shape)}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms [{card}]")


def bspline_taps(tb, spacing: int, device) -> torch.Tensor:
    """(2, 1, 4s-1, 4s-1) separable cubic B-spline taps for the yardstick
    convolutions: tap j is B((j - (2s-1))/s) per axis."""
    j = np.arange(4 * spacing - 1)
    k = tb._cubic_bspline_np((j - (2 * spacing - 1)) / spacing)
    k = torch.from_numpy(k.astype(np.float32)).to(device)
    return (k[:, None] * k[None, :])[None, None].repeat(2, 1, 1, 1)


def bspline_bounds(B, C, X, s):
    """Least time of the forward and the adjoint on this card for these
    inputs (lattice C = (Cx, Cy), image X = (X, Y)): bytes (each input
    read once, each output written once) over the memory rate against the
    kernel's float32 FMAs (2 FLOP each) over the float32 peak.  Returns
    {name: (ms, 'bytes' | 'operations')}."""
    (Cx, Cy), (X, Y) = C, X
    lat, field = B * Cx * Cy * 2 * 4, B * X * Y * 2 * 4
    table = 4 * s * 4
    # forward: per column and run of s rows, 4 x 4 FMAs; then 4 per value
    fwd_flop = 2 * B * 2 * (Y * -(-X // s) * 16 + X * Y * 4)

    def support(n_ctl, n):  # each control's pixels along one axis
        return sum(max(min(n, (i + 1) * s) - max(0, (i - 3) * s), 0)
                   for i in range(n_ctl))

    # adjoint: rows then columns (clipped supports)
    adj_flop = 2 * B * 2 * (support(Cx, X) * Y + Cx * support(Cy, Y))
    out = {}
    for name, nbytes, flop in (("bspline_field", lat + field + table,
                                fwd_flop),
                               ("bspline_field_adjoint", field + lat + table,
                                adj_flop)):
        t_b, t_o = nbytes / PEAK_BYTES, flop / PEAK_F32_FLOPS
        out[name] = (1e3 * max(t_b, t_o),
                     "bytes" if t_b >= t_o else "operations")
    return out


def forward_shapes() -> dict:
    """The B-spline cases at the finest level of the SA and LA strain
    paths and the propagation's, by name."""
    return {"sa": (N_PAIRS, (96, 96), (13, 13), 10),
            "la": (N_LA_PAIRS, (LA_BUCKET, LA_BUCKET), (16, 16), 10),
            "propagation": propagation_case(),
            "both": (N_PAIRS_BOTH, (96, 96), (13, 13), 10)}


def bspline_cases():
    """Every B-spline case of phase 2, (pairs, (X, Y), (Cx, Cy), spacing),
    with its seeded lattices and cotangents (numpy, float32), in order."""
    cases = [(B, (X, X), (C, C), s) for B, X, C, s in BSPLINE_CASES]
    cases += [propagation_case(), VECTOR_CASE] + BOTH_CASES
    rng = np.random.RandomState(11)
    for case in cases:
        B, (X, Y), (Cx, Cy), _ = case
        c = rng.randn(B, Cx, Cy, 2).astype(np.float32)
        yield case, c, rng.randn(B, X, Y, 2).astype(np.float32)


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def bspline_phase(card, tb, bf):
    """The B-spline kernels against their plain versions at every shape of
    the strain path and at the aortic propagation's, and at VECTOR_CASE
    (the forward's unaligned stores at both row parities); the sha256 of
    the forward's output at each.  Returns the times at the SA strain path's finest level (the
    kernels line's, as through earlier slices), the LA path's and the
    propagation's."""
    import torch.nn.functional as F

    print("[2/14] B-spline synthesis and adjoint vs their plain versions, "
          f"B = {N_PAIRS} (SA), {N_LA_PAIRS} (LA) and {N_PAIRS_BOTH} (SA, "
          "both directions)", flush=True)
    result = {}
    for case, c, G in bspline_cases():
        B, (X, Y), (Cx, Cy), s = case
        c, G = torch.from_numpy(c).cuda(), torch.from_numpy(G).cuda()
        cr = c.clone().requires_grad_(True)
        field = bf.bspline_field(cr, (X, Y), s)
        field.backward(G)
        torch.cuda.synchronize()
        with torch.no_grad():
            plain = tb.bspline_dense_field_plain(c, (X, Y), s)
            plain_adj = tb.bspline_adjoint_plain(G, (Cx, Cy), s)
        err = (field.detach() - plain).abs().max().item()
        err_adj = (cr.grad - plain_adj).abs().max().item()
        if not err <= FIELD_ATOL or not err_adj <= ADJOINT_ATOL:
            raise AssertionError(
                f"bspline B={B} at {X}x{Y}/{Cx}x{Cy}/s{s}: max |kernel - "
                f"plain| {err} (atol {FIELD_ATOL}), adjoint {err_adj} "
                f"(atol {ADJOINT_ATOL})")
        W = bspline_taps(tb, s, c.device)
        c_nchw = c.permute(0, 3, 1, 2).contiguous()
        # the yardstick's correlation yields a control only where the
        # cotangent reaches it: zero rows beyond the image extend it to
        # the lattice's last control (a shorter crop than it covers)
        Xg, Yg = max(X, (Cx - 4) * s + 1), max(Y, (Cy - 4) * s + 1)
        G_nchw = F.pad(G.permute(0, 3, 1, 2), (0, Yg - Y, 0, Xg - X))
        lo = 3 * s - 1

        def fwd():
            return bf.bspline_field(c, (X, Y), s)

        def adj():
            return bf.bspline_field_adjoint(G, (Cx, Cy), s)

        def lib_fwd():
            return F.conv_transpose2d(c_nchw, W, stride=s,
                                      groups=2)[:, :, lo:lo + X, lo:lo + Y]

        def lib_adj():
            return F.conv2d(G_nchw, W, stride=s, groups=2,
                            padding=4 * s - 1)[:, :, 1:1 + Cx, 1:1 + Cy]

        with torch.no_grad():
            lib_err = (lib_fwd().permute(0, 2, 3, 1) - plain).abs().max()
            lib_err_adj = (lib_adj().permute(0, 2, 3, 1)
                           - plain_adj).abs().max()
            times = {
                "bspline_field": {
                    "ms": graph_ms(fwd), "eager_ms": cuda_ms(fwd),
                    "plain_ms": graph_ms(lambda: tb.bspline_dense_field_plain(
                        c, (X, Y), s)),
                    "library_ms": graph_ms(lib_fwd), "max_abs_err": err},
                "bspline_field_adjoint": {
                    "ms": graph_ms(adj), "eager_ms": cuda_ms(adj),
                    "plain_ms": graph_ms(lambda: tb.bspline_adjoint_plain(
                        G, (Cx, Cy), s)),
                    "library_ms": graph_ms(lib_adj),
                    "max_abs_err": err_adj}}
        bounds = bspline_bounds(B, (Cx, Cy), (X, Y), s)
        for name, t in times.items():
            t["bound_ms"], t["bound_by"] = bounds[name]
            print(f"  {name} B={B} {X}x{Y} lattice {Cx}x{Cy} s={s}: max "
                  "|kernel - "
                  f"plain| {t['max_abs_err']:.3e}; kernel {t['ms']:.5f} ms "
                  f"(graph replay; eager {t['eager_ms']:.5f} ms), plain "
                  f"{t['plain_ms']:.5f} ms, library {t['library_ms']:.5f} "
                  f"ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}) "
                  f"[{card}]")
        print(f"  yardstick vs plain: conv_transpose2d {lib_err.item():.3e}, "
              f"conv2d {lib_err_adj.item():.3e}; forward plan (rows, threads) "
              f"{bf.field_plan((X, Y), s)}, sha256 "
              f"{sha256(field)}")
        for key, ref in forward_shapes().items():
            if case == ref:
                result[key] = dict(times, shape=[B, X, Y, Cx, Cy, s])
    return result


def forward_vs_earlier(card, kernels, bf, tree):
    """The forward against an earlier design of it: builds ``tree``'s
    ``ukbb_cardiac_tpu_torch/csrc/bspline_field.cu`` (C interface ``B, Cx,
    Cy, X, Y, spacing, table, control, field, stream``), prints the sha256
    of both outputs on phase 2's inputs at every case, fails unless this
    tree's forward is within FIELD_ATOL of its plain version, and times
    both (graph replay) in turns, earlier / this / this / earlier, at the
    SA, LA and propagation shapes."""
    from ukbb_cardiac_tpu_torch.reg import bspline as tb

    print(f"[forward] this tree's B-spline forward against {tree}'s",
          flush=True)
    for line in kernels.build(["bspline_field"])["bspline_field"].ptxas:
        print(f"    {line}")
    src = os.path.join(tree, "ukbb_cardiac_tpu_torch", "csrc",
                       "bspline_field.cu")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = kernels.BUILD_DIR / "libbspline_field_earlier.so"
    t0 = time.perf_counter()
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                    str(lib_path), src], check=True)
    print(f"  earlier kernel built in {time.perf_counter() - t0:.2f} s")
    fn = ctypes.CDLL(str(lib_path)).ukbb_bspline_field
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    timed = {v: k for k, v in forward_shapes().items()}
    same = True
    for case, c, _ in bspline_cases():
        B, (X, Y), (Cx, Cy), s = case
        c = torch.from_numpy(c).cuda()
        table = bf.weight_table(s, c.device)

        def earlier():
            out = torch.empty((B, X, Y, 2), device=c.device)
            rc = fn(B, Cx, Cy, X, Y, s, table.data_ptr(), c.data_ptr(),
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"earlier field kernel: CUDA error {rc}")
            return out

        def this():
            return bf.bspline_field(c, (X, Y), s)

        a, b = earlier(), this()
        torch.cuda.synchronize()
        err = (b - tb.bspline_dense_field_plain(c, (X, Y), s)).abs().max()
        equal = torch.equal(a, b)
        same &= equal
        print(f"  B={B} {X}x{Y} lattice {Cx}x{Cy} s={s}: sha256 earlier "
              f"{sha256(a)}, this {sha256(b)}; bitwise equal {equal}; max "
              f"|this - plain| {err.item():.3e}")
        if not err.item() <= FIELD_ATOL:
            raise AssertionError(f"forward at {case}: {err.item()} from its "
                                 f"plain version (atol {FIELD_ATOL})")
        if case in timed:
            ms = [graph_ms(f) for f in (earlier, this, this, earlier)]
            print(f"  {timed[case]} times (graph replay, ms): earlier "
                  f"{ms[0]:.5f}, this {ms[1]:.5f}, this {ms[2]:.5f}, earlier "
                  f"{ms[3]:.5f} [{card}]")
    print(f"  every case bitwise equal: {same}")


def main_path_phase(card, fh, nifti, deploy, ventricle, engine_mod, work,
                    n_level):
    print(f"[3/14] main path: SA deploy + volumes, {N_SUBJECTS} subjects at "
          f"{MAIN_SHAPE} int16", flush=True)
    data_dir = os.path.join(work, "data")
    truth = write_subjects(data_dir, nifti)
    csv = os.path.join(work, "volumes.csv")

    fh.fused_head.launches = 0
    t0 = time.perf_counter()
    records = deploy.deploy_dataset(BUNDLE, data_dir, seq_name="sa",
                                    chunk=CHUNK, device="cuda")
    df = ventricle.evaluate_ventricular_volume_dataset(data_dir, csv)
    wall = time.perf_counter() - t0
    launches = {"fused_head": fh.fused_head.launches}
    print(f"  main path {wall:.2f} s; launches {launches}: "
          f"{launches['fused_head'] / n_level:g} fused_head calls x "
          f"{n_level} kernels (coarse levels + head)")
    if launches["fused_head"] <= 0:
        raise AssertionError("the main path never launched fused_head")
    if len(records) != N_SUBJECTS or len(df) != N_SUBJECTS:
        raise AssertionError(f"{len(records)} subjects segmented, "
                             f"{len(df)} volume rows; want {N_SUBJECTS}")

    for rec in records:
        print(f"  subject {rec['subject']}: cine wall {rec['seg_time']:.4f} "
              f"s, device {rec['device_ms']:.4f} ms [{card}]")
    for subject, (_, seg_true) in truth.items():
        seg = np.asarray(nifti.load(os.path.join(
            data_dir, subject, "seg_sa.nii.gz")).dataobj)
        if seg.shape != MAIN_SHAPE or not set(np.unique(seg)) <= {0, 1, 2, 3}:
            raise AssertionError(f"bad segmentation {seg.shape}")
        d = [dice(seg, seg_true, k) for k in (1, 2, 3)]
        row = df.loc[subject]
        vals = [row["LVEDV (mL)"], row["LVESV (mL)"], row["LVEF (%)"]]
        print(f"  subject {subject}: Dice LV/Myo/RV "
              f"{d[0]:.4f}/{d[1]:.4f}/{d[2]:.4f}; LVEDV {vals[0]:.3f} mL, "
              f"LVESV {vals[1]:.3f} mL, LVEF {vals[2]:.3f} %")
        if min(d) < 0.9 or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"subject {subject}: Dice {d}, {vals}")

    # the card's labels against the port's CPU path on a reduced cine
    image = truth["1000000"][0][:, :, :2, :4]
    cpu = engine_mod.InferenceEngine(deploy.load_segmentation_model(
        BUNDLE, "cpu"), chunk=CHUNK)
    gpu = engine_mod.InferenceEngine(deploy.load_segmentation_model(
        BUNDLE, "cuda"), chunk=CHUNK)
    seg_cpu = cpu.segment_sequence_dispatch(image).result()
    seg_gpu = gpu.segment_sequence_dispatch(image).result()
    agree = float((seg_cpu == seg_gpu).mean())
    print(f"  card vs CPU path on {image.shape}: label agreement {agree:.6f}")
    if agree < 0.999:
        raise AssertionError(f"card and CPU labels agree on only {agree}")

    # the engine's first call of the full shape runs each program eagerly
    # and captures it (prep, the 64-slice chunk forward, pack)
    path = os.path.join(work, "stages_sa.nii.gz")
    shutil.copy(os.path.join(data_dir, "1000001", "sa.nii.gz"), path)
    cine = np.asarray(nifti.load(
        os.path.join(data_dir, "1000000", "sa.nii.gz")).dataobj)
    n_before = len(gpu.programs())
    _, host, span, n, gc_s = timed_dispatch(
        lambda: gpu.segment_sequence_dispatch(cine))
    new = gpu.programs()[n_before:]
    print(f"  first call of {cine.shape} on an engine: dispatch {host:.4f} s "
          f"(eager run, then {len(new)} captures in "
          f"{sum(p.capture_s for p in new):.4f} s), device span "
          f"{span:.4f} ms, head launches {n}, GC {gc_s:.4f} s [{card}]:\n"
          + captured_programs(new))
    HELD_ENGINES.append(("SA", gpu))

    # where one cine's wall goes, stage by stage, without the pipeline
    # (a fresh copy of the file, so the reader's byte cache misses)
    t = [time.perf_counter()]
    nim = nifti.load(path)
    cine = np.asarray(nim.dataobj)
    t.append(time.perf_counter())
    pending = gpu.segment_sequence_dispatch(cine)
    t.append(time.perf_counter())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    seg = pending.result().astype(np.int16)
    t.append(time.perf_counter())
    nifti.save(nifti.Nifti1Image(seg, nim.affine),
               os.path.join(work, "stages_seg.nii.gz"))
    t.append(time.perf_counter())
    s = np.diff(t)
    print(f"  one cine by stage: read {s[0]:.4f} s, upload + enqueue "
          f"{s[1]:.4f} s, wait for the card {s[2]:.4f} s (device span "
          f"{pending.device_ms:.4f} ms), unpack {s[3]:.4f} s, seg write "
          f"{s[4]:.4f} s [{card}]")
    # the same cine on the eager route and through the graphs, in turns
    dispatch_routes(card, f"SA cine {cine.shape}",
                    lambda: gpu.segment_sequence_dispatch(cine))
    return launches


def strain_tables(stem):
    import pandas as pd

    return {k: pd.read_csv(f"{stem}_{k}.csv", index_col=0)
            for k in ("radial", "circum")}


def strain_phase(card, nifti, crop, bf, strain, register, cli_wt,
                 work):
    """Wall thickness and SA strain on the deployed subjects, then the
    card's strain against the port's CPU path on a reduced subject."""
    print(f"[4/14] main path: wall thickness + SA strain "
          f"(RegConfig.cine_2d_motion(), warp-Dice), {N_SUBJECTS} subjects",
          flush=True)
    data_dir = os.path.join(work, "data")
    t0 = time.perf_counter()
    cli_wt.main(["--data_dir", data_dir, "--output_csv",
                 os.path.join(work, "wall_thickness.csv"), "--device",
                 "cuda"])
    wt = np.loadtxt(os.path.join(work, "wall_thickness.csv"), delimiter=",",
                    skiprows=1, usecols=range(1, 18), ndmin=2)
    print(f"  wall thickness CLI {time.perf_counter() - t0:.3f} s; global "
          f"mean thickness {np.round(wt[:, -1], 4).tolist()} mm")
    if wt.shape[0] != N_SUBJECTS or not np.all(np.isfinite(wt[:, -1])):
        raise AssertionError(f"wall thickness rows {wt}")

    from ukbb_cardiac_tpu_torch.reg import programs

    cfg = register.RegConfig.cine_2d_motion()
    bf.bspline_field.launches = bf.bspline_field.adjoint_launches = 0
    rows, t_path = [], time.perf_counter()
    n_programs = len(programs.programs())
    for subject in sorted(os.listdir(data_dir)):
        subj = os.path.join(data_dir, subject)
        motion = os.path.join(subj, "cine_motion")
        os.makedirs(motion, exist_ok=True)
        before = (bf.bspline_field.launches, bf.bspline_field.adjoint_launches)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        ctx = strain.start_sa_motion_dispatch(subj, motion, cfg,
                                              eval_dice=True, device="cuda")
        ev[1].record()
        # the dispatch returns once its work is queued: what the card still
        # had to do then is what the CLI's pipeline overlaps with the host
        t_dispatch = time.perf_counter() - t0
        ev[1].synchronize()
        t_wait = time.perf_counter() - t0 - t_dispatch
        dice = strain.finish_sa_motion(ctx, os.path.join(subj, "strain_sa"))
        wall = time.perf_counter() - t0
        device_ms = ev[0].elapsed_time(ev[1])
        tab = strain_tables(os.path.join(subj, "strain_sa"))
        ecc = tab["circum"].loc["Global"].min()
        err = tab["radial"].loc["Global"].max()
        d = dice.values.mean(axis=0)
        n = (bf.bspline_field.launches - before[0],
             bf.bspline_field.adjoint_launches - before[1])
        pairs = len(ctx["selected"]) * ctx["T"]
        crop_xy = (ctx["X"], ctx["Y"])
        print(f"  subject {subject}: strain wall {wall:.4f} s (dispatch "
              f"returned at {t_dispatch:.4f} s, then {t_wait:.4f} s of queued "
              f"work), device span {device_ms:.4f} ms [{card}]; {pairs} "
              f"pairs, crop {crop_xy} -> "
              f"{strain.bucket_hw(*crop_xy)}; global Ecc {ecc:.4f} %, Err "
              f"{err:.4f} %; warp-Dice LV {d[0]:.4f} Myo {d[1]:.4f}; "
              f"bspline_field launches {n[0]}, adjoint {n[1]}")
        values = np.concatenate([t.values.ravel() for t in tab.values()])
        if not np.all(np.isfinite(values[~np.isnan(values)])) or not (
                np.isfinite(ecc) and np.isfinite(err)):
            raise AssertionError(f"subject {subject}: strain not finite")
        if not d[0] >= 0.9:
            raise AssertionError(f"subject {subject}: mean LV warp-Dice "
                                 f"{d[0]} < 0.9")
        if not rows:
            # the first subject ran each program once eagerly and then
            # captured it; the others replay
            first = programs.programs()[n_programs:]
            print(f"  first subject: {len(first)} programs captured in "
                  f"{sum(p.capture_s for p in first):.3f} s (host, after "
                  f"one eager run each), memory_reserved +"
                  f"{sum(p.reserved for p in first) / 2 ** 20:.1f} MiB "
                  f"[{card}]:\n" + captured_programs(first))
        rows.append((subject, wall, device_ms))
    launches = {"bspline_field": bf.bspline_field.launches,
                "bspline_field_adjoint": bf.bspline_field.adjoint_launches}
    print(f"  strain path {time.perf_counter() - t_path:.2f} s; launches "
          f"{launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the strain path never launched {name}")

    # the last subject's device stages alone (CUDA events): the batched
    # registration, then densify + invert + compose + blend
    seg_ed = np.array(nifti.load(os.path.join(subj, "seg_sa_ED.nii.gz"))
                      .dataobj)
    seg_ed[seg_ed == 3] = 0
    x1, x2, y1, y2, z1, z2 = crop.foreground_bbox(seg_ed, 20)
    sa = np.asarray(nifti.load(os.path.join(subj, "sa.nii.gz")).dataobj)
    sa = sa[x1:x2, y1:y2, z1:z2].astype(np.float32)
    frames = np.stack([np.transpose(sa[:, :, z], (2, 0, 1))
                       for z in ctx["selected"]])
    Xp, Yp = strain.bucket_hw(*frames.shape[2:])
    frames = np.pad(frames, ((0, 0), (0, 0), (0, Xp - frames.shape[2]),
                             (0, Yp - frames.shape[3])))
    reg = register.make_register_batch((Xp, Yp), cfg, device="cuda")
    stages = {}
    for name in ("eager", "graphs"):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

        def timed_register(targets, sources):
            out = reg(targets, sources)
            ev[1].record()
            return out

        with route(name):
            torch.cuda.synchronize()
            ev[0].record()
            fields = strain.track_multi_slice_fields(
                frames, cfg, register_batch=timed_register, device="cuda")
            ev[2].record()
            ev[2].synchronize()
            # the same again under torch.profiler: kernels launched and
            # the time the card was busy, against the unprofiled span
            n_kern, busy = profiled(lambda: strain.track_multi_slice_fields(
                frames, cfg, register_batch=reg, device="cuda"))
        span = ev[0].elapsed_time(ev[2])
        stages[name] = fields
        print(f"  one subject's device stages, {name} route: registration "
              f"of {frames.shape[0] * frames.shape[1]} pairs at {(Xp, Yp)} "
              f"{ev[0].elapsed_time(ev[1]):.3f} ms, densify + invert + "
              f"compose + blend {ev[1].elapsed_time(ev[2]):.3f} ms [{card}]")
        if busy > 0:
            print(f"  profiled, {name} route: {n_kern} device ops (kernels, "
                  f"copies), busy {busy:.3f} ms of the {span:.3f} ms span "
                  f"({100 * (1 - busy / span):.1f} % idle) [{card}]")
        else:
            print("  profiled: no device time recorded (device busy share "
                  "not measured)")
    same_fields = torch.equal(stages["eager"], stages["graphs"])
    # the stages after the fields (the JAX _sample_program and
    # _warp_dice_program): the contour points' displacements and the
    # warp-Dice, on points and labels of the subject's sizes, on each
    # route (the graphs already captured by the strain path above)
    fields = stages["graphs"]
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.uniform(
        0, min(Xp, Yp) - 1, (fields.shape[0], strain.bucket_points(200),
                             2)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.randint(
        0, 3, fields.shape[:4]).astype(np.int32)).cuda()
    tail = {}
    with torch.no_grad():
        for name in ("eager", "graphs", "graphs", "eager"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with route(name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[0].record()
                disp = strain.sample_points(fields, pts)
                ev[1].record()
                t1 = time.perf_counter()
                dice_t = strain.warp_dice(labels, fields, Xp - 3, Yp - 2)
                ev[2].record()
                t2 = time.perf_counter()
                ev[2].synchronize()
                ops = [profiled(lambda: strain.sample_points(fields, pts)),
                       profiled(lambda: strain.warp_dice(labels, fields,
                                                         Xp - 3, Yp - 2))]
            if name in tail:
                same = (torch.equal(disp, tail[name][0])
                        and torch.equal(dice_t, tail[name][1]))
                if not same:
                    raise AssertionError(f"point sampling / warp-Dice on "
                                         f"the {name} route changed")
            tail[name] = (disp, dice_t)
            print(f"  after the fields, {name} route: point sampling "
                  f"{ev[0].elapsed_time(ev[1]):.3f} ms (host "
                  f"{1e3 * (t1 - t0):.3f} ms), {ops[0][0]} device ops busy "
                  f"{ops[0][1]:.3f} ms; warp-Dice "
                  f"{ev[1].elapsed_time(ev[2]):.3f} ms (host "
                  f"{1e3 * (t2 - t1):.3f} ms), {ops[1][0]} device ops busy "
                  f"{ops[1][1]:.3f} ms [{card}]")
    same = all(torch.equal(a, b) for a, b in zip(tail["eager"],
                                                   tail["graphs"]))
    print(f"  point sampling and warp-Dice: graphs "
          f"{'bitwise equal to' if same else 'DIFFER from'} the eager "
          f"route")
    if not same:
        raise AssertionError("graphed point sampling / warp-Dice differ")

    # the last subject's strain tables and warp-Dice on the eager route
    # against its graphed run above
    motion = os.path.join(subj, "cine_motion_eager")
    os.makedirs(motion)
    t0 = time.perf_counter()
    with route("eager"):
        dice_eager = strain.cine_2d_sa_motion_and_strain_analysis(
            subj, motion, os.path.join(subj, "strain_sa_eager"), cfg,
            eval_dice=True, device="cuda")
    wall_eager = time.perf_counter() - t0
    tab_eager = strain_tables(os.path.join(subj, "strain_sa_eager"))
    bitwise = (same_fields and tables_equal(tab_eager, tab) and
               np.array_equal(dice_eager.values, dice.values))
    seg_diff = max(np.nanmax(np.abs(tab_eager[k].values - tab[k].values))
                   for k in tab)
    dice_diff = float(np.abs(dice_eager.values - dice.values).max())
    print(f"  subject {subject}, graphs against the eager route: strain "
          f"tables, warp-Dice and fields {'bitwise equal' if bitwise else 'NOT bitwise equal'}"
          f" (largest differences {seg_diff:.6g} pp, warp-Dice "
          f"{dice_diff:.6g}); eager strain wall {wall_eager:.4f} s against "
          f"the graphed {rows[-1][1]:.4f} s [{card}]")
    if not bitwise:
        print("  not bitwise: a replay runs the eager route's kernels in its "
              "order, so a difference comes from a kernel whose result "
              "depends on its launch; held to the CPU bounds")
        if not (seg_diff <= STRAIN_SEGMENT_ATOL and dice_diff <= DICE_ATOL):
            raise AssertionError("graphed and eager strain disagree beyond "
                                 "the CPU bounds")

    subj = os.path.join(data_dir, rows[0][0])

    # the card against the port's CPU path on a reduced subject: the first
    # subject's cine cut to 6 frames
    red = os.path.join(work, "reduced", rows[0][0])
    os.makedirs(red)
    for name in ("sa", "seg_sa"):
        src = nifti.load(os.path.join(subj, f"{name}.nii.gz"))
        arr = np.asarray(src.dataobj)[..., :6]
        hdr = src.header.copy()
        hdr["dim"][4] = 6
        nifti.save(nifti.Nifti1Image(arr, src.affine, hdr),
                   os.path.join(red, f"{name}.nii.gz"))
    shutil.copy(os.path.join(subj, "seg_sa_ED.nii.gz"), red)
    out = {}
    for dev in ("cuda", "cpu"):
        motion = os.path.join(red, f"motion_{dev}")
        os.makedirs(motion)
        t0 = time.perf_counter()
        dice = strain.cine_2d_sa_motion_and_strain_analysis(
            red, motion, os.path.join(red, f"strain_{dev}"), cfg,
            eval_dice=True, device=dev)
        out[dev] = (strain_tables(os.path.join(red, f"strain_{dev}")),
                    dice.values, time.perf_counter() - t0)
    seg_diff = max(np.nanmax(np.abs(out["cuda"][0][k].values
                                    - out["cpu"][0][k].values))
                   for k in ("radial", "circum"))
    glob_diff = max(np.abs(out["cuda"][0][k].loc["Global"].values
                           - out["cpu"][0][k].loc["Global"].values).max()
                    for k in ("radial", "circum"))
    dice_diff = np.abs(out["cuda"][1] - out["cpu"][1]).max()
    print(f"  card vs CPU strain on a (192, 208, 10, 6) subject: per-segment "
          f"{seg_diff:.4f} pp (bound {STRAIN_SEGMENT_ATOL}), global "
          f"{glob_diff:.4f} pp (bound {STRAIN_GLOBAL_ATOL}), warp-Dice "
          f"{dice_diff:.5f} (bound {DICE_ATOL}); card {out['cuda'][2]:.3f} "
          f"s, CPU {out['cpu'][2]:.3f} s")
    if not (seg_diff <= STRAIN_SEGMENT_ATOL and glob_diff <= STRAIN_GLOBAL_ATOL
            and dice_diff <= DICE_ATOL):
        raise AssertionError("card and CPU strain disagree")
    return launches


def per_worker_streams(cohort_mod):
    """Patch ``cohort_mod.process_subject_full`` so that each worker
    thread runs its subjects on a CUDA stream of its own (the cohort
    driver issues every worker's work on the default stream).  Returns
    the function to restore."""
    inner = cohort_mod.process_subject_full
    local = threading.local()

    def on_own_stream(*args, **kwargs):
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            return inner(*args, **kwargs)

    cohort_mod.process_subject_full = on_own_stream
    return inner


def cohort_phase(card, work):
    """The port's cohort CLI in full mode (SA chain, then the three LA
    deploys, atrial volumes and LA strain) over N_SUBJECTS full-size
    subjects as a user runs it: with 1 worker (the default), then with 3
    workers on the shared default stream and on a stream per worker,
    in the order shared, own, own, shared, then with 1 worker again
    (every shape's graphs captured by then); then the LA outputs held
    against the truth and against the port's CPU path.  Returns the
    kernels' launches in the 1-worker run."""
    import pandas as pd

    from ukbb_cardiac_tpu_torch.cli import run_cohort
    from ukbb_cardiac_tpu_torch.infer import deploy
    from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.models import fused_head as fh
    from ukbb_cardiac_tpu_torch.parallel import cohort as cohort_mod
    from ukbb_cardiac_tpu_torch.phenotype import atrium, strain_la
    from ukbb_cardiac_tpu_torch.phenotype.strain import bucket_hw
    from ukbb_cardiac_tpu_torch.reg import bspline_field as bf
    from ukbb_cardiac_tpu_torch.reg.register import RegConfig

    T = MAIN_SHAPE[3]
    print(f"[5/14] cohort: run_cohort full mode (SA + la_2ch, la_4ch, seg4 + "
          f"aortic) on {N_SUBJECTS} subjects, SA {MAIN_SHAPE}, LA "
          f"{MAIN_SHAPE[:2] + (1, T)}, aortic {AO_SHAPE} int16, workers 1 "
          f"and 3", flush=True)
    data_dir = os.path.join(work, "cohort")
    truth = write_cohort(data_dir, nifti, T)
    args = ["--data_dir", data_dir, "--model_path", BUNDLE,
            "--model_path_la_2ch", os.path.join(WEIGHTS, LA_BUNDLES["la_2ch"]),
            "--model_path_la_4ch", os.path.join(WEIGHTS, LA_BUNDLES["la_4ch"]),
            "--model_path_seg4", os.path.join(WEIGHTS, LA_BUNDLES["seg4"]),
            "--model_path_ao", AO_BUNDLE,
            "--pressure_csv", os.path.join(work, "bp.csv"),
            "--device", "cuda", "--force"]
    # the last run repeats the first once every shape's graphs are
    # captured (run 1 captures the registrations of each new crop shape)
    runs = [(1, "default stream"), (3, "default stream"),
            (3, "stream per worker"), (3, "stream per worker"),
            (3, "default stream"), (1, "default stream")]
    first = first_tables = None
    for i, (workers, streams) in enumerate(runs):
        tag = f"run {i + 1}, workers {workers}, {streams}"
        out = os.path.join(work, f"cohort_csv_{i}")
        manifest = os.path.join(work, f"cohort_{i}.json")
        fh.fused_head.launches = 0
        fh.fused_head.launches_by_class = {}
        bf.bspline_field.launches = bf.bspline_field.adjoint_launches = 0
        inner = (per_worker_streams(cohort_mod)
                 if streams == "stream per worker" else None)
        try:
            with StallWatch() as watch:
                rc = run_cohort.main(args + ["--workers", str(workers),
                                             "--output_dir", out,
                                             "--manifest", manifest])
        finally:
            if inner is not None:
                cohort_mod.process_subject_full = inner
        print(watch.report(tag))
        launches = {"fused_head": fh.fused_head.launches,
                    "bspline_field": bf.bspline_field.launches,
                    "bspline_field_adjoint": bf.bspline_field.adjoint_launches,
                    "by_class": dict(sorted(
                        fh.fused_head.launches_by_class.items()))}
        first = first or launches
        with open(manifest) as f:
            m = json.load(f)
        if rc != 0 or len(m["succeeded"]) != N_SUBJECTS or m["failed"]:
            raise AssertionError(f"cohort {tag}: rc {rc}, "
                                 f"failed {m['failed']}")
        wall = m["wall_seconds"]
        median = {k: float(np.median([st[k] for st in
                                      m["stage_seconds"].values()]))
                  for k in COHORT_STAGES}
        print(f"  {tag}: cohort wall {wall:.3f} s, "
              f"{len(m['succeeded']) / wall:.4f} subjects/s; "
              f"memory_reserved after it "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB, allocated "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB (the run "
              f"released its engines' graphs) [{card}]")
        print(f"  {tag}: median stage s over subjects: "
              + ", ".join(f"{k} {v:.3f}" for k, v in median.items())
              + f" [{card}]")
        print(f"  {tag}: launches per subject: fused_head "
              f"{launches['fused_head'] / N_SUBJECTS:g} (by classes "
              + ", ".join(f"{c}: {n / N_SUBJECTS:g}"
                          for c, n in launches["by_class"].items())
              + f"), bspline_field "
              f"{launches['bspline_field'] / N_SUBJECTS:g}, adjoint "
              f"{launches['bspline_field_adjoint'] / N_SUBJECTS:g}")
        if not all(
                launches[k] > 0 for k in ("fused_head", "bspline_field",
                                          "bspline_field_adjoint")):
            raise AssertionError(f"cohort {tag} launched a kernel no "
                                 f"time: {launches}")
        if not {2, 3, 4, 6} <= set(launches["by_class"]):
            raise AssertionError(f"cohort {tag}: head launches by classes "
                                 f"{launches['by_class']}: want 2, 3, 4 "
                                 f"and 6")
        tables = {}
        for name, n_col in COHORT_TABLES.items():
            tab = tables[name] = pd.read_csv(os.path.join(out, name),
                                             index_col=0).sort_index()
            if tab.shape != (N_SUBJECTS, n_col) or not np.isfinite(
                    tab.values.astype(float)).all():
                raise AssertionError(f"{name}: shape {tab.shape}, want "
                                     f"{(N_SUBJECTS, n_col)}, or not finite")
        first_tables = first_tables or tables
        if i:
            # every worker replays the same programs: the rows are run 1's
            same = tables_equal(tables, first_tables)
            print(f"  {tag}: rows {'equal to' if same else 'DIFFER from'} "
                  f"run 1's (1 worker)" + ("" if same else ": " + ", ".join(
                      f"{k} {np.abs(t.values - first_tables[k].values).max():.6g}"
                      for k, t in tables.items())))
            if not same:
                raise AssertionError(f"cohort {tag}: rows differ from the "
                                     f"1-worker run's")
    launches = first

    # the deployed LA labels against the phantom truth
    prefix = {"la_2ch": "seg_la_2ch", "la_4ch": "seg_la_4ch",
              "seg4": "seg4_la_4ch"}
    for subject, tr in truth.items():
        d = []
        for key in prefix:
            seg_true = tr[key]
            seg = np.asarray(nifti.load(os.path.join(
                data_dir, subject, f"{prefix[key]}.nii.gz")).dataobj)
            d += [dice(seg, seg_true, k)
                  for k in range(1, int(seg_true.max()) + 1)]
        print(f"  subject {subject}: Dice la_2ch LA {d[0]:.4f}; la_4ch LA/RA "
              f"{d[1]:.4f}/{d[2]:.4f}; seg4 LV/Myo/RV/LA/RA "
              + "/".join(f"{v:.4f}" for v in d[3:]))
        if min(d) < 0.9:
            raise AssertionError(f"subject {subject}: LA Dice {d}")

    # one subject's LA deploys on the port's CPU path, written as the
    # cohort writes them: labels and the atrial row against the card's
    subj = os.path.join(data_dir, sorted(truth)[0])
    cpu_root = os.path.join(work, "la_cpu")
    cpu_subj = os.path.join(cpu_root, os.path.basename(subj))
    os.makedirs(cpu_subj)
    for name in ("sa", "la_2ch", "la_4ch"):
        shutil.copy(os.path.join(subj, f"{name}.nii.gz"), cpu_subj)
    for key, path in LA_BUNDLES.items():
        seq = "la_2ch" if key == "la_2ch" else "la_4ch"
        deploy.deploy_dataset(os.path.join(WEIGHTS, path), cpu_root,
                              seq_name=seq, seg4=key == "seg4",
                              device="cpu")
        seg_card, seg_cpu = (np.asarray(nifti.load(os.path.join(
            d, f"{prefix[key]}.nii.gz")).dataobj) for d in (subj, cpu_subj))
        agree = float((seg_cpu == seg_card).mean())
        # each LA cine's device span on the card: a fresh engine's first
        # call (an eager run, then the captures), then each route with 1
        # and 3 workers, then a second fresh engine's first call (the
        # capture is the engine's; what the process loads once is not
        # paid again)
        cine = np.asarray(nifti.load(os.path.join(
            subj, f"{seq}.nii.gz")).dataobj)
        for n_engine in (1, 2):
            eng = InferenceEngine(deploy.load_segmentation_model(
                os.path.join(WEIGHTS, path), "cuda"))
            want, host, span, _, gc_s = timed_dispatch(
                lambda: eng.segment_sequence_dispatch(cine))
            print(f"  {key} {cine.shape}: fresh engine {n_engine}, first "
                  f"call (eager run + {len(eng.programs())} captures in "
                  f"{sum(p.capture_s for p in eng.programs()):.4f} s): "
                  f"dispatch {host:.4f} s, device span {span:.4f} ms, GC "
                  f"{gc_s:.4f} s [{card}]")
            if n_engine == 2:
                t0 = time.perf_counter()
                eng.release_programs()
                print(f"  {key}: fresh engine 2's programs released in "
                      f"{time.perf_counter() - t0:.4f} s")
            if n_engine == 1:
                dispatch_routes(card, f"{key} {cine.shape}, 1 worker",
                                lambda: eng.segment_sequence_dispatch(cine))
                for name in ("eager", "graphs"):
                    threaded_dispatches(
                        card, f"{key} {cine.shape}",
                        lambda: eng.segment_sequence_dispatch(cine), name,
                        want)
                HELD_ENGINES.append((key, eng))
        print(f"  {key} {cine.shape}: card vs CPU label agreement "
              f"{agree:.6f}")
        if agree < 0.999:
            raise AssertionError(f"{key}: card and CPU labels agree on only "
                                 f"{agree}")
    # the table of the last run, which wrote the segs on disk
    tab = pd.read_csv(os.path.join(work, f"cohort_csv_{len(runs) - 1}",
                                   "table_atrial_volume.csv"), index_col=0)
    card_row = tab.loc[int(os.path.basename(subj))].values
    cpu_row = np.array(list(atrium.atrial_volume_measures(cpu_subj).values()))
    rel = np.abs(card_row - cpu_row).max() / np.abs(cpu_row).max()
    print(f"  atrial row {os.path.basename(subj)}: card "
          f"{np.round(card_row, 4).tolist()}, from the CPU's segs "
          f"{np.round(cpu_row, 4).tolist()}; max difference {rel:.3e} of "
          f"the largest (bound {ATRIAL_RTOL})")
    if not np.allclose(card_row, cpu_row, rtol=ATRIAL_RTOL, atol=0):
        raise AssertionError(f"atrial rows differ: {card_row} vs {cpu_row}")

    # one subject's LA strain alone on the card: launches, wall, device
    # span, replaying the graphs the cohort captured and on the eager route
    cfg = RegConfig()
    alone = {}
    for name in ("graphs", "eager"):
        motion = os.path.join(subj, f"la_motion_alone_{name}")
        os.makedirs(motion)
        before = (bf.bspline_field.launches,
                  bf.bspline_field.adjoint_launches)
        t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with route(name):
            ev[0].record()
            ctx = strain_la.start_la_motion_dispatch(
                subj, motion, cfg, eval_dice=True, device="cuda")
            ev[1].record()
            ev[1].synchronize()
        dice_df = strain_la.finish_la_motion(
            ctx, os.path.join(subj, f"alone_{name}"), eval_dice=True)
        dice_la = dice_df.values.mean(axis=0)
        n = (bf.bspline_field.launches - before[0],
             bf.bspline_field.adjoint_launches - before[1])
        ell = pd.read_csv(os.path.join(subj, f"alone_{name}_longit.csv"),
                          index_col=0)
        alone[name] = ({"longit": ell}, dice_df.values, n)
        print(f"  LA strain of {os.path.basename(subj)} alone, {name} "
              f"route: wall {time.perf_counter() - t0:.4f} s, device span "
              f"{ev[0].elapsed_time(ev[1]):.4f} ms [{card}]; {T} pairs, "
              f"crop {(ctx['X'], ctx['Y'])} -> "
              f"{bucket_hw(ctx['X'], ctx['Y'], 64)}; global Ell min "
              f"{ell.loc['Global'].min():.4f} %; warp-Dice LV "
              f"{dice_la[0]:.4f}; bspline_field launches {n[0]}, adjoint "
              f"{n[1]}")
        if min(n) <= 0:
            raise AssertionError("the LA strain launched no B-spline kernel")
    bitwise = (tables_equal(alone["graphs"][0], alone["eager"][0])
               and np.array_equal(alone["graphs"][1], alone["eager"][1]))
    diff = float(np.nanmax(np.abs(alone["graphs"][0]["longit"].values
                                  - alone["eager"][0]["longit"].values)))
    print(f"  LA strain, graphs against the eager route: "
          f"{'bitwise equal' if bitwise else 'NOT bitwise equal'} (largest "
          f"difference {diff:.6g} pp); launches "
          f"{'equal' if alone['graphs'][2] == alone['eager'][2] else 'DIFFER'}")
    if alone["graphs"][2] != alone["eager"][2]:
        raise AssertionError("the graphed LA strain counted other launches")
    if not bitwise and not diff <= LA_STRAIN_SEGMENT_ATOL:
        raise AssertionError("graphed and eager LA strain disagree beyond "
                             "the CPU bounds")
    if bucket_hw(ctx["X"], ctx["Y"], 64) != (LA_BUCKET, LA_BUCKET):
        raise AssertionError(f"the LA crop's bucket is not the "
                             f"{LA_BUCKET}^2 the B-spline phase checked")

    # the card's LA strain against the port's CPU path on a reduced
    # subject: its cines cut to 6 frames
    red = os.path.join(work, "la_reduced")
    os.makedirs(red)
    for name in ("la_4ch", "seg4_la_4ch"):
        src = nifti.load(os.path.join(subj, f"{name}.nii.gz"))
        save_nifti(nifti, os.path.join(red, f"{name}.nii.gz"),
                   np.asarray(src.dataobj)[..., :6], src.affine)
    for name in ("seg4_la_4ch_ED.nii.gz", "seg_sa_ED.nii.gz"):
        shutil.copy(os.path.join(subj, name), red)
    out = {}
    for dev in ("cuda", "cpu"):
        m_dir = os.path.join(red, f"motion_{dev}")
        os.makedirs(m_dir)
        strain_la.cine_2d_la_motion_and_strain_analysis(
            red, m_dir, os.path.join(red, f"strain_{dev}"), cfg,
            device=dev)
        out[dev] = pd.read_csv(os.path.join(red, f"strain_{dev}_longit.csv"),
                               index_col=0)
    diff = np.abs(out["cuda"].values - out["cpu"].values)
    seg_diff, glob_diff = np.nanmax(diff), diff[-1].max()
    print(f"  card vs CPU LA strain on a {MAIN_SHAPE[:2] + (1, 6)} subject: "
          f"per-segment {seg_diff:.4f} pp (bound {LA_STRAIN_SEGMENT_ATOL}), "
          f"global {glob_diff:.4f} pp (bound {LA_STRAIN_GLOBAL_ATOL})")
    if not (seg_diff <= LA_STRAIN_SEGMENT_ATOL
            and glob_diff <= LA_STRAIN_GLOBAL_ATOL):
        raise AssertionError("card and CPU LA strain disagree")
    del launches["by_class"]
    return launches, truth


# SA cines as a cohort meets them: UK Biobank's differ in slices and in
# matrix size; (198, 208) and (204, 208) pad to one 208^2 chunk plane
SHAPES = [(192, 208, 10, 50), (192, 208, 8, 50), (192, 208, 12, 50),
          (198, 208, 11, 50), (204, 208, 13, 50), (180, 192, 9, 50)]


def shapes_phase(card, work):
    """``run_cohort_sa`` through one SA engine (the default bound on its
    programs) on subjects of six cine shapes, one subject a call, as a
    long run meets new shapes: after each, the engine's programs and
    bytes, the programs it dropped, the registration's programs, and
    memory_reserved; host stalls watched.  Then the same cines through
    an engine bounded to a third of that, each twice: labels bitwise the
    first engine's.  Both engines released at the end."""
    from ukbb_cardiac_tpu_torch.infer import deploy
    from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.parallel import cohort as cohort_mod
    from ukbb_cardiac_tpu_torch.reg import programs

    print(f"[5/14] cohort across SA cine shapes: run_cohort_sa on "
          f"{len(SHAPES)} subjects {SHAPES} int16, one engine, one subject "
          f"a call", flush=True)
    root = os.path.join(work, "shapes")
    cines = []
    for i, shape in enumerate(SHAPES):
        cine, _ = sax_phantom(*shape, r_lv=30.0, wall=10.0,
                              rng=np.random.RandomState(40 + i))
        d = os.path.join(root, f"{3000000 + i}")
        os.makedirs(d)
        save_nifti(nifti, os.path.join(d, "sa.nii.gz"), cine, AFFINE_SA)
        cines.append(cine)
    eng = InferenceEngine(deploy.load_segmentation_model(BUNDLE, "cuda"))
    torch.cuda.synchronize()
    print(f"  before: memory_reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB; the engine's "
          f"bound {eng._programs.max_bytes / 2 ** 30:.3f} GiB [{card}]")
    most = 0
    for i, shape in enumerate(SHAPES):
        with StallWatch() as watch:
            result = cohort_mod.run_cohort_sa(
                root, eng, workers=1, start_idx=i, end_idx=i + 1,
                verbose=False, device="cuda")
        if len(result.fleet.succeeded) != 1:
            raise AssertionError(f"shape {shape}: {result.fleet.failed}")
        (stages,) = result.stage_seconds.values()
        held = eng._programs.nbytes()
        most = max(most, held)
        shared = programs.programs()
        print(f"  {shape}: subject {result.wall_seconds:.3f} s (segment "
              f"{stages['segment']:.3f}, strain {stages['strain']:.3f}); "
              f"engine {len(eng.programs())} programs "
              f"{held / 2 ** 30:.3f} GiB, {eng._programs.dropped} dropped; "
              f"registration {len(shared)} programs "
              f"{sum(p.reserved for p in shared) / 2 ** 30:.3f} GiB; "
              f"memory_reserved {torch.cuda.memory_reserved() / 2 ** 30:.3f}"
              f" GiB, allocated "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB [{card}]")
        print(watch.report(f"{shape}"))
        if held > eng._programs.max_bytes and len(eng.programs()) > 1:
            raise AssertionError(f"the engine holds {held} bytes of "
                                 f"programs, over its bound")
    want = [eng.segment_sequence_dispatch(c).result() for c in cines]
    small = InferenceEngine(eng.model)
    small._programs.max_bytes = most // 3
    same = True
    for _ in range(2):
        for c, w in zip(cines, want):
            same &= np.array_equal(small.segment_sequence_dispatch(c)
                                   .result(), w)
            if (small._programs.nbytes() > small._programs.max_bytes
                    and len(small.programs()) > 1):
                raise AssertionError("the bounded engine is over its bound")
    print(f"  an engine bounded to "
          f"{small._programs.max_bytes / 2 ** 30:.3f} GiB: "
          f"{small._programs.dropped} programs dropped over 2 x "
          f"{len(SHAPES)} cines, {len(small.programs())} held "
          f"{small._programs.nbytes() / 2 ** 30:.3f} GiB; labels "
          f"{'bitwise equal to' if same else 'DIFFER from'} the first "
          f"engine's")
    if not same:
        raise AssertionError("a bounded engine's labels differ")
    for name, e in (("bounded", small), ("first", eng)):
        t0 = time.perf_counter()
        e.release_programs()
        print(f"  the {name} engine released in "
              f"{time.perf_counter() - t0:.4f} s: memory_reserved "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB [{card}]")


def conv_flops(module, run) -> float:
    """FLOPs of the convolutions (with BN) inside ``module`` during
    ``run()``: 2 per product, a transposed conv counted by its input
    pixels (the products that are not with stuffed zeros)."""
    from ukbb_cardiac_tpu_torch.models.layers import ConvBN

    total = [0.0]

    def hook(mod, inp, out):
        cout, cin = mod.weight.shape[:2]
        src = inp[0] if mod.transpose else out
        pixels = src.numel() / src.shape[1]
        total[0] += 2.0 * pixels * cin * cout * mod.weight[0, 0].numel()

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, ConvBN)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def aortic_phase(card, work, truth):
    """The cohort's aortic stage seen closer: Dice of its segs, the device
    span of one aortic cine through the deploy on each route, the U-Net /
    ConvLSTM split (CUDA events), the ConvLSTM eager and as a graph under
    torch.profiler, and the card's labels and area row against the port's
    CPU path on a 10-frame cut."""
    import torch.nn.functional as F

    from ukbb_cardiac_tpu_torch.infer.deploy_ao import (AO_SIZE,
                                                        load_aortic_engine)
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.ops.crop import pad_to_size
    from ukbb_cardiac_tpu_torch.ops.intensity import normalise_intensity_torch
    from ukbb_cardiac_tpu_torch.phenotype.aorta import (aortic_area_measures,
                                                        aortic_row)
    from ukbb_cardiac_tpu_torch.reg import programs

    print(f"[6/14] aortic stage: UNet-LSTM_ao on {AO_SHAPE} int16 cines",
          flush=True)
    data_dir = os.path.join(work, "cohort")
    for subject, tr in truth.items():
        seg = np.asarray(nifti.load(os.path.join(
            data_dir, subject, "seg_ao.nii.gz")).dataobj)
        d = [dice(seg, tr["ao"], k) for k in (1, 2)]
        print(f"  subject {subject}: Dice AAo {d[0]:.4f}, DAo {d[1]:.4f}")
        if seg.shape != AO_SHAPE or min(d) < 0.9:
            raise AssertionError(f"subject {subject}: aortic seg "
                                 f"{seg.shape}, Dice {d}")
    with open(os.path.join(work, "cohort_0.json")) as f:
        stages = json.load(f)["stage_seconds"]
    print("  aortic stage s per subject, 1-worker cohort run: "
          + ", ".join(f"{k} {v['aortic']:.4f}" for k, v in
                      sorted(stages.items())) + f" [{card}]")

    engine = load_aortic_engine(AO_BUNDLE, "cuda")
    HELD_ENGINES.append(("aortic", engine))
    subj = os.path.join(data_dir, sorted(truth)[0])
    cine = np.asarray(nifti.load(os.path.join(subj, "ao.nii.gz")).dataobj)
    for i in range(3):
        t0 = time.perf_counter()
        pending = engine.segment_cine_dispatch(cine)
        t1 = time.perf_counter()
        pending.result()
        print(f"  deploy of one aortic cine, call {i + 1}"
              f"{' (eager run + captures)' if i == 0 else ''}: dispatch "
              f"{t1 - t0:.4f} s, to labels {time.perf_counter() - t0:.4f} s; "
              f"device span {pending.device_ms:.4f} ms [{card}]")
    print("  the engine's programs [" + card + "]:\n"
          + captured_programs(engine.programs()))
    dispatch_routes(card, f"aortic cine {cine.shape}",
                    lambda: engine.segment_cine_dispatch(cine))

    # the same pipeline by part, CUDA events between the parts
    net = engine.net
    X, Y, Z, T = cine.shape
    x_pre, x_post, y_pre, y_post = pad_to_size(X, Y, AO_SIZE)
    with torch.inference_mode():
        for i in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            ev[0].record()
            raw = torch.from_numpy(np.ascontiguousarray(cine.T)).cuda()
            seq = F.pad(normalise_intensity_torch(raw).permute(1, 0, 3, 2),
                        (y_pre, y_post, x_pre, x_post))
            ev[1].record()
            _, feats = net.unet(seq.reshape(Z * T, 1, AO_SIZE, AO_SIZE))
            ev[2].record()
            t0 = time.perf_counter()
            logits = net.lstm(feats.view(Z, T, *feats.shape[1:]))
            lstm_host = time.perf_counter() - t0
            ev[3].record()
            torch.argmax(torch.softmax(logits, dim=2), dim=2)
            ev[4].record()
            ev[4].synchronize()
            ms = [ev[k].elapsed_time(ev[k + 1]) for k in range(4)]
            print(f"  by part, run {i + 1}: upload + z-score + pad "
                  f"{ms[0]:.4f} ms, U-Net ({Z * T} frames at {AO_SIZE}^2) "
                  f"{ms[1]:.4f} ms, ConvLSTM (2 x {T} steps) {ms[2]:.4f} ms "
                  f"(host issued it in {1e3 * lstm_host:.4f} ms), softmax + "
                  f"argmax {ms[3]:.4f} ms [{card}]")
        unet_flop = conv_flops(net.unet, lambda: net.unet(
            seq.reshape(Z * T, 1, AO_SIZE, AO_SIZE)))
        cell = net.lstm.forward_cell
        lstm_flop = 2 * T * 2.0 * AO_SIZE ** 2 * cell.weight.numel()
        print(f"  U-Net {unet_flop / 1e12:.4f} TFLOP "
              f"({unet_flop / (Z * T) / 1e9:.3f} GFLOP per frame) at "
              f"{unet_flop / ms[1] / 1e9:.2f} TFLOP/s; "
              f"ConvLSTM {lstm_flop / 1e12:.4f} TFLOP at "
              f"{lstm_flop / ms[2] / 1e9:.2f} TFLOP/s [{card}]")
        # the ConvLSTM alone on each route: op by op, and its 2 x T steps
        # captured as one graph by the programs' mechanism
        feats = feats.view(Z, T, *feats.shape[1:])
        lstm_programs = programs.ProgramCache()

        def lstm(f):
            return lstm_programs.run(("lstm",), lambda x: (net.lstm(x),),
                                     f)[0]

        lstm_out = {}
        for name in ("eager", "graphs"):
            with route(name):
                lstm(feats)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[0].record()
                lstm_out[name] = lstm(feats)
                ev[1].record()
                host = time.perf_counter() - t0
                ev[1].synchronize()
                span = ev[0].elapsed_time(ev[1])
                n_ops, busy = profiled(lambda: lstm(feats))
            if busy > 0:
                print(f"  ConvLSTM, {name} route: {span:.4f} ms (the host "
                      f"enqueued it in {1e3 * host:.4f} ms); under "
                      f"torch.profiler {n_ops} device ops "
                      f"({n_ops / (2 * T):.1f} per step), "
                      f"busy {busy:.4f} ms of the {span:.4f} ms span "
                      f"({100 * (1 - busy / span):.1f} % idle) [{card}]")
            else:
                print(f"  ConvLSTM, {name} route: {span:.4f} ms; under "
                      "torch.profiler no device time recorded (busy share "
                      "not measured)")
        same = torch.equal(lstm_out["eager"], lstm_out["graphs"])
        print(f"  ConvLSTM logits: graphs "
              f"{'bitwise equal to' if same else 'DIFFER from'} the eager "
              f"route")
        if not same:
            raise AssertionError("the graphed ConvLSTM differs")

    # the card against the port's CPU path on the cine cut to 10 frames:
    # labels, and the area row from each side's segs
    cut = np.ascontiguousarray(cine[..., :10])
    segs = {"cuda": engine.segment_cine(cut),
            "cpu": load_aortic_engine(AO_BUNDLE, "cpu").segment_cine(cut)}
    agree = float((segs["cuda"] == segs["cpu"]).mean())
    rows = {}
    for dev, seg in segs.items():
        d = os.path.join(work, f"ao_{dev}")
        os.makedirs(d)
        save_nifti(nifti, os.path.join(d, "ao.nii.gz"), cut, AFFINE_AO)
        save_nifti(nifti, os.path.join(d, "seg_ao.nii.gz"),
                   seg.astype(np.float64), AFFINE_AO)
        val = aortic_area_measures(d, 40.0)
        rows[dev] = np.array(aortic_row(val) if val else [np.nan] * 6)
    rel = np.abs(rows["cuda"] - rows["cpu"]).max() / np.abs(rows["cpu"]).max()
    print(f"  card vs CPU on {cut.shape}: label agreement {agree:.6f}; area "
          f"row card {np.round(rows['cuda'], 4).tolist()}, CPU "
          f"{np.round(rows['cpu'], 4).tolist()}, max difference {rel:.3e} of "
          f"the largest (bound {AREA_RTOL})")
    if agree < 0.999:
        raise AssertionError(f"aortic labels agree on only {agree}")
    if not (np.isfinite(rows["cpu"]).all() and np.allclose(
            rows["cuda"], rows["cpu"], rtol=AREA_RTOL, atol=0)):
        raise AssertionError(f"aortic rows differ: {rows}")


def write_training_set(root, nifti):
    """Phantom ED/ES training and validation pairs (the SA cine geometry
    of :func:`sax_phantom` at TRAIN_SHAPE, LV radius and wall varied per
    subject): ``{train,validation}/<id>/{sa,label_sa}_{ED,ES}.nii.gz``."""
    X, Y, Z = TRAIN_SHAPE
    affine = np.diag([-1.8, -1.8, 10.0, 1.0])
    for i in range(TRAIN_SUBJECTS + VAL_SUBJECTS):
        rng = np.random.RandomState(100 + i)
        subset = "train" if i < TRAIN_SUBJECTS else "validation"
        d = os.path.join(root, subset, f"{3000000 + i}")
        os.makedirs(d)
        # T = 2: frame 0 is ED, frame 1 the most contracted (ES)
        image, seg = sax_phantom(X, Y, Z, 2, r_lv=0.08 * X + 2 * (i % 4),
                                 wall=0.03 * X + (i % 3), rng=rng)
        for fr, t in (("ED", 0), ("ES", 1)):
            save_nifti(nifti, os.path.join(d, f"sa_{fr}.nii.gz"),
                       image[..., t], affine)
            save_nifti(nifti, os.path.join(d, f"label_sa_{fr}.nii.gz"),
                       seg[..., t], affine)


# --- the trainers' programs on both routes (train/steps.py) ---------------

def fcn_net(bundle):
    """(net on the card, channels-last as the trainer has it, names,
    config, params, state) of an FCN bundle."""
    from ukbb_cardiac_tpu_torch.ckpt import convert, store

    _, mcfg, names, params, state = store.load_model(bundle)
    net = convert.fcn_from_jax(params, state, names, mcfg).to(
        "cuda", memory_format=torch.channels_last)
    return net, names, mcfg, params, state


def read_bundle(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def differing(a: dict, b: dict) -> list:
    """The keys whose arrays differ bitwise, or that one side lacks."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b
                  or not np.array_equal(a[k], b[k]))


def log_records(model_dir) -> list:
    """A trainer's train_log.jsonl records without their host seconds."""
    with open(os.path.join(model_dir, "train_log.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k != "seconds"} for line in f]


def route_line(card, what, name, stats, items, unit, wall):
    """One trainer run's line: ms per step, items/s, the loader's wait,
    host dispatch per call, peak memory; then its captured programs."""
    steps = stats["steady_iterations"]
    ms = 1e3 * stats["steady_s"] / max(steps, 1)
    calls = max(stats.get("steady_calls", 0), 1)
    print(f"  {what}, {name} route ({stats.get('route')}, cuDNN "
          f"deterministic): "
          f"{stats['iterations']} iterations in {wall:.2f} s; steady {steps} "
          f"steps at {ms:.4f} ms/step, {1e3 * items / ms:.2f} {unit}/s, "
          f"waited on the loader {stats['wait_s']:.4f} s of "
          f"{stats['steady_s']:.4f} s, host dispatch "
          f"{1e3 * stats['dispatch_s'] / calls:.3f} ms a call; peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB, reserved {torch.cuda.max_memory_reserved() / 2 ** 30:.3f} "
          f"GiB [{card}]")
    for p in stats.get("programs", []):
        print(f"    program {p['tag']} {tuple(p['first_input'])}: capture "
              f"{p['capture_s']:.3f} s, memory_reserved "
              f"+{p['reserved'] / 2 ** 20:.1f} MiB, {p['replays']} replays")
    return ms


def cli_routes(card, what, run, items, unit,
               routes=("graphs", "eager")) -> dict:
    """``run(name) -> (stats, model_dir)``, a trainer's CLI, on the graphs
    route and then on the eager route, from the same seed, with cuDNN
    deterministic (so that the two runs can be compared bit for bit):
    each run's line and the head kernel's launches it counted.  Returns
    {route: (stats, model_dir, head launches, ms per step)}."""
    out = {}
    for name in routes:
        torch.cuda.reset_peak_memory_stats()
        before = head_launches()
        t0 = time.perf_counter()
        with route(name), deterministic_cudnn():
            stats, model_dir = run(name)
        wall = time.perf_counter() - t0
        ms = route_line(card, what, name, stats, items, unit, wall)
        out[name] = (stats, model_dir, head_launches() - before, ms)
    return out


def routes_agree(what, out, bundle) -> None:
    """Fails unless the graphs' run wrote the eager route's bundle (every
    parameter, BN statistic and, where the trainer keeps it, Adam leaf)
    and log records (losses, aux, validation metrics) bit for bit, with
    as many head launches."""
    a, b = (read_bundle(os.path.join(out[n][1], bundle))
            for n in ("graphs", "eager"))
    diff = differing(a, b)
    logs = [log_records(out[n][1]) for n in ("graphs", "eager")]
    launches = [out[n][2] for n in ("graphs", "eager")]
    n_opt = sum(k.startswith("opt/") for k in a)
    print(f"  {what}: graphs against the eager route: {len(a)} arrays "
          f"({n_opt} Adam leaves) bitwise equal: {not diff}"
          + (f" ({len(diff)} differ: {diff[:4]})" if diff else "")
          + f"; {len(logs[0])} log records equal: {logs[0] == logs[1]}; "
          f"head launches {launches[0]} / {launches[1]}; ms per step "
          f"{out['graphs'][3]:.4f} against {out['eager'][3]:.4f}")
    if diff or logs[0] != logs[1] or launches[0] != launches[1]:
        raise AssertionError(f"{what}: the graphs route differs from the "
                             "eager route")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms inside the block: with
    its default ones a trainer's eager route is not bitwise against
    itself (the f32 FCN's and the ConvLSTM's backward,
    ``tests/test_torch_card.py``), so the routes are compared under it."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _step_run(card, what, name, build, K, items, unit, timed=True):
    """One route's four calls of a step (``build() -> (call, state,
    programs)``): the first call (on the graphs an eager run and the
    capture), the second (on the graphs the first replay, which also
    uploads the graph), a timed call and a profiled one when ``timed``
    (else a plain fourth call); prints what was measured.  Returns
    (losses and state, ms per step or None)."""
    with route(name):
        call, state, cache = build()
        seconds = []
        losses = []
        for _ in range(2):  # the first call; the first replay
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(call())
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        losses.append(call())
        host = time.perf_counter() - t0
        ev[1].record()
        ev[1].synchronize()
        span = ev[0].elapsed_time(ev[1])
        if timed:
            n_ops, busy = profiled(lambda: losses.append(call()))
        else:
            losses.append(call())
        snap = {"losses": torch.cat(losses).cpu(), **state()}
        progs = [p for p in cache.programs() if p.graph is not None]
        cache.clear()
    if not timed:
        return snap, None
    if busy > span:
        idle = (f"{n_ops} device ops, busy {busy:.4f} ms: more than the "
                "span (kernels overlap; idle share not measured)")
    elif busy > 0:
        idle = (f"{n_ops} device ops, busy {busy:.4f} ms "
                f"({100 * (1 - busy / span):.1f} % idle)")
    else:
        idle = "no device time recorded (idle share not measured)"
    print(f"  {what}, {name} route: first call {seconds[0]:.3f} s, second "
          f"{seconds[1]:.3f} s (on the graphs the first replay); a call of "
          f"{K} steps {span:.4f} ms ({span / K:.4f} ms/step, "
          f"{1e3 * items * K / span:.2f} {unit}/s), host dispatch "
          f"{1e3 * host:.3f} ms; under torch.profiler {idle} [{card}]")
    for p in progs:
        print(f"    program {describe_program(p)}: capture "
              f"{p.capture_s:.3f} s, memory_reserved "
              f"+{p.reserved / 2 ** 20:.1f} MiB, {p.replays} replays")
    return snap, span / K


def _largest(a: dict, b: dict) -> dict:
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a}


def step_routes(card, what, build, K, items, unit) -> dict:
    """Four K-step calls of a trainer's step from the same start
    (``build() -> (call, state, programs)``: ``call()`` runs one call and
    returns its losses, ``state()`` the parameters, BN buffers and Adam
    state) on the eager route, through the graphs and on the eager route
    again, with cuDNN's default algorithms: per route the first call's
    seconds (on the graphs an eager run and the capture), the second's
    (the first replay), one call's device span (CUDA events) and host
    dispatch, one call under
    torch.profiler (device ops, busy ms, idle share), each program's
    capture seconds and memory; the eager route's run-to-run spread and
    the graphs' distance from it.  Then the eager route and the graphs
    again with cuDNN deterministic: fails unless they leave the same
    losses and state bit for bit.  Returns {route: ms per step}."""
    eager, ms_eager = _step_run(card, what, "eager", build, K, items, unit)
    graphs, ms_graphs = _step_run(card, what, "graphs", build, K, items,
                                  unit)
    again, _ = _step_run(card, what, "eager", build, K, items, unit,
                         timed=False)
    spread, got = _largest(eager, again), _largest(graphs, eager)
    varied = sorted(k for k in spread if spread[k] > 0)
    beyond = sorted(k for k in got if got[k] > spread[k])
    with deterministic_cudnn():
        det = [_step_run(card, what, name, build, K, items, unit,
                         timed=False)[0] for name in ("eager", "graphs")]
    differ = sorted(k for k, v in _largest(*det).items() if v > 0)
    print(f"  {what}: {len(got)} tensors (losses, parameters, BN buffers, "
          f"Adam state) after 4 calls; cuDNN's default algorithms: the "
          f"eager route against itself "
          + ("bitwise" if not varied else
             f"{len(varied)} vary, up to {max(spread.values()):.3e}")
          + ", the graphs against it "
          + ("bitwise" if not any(got.values()) else
             f"up to {max(got.values()):.3e} ({len(beyond)} tensors past "
             "the eager spread of this one pair of runs)")
          + "; cuDNN deterministic: the graphs against the eager route "
          + ("bitwise" if not differ else f"{len(differ)} DIFFER: "
             f"{differ[:4]}"))
    if differ or set(det[0]) != set(det[1]):
        raise AssertionError(f"{what}: the graphs route differs from the "
                             "eager route")
    return {"eager": ms_eager, "graphs": ms_graphs}


def train_state(net, optimizer) -> dict:
    """A model's parameters and buffers and its Adam state, on the CPU."""
    out = {f"net.{k}": v.detach().cpu().clone()
           for k, v in net.state_dict().items()}
    for i, p in enumerate(p for g in optimizer.param_groups
                          for p in g["params"]):
        for k, v in optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v.detach().cpu().clone()
    return out


def train_phase(card, work, fh):
    """FCN training on the card through ``cli.train_network.main`` in both
    profiles, at the released FCN_sa architecture; then one float32 step
    card vs CPU, and the written bundle deployed through the head
    kernel and held to the port's CPU deploy of it.  Returns the head's
    launches in the phase."""
    from ukbb_cardiac_tpu_torch.cli import train_network
    from ukbb_cardiac_tpu_torch.infer import deploy
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.train import sa as tsa

    print(f"[7/14] training: FCN_sa architecture, {TRAIN_SUBJECTS} phantom "
          f"subjects' ED/ES pairs at {TRAIN_SHAPE}, {TRAIN_CROP}^2 crops",
          flush=True)
    data = os.path.join(work, "train_set")
    write_training_set(data, nifti)
    fh.fused_head.launches = 0
    bundles = {}
    validation_launches = 0
    for profile, extra in (
            ("production", ["--pool_gb", "1.0"]),
            ("reference", [])):
        prod = profile == "production"
        # slices per step: fixed in production; the reference's batches
        # of 2 subjects hold 2 x Z slices
        slices = TRAIN_BATCH if prod else 2 * TRAIN_SHAPE[2]

        def run(name, profile=profile, extra=extra):
            ckpt = os.path.join(work, f"ckpt_{profile}_{name}")
            _, _, _, stats = train_network.main(
                ["--dataset_dir", data, "--profile", profile,
                 "--checkpoint_dir", ckpt, "--train_iteration",
                 str(TRAIN_ITERS[profile]), "--device", "cuda", "--seed",
                 "0", *extra])
            (model_dir,) = os.listdir(ckpt)
            return stats, os.path.join(ckpt, model_dir)

        out = cli_routes(card, profile, run, slices, "slices")
        name = f"model-{TRAIN_ITERS[profile]}.npz"
        routes_agree(profile, out, name)
        stats, model_dir, launched, ms = out["graphs"]
        validation_launches += launched
        bundles[profile] = os.path.join(model_dir, name)
        log = log_records(model_dir)
        net = fcn_net(bundles[profile])[0]
        losses = [r["loss"] for r in log]
        x = torch.zeros((slices, 1, TRAIN_CROP, TRAIN_CROP), device="cuda",
                        dtype=torch.bfloat16 if prod else torch.float32)
        with torch.no_grad():
            flop = 3 * conv_flops(net, lambda: net(x, fused_head=False))
        print(f"  {profile}: {flop / 1e12:.4f} TFLOP per step (conv_flops "
              f"x 3, concat head) at {flop / ms / 1e9:.2f} TFLOP/s on the "
              f"graphs [{card}]")
        print(f"  {profile}: loss by validation "
              + ", ".join(f"{r['iteration']}: {r['loss']:.4f}" for r in log)
              + f"; last val Dice LV/Myo/RV "
              + "/".join(f"{log[-1][f'val_dice_{k}']:.3f}" for k in (1, 2, 3)))
        if not (all(math.isfinite(v) for v in losses) and len(losses) >= 2
                and losses[-1] < losses[0]):
            raise AssertionError(f"{profile}: loss not finite or not "
                                 f"falling: {losses}")
    head_launches = fh.fused_head.launches
    print(f"  fused_head launches in the validations: graphs route "
          f"{validation_launches}, both routes {head_launches}")

    # one float32 step from the same weights and batch, card vs CPU
    from ukbb_cardiac_tpu_torch.ckpt import convert, store

    kind, mcfg, names, params, state = store.load_model(
        bundles["production"])
    images, labels = tsa.get_random_batch(
        tsa.scan_dataset(data, "sa")["train"], 1, image_size=TRAIN_CROP,
        rng=random.Random(0))
    batch = {"image": torch.from_numpy(images[:GRAD_BATCH]),
             "label": torch.from_numpy(labels[:GRAD_BATCH])}
    grads, loss = {}, {}
    for d in ("cpu", "cuda"):
        net = convert.fcn_from_jax(params, state, names, mcfg).to(d)
        loss_fn = tsa.make_fcn_loss(net, mcfg)
        value, _ = loss_fn({k: v.to(d) for k, v in batch.items()}, 1)
        value.backward()
        loss[d] = float(value.detach())
        grads[d] = {k: p.grad.cpu() for k, p in net.named_parameters()}
    worst = max(float((grads["cuda"][k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for k, g in grads["cpu"].items())
    print(f"  one f32 step on {tuple(batch['image'].shape)}: loss card "
          f"{loss['cuda']:.6f}, CPU {loss['cpu']:.6f}; gradients differ by at "
          f"most {worst:.3e} of a tensor's largest (bound {GRAD_RTOL})")
    if (worst > GRAD_RTOL
            or abs(loss["cuda"] - loss["cpu"]) > 1e-4 * loss["cpu"]):
        raise AssertionError(f"card and CPU gradients differ: {worst}")

    # what the production run learned, seen with batch statistics: after
    # N iterations the moving statistics still hold 0.99^N of their
    # initial values (0.37 at N = 100), which the inference forward uses
    from ukbb_cardiac_tpu_torch.models import fcn as tfcn

    v_img, v_lab = tsa.get_random_batch(
        tsa.scan_dataset(data, "sa")["validation"], 2,
        image_size=TRAIN_CROP, rng=random.Random(2))
    with torch.no_grad():
        pred = tfcn.apply_fcn(net, torch.from_numpy(v_img).cuda(),
                              train=True).argmax(-1).cpu().numpy()
    d = [dice(pred, v_lab, k) for k in (1, 2, 3)]
    print(f"  production net on the validation pairs, batch-statistics "
          f"forward: Dice LV/Myo/RV {d[0]:.4f}/{d[1]:.4f}/{d[2]:.4f} "
          f"(moving statistics at 0.99^{TRAIN_ITERS['production']} = "
          f"{0.99 ** TRAIN_ITERS['production']:.2f} of their initial "
          f"values)")
    with route("eager"):
        step_profile(card, params, state, names, mcfg, data)
    train_programs(card, work, bundles, data)

    # the trained bundle deploys through the head kernel, which folds its
    # trained BN statistics; the port's CPU deploy of it is the yardstick
    root = os.path.join(work, "train_deploy")
    cine, truth = sax_phantom(*TRAIN_SHAPE, 10, r_lv=0.1 * 192,
                              wall=0.039 * 192,
                              rng=np.random.RandomState(7))
    for d in ("cuda", "cpu"):
        sub = os.path.join(root, d, "3100000")
        os.makedirs(sub)
        save_nifti(nifti, os.path.join(sub, "sa.nii.gz"), cine, AFFINE_SA)
    fh.fused_head.launches = 0
    deploy.deploy_dataset(bundles["production"], os.path.join(root, "cuda"),
                          seq_name="sa", device="cuda")
    deploy_launches = fh.fused_head.launches
    deploy.deploy_dataset(bundles["production"], os.path.join(root, "cpu"),
                          seq_name="sa", device="cpu")
    seg, seg_cpu = (np.asarray(nifti.load(os.path.join(
        root, d, "3100000", "seg_sa.nii.gz")).dataobj)
        for d in ("cuda", "cpu"))
    agree = float((seg == seg_cpu).mean())
    d = [dice(seg, truth, k) for k in (1, 2, 3)]
    print(f"  trained bundle deployed on {cine.shape}: fused_head launches "
          f"{deploy_launches}, card vs CPU label agreement {agree:.6f}, "
          f"Dice LV/Myo/RV {d[0]:.4f}/{d[1]:.4f}/{d[2]:.4f} after "
          f"{TRAIN_ITERS['production']} iterations")
    x = cine.transpose(3, 2, 0, 1).reshape(-1, *TRAIN_SHAPE[:2], 1)[:16]
    x = torch.from_numpy((x / 1000.0).astype(np.float32))
    logits = {d: deploy.load_segmentation_model(bundles["production"], d)
              .forward(x.to(d)).cpu() for d in ("cpu", "cuda")}
    scale = float(logits["cpu"].abs().max())
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    print(f"  trained bundle, {tuple(x.shape)} slices: card vs CPU logits "
          f"max abs err {err:.3e} of a largest {scale:.3e} (bound "
          f"{RESNET_RTOL} of it)")
    if (seg.shape != cine.shape or deploy_launches <= 0 or agree < 0.999
            or not math.isfinite(scale) or err > RESNET_RTOL * scale):
        raise AssertionError(f"trained bundle deploy: seg {seg.shape}, "
                             f"launches {deploy_launches}, agreement "
                             f"{agree}, logits err {err}")
    return validation_launches + deploy_launches


def slice_pool_call(data, K):
    """The production profile's slice pool on the card, filled by the
    trainer's own sampler from phase 7's training pairs, and one call's
    (K, 128) index batches: (pool image, pool label, batches)."""
    from ukbb_cardiac_tpu_torch.train import sa as tsa

    train_list = tsa.scan_dataset(data, "sa")["train"]
    cfg = tsa.SATrainConfig(image_size=TRAIN_CROP, batch_slices=TRAIN_BATCH,
                            steps_per_dispatch=K, pool_gb=1.0,
                            device_augment=True, device_slices=True)
    pool = tsa._pool_for(cfg, train_list, K, "cuda", verbose=False)
    sample = tsa.make_device_slice_sampler(train_list, TRAIN_BATCH, pool,
                                           image_size=TRAIN_CROP,
                                           rng=random.Random(0))
    drawn = [sample() for _ in range(K)]
    batches = {k: torch.from_numpy(np.stack([b[k] for b in drawn])).cuda()
               for k in drawn[0]}
    return (*pool.snapshot(), batches)


def train_programs(card, work, bundles, data):
    """Phase 7's step programs on both routes from the trained bundles:
    the production call (K = 10 steps of 128 slices from the slice pool,
    bf16, device augmentation) and the reference step (f32, a host
    augmented batch of 2 subjects) through :func:`step_routes`; the
    validation program (fold + pack + encoder + head kernel + argmax) on
    both routes, labels and head launches compared; and a checkpoint
    written after two graphed production calls, restored as the trainer
    restores it, continued for two more: bitwise the four calls straight
    through."""
    from ukbb_cardiac_tpu_torch.ckpt import convert, store
    from ukbb_cardiac_tpu_torch.reg.programs import ProgramCache
    from ukbb_cardiac_tpu_torch.train import sa as tsa
    from ukbb_cardiac_tpu_torch.train import steps

    K = 10
    lr = {"production": 1e-3 * TRAIN_BATCH / 20, "reference": 1e-3}
    train_list = tsa.scan_dataset(data, "sa")["train"]
    img, lab, batches = slice_pool_call(data, K)
    ref_img, ref_lab = tsa.get_random_batch(
        train_list, 2, image_size=TRAIN_CROP, data_augmentation=True,
        rotate=10, scale=0.2, rng=random.Random(1))
    ref_batch = {"image": torch.from_numpy(ref_img).cuda(),
                 "label": torch.from_numpy(ref_lab).cuda()}

    def fresh(profile, path):
        prod = profile == "production"
        net, names, mcfg, _, _ = fcn_net(path)
        opt = steps.Adam(net.parameters(), lr=lr[profile])
        leaves = store.load_opt_state(path)
        if leaves is not None:
            convert.load_adam_leaves(opt, net, convert.fcn_layout(names, mcfg),
                                     leaves)
        cache = ProgramCache(max_bytes=steps.TRAINER_BYTES)
        loss_fn = tsa.make_fcn_loss(
            net, mcfg, device_augment=prod,
            compute_dtype=torch.bfloat16 if prod else None)
        step, multi = tsa.make_steps(loss_fn, opt, None, cache, prod,
                                     "slice")
        if prod:
            def call(c=0):
                return multi(img, lab, batches,
                             [c * K + k + 1 for k in range(K)])[0]
        else:
            def call(c=0):
                return step(ref_batch, c + 1)[0][None]
        return net, opt, names, mcfg, cache, call

    def build(profile):
        def make():
            net, opt, _, _, cache, call = fresh(profile, bundles[profile])
            return call, lambda: train_state(net, opt), cache
        return make

    step_routes(card, f"production step call (K = {K}, {TRAIN_BATCH} "
                f"slices, bf16, the slice pool, device augmentation)",
                build("production"), K, TRAIN_BATCH, "slices")
    step_routes(card, f"reference step ({ref_img.shape[0]} slices of 2 "
                "subjects, f32, host augmentation)", build("reference"), 1,
                ref_img.shape[0], "slices")

    # the validation program on both routes
    v_img, _ = tsa.get_random_batch(tsa.scan_dataset(data, "sa")[
        "validation"], 2, image_size=TRAIN_CROP, rng=random.Random(3))
    net = fcn_net(bundles["production"])[0]
    cache = ProgramCache()
    got = []
    for name in ("eager", "graphs", "graphs", "graphs", "eager"):
        before = head_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with route(name):
            labels = tsa.validation_predict(net, v_img, "cuda", cache)
        got.append((name, labels, time.perf_counter() - t0,
                    head_launches() - before))
    progs = [p for p in cache.programs() if p.graph is not None]
    same = all(np.array_equal(g[1], got[0][1]) for g in got)
    print(f"  validation forward on {v_img.shape}: "
          + ", ".join(f"{n} {1e3 * t:.3f} ms ({k} head launches)"
                      for n, _, t, k in got)
          + f" (host seconds to the labels); labels "
          f"{'bitwise equal' if same else 'DIFFER'} [{card}]")
    for p in progs:
        print(f"    program {describe_program(p)}: capture {p.capture_s:.3f} "
              f"s, memory_reserved +{p.reserved / 2 ** 20:.1f} MiB, "
              f"{p.replays} replays, "
              f"{sum(p.launches.counts.values())} kernel launches a replay")
    cache.clear()
    if not same or len({g[3] for g in got}) != 1 or not progs:
        raise AssertionError("the validation program differs from the eager "
                             "route")

    # a checkpoint after two graphed calls resumes into the same next calls
    # (cuDNN deterministic: a fresh program's first call runs eagerly)
    with deterministic_cudnn():
        net, opt, names, mcfg, cache, call = fresh("production",
                                                   bundles["production"])
        straight = [call(c) for c in range(4)]
        want = train_state(net, opt)
        cache.clear()
        net, opt, names, mcfg, cache, call = fresh("production",
                                                   bundles["production"])
        first = [call(c) for c in range(2)]
        path = os.path.join(work, "resume_chunk.npz")
        tsa.save_checkpoint(path, net, names, opt,
                            convert.fcn_layout(names, mcfg),
                            {"iteration": 2 * K, "seq_name": "sa"})
        cache.clear()
        net, opt, _, _, cache, call = fresh("production", path)
        second = [call(c) for c in range(2, 4)]
        have = train_state(net, opt)
        cache.clear()
        same = (all(torch.equal(a, b)
                    for a, b in zip(straight, first + second))
                and all(torch.equal(want[k], have[k]) for k in want))
    print(f"  a checkpoint after 2 graphed production calls, restored and "
          f"continued for 2 (cuDNN deterministic): losses, {len(want)} "
          f"parameters, buffers and Adam tensors "
          f"{'bitwise equal to' if same else 'DIFFER from'} 4 "
          "calls straight through")
    if not same:
        raise AssertionError("resuming after a graphed chunk differs")


def step_profile(card, params, state, names, mcfg, data):
    """One production step (128 slices, bf16, device augmentation) timed
    with CUDA events, its augmentation alone, and three steps under
    torch.profiler: device time by kernel family and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ukbb_cardiac_tpu_torch.ckpt import convert
    from ukbb_cardiac_tpu_torch.ops.augment import data_augmenter_torch
    from ukbb_cardiac_tpu_torch.train import sa as tsa
    from ukbb_cardiac_tpu_torch.train import steps

    net = convert.fcn_from_jax(params, state, names, mcfg).to(
        "cuda", memory_format=torch.channels_last)  # as the trainer has it
    images, labels = tsa.get_random_batch(
        tsa.scan_dataset(data, "sa")["train"], 13, image_size=TRAIN_CROP,
        rng=random.Random(1))
    batch = {"image": torch.from_numpy(images[:TRAIN_BATCH]).half().cuda(),
             "label": torch.from_numpy(labels[:TRAIN_BATCH]).to(
                 torch.uint8).cuda()}
    loss_fn = tsa.make_fcn_loss(net, mcfg, device_augment=True,
                                compute_dtype=torch.bfloat16)
    step = steps.make_train_step(loss_fn, steps.Adam(net.parameters(),
                                                     lr=1e-4))
    seeds = iter(range(1, 1000))
    ms = cuda_ms(lambda: step(batch, next(seeds)), iters=5, warmup=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = batch["image"].float()
    aug_ms = cuda_ms(lambda: data_augmenter_torch(
        gen, img, batch["label"], 0, 10, 0.2, 0, False), iters=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch, next(seeds))
        torch.cuda.synchronize()
    span = 1e3 * (time.perf_counter() - t0) / 3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 3e3
    # first match wins: cuDNN's BatchNorm kernels before its convolutions
    families = {"batch norm": ("batch_norm", "batchnorm", "cudnn::bn_"),
                "convolution (cuDNN)": ("conv", "xmma", "cudnn", "fprop",
                                        "dgrad", "wgrad", "implicit",
                                        "nchwtonhwc", "nhwctonchw"),
                "matmul (cuBLAS)": ("gemm", "cutlass"),
                "gather / index": ("index_kernel", "gather", "scatter"),
                "reduction": ("reduce_kernel",),
                "elementwise": ("elementwise",)}
    by = dict.fromkeys(list(families) + ["other"], 0.0)
    for e in kern:
        name = e.key.lower()
        fam = next((f for f, keys in families.items()
                    if any(k in name for k in keys)), "other")
        by[fam] += e.self_device_time_total / 3e3
    print(f"  production step alone, eager route (128 x {TRAIN_CROP}^2, "
          f"bf16, device augmentation): {ms:.4f} ms (CUDA events), of which "
          f"the "
          f"augmentation alone {aug_ms:.4f} ms [{card}]")
    if busy > 0:
        n_ops = sum(e.count for e in kern) / 3
        print(f"  under torch.profiler, per step: {n_ops:.0f} device ops, "
              f"busy {busy:.4f} ms of a {span:.4f} ms host span; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in by.items()))
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            print(f"    {e.self_device_time_total / 3e3:9.4f} ms  "
                  f"{e.count / 3:5.0f}x  {e.key[:90]}")
    else:
        print("  under torch.profiler: no device time recorded (busy share "
              "not measured)")


def resnet_phase(card, work, fh):
    """A ResNet-FCN bundle at the released widths from a seeded init,
    written by the port, deployed on the card and on the CPU: logits and
    labels compared, the head kernel's launches counted."""
    from ukbb_cardiac_tpu_torch.ckpt import convert, store
    from ukbb_cardiac_tpu_torch.infer import deploy
    from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
    from ukbb_cardiac_tpu_torch.models import fcn as tfcn

    print("[8/14] ResNet-FCN deploy: seeded init at the FCN_sa widths",
          flush=True)
    cfg = tfcn.ResNetConfig(n_class=4, n_level=5,
                            n_filter=(16, 32, 64, 128, 256),
                            n_block=(2, 2, 3, 3, 3))
    net = tfcn.init_weights(tfcn.ResNetFCN(cfg),
                            torch.Generator().manual_seed(0))
    names = convert.fcn_names(cfg)
    params, state = convert.fcn_to_jax(net, names)
    path = os.path.join(work, "ResNet_sa.npz")
    store.save_model(path, "resnet", cfg, names, params, state)
    cine, _ = sax_phantom(*MAIN_SHAPE[:3], 4, r_lv=0.1 * 192,
                          wall=0.039 * 192, rng=np.random.RandomState(9))
    x = cine.transpose(3, 2, 0, 1).reshape(-1, *MAIN_SHAPE[:2], 1)
    x = torch.from_numpy((x / 1000.0).astype(np.float32))
    models = {d: deploy.load_segmentation_model(path, d)
              for d in ("cpu", "cuda")}
    logits = {d: m.forward(x.to(d)).cpu() for d, m in models.items()}
    scale = float(logits["cpu"].abs().max())
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    agree = float((logits["cuda"].argmax(1) == logits["cpu"].argmax(1))
                  .float().mean())
    print(f"  {tuple(x.shape)} slices: card vs CPU logits max abs err "
          f"{err:.3e} of a largest {scale:.3e} (bound {RESNET_RTOL} of it), "
          f"argmax agreement {agree:.6f}")
    if not (math.isfinite(scale) and err <= RESNET_RTOL * scale
            and agree >= 0.999):
        raise AssertionError(f"ResNet card vs CPU: err {err}, agree {agree}")
    chunk = x[:CHUNK].cuda()
    ms = cuda_ms(lambda: models["cuda"].forward(chunk), iters=10)
    print(f"  ResNet-FCN forward + head kernel, {tuple(chunk.shape)}: "
          f"{ms:.4f} ms per chunk [{card}]")
    fh.fused_head.launches = 0
    seg = InferenceEngine(models["cuda"]).segment_sequence_fused(cine)
    launches = fh.fused_head.launches
    print(f"  segment_sequence_fused on {cine.shape}: fused_head launches "
          f"{launches}, labels {sorted(np.unique(seg).tolist())}")
    if seg.shape != cine.shape or launches <= 0:
        raise AssertionError(f"ResNet deploy: seg {seg.shape}, launches "
                             f"{launches}")
    return launches


def lstm_flops(n_frames, X, Y, c_in, hidden, n_class, directions=2):
    """FLOPs of a (bi)ConvLSTM head's forward over ``n_frames`` frames:
    each step's 3x3 gate conv over [x, h], then the 1x1 output conv."""
    gates = 2.0 * X * Y * (c_in + hidden) * 4 * hidden * 9
    out = 2.0 * X * Y * directions * hidden * n_class
    return n_frames * (directions * gates + out)


def propagation_phase(card, work, bf):
    """The propagation CLI on the card over AO_TRAIN_SUBJECTS bench-size
    aortic subjects; the card's labels against the port's CPU path on a
    reduced cine.  Returns (training set root, truth, launches)."""
    from ukbb_cardiac_tpu_torch.cli import propagate_aortic_annotation
    from ukbb_cardiac_tpu_torch.data import propagate_aortic as prop
    from ukbb_cardiac_tpu_torch.io import nifti

    B, crop_shape, lattice, spacing = propagation_case()
    print(f"[9/14] aortic labels propagated (RegConfig.aortic_motion(): 1 "
          f"level, 100 Adam steps, NMI) on {AO_TRAIN_SUBJECTS} {AO_SHAPE} "
          f"int16 cines annotated at frames {AO_ANNOTATED}", flush=True)
    root = os.path.join(work, "ao_train")
    data = os.path.join(root, "train")
    truth = {f"{4000000 + i}": write_ao_annotated(
        os.path.join(data, f"{4000000 + i}"), nifti, AO_SHAPE[3], 40 + i)
        for i in range(AO_TRAIN_SUBJECTS)}
    spans = []
    register_pairs = prop.register_pairs

    def timed(crop_img, pairs, cfg, device=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = register_pairs(crop_img, pairs, cfg, device)
        ev[1].record()
        ev[1].synchronize()
        spans.append((len(pairs), crop_img.shape[:2],
                      ev[0].elapsed_time(ev[1])))
        return out

    prop.register_pairs = timed
    torch.cuda.reset_peak_memory_stats()
    bf.bspline_field.launches = bf.bspline_field.adjoint_launches = 0
    try:
        result = propagate_aortic_annotation.main(
            ["--data_dir", data, "--device", "cuda"])
    finally:
        prop.register_pairs = register_pairs
    launches = {"bspline_field": bf.bspline_field.launches,
                "bspline_field_adjoint": bf.bspline_field.adjoint_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if result.failed or len(spans) != AO_TRAIN_SUBJECTS:
        raise AssertionError(f"propagation failed: {result.failed}")
    failed = {}
    for (subject, tr), (n, shape, ms) in zip(sorted(truth.items()), spans):
        lab = np.asarray(nifti.load(os.path.join(
            data, subject, "label_ao_prop.nii.gz")).dataobj)
        d = np.array([[dice(lab[..., t], tr[..., t], k) for k in (1, 2)]
                      for t in range(AO_SHAPE[3])])
        failed[subject] = propagation_failures(lab, tr)
        wall = result.seconds[os.path.join(data, subject)]
        print(f"  {subject}: wall {wall:.3f} s, "
              f"registration + densify device span {ms:.3f} ms, {n} pairs "
              f"at crop {tuple(shape)}, Dice AAo/DAo mean "
              f"{d[:, 0].mean():.4f}/{d[:, 1].mean():.4f}, min "
              f"{d[:, 0].min():.4f}/{d[:, 1].min():.4f} [{card}]")
        if tuple(shape) != crop_shape or n != B:
            raise AssertionError(f"crop {shape}, {n} pairs: phase 2 checked "
                                 f"{crop_shape}, {B}")
    # the control: the first subject with no registration at all must miss
    # both bounds against the truth
    subject = sorted(truth)[0]
    idle = idle_propagation(prop, nifti, os.path.join(work, "prop_idle"),
                            AO_SHAPE[3], 40)
    idle_failed = propagation_failures(idle, truth[subject])
    print(f"  bounds missed against the truth (mean Dice over the "
          f"propagated frames >= {PROP_MIN_TRUTH_DICE:.3f}, every AAo "
          f"Dice > {PROP_MIN_DICE}): {failed}; by {subject} with every "
          f"field zero (the control): {idle_failed}")
    if any(failed.values()) or set(idle_failed) != {"truth_dice",
                                                    "frame_dice"}:
        raise AssertionError("propagation: the card's labels miss a bound, "
                             "or the control passes one")
    per_subject = (100 + 1, 100)  # an Adam step each, plus the densify
    print(f"  B-spline launches: {launches} ({per_subject} per subject); "
          f"max allocated {peak:.3f} GiB (the NMI Parzen weights of {B} "
          f"pairs)")
    # one subject's registration again, replaying the graphs the CLI
    # captured and on the eager route: span, device operations and the
    # time the card was busy under torch.profiler, output bit for bit
    frames = np.random.RandomState(0).rand(*crop_shape, 1, B + 2).astype(
        np.float32)
    pairs = [(t - 1, t) for t in range(1, B + 1)]
    cfg = prop.RegConfig.aortic_motion()
    disps = {}
    for name in ("graphs", "eager"):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with route(name):
            torch.cuda.synchronize()
            ev[0].record()
            disps[name] = prop.register_pairs(frames, pairs, cfg, "cuda")
            ev[1].record()
            torch.cuda.synchronize()
            n_ops, busy = profiled(lambda: prop.register_pairs(
                frames, pairs, cfg, "cuda"))
        span = ev[0].elapsed_time(ev[1])
        print(f"  one registration of {B} pairs at {crop_shape}, {name} "
              f"route: span {span:.3f} ms; under torch.profiler {n_ops} "
              f"device operations ({n_ops / 100:.1f} per Adam step), busy "
              f"{busy:.3f} ms ({100 * (1 - busy / span):.1f} % idle) "
              f"[{card}]")
    same = np.array_equal(disps["graphs"], disps["eager"])
    print(f"  propagation fields, graphs against the eager route: "
          f"{'bitwise equal' if same else 'NOT bitwise equal'} (largest "
          f"difference "
          f"{np.abs(disps['graphs'] - disps['eager']).max():.6g} px)")
    if not same:
        raise AssertionError("the graphed propagation's fields differ from "
                             "the eager route's")
    if (launches["bspline_field"] != AO_TRAIN_SUBJECTS * per_subject[0]
            or launches["bspline_field_adjoint"]
            != AO_TRAIN_SUBJECTS * per_subject[1]):
        raise AssertionError(f"propagation: launches {launches}")

    labels = {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(work, "prop_cut", dev)
        cut_truth = write_ao_annotated(d, nifti, PROP_CPU_T, 40)
        t0 = time.perf_counter()
        prop.propagate_subject(d, device=dev)
        labels[dev] = np.asarray(nifti.load(os.path.join(
            d, "label_ao_prop.nii.gz")).dataobj)
        print(f"  {PROP_CPU_T}-frame cut on {dev}: "
              f"{time.perf_counter() - t0:.3f} s")
    got, ref = labels["cuda"], labels["cpu"]
    disagree = float(np.mean(got != ref))
    mean_dice = float(np.mean([dice(got[..., t], ref[..., t], k)
                               for t in range(PROP_CPU_T) for k in (1, 2)]))
    failed = propagation_failures(got, cut_truth, ref)
    idle = idle_propagation(prop, nifti, os.path.join(work, "prop_cut",
                                                      "idle"), PROP_CPU_T, 40)
    idle_failed = propagation_failures(idle, cut_truth, ref)
    print(f"  card vs CPU labels: {disagree:.5f} of voxels differ (bound "
          f"{PROP_MAX_DISAGREE:.4f}), mean per-frame Dice {mean_dice:.4f} "
          f"(bound {PROP_MIN_MEAN_DICE:.3f}); bounds missed {failed}; by "
          f"every field zero (the control) {idle_failed}")
    if failed or not {"mean_dice", "truth_dice",
                      "frame_dice"} <= set(idle_failed):
        raise AssertionError("card and CPU propagations differ beyond the "
                             "CPU bounds, or the control passes them")
    return root, truth, launches


def ao_train_phase(card, root, truth, work):
    """``cli.train_network_ao`` on the propagated labels at the released
    UNet-LSTM_ao widths: UNet, then UNet-LSTM restoring it, in the
    reference profile and with the production options (those on both
    routes); the step programs on both routes (:func:`ao_programs`); one
    float32 step's card and CPU gradients; the trained UNet-LSTM bundle
    deployed on the card and on the CPU."""
    from ukbb_cardiac_tpu_torch.cli import train_network_ao
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import deploy_dataset_ao
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.train import ao as tao

    print(f"[9/14] aortic trainer on the propagated labels: U-Net 16-256, "
          f"5 levels, BiConvLSTM 16 hidden, {AO_SIZE_TRAIN}^2 crops",
          flush=True)
    # one validation subject with its true labels
    v = os.path.join(root, "validation", "4100000")
    seg = write_ao_annotated(v, nifti, AO_SHAPE[3], 50)
    save_nifti(nifti, os.path.join(v, "label_ao_prop.nii.gz"), seg,
               AFFINE_AO)
    bundles = {}
    for profile in ("reference", "production"):
        n_iter = AO_TRAIN_ITERS[profile]
        unet_bundle = None
        for model in ("UNet", "UNet-LSTM"):
            prod = profile == "production"

            def run(name, model=model, unet_bundle=unet_bundle,
                    profile=profile, n_iter=n_iter):
                ckpt = os.path.join(work, f"ao_ckpt_{profile}_{name}")
                flags = ["--dataset_dir", root, "--model", model,
                         "--train_iteration", str(n_iter),
                         "--checkpoint_dir", ckpt, "--device", "cuda"]
                # the subject cache in both profiles: the reference
                # profile's loader decoded 5 cines a step (1.7-2.4 s)
                flags += ["--cache_gb", "2"]
                if profile == "production":
                    flags += ["--batch_windows", str(AO_BATCH_WINDOWS[model]),
                              "--steps_per_dispatch", str(AO_K), "--bf16",
                              "--device_augment", "--device_windows",
                              "--compact_transfer"]
                if unet_bundle:
                    flags += ["--model_path", unet_bundle]
                _, _, _, stats = train_network_ao.main(flags)
                (model_dir,) = [os.path.join(ckpt, m) for m in os.listdir(ckpt)
                                if m.startswith(model + "_")]
                return stats, model_dir

            cfg = tao.AoTrainConfig(model=model)
            tw = cfg.time_window
            # windows per step: fixed in production; the reference's 5
            # subjects hold 2 annotated frames each
            windows = (AO_BATCH_WINDOWS[model] if prod
                       else 5 * len(AO_ANNOTATED))
            # the reference profile waits on its host loader (host
            # augmentation of 5 subjects' windows): its routes are
            # compared step by step (ao_programs) instead
            out = cli_routes(card, f"{profile} {model}", run, windows,
                             f"windows ({tw} frames each)",
                             ("graphs", "eager") if prod else ("graphs",))
            if prod:
                routes_agree(f"{profile} {model}", out,
                             f"model-{n_iter}.npz")
            stats, model_dir, _, ms = out["graphs"]
            log = log_records(model_dir)
            bundle = os.path.join(model_dir, f"model-{n_iter}.npz")
            bundles[(profile, model)] = bundle
            if model == "UNet":
                unet_bundle = bundle
            side = AO_SIZE_TRAIN
            dtype = torch.bfloat16 if prod else torch.float32
            net = ao_net(bundle, model)
            unet = net.unet if model == "UNet-LSTM" else net
            x = torch.zeros((windows * tw, 1, side, side), device="cuda",
                            dtype=dtype)
            with torch.no_grad():
                f_unet = conv_flops(unet, lambda: unet(x))
            # the U-Net trains in phase 1 (forward + backward); in phase 2
            # it runs forward only, the LSTM forward + backward
            flop = 3 * f_unet if model == "UNet" else (
                f_unet + 3 * lstm_flops(windows * tw, side, side, 16, 16, 3))
            losses = [r["loss"] for r in log]
            print(f"  {profile} {model}: {flop / 1e12:.4f} TFLOP per step at "
                  f"{flop / ms / 1e9:.2f} TFLOP/s on the graphs [{card}]")
            print(f"  {profile} {model}: loss by log record "
                  + ", ".join(f"{r['iteration']}: {r['loss']:.4f}"
                              for r in log)
                  + "; last val Dice AAo/DAo "
                  + f"{log[-1]['val_dice_aa']:.3f}/"
                  + f"{log[-1]['val_dice_da']:.3f}")
            if not (all(math.isfinite(v) for v in losses)
                    and len(losses) >= 2 and losses[-1] < losses[0]):
                raise AssertionError(f"{profile} {model}: loss not finite "
                                     f"or not falling: {losses}")
    ao_programs(card, root, bundles)

    # one float32 step (joint: the U-Net takes gradients too) from the
    # trained production UNet-LSTM, card vs CPU
    from ukbb_cardiac_tpu_torch.ckpt import convert, store
    from ukbb_cardiac_tpu_torch.models.wrappers import UNetLSTM

    bundle = bundles[("production", "UNet-LSTM")]
    _, ucfg, names, params, state = store.load_model(bundle)
    cfg = tao.AoTrainConfig(model="UNet-LSTM", joint_train=True)
    images, labels = tao.get_random_batch_ao(
        tao.scan_dataset_ao(root)["train"], 1, image_size=AO_SIZE_TRAIN,
        time_window=cfg.time_window, rng=random.Random(0))
    batch = {"image": torch.from_numpy(images[:1]),
             "label": torch.from_numpy(labels[:1])}
    grads, loss = {}, {}
    for d in ("cpu", "cuda"):
        net = UNetLSTM(convert.unet_from_jax(params, state, names, ucfg),
                       convert.convlstm_from_jax(params, True)).to(d)
        value, _ = tao.make_ao_loss(cfg, net)(
            {k: t.to(d) for k, t in batch.items()}, 1)
        value.backward()
        loss[d] = float(value.detach())
        grads[d] = {k: p.grad.cpu() for k, p in net.named_parameters()
                    if p.grad is not None}
    worst = max(float((grads["cuda"][k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for k, g in grads["cpu"].items())
    print(f"  one f32 joint UNet-LSTM step on "
          f"{tuple(batch['image'].shape)}: loss card {loss['cuda']:.6f}, CPU "
          f"{loss['cpu']:.6f}; {len(grads['cpu'])} gradients differ by at "
          f"most {worst:.3e} of a tensor's largest (bound {GRAD_RTOL})")
    if (worst > GRAD_RTOL or len(grads["cuda"]) != len(grads["cpu"])
            or abs(loss["cuda"] - loss["cpu"]) > 1e-4 * loss["cpu"]):
        raise AssertionError(f"aortic card and CPU gradients differ: {worst}")

    # the trained bundle's deploy, card vs CPU, on a 10-frame cut
    dep = os.path.join(work, "ao_train_deploy")
    segs = {}
    for d in ("cuda", "cpu"):
        sub = os.path.join(dep, d, "4200000")
        tr = write_ao_annotated(sub, nifti, PROP_CPU_T, 60)
        deploy_dataset_ao(bundle, os.path.join(dep, d), device=d)
        segs[d] = np.asarray(nifti.load(os.path.join(
            sub, "seg_ao.nii.gz")).dataobj)
    agree = float((segs["cuda"] == segs["cpu"]).mean())
    dd = [dice(segs["cuda"], tr, k) for k in (1, 2)]
    print(f"  trained UNet-LSTM bundle deployed on a {PROP_CPU_T}-frame cine: "
          f"card vs CPU label agreement {agree:.6f}, Dice AAo/DAo "
          f"{dd[0]:.4f}/{dd[1]:.4f}")
    if agree < 0.999:
        raise AssertionError(f"trained aortic bundle: card and CPU labels "
                             f"agree on {agree}")


def ao_net(bundle, model):
    """The trained aortic model of a bundle on the card, channels-last as
    the trainer has it."""
    from ukbb_cardiac_tpu_torch.ckpt import convert, store
    from ukbb_cardiac_tpu_torch.models.wrappers import UNetLSTM

    _, ucfg, names, params, state = store.load_model(bundle)
    unet = convert.unet_from_jax(params, state, names, ucfg)
    net = (UNetLSTM(unet, convert.convlstm_from_jax(params, True))
           if model == "UNet-LSTM" else unet)
    return net.to("cuda", memory_format=torch.channels_last)


def ao_programs(card, root, bundles):
    """Phase 9's step programs on both routes from the trained bundles
    (:func:`step_routes`): the U-Net's and the phase-2 UNet-LSTM's (Adam
    over the LSTM, the U-Net frozen under ``no_grad`` inside the graph)
    production calls (K = 10 from the window pool, bf16, device
    augmentation) and reference steps (f32, host augmented windows of 5
    subjects); then the validation loss program of each, bitwise against
    the eager route."""
    from ukbb_cardiac_tpu_torch.reg.programs import ProgramCache
    from ukbb_cardiac_tpu_torch.train import ao as tao
    from ukbb_cardiac_tpu_torch.train import sa as tsa
    from ukbb_cardiac_tpu_torch.train import steps

    data = tao.scan_dataset_ao(root)
    for model in ("UNet", "UNet-LSTM"):
        cfg = tao.AoTrainConfig(
            model=model, image_size=AO_SIZE_TRAIN,
            batch_windows=AO_BATCH_WINDOWS[model], steps_per_dispatch=AO_K,
            device_augment=True, device_windows=True, pool_gb=2.0,
            device="cuda")
        pool, sample = tao._make_device_window_pipeline(
            cfg, data["train"], AO_K, random.Random(0), None, "cuda",
            verbose=False)
        drawn = [sample() for _ in range(AO_K)]
        batches = {k: torch.from_numpy(np.stack([b[k] for b in drawn])).cuda()
                   for k in drawn[0]}
        img, lab = pool.snapshot()
        ref_img, ref_lab = tao.get_random_batch_ao(
            data["train"], 5, image_size=AO_SIZE_TRAIN,
            time_window=cfg.time_window, flatten=model == "UNet",
            data_augmentation=True, rotate=10, scale=0.2,
            rng=random.Random(1))
        ref_batch = {"image": torch.from_numpy(ref_img).cuda(),
                     "label": torch.from_numpy(ref_lab).cuda()}

        def build(profile, model=model, cfg=cfg, img=img, lab=lab,
                  batches=batches, ref_batch=ref_batch):
            prod = profile == "production"

            def make():
                net = ao_net(bundles[(profile, model)], model)
                opt = tao.make_ao_optimizer(cfg, net)
                cache = ProgramCache(max_bytes=steps.TRAINER_BYTES)
                loss_fn = tao.make_ao_loss(
                    cfg, net, device_augment=prod,
                    compute_dtype=torch.bfloat16 if prod else None)
                step, multi = tsa.make_steps(loss_fn, opt, None, cache,
                                             prod, "window")
                if prod:
                    def call():
                        return multi(img, lab, batches,
                                     list(range(1, AO_K + 1)))[0]
                else:
                    def call():
                        return step(ref_batch, 1)[0][None]
                return call, lambda: train_state(net, opt), cache
            return make

        step_routes(card, f"{model} production call (K = {AO_K}, "
                    f"{cfg.batch_windows} windows of {cfg.time_window} "
                    "frames, bf16, the window pool, device augmentation)",
                    build("production"), AO_K, cfg.batch_windows,
                    "windows")
        n_ref = ref_img.shape[0] // (cfg.time_window if model == "UNet"
                                     else 1)
        step_routes(card, f"{model} reference step ({ref_img.shape[0]} "
                    f"{'frames' if model == 'UNet' else 'windows'}, f32, "
                    "host augmentation)", build("reference"), 1, n_ref,
                    "windows")

        # the validation loss on both routes
        net = ao_net(bundles[("production", model)], model)
        eval_loss = tao.make_ao_loss(cfg, net, train=False)
        cache = ProgramCache()
        v_img, v_lab = tao.get_random_batch_ao(
            data["validation"], 5, image_size=AO_SIZE_TRAIN,
            time_window=cfg.time_window, flatten=model == "UNet",
            rng=random.Random(2))
        v = {"image": torch.from_numpy(v_img).cuda(),
             "label": torch.from_numpy(v_lab).cuda()}
        eval_step = steps.make_eval_step(lambda b: eval_loss(b, 0),
                                         programs=cache)
        got = []
        for name in ("eager", "graphs", "graphs", "graphs", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with route(name):
                loss, aux = eval_step(v)
            got.append((name, float(loss), {k: float(a)
                                            for k, a in aux.items()},
                        time.perf_counter() - t0))
        progs = [p for p in cache.programs() if p.graph is not None]
        same = all(g[1:3] == got[0][1:3] for g in got)
        print(f"  {model} validation loss on {tuple(v_img.shape)}: "
              + ", ".join(f"{n} {1e3 * t:.3f} ms" for n, _, _, t in got)
              + f" (host seconds to the values); loss {got[0][1]:.6f}, "
              f"{'bitwise equal' if same else 'DIFFER'} on both routes"
              + "".join(f"; program capture {p.capture_s:.3f} s, "
                        f"+{p.reserved / 2 ** 20:.1f} MiB" for p in progs)
              + f" [{card}]")
        cache.clear()
        if not same or not progs:
            raise AssertionError(f"{model}: the validation loss program "
                                 "differs from the eager route")


def _write_dicom(job):
    """One DICOM file (a process-pool task: the Python encoders)."""
    from ukbb_cardiac_tpu_torch.data.dicom import dcmwrite_minimal

    path, attrs, pixel, syntax = job
    dcmwrite_minimal(path, attrs, pixel, transfer_syntax=syntax)
    return path


def dicom_affine(orientation, position, next_position, spacing, dz):
    """The RAS affine of a series from its DICOM header fields (LPS: x and
    y negated): columns along the rows and columns of the image, the
    slice step (or, for one slice, their cross product) times dz."""
    flip = np.array([-1.0, -1.0, 1.0])
    ax = flip * np.asarray(orientation[:3], float)
    ay = flip * np.asarray(orientation[3:], float)
    p0 = flip * np.asarray(position, float)
    if next_position is None:
        az = np.cross(ax, ay)
    else:
        az = flip * np.asarray(next_position, float) - p0
        az = az / np.linalg.norm(az)
    out = np.eye(4)
    out[:3, 0], out[:3, 1], out[:3, 2] = ax * spacing, ay * spacing, az * dz
    out[:3, 3] = p0
    return out


def application_files(work, eid, cines, compressed):
    """One subject's DICOM files for a UK Biobank application zip: per
    series (folder names as the conversion recognises them) and slice z,
    one file per frame t (SOP-UID file names) under ``work``, the frame's
    (Y, X) pixels as uint16, trigger time 40 t ms; ``compressed`` maps
    folders to transfer syntaxes.  Returns the :func:`_write_dicom` jobs
    and {sequence: expected affine}."""
    jobs, affines = [], {}
    for k, (seq, (key, iop, ipp)) in enumerate(INGEST_GEOMETRY.items()):
        cine = cines[key]
        X, Y, Z, T = cine.shape
        positions = [(ipp[0], ipp[1], ipp[2] + 10.0 * z) for z in range(Z)]
        affines[seq] = dicom_affine(iop, positions[0],
                                    positions[1] if Z > 1 else None, 1.8,
                                    10.0)
        for z in range(Z):
            folder = (f"CINE_segmented_SAX_b{z + 1}" if seq == "sa"
                      else INGEST_FOLDERS[seq])
            os.makedirs(os.path.join(work, folder), exist_ok=True)
            syntax = compressed.get(folder, EXPLICIT_LE)
            for t in range(T):
                uid = f"1.2.826.0.1.{eid}.{k}.{z}.{t}"
                attrs = {"SOPInstanceUID": uid,
                         "SeriesInstanceUID": f"1.2.826.0.2.{eid}.{k}.{z}",
                         "SeriesDescription": folder,
                         "CardiacNumberOfImages": T, "Rows": Y,
                         "Columns": X, "PixelSpacing": [1.8, 1.8],
                         "SpacingBetweenSlices": 10.0, "SliceThickness": 8.0,
                         "TriggerTime": 40.0 * t, "InstanceNumber": t + 1,
                         "ImagePositionPatient": list(positions[z]),
                         "ImageOrientationPatient": list(iop),
                         "BitsAllocated": 16, "PixelRepresentation": 0}
                jobs.append((os.path.join(work, folder, f"{uid}.dcm"), attrs,
                             np.ascontiguousarray(cine[:, :, z, t].T.astype(
                                 np.uint16)), syntax))
    return jobs, affines


def zip_folder(work, path):
    """``work``'s files, stored uncompressed in the zip ``path`` under
    their relative paths; ``work`` is removed."""
    import zipfile

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for d, _, files in sorted(os.walk(work)):
            for f in sorted(files):
                zf.write(os.path.join(d, f),
                         os.path.relpath(os.path.join(d, f), work))
    shutil.rmtree(work)


def write_application_zips(zips, T):
    """The cohort's N_SUBJECTS subjects (:func:`cohort_subject`) as
    ``<eid>.zip`` in ``zips``, subject 0 with INGEST_COMPRESSED's series,
    which a pool of processes encodes (the Python encoders, slowest syntax
    first) while this process writes the uncompressed files.  Returns the
    cines, the truth labels, the expected affines (each by eid) and the
    seconds of each part."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    cines, truth, affines, jobs = {}, {}, {}, []
    sec = {}
    t0 = time.perf_counter()
    for i in range(N_SUBJECTS):
        eid = str(INGEST_EID0 + i)
        cines[eid], truth[eid] = cohort_subject(i, T)
        files, affines[eid] = application_files(
            os.path.join(zips, eid), eid, cines[eid],
            INGEST_COMPRESSED if i == 0 else {})
        jobs += files
    sec["phantoms and headers"] = time.perf_counter() - t0
    slowest = {JPEG_LS: 0, SOF3: 1, RLE: 2}
    encoded = sorted((j for j in jobs if j[3] != EXPLICIT_LE),
                     key=lambda j: slowest[j[3]])
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = [pool.submit(_write_dicom, j) for j in encoded]
        t1 = time.perf_counter()
        for job in jobs:
            if job[3] == EXPLICIT_LE:
                _write_dicom(job)
        sec["uncompressed files"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        for f in pending:
            f.result()
        sec["then waiting for the encoders"] = time.perf_counter() - t1
    sec["compressed files (pool, from its start)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for eid in cines:
        zip_folder(os.path.join(zips, eid), os.path.join(zips, f"{eid}.zip"))
    sec["zips"] = time.perf_counter() - t0
    print(f"  {len(jobs)} DICOM files, {len(encoded)} of them compressed "
          f"(subject 0's {', '.join(INGEST_COMPRESSED)})")
    return cines, truth, affines, sec


def decode_rates(tree):
    """Decode rates of subject 0's compressed series, read from its zip's
    DICOMs: every frame through the reader (the native decoder for SOF3
    and JPEG-LS; RLE has only the Python one), and three frames of each
    JPEG syntax through the Python decoder alone.  Returns lines to
    print."""
    import zipfile

    from ukbb_cardiac_tpu_torch.data import dicom
    from ukbb_cardiac_tpu_torch.data import jpegcodec as jc

    lines = []
    with zipfile.ZipFile(os.path.join(tree, f"{INGEST_EID0}.zip")) as zf:
        for folder, syntax in INGEST_COMPRESSED.items():
            names = sorted(n for n in zf.namelist()
                           if n.startswith(folder + "/"))
            images = [dicom._dcmread_pure(zf.read(n)) for n in names]
            t0 = time.perf_counter()
            frames = [img.pixel_array for img in images]
            sec = time.perf_counter() - t0
            mb = sum(f.nbytes for f in frames) / 1e6
            how = "Python" if syntax == RLE else "native"
            lines.append(f"{folder} ({syntax}): {len(frames)} frames "
                         f"{frames[0].shape} decoded ({how}) in {sec:.4f} s, "
                         f"{mb / sec:.1f} MB/s")
            if syntax != RLE:
                slow = (jc.decode_jpeg_lossless if syntax == SOF3
                        else jc.decode_jpegls)
                t0 = time.perf_counter()
                for img, frame in zip(images[:3], frames):
                    if not np.array_equal(slow(img.PixelDataFragments[0]),
                                          frame):
                        raise AssertionError(f"{folder}: the Python and "
                                             f"native decoders differ")
                sec = time.perf_counter() - t0
                lines.append(f"  the same syntax, 3 frames through the "
                             f"Python decoder: {sec:.4f} s, "
                             f"{3 * frames[0].nbytes / 1e6 / sec:.2f} MB/s")
    return lines


def ingestion_phase(card, work):
    """UK Biobank ingestion on the card's path: N_SUBJECTS subjects of the
    cohort as application zips (subject 0 with a SOF3, a JPEG-LS and an
    RLE series), ``cli.convert_data`` to NIfTI, the converted voxels and
    affines held to the cines and headers written, then
    ``cli.run_cohort`` in full mode with 1 worker on the converted tree:
    every stage succeeds, SA Dice >= 0.9 against the phantom truth.
    Returns the kernels' launches in that cohort run."""
    import pandas as pd

    from ukbb_cardiac_tpu_torch.cli import convert_data, run_cohort
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.models import fused_head as fh
    from ukbb_cardiac_tpu_torch.reg import bspline_field as bf

    T = MAIN_SHAPE[3]
    print(f"[10/14] ingestion: {N_SUBJECTS} subjects as UK Biobank zips of "
          f"DICOMs (SA {MAIN_SHAPE}, LA 2/3/4Ch {MAIN_SHAPE[:2] + (1, T)}, "
          f"aortic {AO_SHAPE}; SOF3, JPEG-LS and RLE series in subject 0) -> "
          f"cli.convert_data -> cli.run_cohort full mode, 1 worker",
          flush=True)
    zips = os.path.join(work, "ingest_zips")
    tree = os.path.join(work, "ingest_nifti")
    os.makedirs(zips)
    t_phase = t0 = time.perf_counter()
    cines, truth, affines, parts = write_application_zips(zips, T)
    print(f"  wrote {N_SUBJECTS} zips in {time.perf_counter() - t0:.2f} s "
          f"({sum(os.path.getsize(os.path.join(zips, f)) for f in os.listdir(zips)) / 1e6:.1f} MB): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()))
    from ukbb_cardiac_tpu_torch import native

    t0 = time.perf_counter()
    print(f"  native host ops {native.build().name} ready in "
          f"{time.perf_counter() - t0:.2f} s (g++ at first use)")
    for line in decode_rates(zips):
        print(f"  {line}")
    t0 = time.perf_counter()
    convert_data.main(["--input_dir", zips, "--output_dir", tree])
    convert_s = time.perf_counter() - t0
    print(f"  cli.convert_data: {convert_s:.3f} s, "
          f"{convert_s / N_SUBJECTS:.3f} s per subject (host)")
    for eid, cine in cines.items():
        for seq, (key, _, _) in INGEST_GEOMETRY.items():
            img = nifti.load(os.path.join(tree, eid, f"{seq}.nii.gz"))
            vol = np.asarray(img.dataobj)
            want = cine[key].astype(np.float32)
            if not (vol.shape == want.shape and np.array_equal(vol, want)
                    and np.allclose(img.affine, affines[eid][seq],
                                    atol=1e-6)
                    and abs(float(img.header["pixdim"][4]) - 0.04) < 1e-6):
                raise AssertionError(f"{eid} {seq}: converted voxels, affine "
                                     f"or dt differ from what was written")
            # the cohort's phantom affine: the same world position for
            # every voxel of the written slices
            ref = COHORT_AFFINES[key]
            if not np.allclose(img.affine[:, [0, 1, 3]], ref[:, [0, 1, 3]]):
                raise AssertionError(f"{eid} {seq}: affine {img.affine} is "
                                     f"not the cohort's {ref}")
    print(f"  converted voxels equal the cines written; affines equal the "
          f"headers' (SA and aortic: the cohort's; LA: its in-plane axes "
          f"and origin); dt 0.04 s")
    write_pressures(os.path.join(work, "ingest_bp.csv"), sorted(cines))
    fh.fused_head.launches = 0
    bf.bspline_field.launches = bf.bspline_field.adjoint_launches = 0
    manifest = os.path.join(work, "ingest_cohort.json")
    out = os.path.join(work, "ingest_csv")
    rc = run_cohort.main([
        "--data_dir", tree, "--model_path", BUNDLE,
        "--model_path_la_2ch", os.path.join(WEIGHTS, LA_BUNDLES["la_2ch"]),
        "--model_path_la_4ch", os.path.join(WEIGHTS, LA_BUNDLES["la_4ch"]),
        "--model_path_seg4", os.path.join(WEIGHTS, LA_BUNDLES["seg4"]),
        "--model_path_ao", AO_BUNDLE,
        "--pressure_csv", os.path.join(work, "ingest_bp.csv"),
        "--device", "cuda", "--workers", "1", "--output_dir", out,
        "--manifest", manifest])
    launches = {"fused_head": fh.fused_head.launches,
                "bspline_field": bf.bspline_field.launches,
                "bspline_field_adjoint": bf.bspline_field.adjoint_launches}
    with open(manifest) as f:
        m = json.load(f)
    wall = m["wall_seconds"]
    print(f"  cohort on the converted tree: wall {wall:.3f} s, "
          f"{len(m['succeeded']) / wall:.4f} subjects/s; launches {launches} "
          f"[{card}]")
    if rc != 0 or len(m["succeeded"]) != N_SUBJECTS or m["failed"]:
        raise AssertionError(f"ingestion cohort: rc {rc}, failed "
                             f"{m['failed']}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"ingestion cohort launched a kernel no time: "
                             f"{launches}")
    for name, n_col in COHORT_TABLES.items():
        tab = pd.read_csv(os.path.join(out, name), index_col=0)
        if tab.shape != (N_SUBJECTS, n_col) or not np.isfinite(
                tab.values.astype(float)).all():
            raise AssertionError(f"ingestion {name}: shape {tab.shape} or "
                                 f"not finite")
    for eid, tr in truth.items():
        seg = np.asarray(nifti.load(os.path.join(
            tree, eid, "seg_sa.nii.gz")).dataobj)
        d = [dice(seg, tr["sa"], k) for k in (1, 2, 3)]
        print(f"  subject {eid}: SA Dice LV/Myo/RV "
              + "/".join(f"{v:.4f}" for v in d))
        if min(d) < 0.9:
            raise AssertionError(f"subject {eid}: SA Dice {d} < 0.9")
    print(f"  ingestion phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# the ninth slice's phase: the demo on the cohort phase's first subjects,
# the device trace, both-directions strain, the checkpoint audit, PheWAS
DEMO_SUBJECTS = 2
DEMO_SEGS = ("seg_sa.nii.gz", "seg_sa_ED.nii.gz", "seg_sa_ES.nii.gz",
             "seg_la_2ch.nii.gz", "seg_la_4ch.nii.gz", "seg4_la_4ch.nii.gz",
             "seg_ao.nii.gz")
# demo tables against the cohort phase's rows: exact for volumes (labels
# are the same), the CPU tests' rtol 1e-6 for the host measures, the
# strain bounds (per column, Global columns) for the registrations
DEMO_TABLES = {"table_ventricular_volume.csv": 0.0,
               "table_wall_thickness.csv": 1e-6,
               "table_atrial_volume.csv": 1e-6,
               "table_aortic_area.csv": 1e-6}
COHORT_VOLUME_NAMES = {"LVM (g)": "LVEDM"}
DEMO_STRAIN = {"table_strain_sax.csv": (STRAIN_SEGMENT_ATOL,
                                        STRAIN_GLOBAL_ATOL),
               "table_strain_lax.csv": (LA_STRAIN_SEGMENT_ATOL,
                                        LA_STRAIN_GLOBAL_ATOL)}
# PheWAS at a size whose CLI run stays under 30 s on one host core: a
# UK Biobank imaging cohort's ~20,000 subjects cut to 3,000 (age_by_date
# reads each subject's row of the whole table, O(subjects x fields)); 500
# fields; one IDP per column of the cohort's tables
PHEWAS_SIZE = (3000, 500, sum(COHORT_TABLES.values()))
PHEWAS_STEPS = ("build_confounders", "clean_columns", "normalise_non_idps",
                "deconfound_idps", "univariate_correlation",
                "significance_thresholds", "manhattan_plot",
                "top_hits_table")


def _reset_launches():
    from ukbb_cardiac_tpu_torch.models import fused_head as fh
    from ukbb_cardiac_tpu_torch.reg import bspline_field as bf

    fh.fused_head.launches = 0
    bf.bspline_field.launches = bf.bspline_field.adjoint_launches = 0


def _launches():
    from ukbb_cardiac_tpu_torch.models import fused_head as fh
    from ukbb_cardiac_tpu_torch.reg import bspline_field as bf

    return {"fused_head": fh.fused_head.launches,
            "bspline_field": bf.bspline_field.launches,
            "bspline_field_adjoint": bf.bspline_field.adjoint_launches}


def demo_phase(card, work, truth):
    """``cli.demo_pipeline.main`` on the cohort phase's first subjects
    (their cines, its pressure CSV, the trained bundles): every seg and
    table, the rows against the cohort phase's, SA Dice.  Returns the
    kernels' launches in the demo."""
    import pandas as pd

    from ukbb_cardiac_tpu_torch.cli import demo_pipeline
    from ukbb_cardiac_tpu_torch.io import nifti

    subjects = sorted(truth)[:DEMO_SUBJECTS]
    print(f"[11/14] this slice: the demo pipeline on {len(subjects)} "
          f"subjects (SA {MAIN_SHAPE}, LA {MAIN_SHAPE[:2] + (1, MAIN_SHAPE[3])}"
          f", aortic {AO_SHAPE} int16), the trained bundles", flush=True)
    root = os.path.join(work, "demo")
    data, csv = (os.path.join(root, "demo_image"),
                 os.path.join(root, "demo_csv"))
    os.makedirs(csv)
    for subject in subjects:
        os.makedirs(os.path.join(data, subject))
        for seq in ("sa", "la_2ch", "la_4ch", "ao"):
            shutil.copy(os.path.join(work, "cohort", subject,
                                     f"{seq}.nii.gz"),
                        os.path.join(data, subject))
    shutil.copy(os.path.join(work, "bp.csv"),
                os.path.join(csv, "blood_pressure_info.csv"))
    _reset_launches()
    t0 = time.perf_counter()
    stages = demo_pipeline.main(["--data_dir", data, "--model_dir", WEIGHTS,
                                 "--csv_dir", csv, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = _launches()
    print(f"  demo wall {wall:.3f} s; stage s "
          + ", ".join(f"{k} {v['total_s']:.3f}" for k, v in stages.items())
          + f"; launches {launches} [{card}]")
    if len(stages) != 9 or not all(n > 0 for n in launches.values()):
        raise AssertionError(f"demo: stages {list(stages)}, launches "
                             f"{launches}")
    for subject in subjects:
        for name in DEMO_SEGS:
            if not os.path.exists(os.path.join(data, subject, name)):
                raise AssertionError(f"demo: {subject}/{name} missing")
        seg = np.asarray(nifti.load(os.path.join(
            data, subject, "seg_sa.nii.gz")).dataobj)
        d = [dice(seg, truth[subject]["sa"], k) for k in (1, 2, 3)]
        print(f"  subject {subject}: SA Dice LV/Myo/RV "
              + "/".join(f"{v:.4f}" for v in d))
        if min(d) < 0.9:
            raise AssertionError(f"demo: subject {subject} SA Dice {d}")
    cohort = os.path.join(work, "cohort_csv_0")
    rows = [int(s) for s in subjects]
    for name, bounds in list(DEMO_TABLES.items()) + list(DEMO_STRAIN.items()):
        got = pd.read_csv(os.path.join(csv, name), index_col=0)
        ref = pd.read_csv(os.path.join(cohort, name), index_col=0)
        # the cohort's volume table keeps the measures' own names
        # (LVEDV, LVEDM, ...), the CLI's adds units (LVEDV (mL), LVM (g))
        cols = [c if c in ref.columns else
                COHORT_VOLUME_NAMES.get(c, c.split(" (")[0])
                for c in got.columns]
        if sorted(got.index) != rows or not set(cols) <= set(ref.columns):
            raise AssertionError(f"demo {name}: rows {list(got.index)}, "
                                 f"columns {list(got.columns)}")
        g = got.loc[rows].values.astype(float)
        r = ref.loc[rows, cols].values.astype(float)
        if name in DEMO_TABLES:
            ok = np.allclose(g, r, rtol=bounds, atol=0, equal_nan=True)
            worst = np.nanmax(np.abs(g - r) / np.maximum(np.abs(r), 1e-30))
            print(f"  {name}: rows against the cohort phase's, largest "
                  f"relative difference {worst:.3e} (bound {bounds})")
        else:
            glob_cols = np.array(["Global" in c for c in cols])
            diff = np.abs(g - r)
            seg_diff = np.nanmax(diff)
            glob_diff = np.nanmax(diff[:, glob_cols]) if glob_cols.any() \
                else 0.0
            ok = seg_diff <= bounds[0] and glob_diff <= bounds[1]
            print(f"  {name}: against the cohort phase's, per column "
                  f"{seg_diff:.4f} pp (bound {bounds[0]}), Global "
                  f"{glob_diff:.4f} pp (bound {bounds[1]})")
        if not ok:
            raise AssertionError(f"demo {name} differs from the cohort "
                                 f"phase's rows")
    return launches


def trace_phase(card, work, subject):
    """``cli.deploy_network --trace_dir`` on one subject: the trace names
    the head's kernels; their device time read from it."""
    from ukbb_cardiac_tpu_torch.cli import deploy_network

    data = os.path.join(work, "trace_data")
    os.makedirs(os.path.join(data, subject))
    shutil.copy(os.path.join(work, "cohort", subject, "sa.nii.gz"),
                os.path.join(data, subject))
    trace_dir = os.path.join(work, "trace")
    t0 = time.perf_counter()
    deploy_network.main(["--data_dir", data, "--model_path", BUNDLE,
                         "--trace_dir", trace_dir, "--device", "cuda"])
    wall = time.perf_counter() - t0
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
             if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"device trace: files {files}")
    with open(files[0]) as f:
        text = f.read()
    if "head_kernel" not in text or "coarse_kernel" not in text:
        raise AssertionError("device trace names no head_kernel / "
                             "coarse_kernel")
    kern = {k: [e["dur"] for e in json.loads(text)["traceEvents"]
                if e.get("cat") == "kernel" and k in e.get("name", "")]
            for k in ("head_kernel", "coarse_kernel")}
    print(f"  device trace of one SA deploy (wall {wall:.3f} s): "
          f"{os.path.getsize(files[0]) / 1e6:.2f} MB; head_kernel "
          f"{len(kern['head_kernel'])} launches, "
          f"{sum(kern['head_kernel']) / 1e3:.4f} ms on the device; "
          f"coarse_kernel {len(kern['coarse_kernel'])} launches, "
          f"{sum(kern['coarse_kernel']) / 1e3:.4f} ms [{card}]")


def both_directions_phase(card, work, strain, register):
    """Both-directions SA strain (``inverse_consistent=False``) on the
    main path's first deployed subject on the card, beside the default
    scheme's tables there; then card against the port's CPU path on the
    strain phase's 6-frame cut.  Returns the B-spline launches of the
    full-size run."""
    cfg = register.RegConfig.cine_2d_motion()
    subject = sorted(os.listdir(os.path.join(work, "data")))[0]
    subj = os.path.join(work, "data", subject)
    # the first call captures the programs of B = 294, the second replays
    # them; then the eager route
    runs = {}
    for name, how in (("capture", "graphs"), ("replay", "graphs"),
                      ("eager", "eager")):
        motion = os.path.join(subj, f"motion_both_{name}")
        os.makedirs(motion)
        _reset_launches()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        with route(how):
            ev[0].record()
            ctx = strain.start_sa_motion_dispatch(
                subj, motion, cfg, eval_dice=True, device="cuda",
                inverse_consistent=False)
            ev[1].record()
        stem = "strain_both" if name == "replay" else f"strain_both_{name}"
        dice_df = strain.finish_sa_motion(ctx, os.path.join(subj, stem))
        wall = time.perf_counter() - t0
        n = _launches()
        del n["fused_head"]
        runs[name] = (strain_tables(os.path.join(subj, stem)),
                      dice_df.values, n, wall)
        print(f"  both-directions SA strain, {name} ({how}): wall "
              f"{wall:.4f} s, device span {ev[0].elapsed_time(ev[1]):.4f} "
              f"ms [{card}]; launches {n}")
    launches = runs["replay"][2]
    pairs = len(ctx["selected"]) * 2 * (ctx["T"] - 1)
    tab = {k: strain_tables(os.path.join(subj, k))
           for k in ("strain_both", "strain_sa")}
    ecc = {k: t["circum"].loc["Global"].min() for k, t in tab.items()}
    err = {k: t["radial"].loc["Global"].max() for k, t in tab.items()}
    d = runs["replay"][1].mean(axis=0)
    bitwise = all(tables_equal(runs[k][0], runs["eager"][0])
                  and np.array_equal(runs[k][1], runs["eager"][1])
                  for k in ("capture", "replay"))
    print(f"  both-directions SA strain, subject {subject}: {pairs} pairs; "
          f"global Ecc {ecc['strain_both']:.4f} % (default "
          f"scheme {ecc['strain_sa']:.4f}), Err {err['strain_both']:.4f} % "
          f"(default {err['strain_sa']:.4f}); warp-Dice LV {d[0]:.4f} Myo "
          f"{d[1]:.4f}; capture and replay against the eager route: "
          f"{'bitwise equal' if bitwise else 'NOT bitwise equal'}")
    if pairs != N_PAIRS_BOTH or not all(n > 0 for n in launches.values()):
        raise AssertionError(f"both directions: {pairs} pairs, launches "
                             f"{launches}")
    if not all(runs[k][2] == launches for k in runs):
        raise AssertionError("both directions: the routes counted other "
                             "launches")
    if not (np.isfinite(ecc["strain_both"]) and np.isfinite(err[
            "strain_both"]) and d[0] >= 0.9):
        raise AssertionError("both directions: strain not finite or "
                             f"warp-Dice {d}")
    if not bitwise:
        diff = max(np.nanmax(np.abs(runs[k][0][c].values
                                    - runs["eager"][0][c].values))
                   for k in ("capture", "replay") for c in ("radial",
                                                            "circum"))
        print(f"  not bitwise: largest difference {diff:.6g} pp, held to "
              f"the both-directions bound {BOTH_SEGMENT_ATOL}")
        if not diff <= BOTH_SEGMENT_ATOL:
            raise AssertionError("graphed and eager both-directions strain "
                                 "disagree beyond the CPU bound")
    red = os.path.join(work, "reduced", subject)
    out = {}
    for dev in ("cuda", "cpu"):
        m_dir = os.path.join(red, f"motion_both_{dev}")
        os.makedirs(m_dir)
        t0 = time.perf_counter()
        dd = strain.cine_2d_sa_motion_and_strain_analysis(
            red, m_dir, os.path.join(red, f"both_{dev}"), cfg,
            eval_dice=True, device=dev, inverse_consistent=False)
        out[dev] = (strain_tables(os.path.join(red, f"both_{dev}")),
                    dd.values, time.perf_counter() - t0)
    seg_diff = max(np.nanmax(np.abs(out["cuda"][0][k].values
                                    - out["cpu"][0][k].values))
                   for k in ("radial", "circum"))
    glob_diff = max(np.abs(out["cuda"][0][k].loc["Global"].values
                           - out["cpu"][0][k].loc["Global"].values).max()
                    for k in ("radial", "circum"))
    dice_diff = np.abs(out["cuda"][1] - out["cpu"][1]).max()
    print(f"  card vs CPU both-directions strain on a (192, 208, 10, 6) "
          f"subject: per-segment {seg_diff:.4f} pp (bound "
          f"{BOTH_SEGMENT_ATOL}), global {glob_diff:.4f} pp (bound "
          f"{STRAIN_GLOBAL_ATOL}), warp-Dice {dice_diff:.5f} (bound "
          f"{DICE_ATOL}); card {out['cuda'][2]:.3f} s, CPU "
          f"{out['cpu'][2]:.3f} s")
    if not (seg_diff <= BOTH_SEGMENT_ATOL and glob_diff <= STRAIN_GLOBAL_ATOL
            and dice_diff <= DICE_ATOL):
        raise AssertionError("card and CPU both-directions strain disagree")
    return launches


def checkpoint_phase(work):
    """``cli.verify_checkpoint --fingerprint`` on the five trained bundles
    and ``--fingerprint_diff`` against the committed goldens."""
    import importlib.util

    from ukbb_cardiac_tpu_torch.cli import verify_checkpoint

    has_tf = importlib.util.find_spec("tensorflow") is not None
    for name in ("FCN_sa", "FCN_la_2ch", "FCN_la_4ch", "FCN_la_4ch_seg4",
                 "UNet-LSTM_ao"):
        fp = os.path.join(work, f"{name}.json")
        rc = verify_checkpoint.main([
            "--model_path", os.path.join(WEIGHTS, f"{name}.npz"),
            "--fingerprint", fp, "--device", "cuda"])
        diff = verify_checkpoint.main([
            "--fingerprint_diff",
            os.path.join(WEIGHTS, "fingerprints", f"{name}.json"), fp])
        print(f"  checkpoint audit {name}: verify exit {rc} ("
              + ("forward checked against the TF ops" if has_tf else
                 "TensorFlow absent on this machine: the forward check "
                 "cannot run, exit 2 as the JAX CLI's")
              + f"), fingerprint diff against the golden exit {diff}")
        if diff != 0 or rc != (0 if has_tf else 2):
            raise AssertionError(f"checkpoint audit {name}: exit {rc}, "
                                 f"diff {diff}")


def phewas_phase(card, work):
    """``cli.perform_phenome_wide_association`` on a synthetic UK
    Biobank-shaped table (host work): seconds by step, M x N, the
    thresholds; the planted associations must be the top hits."""
    import pandas as pd

    from ukbb_cardiac_tpu_torch.cli import \
        perform_phenome_wide_association as cli

    n, m, k = PHEWAS_SIZE
    root = os.path.join(work, "phewas")
    t0 = time.perf_counter()
    idp, pheno, planted = phewas_tables(root, n, m, k)
    t_tables = time.perf_counter() - t0
    has_mpl = subprocess.run([sys.executable, "-c", "import matplotlib"],
                             capture_output=True, timeout=120).returncode == 0
    t_mpl = 0.0
    if has_mpl:
        t0 = time.perf_counter()
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import font_manager
        font_manager.findfont("DejaVu Sans")   # builds the font cache
        t_mpl = time.perf_counter() - t0
    seconds, returned = {}, {}
    real = {name: getattr(cli, name) for name in PHEWAS_STEPS}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            returned[name] = out
            return out
        return run

    for name, fn in real.items():
        if name == "manhattan_plot" and not has_mpl:
            fn = (lambda *a, **kw: None)
        setattr(cli, name, timed(name, fn))
    out = os.path.join(root, "out")
    t0 = time.perf_counter()
    try:
        cli.main(["--idp_csv", idp, "--pheno_csv", *pheno, "--output_dir",
                  out])
    finally:
        for name, fn in real.items():
            setattr(cli, name, fn)
    wall = time.perf_counter() - t0
    p_bonf, p_fdr = returned["significance_thresholds"]
    M, N = returned["univariate_correlation"][1].shape
    hits = pd.read_csv(os.path.join(out, "top_hits.csv"))
    top = hits.sort_values("p").head(len(planted))
    want = {(i, int(c.split("-")[0])) for i, c in planted}
    got = set(zip(top["IDP"], top["FieldID"]))
    print(f"  PheWAS ({'whole CLI' if has_mpl else 'CLI steps without the '
          'Manhattan plot: matplotlib absent on this machine (the plots '
          'extra)'}): {n} subjects x {m} fields x {k} IDPs; tables written "
          f"in {t_tables:.2f} s, font cache {t_mpl:.2f} s; CLI {wall:.2f} s "
          "(GPU machine's host), by step "
          + ", ".join(f"{s} {seconds.get(s, 0.0):.3f}" for s in PHEWAS_STEPS)
          + f", reading and writing {wall - sum(seconds.values()):.3f} s; "
          f"M x N = {M} x {N}; Bonferroni p {p_bonf:.3e}, FDR p "
          f"{p_fdr:.3e}; top hits {sorted(got)}")
    if got != want:
        raise AssertionError(f"PheWAS: top hits {sorted(got)}, planted "
                             f"{sorted(want)}")


def slice_phase(card, work, truth, strain, register):
    """Phase 11: the demo, the device trace, both-directions strain, the
    checkpoint audit and PheWAS.  Returns the kernels' launches in the
    demo and in the both-directions strain run."""
    t_phase = time.perf_counter()
    demo = demo_phase(card, work, truth)
    trace_phase(card, work, sorted(truth)[0])
    both = both_directions_phase(card, work, strain, register)
    checkpoint_phase(work)
    phewas_phase(card, work)
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    return demo, both


# the mesh slice's phase: the cohort phase's subjects split over a mesh
# that names the one card twice
MESH_DEVICES = ["cuda:0", "cuda:0"]
MESH_AO_SUBJECTS = 2


def mesh_phase(card, work, truth):
    """``make_mesh`` on the card; both engines' ``segment_subjects_sharded``
    over ``make_mesh(MESH_DEVICES)`` on the cohort's SA cines and on
    MESH_AO_SUBJECTS aortic cines, labels byte for byte against the
    per-subject path; ``run_cohort_sa(mesh=...)`` with 1 worker on the
    cohort's subjects (segs on disk: the strain stage runs, its pairs in
    two shards), strain rows against phase 5's 1-worker rows; and
    ``cli.eval_strain_sax --mesh_devices 1`` on one subject.  Returns the
    kernels' launches in the sharded runs."""
    import pandas as pd

    from ukbb_cardiac_tpu_torch.cli import eval_strain_sax
    from ukbb_cardiac_tpu_torch.infer import deploy, deploy_ao
    from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
    from ukbb_cardiac_tpu_torch.parallel import cohort as cohort_mod
    from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    T = MAIN_SHAPE[3]
    print(f"[12/14] meshes: fleet deploys and the sharded registration over "
          f"make_mesh({MESH_DEVICES}): {N_SUBJECTS} SA cines {MAIN_SHAPE}, "
          f"{MESH_AO_SUBJECTS} aortic cines {AO_SHAPE} int16, the SA strain "
          f"of {N_SUBJECTS} subjects", flush=True)
    one = make_mesh(1)
    print(f"  make_mesh(1) -> {one}")
    if one.devices.tolist() != [torch.device("cuda", 0)]:
        raise AssertionError(f"make_mesh(1) holds {one.devices.tolist()}")
    n_cards = torch.cuda.device_count()
    try:
        make_mesh(n_cards + 1)
    except ValueError as exc:
        print(f"  make_mesh({n_cards + 1}) -> ValueError: {exc}")
    else:
        raise AssertionError(f"make_mesh({n_cards + 1}) did not raise")
    mesh = make_mesh(MESH_DEVICES)
    launches = dict.fromkeys(("fused_head", "bspline_field",
                              "bspline_field_adjoint"), 0)

    def sharded(fn):
        """Run ``fn`` with the counts at 0; add its launches."""
        _reset_launches()
        out = fn()
        for k, v in _launches().items():
            launches[k] += v
        return out

    def per_subject(dispatch, cines):
        pending = [dispatch(c) for c in cines]
        return [p.result() for p in pending]

    # the SA fleet against the per-subject path (run once first: cuDNN's
    # first calls choose their algorithms)
    sa = np.stack([cohort_subject(i, T)[0]["sa"] for i in range(N_SUBJECTS)])
    engine = InferenceEngine(deploy.load_segmentation_model(BUNDLE, "cuda"))
    per_subject(engine.segment_sequence_dispatch, sa[:1])
    t0 = time.perf_counter()
    ref = per_subject(engine.segment_sequence_dispatch, sa)
    t_ref = time.perf_counter() - t0
    head_before = launches["fused_head"]
    t0 = time.perf_counter()
    fleet = sharded(lambda: engine.segment_subjects_sharded(sa, mesh))
    t_fleet = time.perf_counter() - t0
    same = [np.array_equal(fleet[i], ref[i]) for i in range(N_SUBJECTS)]
    print(f"  SA fleet {sa.shape}: wall {t_fleet:.4f} s against the "
          f"per-subject path's {t_ref:.4f} s [{card}]; fused_head launches "
          f"{launches['fused_head'] - head_before}; labels byte-identical "
          f"to segment_sequence_dispatch: {same}")
    if fleet.dtype != np.uint8 or fleet.shape != sa.shape or not all(same):
        raise AssertionError("the SA fleet's labels differ from the "
                             "per-subject path's")

    # the aortic fleet
    ao = np.stack([cohort_subject(i, T)[0]["ao"]
                   for i in range(MESH_AO_SUBJECTS)])
    ao_engine = deploy_ao.load_aortic_engine(AO_BUNDLE, "cuda")
    ao_engine.segment_cine(ao[0])
    t0 = time.perf_counter()
    ref_ao = per_subject(ao_engine.segment_cine_dispatch, ao)
    t_ref_ao = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_ao = sharded(lambda: ao_engine.segment_subjects_sharded(ao, mesh))
    t_fleet_ao = time.perf_counter() - t0
    same = [np.array_equal(fleet_ao[i], ref_ao[i])
            for i in range(MESH_AO_SUBJECTS)]
    print(f"  aortic fleet {ao.shape}: wall {t_fleet_ao:.4f} s against the "
          f"per-subject path's {t_ref_ao:.4f} s [{card}]; labels "
          f"byte-identical to segment_cine: {same}")
    if fleet_ao.shape != ao.shape or not all(same):
        raise AssertionError("the aortic fleet's labels differ from "
                             "segment_cine's")

    # the sharded registration through the cohort: phase 5's segs are on
    # disk, so each subject's deploy skips and its strain stage runs
    out = os.path.join(work, "mesh_csv")
    bsp_before = (launches["bspline_field"],
                  launches["bspline_field_adjoint"])
    result = sharded(lambda: cohort_mod.run_cohort_sa(
        os.path.join(work, "cohort"), engine, workers=1, mesh=mesh,
        output_dir=out, verbose=False))
    if sorted(result.fleet.succeeded) != sorted(truth) or \
            result.fleet.failed:
        raise AssertionError(f"sharded cohort: {result.fleet.failed}")
    # phase 5's last run: 1 worker, every shape's graphs captured
    with open(os.path.join(work, "cohort_5.json")) as f:
        flat_stages = json.load(f)["stage_seconds"]
    strain_s = {k: float(np.median([st["strain"] for st in v.values()]))
                for k, v in (("mesh", result.stage_seconds),
                             ("flat", flat_stages))}
    n = (launches["bspline_field"] - bsp_before[0],
         launches["bspline_field_adjoint"] - bsp_before[1])
    got, want = (pd.read_csv(os.path.join(d, "table_strain_sax.csv"),
                             index_col=0).sort_index()
                 for d in (out, os.path.join(work, "cohort_csv_0")))
    diff = np.abs(got.values - want.values)
    glob = [want.columns.get_loc(c) for c in ("Ecc_Global (%)",
                                              "Err_Global (%)")]
    seg_diff, glob_diff = float(np.nanmax(diff)), float(diff[:, glob].max())
    print(f"  sharded SA strain, {N_SUBJECTS} subjects, 1 worker: median "
          f"strain stage {strain_s['mesh']:.4f} s (its first subject "
          f"captures the shards' graphs) against phase 5's last "
          f"unsharded run's {strain_s['flat']:.4f} s [{card}]; per subject "
          f"bspline_field launches {n[0] / N_SUBJECTS:g}, adjoint "
          f"{n[1] / N_SUBJECTS:g}; strain rows against phase 5's 1-worker "
          f"rows: max difference {seg_diff:.6g} pp, Global {glob_diff:.6g} "
          f"pp ({'equal' if seg_diff == 0 else 'not equal'})")
    if got.shape != want.shape or list(got.index) != list(want.index):
        raise AssertionError(f"sharded strain table {got.shape}")
    if seg_diff != 0:
        print("  the rows differ: float noise in the shards' batched ops "
              "(the shards run at half the batch) grows through Adam; held "
              f"to the SA strain bounds ({STRAIN_SEGMENT_ATOL} / "
              f"{STRAIN_GLOBAL_ATOL} pp)")
    if not (seg_diff <= STRAIN_SEGMENT_ATOL
            and glob_diff <= STRAIN_GLOBAL_ATOL):
        raise AssertionError("sharded strain rows outside the SA bounds")
    if min(n) <= 0:
        raise AssertionError("the sharded strain launched no B-spline kernel")

    # the strain CLI through its main with --mesh_devices 1
    subject = sorted(truth)[0]
    data = os.path.join(work, "mesh_cli")
    os.makedirs(os.path.join(data, subject))
    for name in ("sa", "seg_sa", "seg_sa_ED"):
        shutil.copy(os.path.join(work, "cohort", subject, f"{name}.nii.gz"),
                    os.path.join(data, subject))
    t0 = time.perf_counter()
    eval_strain_sax.main(["--data_dir", data, "--output_csv",
                          os.path.join(work, "mesh_cli.csv"), "--device",
                          "cuda", "--mesh_devices", "1"])
    row = pd.read_csv(os.path.join(work, "mesh_cli.csv"), index_col=0)
    cli_diff = float(np.nanmax(np.abs(
        row.loc[int(subject)].values - want.loc[int(subject)].values)))
    print(f"  eval_strain_sax --mesh_devices 1 on {subject}: wall "
          f"{time.perf_counter() - t0:.4f} s; row against phase 5's: max "
          f"difference {cli_diff:.6g} pp")
    if not cli_diff <= STRAIN_SEGMENT_ATOL:
        raise AssertionError("the strain CLI's row is outside the SA bounds")
    print(f"  mesh launches {launches}; phase 12: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# the data-parallel slice's phase: the FCN_sa architecture on phase 7's
# phantom set and the UNet-LSTM_ao widths on phase 9's propagated labels,
# over train/distributed.py.  The machine has one card: a world of one
# NCCL rank (bitwise against the single-card trainer), and two gloo ranks
# on cuda:0 (NCCL refuses two ranks on one card; gloo stages CUDA tensors
# through the host).  No figure here is a multi-card speed.
DP_ITERS = 20                        # 2 calls of K = 10 (the first untimed)
DP_AO_ITERS, DP_AO_K = 10, 5
DP_WINDOWS = 8                       # 4 a rank


def dp_sa_config(ckpt, data, iters, validation_every=10):
    """The production profile at the released FCN_sa architecture (the
    CLI's defaults: 128-slice batches, K = 10, bf16, device augmentation,
    compact transfer, the subject cache, the slice pool)."""
    from ukbb_cardiac_tpu_torch.train import sa as tsa

    return tsa.SATrainConfig(
        seq_name="sa", image_size=TRAIN_CROP, train_iteration=iters,
        learning_rate=1e-3 * TRAIN_BATCH / 20, dataset_dir=data,
        checkpoint_dir=ckpt, validation_every=validation_every, seed=0,
        device_augment=True, steps_per_dispatch=10, batch_slices=TRAIN_BATCH,
        bf16=True, compact_transfer=True, device_slices=True, pool_gb=1.0,
        cache_gb=4.0, device="cuda")


def train_log(ckpt):
    (model_dir,) = [os.path.join(ckpt, m) for m in os.listdir(ckpt)]
    with open(os.path.join(model_dir, "train_log.jsonl")) as f:
        return model_dir, [json.loads(line) for line in f]


def nccl_step_routes(card, work, data):
    """A world of one NCCL rank in this process: the data-parallel pool
    step (``make_pool_slice_multi_dp_step``, K = 10 x 128 slices, bf16,
    the FCN_sa bundle) on both routes through :func:`step_routes` (its
    all-reduce captured in the graph); the group goes at the end."""
    import torch.distributed as dist

    from ukbb_cardiac_tpu_torch.reg.programs import ProgramCache
    from ukbb_cardiac_tpu_torch.train import device_pool
    from ukbb_cardiac_tpu_torch.train import sa as tsa
    from ukbb_cardiac_tpu_torch.train import steps

    K = 10
    img, lab, batches = slice_pool_call(data, K)
    rendezvous = tempfile.mkdtemp(dir=work)
    dist.init_process_group(
        "nccl", init_method=f"file://{rendezvous}/rdv", world_size=1,
        rank=0, device_id=torch.device("cuda:0"))
    try:
        group = dist.group.WORLD
        routes = set()

        def build():
            net, names, mcfg, _, _ = fcn_net(BUNDLE)
            opt = steps.Adam(net.parameters(), lr=1e-3 * TRAIN_BATCH / 20)
            cache = ProgramCache(max_bytes=steps.TRAINER_BYTES)
            step = device_pool.make_pool_slice_multi_dp_step(
                tsa.make_fcn_loss(net, mcfg, device_augment=True,
                                  compute_dtype=torch.bfloat16,
                                  group=group),
                opt, group, programs=cache)
            routes.add(step.route)

            def call():
                return step(img, lab, batches, list(range(1, K + 1)))[0]
            return call, lambda: train_state(net, opt), cache

        step_routes(card, f"DP pool step call, a world of one NCCL rank (K "
                    f"= {K}, {TRAIN_BATCH} slices, bf16)", build, K,
                    TRAIN_BATCH, "slices")
        print(f"  its route: {routes}")
        if routes != {"nccl group (graphs)"}:
            raise AssertionError(f"NCCL step route: {routes}")
    finally:
        dist.destroy_process_group()


def dp_phase(card, work, ao_root):
    """Data-parallel training on the one card: a world of one NCCL rank
    against the single-card trainer, bitwise; the DP step's call of a
    world of one NCCL rank on both routes (:func:`nccl_step_routes`);
    then one group of two gloo
    ranks on cuda:0 (one spawn, ``distributed.run_in_turn``) for 20
    production SA iterations, one float32 step against the single-card
    step, and 10 UNet-LSTM iterations beside the single card's, losses
    falling; the CLI's refusal of more ranks than cards.  Returns the
    head kernel's launches in rank 0's validations."""
    from ukbb_cardiac_tpu_torch.ckpt import convert, store
    from ukbb_cardiac_tpu_torch.cli import train_network
    from ukbb_cardiac_tpu_torch.train import ao as tao
    from ukbb_cardiac_tpu_torch.train import distributed
    from ukbb_cardiac_tpu_torch.train import sa as tsa

    t_phase = time.perf_counter()
    data = os.path.join(work, "train_set")
    print(f"[13/14] data-parallel training (train/distributed.py) on the one "
          f"card: FCN_sa architecture on phase 7's set, {TRAIN_BATCH}-slice "
          f"batches; UNet-LSTM_ao widths on phase 9's labels, "
          f"{DP_WINDOWS}-window batches", flush=True)
    launches = 0

    def report(what, stats, items, wall=None, t0=None):
        ms = 1e3 * stats["steady_s"] / max(stats["steady_iterations"], 1)
        peak = stats.get("max_allocated_by_rank",
                         [torch.cuda.max_memory_allocated()])
        spawn = ("" if t0 is None else
                 f"; spawn + group set-up {stats['rank_start_time'] - t0:.2f}"
                 " s (host clock, call to the rank's start)")
        took = "" if wall is None else f" in {wall:.2f} s"
        print(f"  {what}: {stats['iterations']} iterations{took}; "
              f"steady {stats['steady_iterations']} steps at {ms:.4f} "
              f"ms/step, {1e3 * items / ms:.1f} {'windows' if items == DP_WINDOWS else 'slices'}/s, "
              f"waited on the loader {stats['wait_s']:.4f} s; peak memory "
              f"by rank {[round(b / 2 ** 30, 3) for b in peak]} GiB{spawn} "
              f"[{card}]")

    def falling(what, ckpt):
        _, log = train_log(ckpt)
        losses = [r["loss"] for r in log]
        print(f"  {what}: loss by log record "
              + ", ".join(f"{r['iteration']}: {r['loss']:.4f}" for r in log))
        if not (len(losses) >= 2 and all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{what}: losses not falling: {losses}")

    # a world of one NCCL rank against the single-card trainer, on the
    # graphs and on the eager route: cuDNN restricted to deterministic
    # algorithms in all three (the ranks take the caller's setting)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name in ("single card", "single card, eager route",
                     "NCCL world of 1"):
            ckpt = os.path.join(work, "dp_" + name.replace(" ", "_")
                                .replace(",", ""))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with route("eager" if "eager" in name else "graphs"):
                _, _, _, stats = tsa.train(
                    dp_sa_config(ckpt, data, DP_ITERS), progress_every=1000,
                    **({"devices": ["cuda:0"], "backend": "nccl"}
                       if name.startswith("NCCL") else {}))
            wall = time.time() - t0
            model_dir, _ = train_log(ckpt)
            with np.load(os.path.join(model_dir,
                                      f"model-{DP_ITERS}.npz")) as z:
                runs[name] = {k: z[k] for k in z.files}
            nccl = name.startswith("NCCL")
            report(f"SA, {name} ({stats['route']})", stats, TRAIN_BATCH,
                   wall, t0 if nccl else None)
            calls = max(stats["steady_calls"], 1)
            print(f"    host dispatch {1e3 * stats['dispatch_s'] / calls:.3f} "
                  f"ms a call; programs: " + ("; ".join(
                      f"{p['tag']} {tuple(p['first_input'])} capture "
                      f"{p['capture_s']:.3f} s, +{p['reserved'] / 2 ** 20:.1f}"
                      f" MiB" for p in stats["programs"]) or "none"))
            if nccl:
                launches += stats["fused_head_launches"]
                print(f"  head launches in rank 0's validations: "
                      f"{stats['fused_head_launches']}")
                if stats["route"] != "nccl group (graphs)":
                    raise AssertionError(f"NCCL route: {stats['route']}")
    finally:
        torch.backends.cudnn.deterministic = saved
    for name in ("single card, eager route", "NCCL world of 1"):
        differ = sorted(k for k, v in runs["single card"].items()
                        if not np.array_equal(v, runs[name][k]))
        print(f"  {name} against the single card's graphs: "
              f"{len(runs['single card'])} arrays (params, BN state, Adam "
              f"state), bitwise equal: {not differ}"
              + (f" ({len(differ)} differ: {differ[:4]})" if differ else ""))
        if differ or set(runs[name]) != set(runs["single card"]):
            raise AssertionError(f"{name}: {len(differ)} arrays differ from "
                                 "the single-card trainer's")

    # the DP pool step of a world of one NCCL rank, in this process, on
    # both routes (its gradient all-reduce captured in the graph)
    nccl_step_routes(card, work, data)

    # one group of two gloo ranks on cuda:0 for three jobs: 20 production
    # SA iterations, one float32 step of the FCN_sa bundle at a global
    # batch of GRAD_BATCH slices, 10 UNet-LSTM iterations from phase 9's
    # production U-Net
    kind, mcfg, names, params, state = store.load_model(BUNDLE)
    net = convert.fcn_from_jax(params, state, names, mcfg)
    images, labels = tsa.get_random_batch(
        tsa.scan_dataset(data, "sa")["train"], 1, image_size=TRAIN_CROP,
        rng=random.Random(0))
    step_args = (net, functools.partial(tsa.make_fcn_loss, cfg=mcfg),
                 {"image": images[None, :GRAD_BATCH],
                  "label": labels[None, :GRAD_BATCH]}, [1], None, 1e-4,
                 "single")
    ao_ckpt = os.path.join(work, "ao_ckpt_production_graphs")
    (unet_dir,) = [os.path.join(ao_ckpt, m) for m in os.listdir(ao_ckpt)
                   if m.startswith("UNet_")]
    ao_cfgs = {name: tao.AoTrainConfig(
        model="UNet-LSTM", image_size=AO_SIZE_TRAIN,
        train_iteration=DP_AO_ITERS, dataset_dir=ao_root,
        checkpoint_dir=os.path.join(work, "dp_ao_" + name),
        model_path=os.path.join(
            unet_dir, f"model-{AO_TRAIN_ITERS['production']}.npz"),
        validation_every=DP_AO_ITERS // 2, cache_gb=2.0,
        compact_transfer=True, batch_windows=DP_WINDOWS,
        steps_per_dispatch=DP_AO_K, device_augment=True, bf16=True,
        device_windows=True, device="cuda") for name in ("single", "dp")}
    sa_ckpt = os.path.join(work, "dp_gloo_sa")
    calls = [(tsa.train_rank, (dp_sa_config(sa_ckpt, data, DP_ITERS), 10,
                               None, 1000), {}),
             (distributed.replica_steps, step_args, {}),
             (tao.train_rank, (ao_cfgs["dp"], DP_AO_K, None, 1000), {})]
    t0 = time.time()
    (_, _, _, sa_stats), got, (_, _, _, ao_stats) = distributed.run(
        distributed.run_in_turn, (calls,), ["cuda:0", "cuda:0"],
        backend="gloo")
    wall = time.time() - t0
    print(f"  two gloo ranks on cuda:0, three jobs in one group: {wall:.2f} "
          "s with the spawn")
    report(f"SA over 2 gloo ranks ({sa_stats['route']}: by design, chosen "
           "when the step is built)", sa_stats, TRAIN_BATCH, t0=t0)
    if sa_stats["route"] != "gloo group (uncaptured)":
        raise AssertionError(f"gloo route: {sa_stats['route']}")
    launches += sa_stats["fused_head_launches"]
    print(f"  head launches in rank 0's validations: "
          f"{sa_stats['fused_head_launches']}")
    falling("SA over 2 gloo ranks", sa_ckpt)
    want = distributed.replica_steps(None, *step_args, device="cuda")
    worst = {part: max(float((got[part][k] - v).abs().max())
                       / max(float(v.abs().max()), 1e-30)
                       for k, v in want[part].items()
                       if part == "grads" or "moving" in k)
             for part in ("grads", "state")}
    print(f"  one f32 step, {GRAD_BATCH} slices over the 2 ranks: loss "
          f"{float(got['losses'][0]):.6f} against the single card's "
          f"{float(want['losses'][0]):.6f}; gradients within "
          f"{worst['grads']:.3e}, BN state within {worst['state']:.3e} of "
          f"each tensor's largest (bound {GRAD_RTOL})")
    if (max(worst.values()) > GRAD_RTOL
            or set(got["grads"]) != set(want["grads"])):
        raise AssertionError(f"two gloo ranks against one card: {worst}")
    report(f"UNet-LSTM over 2 gloo ranks ({ao_stats['route']})", ao_stats,
           DP_WINDOWS)
    falling("UNet-LSTM over 2 gloo ranks", ao_cfgs["dp"].checkpoint_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    _, _, _, stats = tao.train(ao_cfgs["single"], progress_every=1000)
    report(f"UNet-LSTM, single card ({stats['route']})", stats, DP_WINDOWS,
           time.time() - t0)
    falling("UNet-LSTM, single card", ao_cfgs["single"].checkpoint_dir)

    # the CLI on one card refuses two ranks, naming the card count
    try:
        train_network.main(["--dataset_dir", data, "--mesh_devices", "2",
                            "--checkpoint_dir", os.path.join(work, "dp_cli")])
    except ValueError as exc:
        print(f"  cli.train_network --mesh_devices 2 -> ValueError: {exc}")
        if f"has {torch.cuda.device_count()}" not in str(exc):
            raise AssertionError("the refusal does not name the card count")
    else:
        raise AssertionError("--mesh_devices 2 on one card did not raise")
    print(f"  one-card figures (the ranks share cuda:0), no multi-card "
          f"speed; phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launches


def sort_probe(card):
    """The percentile rescale's ``torch.sort`` of an int16 cine at each
    size the smoke run meets and 12 more, in a fresh process that has
    reserved 16 GiB as a long run has: per size the first eager sort,
    the second, and the sort captured into a CUDA graph after them (as a
    program's warm-up and capture run it), each under torch.profiler
    (CPU and CUDA activities), the host seconds of each; for a call of
    0.1 s or more, its longest CPU-side events (aten ops and CUDA
    runtime calls), to name where the host waits."""
    from torch.profiler import ProfilerActivity, profile

    sizes = sorted({X * Y * Z * T for X, Y, Z, T in SHAPES}
                   | {192 * 208 * 50, AO_SHAPE[0] * AO_SHAPE[1] * 100}
                   | {1_000_003 + 2_411_917 * k for k in range(12)})
    print(f"sort probe: the first torch.sort of int16 cines at {len(sizes)} "
          f"sizes, eager then captured [{card}]", flush=True)
    blocks = [torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
              for _ in range(16)]
    del blocks
    rng = torch.Generator(device="cuda").manual_seed(0)
    for n in sizes:
        x = torch.randint(0, 1000, (n,), generator=rng, device="cuda",
                          dtype=torch.int16)
        torch.cuda.synchronize()
        row = []
        for what in ("first", "second", "captured"):
            graph = torch.cuda.CUDAGraph() if what == "captured" else None
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    if graph is None:
                        torch.sort(x)
                    else:
                        with torch.cuda.graph(graph):
                            torch.sort(x)
                    host = time.perf_counter() - t0
                    torch.cuda.synchronize()
            except RuntimeError as err:
                row.append(f"{what} raised {str(err).splitlines()[0]}")
                continue
            row.append(f"{what} {host:.4f} s")
            if host >= 0.1:
                longest = sorted(
                    (e for e in prof.events() if e.device_type.name == "CPU"),
                    key=lambda e: -e.time_range.elapsed_us())[:6]
                row.append("(longest: " + ", ".join(
                    f"{e.name} {e.time_range.elapsed_us() / 1e6:.4f} s"
                    for e in longest) + ")")
            del graph
        print(f"  n = {n}: " + "; ".join(row), flush=True)


def training_only(card, kernels, fh, bf):
    """``--training``: the kernels' build, then phases 7, 9 (the
    propagation and the aortic trainer) and 13 alone, on fresh data; no
    result line."""
    build_phase(kernels)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        train_phase(card, work, fh)
        print(f"  phase 7: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        root, ao_truth, _ = propagation_phase(card, work, bf)
        ao_train_phase(card, root, ao_truth, work)
        print(f"  phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
        dp_phase(card, work, root)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ukbb_cardiac_tpu_torch import kernels, resolve_device
    from ukbb_cardiac_tpu_torch.cli import eval_wall_thickness
    from ukbb_cardiac_tpu_torch.infer import deploy
    from ukbb_cardiac_tpu_torch.infer import engine as engine_mod
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.models import fcn as tfcn
    from ukbb_cardiac_tpu_torch.models import fused_head as fh
    from ukbb_cardiac_tpu_torch.ops import crop
    from ukbb_cardiac_tpu_torch.phenotype import strain, ventricle
    from ukbb_cardiac_tpu_torch.reg import bspline as tb
    from ukbb_cardiac_tpu_torch.reg import bspline_field as bf
    from ukbb_cardiac_tpu_torch.reg import programs, register

    t_start = time.perf_counter()
    resolve_device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    if sys.argv[1:] == ["--sort_probe"]:
        sort_probe(card)
        print(card_line())
        return 0
    if sys.argv[1:] == ["--training"]:
        training_only(card, kernels, fh, bf)
        print(card_line())
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--forward_vs":
        forward_vs_earlier(card, kernels, bf, sys.argv[2])
        print(card_line())
        return 0
    builds = build_phase(kernels)
    model = deploy.load_segmentation_model(BUNDLE, "cuda")
    head = kernel_phase(card, fh, tfcn, model, builds["fused_head"])
    la_head_phase(card, fh, tfcn, deploy)
    spline = bspline_phase(card, tb, bf)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(ROOT, "build"))
    try:
        launches = main_path_phase(card, fh, nifti, deploy, ventricle,
                                   engine_mod, work, model.head.n_level)
        launches.update(strain_phase(card, nifti, crop, bf, strain, register,
                                     eval_wall_thickness, work))
        print(f"  earlier paths' launches {launches}")
        # the kernels line counts the cohort's 1-worker run: the path a
        # user runs by default, through every kernel
        cohort_launches, truth = cohort_phase(card, work)
        shapes_phase(card, work)
        aortic_phase(card, work, truth)
        train_launches = train_phase(card, work, fh)
        resnet_launches = resnet_phase(card, work, fh)
        print(f"  fused_head launches: training phase {train_launches}, "
              f"ResNet phase {resnet_launches}")
        # this slice's path: the propagation (both B-spline kernels in
        # every Adam step at its crop), then the aortic trainer, which
        # runs cuDNN and PyTorch only
        root, ao_truth, prop_launches = propagation_phase(card, work, bf)
        ao_train_phase(card, root, ao_truth, work)
        # raw DICOM zips -> NIfTI -> the full cohort
        ingest_launches = ingestion_phase(card, work)
        # this slice's path: the demo, the trace, both-directions strain,
        # the checkpoint audit and PheWAS
        demo_launches, both_launches = slice_phase(card, work, truth, strain,
                                                   register)
        # this slice's path: the fleet deploys and the sharded registration
        mesh_launches = mesh_phase(card, work, truth)
        # this slice's path: data-parallel training over torch.distributed
        dp_launches = dp_phase(card, work, root)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[14/14] total {time.perf_counter() - t_start:.1f} s")
    held = [p for p in programs.programs() if p.graph is not None]
    print(f"  captured programs held: {len(held)}, memory_reserved +"
          f"{sum(p.reserved for p in held) / 2 ** 30:.3f} GiB in all "
          f"[{card}]:\n" + captured_programs(held))
    # the engines' own programs (each engine holds its cache; the cohort
    # runs' engines went with their runs)
    engine_progs = []
    for name, eng in HELD_ENGINES:
        progs = [p for p in eng.programs() if p.graph is not None]
        engine_progs += progs
        print(f"  {name} engine: {len(progs)} programs, memory_reserved +"
              f"{sum(p.reserved for p in progs) / 2 ** 30:.3f} GiB "
              f"[{card}]:\n" + captured_programs(progs))
    print(f"  the engines' programs held: {len(engine_progs)}, "
          f"memory_reserved +"
          f"{sum(p.reserved for p in engine_progs) / 2 ** 30:.3f} GiB; "
          f"all programs "
          f"{sum(p.reserved for p in held + engine_progs) / 2 ** 30:.3f} "
          f"GiB; memory_reserved at the end "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB [{card}]")

    entries = [{
        "name": "fused_head", "route": "cuda",
        "source": "ukbb_cardiac_tpu_torch/csrc/fused_head.cu",
        "replaces": "ukbb_cardiac_tpu/models/pallas_head.py:178",
        "launches": cohort_launches["fused_head"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "path": "cohort, 1 worker",
        "launched_by": "replays of the deploy engines' CUDA graphs (each "
                       "adds the launches its capture recorded) and the "
                       "first, eager call of each shape on each engine",
        "ingestion": {"launches": ingest_launches["fused_head"]},
        "demo": {"launches": demo_launches["fused_head"]},
        "mesh": {"launches": mesh_launches["fused_head"]},
        # phase 7: the graphs route's validation programs and the trained
        # bundle's deploy
        "training": {"launches": train_launches},
        "data_parallel": {"launches": dp_launches}}]
    # the B-spline kernels: launches on the cohort's path and times at the
    # SA strain path's 96^2 (the series of earlier slices), and under
    # "propagation" the aortic propagation's launches and times at its
    # shape (pairs, crop X, Y, lattice, spacing), under "demo" the demo's
    # launches, under "both_directions" the both-directions strain run's
    # launches and the times at its B = 294, 96^2
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name in ("bspline_field", "bspline_field_adjoint"):
        t, tp, tb2 = (spline[k][name] for k in ("sa", "propagation", "both"))
        entries.append({
            "name": name, "route": "cuda",
            "source": "ukbb_cardiac_tpu_torch/csrc/bspline_field.cu",
            "replaces": "ukbb_cardiac_tpu/reg/pallas_bspline.py:84",
            "launches": cohort_launches[name],
            **{k: t[k] for k in keys},
            "path": "cohort, 1 worker",
            "launched_by": "replays of the registration's CUDA graphs "
                           "(each adds the launches its capture recorded) "
                           "and the first, eager call of each shape",
            "ingestion": {"launches": ingest_launches[name]},
            "propagation": {"launches": prop_launches[name],
                            "shape": spline["propagation"]["shape"],
                            **{k: tp[k] for k in keys}},
            "demo": {"launches": demo_launches[name]},
            "mesh": {"launches": mesh_launches[name]},
            "both_directions": {"launches": both_launches[name],
                                "shape": spline["both"]["shape"],
                                **{k: tb2[k] for k in keys}}})
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
