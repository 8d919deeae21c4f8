"""The arithmetic against the figures ``chip_smoke.py`` printed on an H100
(PERF.md).  Where a count here is larger, the difference is the 1x1
output convolution, which ``chip_smoke.py``'s hooks on ``ConvBN`` modules
did not see; each test names it."""

import pytest

from benchmark.counts.bspline_bounds import (bspline_bounds, lattice_shape,
                                             registration_calls)
from benchmark.counts.cohort_work import forward_flops, strain_image
from benchmark.counts.fcn_flops import fcn_forward_flops, fcn_train_flops
from benchmark.counts.head_bound import fcn_head_levels, head_bound
from benchmark.counts.unet_lstm_flops import (convlstm_forward_flops,
                                              phase2_train_flops,
                                              unet_forward_flops)

FCN = {"n_class": 4, "n_level": 5, "n_filter": [16, 32, 64, 128, 256],
       "n_block": [2, 2, 3, 3, 3], "same_dim": 32, "fc": 64, "in_ch": 1}
UNET = {"n_class": 3, "n_level": 5, "n_filter": [16, 32, 64, 128, 256],
        "n_block": [2, 2, 2, 2, 2], "in_ch": 1}
AO = {"unet": UNET, "lstm_hidden": 16, "bidirectional": True}


def test_fcn_production_step():
    # chip_smoke: 1.0903 TFLOP (128 slices of 192^2, forward x 3) without
    # the output convolution: 3 x 128 x 2 x 192^2 x 64 x 4 = 7.25 GFLOP
    out_conv = 3 * 128 * 2 * 192 * 192 * 64 * 4
    assert fcn_train_flops(FCN, 128, 192, 192) == pytest.approx(
        1.0903e12 + out_conv, abs=5e7)


def test_fcn_forward_slice():
    # about 3.1 GFLOP a (192, 208) slice
    assert fcn_forward_flops(FCN, 192, 208) == pytest.approx(3.0965e9,
                                                              rel=1e-4)


def test_unet_frame_and_convlstm_cine():
    # chip_smoke: 6.361 GFLOP a 256^2 frame, without the output conv
    assert unet_forward_flops(UNET, 256, 256) == pytest.approx(
        6.361e9 + 2 * 256 * 256 * 16 * 3, abs=1e6)
    # chip_smoke: 0.4832 TFLOP the gates of 2 x 100 steps at 256^2; the
    # 1x1 output convolution adds 100 x 2 x 256^2 x 32 x 3
    gates = convlstm_forward_flops(100, 256, 256, 16, 16, 3) \
        - 100 * 2 * 256 * 256 * 32 * 3
    assert gates == pytest.approx(0.4832e12, abs=5e7)


def test_unet_lstm_production_step():
    # chip_smoke: 1.5044 TFLOP (72 frames: the U-Net forward, the
    # ConvLSTM x 3), without the U-Net's output convolution
    assert phase2_train_flops(AO, 72, 256, 256) == pytest.approx(
        1.5044e12 + 72 * 2 * 256 * 256 * 16 * 3, abs=5e7)


def test_head_bound():
    ms = 1e3 * head_bound(64, fcn_head_levels(FCN, 192, 208), 4, 32, 64)[0]
    assert ms == pytest.approx(0.2501, abs=5e-5)
    assert head_bound(64, fcn_head_levels(FCN, 192, 208), 4, 32,
                      64)[1] == "operations"


def test_bspline_bound():
    b = bspline_bounds(150, (13, 13), (96, 96), 10)
    assert 1e3 * b["synthesis"][0] == pytest.approx(0.00336, abs=5e-6)
    assert b["synthesis"][1] == b["adjoint"][1] == "bytes"


def test_registration_calls():
    reg = {"spacing": 10, "levels": 3, "iters": 30}
    calls = registration_calls(150, (128, 128), reg)
    # each level's 30 Adam steps, the finished levels densified at the
    # next ones (1 + 2), every level densified at full size (3)
    assert sum(c[0] == "adjoint" for c in calls) == 90
    assert sum(c[0] == "synthesis" for c in calls) == 96
    assert lattice_shape((128, 128), 10) == (16, 16)
    assert {c[2] for c in calls} == {(7, 7), (10, 10), (16, 16)}


def test_cohort_work_from_shapes():
    cfg = {"model": "fcn", "network": FCN}
    assert forward_flops(cfg, (198, 208, 11, 50)) == pytest.approx(
        550 * fcn_forward_flops(FCN, 208, 208))
    import numpy as np
    ed = np.zeros((180, 192, 9), np.int16)
    ed[50:131, 56:137] = 2
    ed[60:121, 66:127] = 1
    ed[10:40, 60:120] = 3          # the RV is left out of the crop
    assert strain_image(ed) == (128, 128)
