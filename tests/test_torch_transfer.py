"""The port's packed up-leg (``infer/transfer.py``) against the JAX
package's, on the CPU.

Bounds: the pack planner's decisions and the packed bytes identical to
the JAX package's; ``unpack_torch`` rebuilds every array exactly (plane
and temporal-delta modes); the bandwidth tracker's EMA equal to JAX's;
the SA and aortic engines' labels with a packed up-leg byte-identical to
the raw up-leg's, and their transfer accounting as the JAX engines'.
"""

import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.infer import transfer as jtr
from ukbb_cardiac_tpu_torch.infer import transfer as ttr
from ukbb_cardiac_tpu_torch.infer.deploy_ao import AorticEngine
from ukbb_cardiac_tpu_torch.infer.engine import (InferenceEngine,
                                                 SegmentationModel)
from ukbb_cardiac_tpu_torch.models import convlstm, fcn, unet, wrappers

torch.set_num_threads(1)


def _bw(mod, mbps):
    """A tracker of either package: None = no sample yet."""
    bw = mod.BandwidthTracker()
    if mbps is not None:
        bw.update(int(mbps * 1e5), 0.1)
    return bw


def _quiet(dtype, shape=(32, 36, 4, 24), seed=1, step=40):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4000, size=shape[:-1] + (1,)).astype(np.int32)
    walk = rng.randint(-step, step + 1, size=shape).astype(np.int32)
    walk[..., 0] = 0
    return np.clip(base + np.cumsum(walk, axis=-1), 0, 4095).astype(dtype)


def _arrays():
    rng = np.random.RandomState(0)
    out = {f"plane{m}": rng.randint(0, m + 1, size=(13, 17, 3, 5)).astype(
        np.int16) for m in (255, 1023, 4095)}
    out["delta_i16"] = _quiet(np.int16)
    out["delta_u16"] = _quiet(np.uint16)
    out["noisy"] = np.clip(500 + 80 * rng.randn(24, 24, 2, 20), 0,
                           1023).astype(np.int16)
    out["negative"] = out["plane1023"].copy()
    out["negative"][0, 0, 0, 0] = -1
    out["wide"] = out["plane1023"].copy()
    out["wide"][0, 0, 0, 0] = 5000
    out["float"] = out["plane1023"].astype(np.float32)
    out["uint8"] = (out["plane1023"] % 200).astype(np.uint8)
    out["int8"] = (out["plane1023"] % 100).astype(np.int8)
    out["odd_tail"] = rng.randint(0, 1024, size=(7, 3, 1, 1)).astype(
        np.int16)
    return out


ARRAYS = _arrays()


@pytest.mark.parametrize("mbps", [None, 10.0, 1000.0])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_plan_and_bytes_identical_to_jax(name, mbps):
    img = ARRAYS[name]
    ref = jtr.plan_pack(img, _bw(jtr, mbps))
    got = ttr.plan_pack(img, _bw(ttr, mbps))
    if ref is None:
        assert got is None
        return
    assert got is not None and got.__dict__ == ref.__dict__
    assert ttr.packed_nbytes(got) == jtr.packed_nbytes(ref)
    np.testing.assert_array_equal(ttr.pack_buffer(img, got),
                                  jtr.pack_buffer(img, ref))


@pytest.mark.parametrize("name", ["plane255", "plane1023", "plane4095",
                                  "delta_i16", "noisy", "int8", "odd_tail"])
def test_unpack_round_trip_exact(name):
    img = ARRAYS[name]
    plan = ttr.plan_pack(img, None)
    buf = ttr.pack_buffer(img, plan)
    got = ttr.unpack_torch(torch.from_numpy(buf), plan)
    assert got.dtype == torch.from_numpy(img).dtype
    np.testing.assert_array_equal(got.numpy(), img)
    if name == "delta_i16":
        assert plan.mode == "delta"


def test_unpack_forced_delta_and_uint16():
    """Large but packable deltas (a moving bright edge) with delta mode
    forced; a uint16 cine comes back as int32 holding the same values."""
    img = np.zeros((8, 8, 1, 16), np.int16)
    for t in range(16):
        img[t % 8, :, 0, t] = 2000  # |delta| 2000 -> zigzag 4000 < 4096
    plan = ttr.PackPlan(img.shape, img.dtype.str, "delta", hi_bits=4,
                        f0_hi_bits=4)
    buf = ttr.pack_buffer(img, plan)
    np.testing.assert_array_equal(
        buf, jtr.pack_buffer(img, jtr.PackPlan(**plan.__dict__)))
    np.testing.assert_array_equal(
        ttr.unpack_torch(torch.from_numpy(buf), plan).numpy(), img)
    u16 = ARRAYS["delta_u16"]
    plan = ttr.plan_pack(u16, None)
    assert plan.mode == "delta"
    got = ttr.unpack_torch(torch.from_numpy(ttr.pack_buffer(u16, plan)),
                           plan)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), u16)


def test_bandwidth_tracker_ema_matches_jax():
    pairs = [(40_000_000, 0.04), (4_000_000, 1.0), (4_000_000, 1.0),
             (0, 1.0), (3_000_000, 0.0), (900_000_000, 1.5)]
    jb, tb = jtr.BandwidthTracker(), ttr.BandwidthTracker()
    assert jb.degraded and tb.degraded  # unknown
    for n, s in pairs:
        jb.update(n, s)
        tb.update(n, s)
        assert tb.mbps == jb.mbps and tb.degraded == jb.degraded
    assert not tb.want_sample()  # just sampled: throttled


@pytest.mark.parametrize("mbps", [None, 1000.0])
def test_upload_cine_is_the_raw_transpose(mbps):
    """upload_cine hands the engines the cine's (T, Z, Y, X) transpose in
    its own dtype, packed or not, and counts the bytes shipped."""
    cine = np.asfortranarray(_quiet(np.int16, (32, 36, 4, 24), seed=5))
    stats = ttr.TransferStats()
    got = ttr.upload_cine(cine, "cpu", _bw(ttr, mbps), stats)
    assert got.dtype == torch.int16 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), cine.T)
    assert stats.h2d_dispatches == 1 and stats.h2d_raw_bytes == cine.nbytes
    if mbps is None:
        plan = ttr.plan_pack(cine, None)
        assert stats.packed_dispatches == 1 and plan.mode == "delta"
        assert stats.h2d_bytes == ttr.packed_nbytes(plan) < cine.nbytes
    else:
        assert stats.packed_dispatches == 0
        assert stats.h2d_bytes == cine.nbytes


TINY = fcn.FCNConfig(n_class=4, n_level=5, n_filter=(4, 8, 8, 8, 8),
                     n_block=(1, 1, 1, 1, 1), same_dim=4, fc=8)


@pytest.mark.parametrize("cine", ["plane", "delta"])
def test_sa_engine_packed_dispatch_byte_identical(cine):
    net = fcn.init_weights(fcn.FCN(TINY), torch.Generator().manual_seed(0))
    model = SegmentationModel.from_fcn(net, "cpu")
    if cine == "plane":
        img = (np.random.RandomState(7).rand(48, 52, 3, 9) * 1000).astype(
            np.int16)
    else:
        img = _quiet(np.int16, (48, 52, 3, 12), seed=11, step=30)
    img = np.asfortranarray(img)  # as a NIfTI cine arrives
    eng_raw = InferenceEngine(model, chunk=8)
    eng_raw._bw = _bw(ttr, 1000.0)
    seg_raw = eng_raw.segment_sequence_fused(img)
    assert eng_raw._stats.packed_dispatches == 0
    assert eng_raw._stats.h2d_bytes == img.nbytes

    eng_pack = InferenceEngine(model, chunk=8)
    assert eng_pack._bw.mbps is None  # unknown counts as degraded
    seg_pack = eng_pack.segment_sequence_fused(img)
    np.testing.assert_array_equal(seg_pack, seg_raw)
    assert eng_pack._stats.packed_dispatches == 1
    assert eng_pack._stats.delta_dispatches == (cine == "delta")
    assert eng_pack._stats.h2d_bytes < img.nbytes
    assert len(np.unique(seg_raw)) > 1


def test_aortic_engine_packed_dispatch_byte_identical():
    cfg = unet.UNetConfig(n_class=3, n_level=3, n_filter=(4, 8, 8),
                          n_block=(1, 1, 1))
    gen = torch.Generator().manual_seed(0)
    net = wrappers.UNetLSTM(
        fcn.init_weights(unet.UNet(cfg), gen),
        fcn.init_weights(convlstm.BiConvLSTM(4, 4, 3), gen))
    rng = np.random.RandomState(3)
    cine = np.asfortranarray((rng.rand(40, 44, 1, 6) * 1000).astype(
        np.int16))
    eng = AorticEngine("unet_lstm", net, "cpu")
    seg_pack = eng.segment_cine(cine, z_score=True, pad_to=48)
    assert eng._stats.packed_dispatches == 1
    eng._bw = _bw(ttr, 1000.0)
    seg_raw = eng.segment_cine(cine, z_score=True, pad_to=48)
    np.testing.assert_array_equal(seg_pack, seg_raw)
    assert eng._stats.packed_dispatches == 1
    assert eng._stats.h2d_dispatches == 2
    assert len(np.unique(seg_raw)) > 1
