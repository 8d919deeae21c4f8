"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card.  This file
imports neither ``jax`` nor the JAX package, so it also runs on a GPU
machine that has no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py
"""

import contextlib
import functools
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
from ukbb_cardiac_tpu_torch.infer.engine import (InferenceEngine,
                                                 SegmentationModel, pack_bits,
                                                 unpack_bits)
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.models import fused_head as tfh
from ukbb_cardiac_tpu_torch.phenotype import strain as tstrain
from ukbb_cardiac_tpu_torch.reg import bspline as tb
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.reg import register as tr
from ukbb_cardiac_tpu_torch.reg.bspline_field import bspline_field

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(__file__), "fixtures", "bench_weights")

# float32: the kernel and the plain version differ only in summation
# order; bfloat16 features are read exactly by both, so the same order
# argument holds, with the larger activations of a random net.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# B-spline synthesis: at most 16 float32 products per value, summed in
# another order; the adjoint sums up to (4s)^2 of them per control.
FIELD_ATOL, ADJOINT_ATOL = 1e-5, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


def _random_fcn(n_class=4, seed=0, n_level=5):
    """FCN at the released widths (the first ``n_level`` levels) with
    seeded random weights and BN statistics."""
    cfg = tfcn.FCNConfig(n_class=n_class, n_level=n_level,
                         n_filter=(16, 32, 64, 128, 256)[:n_level],
                         n_block=(2, 2, 3, 3, 3)[:n_level])
    net = tfcn.FCN(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("weight"):
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=g) / fan_in ** 0.5)
            elif name.endswith(("gamma", "moving_variance")):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return net.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_class,shape", [(4, (3, 64, 80)),
                                           (6, (2, 48, 112))])
def test_fused_head_kernel_matches_plain(card, dtype, n_class, shape):
    net = _random_fcn(n_class).to(card)
    head = tfh.fold_head(net)
    N, X, Y = shape
    x = torch.rand(N, X, Y, 1, device=card,
                   generator=torch.Generator(card).manual_seed(1))
    with torch.inference_mode():
        feats = net.encode(tfcn.nchw(x, dtype))
        before = tfh.fused_head.launches
        got = tfh.fused_head(feats, head)
        torch.cuda.synchronize()
        ref = tfh.fused_head_plain(feats, head)
    assert tfh.fused_head.launches == before + head.n_level
    assert got.shape == (N, n_class, X, Y)
    torch.testing.assert_close(got, ref, atol=ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_class,n_level,shape", [
    (2, 3, (2, 36, 44)),   # 1584 pixels per image: a last tile of 48
    (4, 2, (3, 18, 26)),   # 468: a last 16-pixel block of 4 pixels
    (8, 1, (2, 13, 7)),    # 91: not 16-byte aligned, staged by plain loads
])
def test_fused_head_kernel_ragged_tiles(card, dtype, n_class, n_level,
                                        shape):
    net = _random_fcn(n_class, seed=n_level, n_level=n_level).to(card)
    head = tfh.fold_head(net)
    N, X, Y = shape
    x = torch.rand(N, X, Y, 1, device=card,
                   generator=torch.Generator(card).manual_seed(2))
    with torch.inference_mode():
        feats = net.encode(tfcn.nchw(x, dtype))
        got = tfh.fused_head(feats, head)
        torch.cuda.synchronize()
        ref = tfh.fused_head_plain(feats, head)
    assert got.shape == (N, n_class, X, Y)
    torch.testing.assert_close(got, ref, atol=ATOL[dtype], rtol=0)


@pytest.mark.cuda
def test_fused_head_rejects_widths_it_was_not_built_for(card):
    net = tfcn.FCN(tfcn.FCNConfig(n_filter=(4, 8, 8, 8, 8), same_dim=4,
                                  fc=8)).to(card).eval()
    x = torch.rand(1, 32, 32, 1, device=card)
    with torch.inference_mode(), pytest.raises(ValueError, match="same_dim"):
        tfh.apply_fcn_fused(net, x)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(card):
    net = _random_fcn()
    image = (np.random.RandomState(2).rand(40, 52, 3, 4) * 1000).astype(
        np.int16)
    segs = []
    for dev in ("cpu", card):
        model = SegmentationModel.from_fcn(net, dev)
        pending = InferenceEngine(model, chunk=8).segment_sequence_dispatch(
            image)
        segs.append(pending.result())
        net = net.cpu()
    assert segs[0].shape == image.shape
    assert (segs[0] == segs[1]).mean() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing,lattice", [
    ((24, 24), 10, None), ((48, 48), 10, None), ((96, 96), 10, None),
    ((96, 96), 40, (6, 6)),            # synth_prev: a coarse lattice
    ((97, 113), 7, (12, 23)),          # shorter in x, longer in y
    ((192, 192), 10, None),            # adjoint: rows staged in 5 chunks
    ((40, 1536), 10, None),            # adjoint: bands of controls
])
def test_bspline_field_kernel_matches_plain(card, shape, spacing, lattice):
    Cx, Cy = lattice or tb.lattice_shape(shape, spacing)
    rng = np.random.RandomState(3)
    c = torch.from_numpy(rng.randn(150, Cx, Cy, 2).astype(np.float32)).to(
        card).requires_grad_(True)
    G = torch.from_numpy(rng.randn(150, *shape, 2).astype(np.float32)).to(
        card)
    before = (bspline_field.launches, bspline_field.adjoint_launches)
    out = bspline_field(c, shape, spacing)
    (out * G).sum().backward()
    torch.cuda.synchronize()
    assert (bspline_field.launches, bspline_field.adjoint_launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        torch.testing.assert_close(
            out, tb.bspline_dense_field_plain(c, shape, spacing),
            atol=FIELD_ATOL, rtol=0)
        torch.testing.assert_close(
            c.grad, tb.bspline_adjoint_plain(G, (Cx, Cy), spacing),
            atol=ADJOINT_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 96), (40, 1536)])
def test_bspline_adjoint_is_deterministic(card, shape):
    G = torch.randn(150, *shape, 2, device=card,
                    generator=torch.Generator(card).manual_seed(4))
    lattice = tb.lattice_shape(shape, 10)
    grads = []
    for _ in range(2):
        c = torch.zeros(150, *lattice, 2, device=card, requires_grad=True)
        (bspline_field(c, shape, 10) * G).sum().backward()
        grads.append(c.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_bspline_field_rejects_non_contiguous_on_card(card):
    c = torch.zeros(2, 6, 7, 2, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bspline_field(c, (24, 24), 10)


@pytest.mark.cuda
def test_register_batch_on_card_matches_cpu(card):
    """48^2, 2 levels on smooth blobs: the card's run against the CPU's.
    Adam turns float noise in near-zero gradients into steps of up to lr;
    on the CPU the same run held to 1e-3 px against the JAX package."""
    X = Y = 48
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    rng = np.random.RandomState(5)

    def frames(shifts):
        return np.stack([np.exp(-((gx - 24 - s) ** 2 + (gy - 22 - s / 2) ** 2)
                                / 72.0) for s in shifts])

    tgt = (frames([0, 1.5, 3.0]) + 0.01 * rng.randn(3, X, Y)).astype(
        np.float32)
    src = (frames([1.5, 3.0, 1.0]) + 0.01 * rng.randn(3, X, Y)).astype(
        np.float32)
    cfg = tr.RegConfig(spacing=8, levels=2, iters=30, lr=0.5, be_weight=1e-2)
    fields = []
    for dev in ("cpu", card):
        controls = tr.make_register_batch((X, Y), cfg, device=dev)(tgt, src)
        fields.append(tr.total_field(controls, (X, Y), cfg).cpu())
    torch.testing.assert_close(fields[1], fields[0], atol=1e-3, rtol=0)
    assert fields[0].abs().max() > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bundle, n_class", [("FCN_la_2ch.npz", 2),
                                             ("FCN_la_4ch.npz", 3),
                                             ("FCN_la_4ch_seg4.npz", 6)])
def test_fused_head_with_trained_la_bundles(card, bundle, n_class):
    """The LA deploys' heads (2, 3 and 6 classes, padded to the kernel's
    8) at the LA cine's 192 x 208, trained weights."""
    model = load_segmentation_model(os.path.join(WEIGHTS, bundle), card)
    assert model.head.n_class == n_class
    yy, xx = np.meshgrid(np.arange(208), np.arange(192))
    rng = np.random.RandomState(n_class)
    x = np.stack([((xx - 96 - 9 * k) ** 2 + (yy - 104) ** 2 < 900) * 0.8
                  + 0.05 * rng.randn(192, 208) for k in range(3)])
    x = torch.from_numpy(x[..., None].astype(np.float32)).to(card)
    with torch.inference_mode():
        feats = model.net.encode(tfcn.nchw(x, torch.float32))
        before = tfh.fused_head.launches_by_class.get(n_class, 0)
        got = tfh.fused_head(feats, model.head)
        torch.cuda.synchronize()
        ref = tfh.fused_head_plain(feats, model.head)
    assert tfh.fused_head.launches_by_class[n_class] == (
        before + model.head.n_level)
    assert got.shape == (3, n_class, 192, 208)
    torch.testing.assert_close(got, ref, atol=ATOL[torch.float32], rtol=0)


@pytest.mark.cuda
def test_four_bit_pack_of_six_classes_on_card(card):
    labels = np.random.RandomState(6).randint(0, 6, 192 * 208 * 50 + 1)
    flat = torch.from_numpy(labels.astype(np.uint8))
    packed = pack_bits(flat.to(card), 4).cpu()
    assert torch.equal(packed, pack_bits(flat, 4))
    np.testing.assert_array_equal(
        unpack_bits(packed.numpy(), 4, labels.size), labels)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing,lattice", [
    # the LA strain's pyramid on a crop bucketed to 128 x 128, B = 50
    ((32, 32), 10, None), ((64, 64), 10, None), ((128, 128), 10, None),
    ((128, 128), 40, (7, 7)), ((128, 128), 20, (10, 10)),
    ((192, 128), 10, None),            # a crop bucketed to 192 x 128
])
def test_bspline_kernels_at_the_la_shapes(card, shape, spacing, lattice):
    Cx, Cy = lattice or tb.lattice_shape(shape, spacing)
    rng = np.random.RandomState(8)
    c = torch.from_numpy(rng.randn(50, Cx, Cy, 2).astype(np.float32)).to(
        card).requires_grad_(True)
    G = torch.from_numpy(rng.randn(50, *shape, 2).astype(np.float32)).to(card)
    out = bspline_field(c, shape, spacing)
    (out * G).sum().backward()
    torch.cuda.synchronize()
    with torch.no_grad():
        torch.testing.assert_close(
            out, tb.bspline_dense_field_plain(c, shape, spacing),
            atol=FIELD_ATOL, rtol=0)
        torch.testing.assert_close(
            c.grad, tb.bspline_adjoint_plain(G, (Cx, Cy), spacing),
            atol=ADJOINT_ATOL, rtol=0)


def _ao_cine(X, Y, T, seed=0):
    """Aortic cine (X, Y, 1, T) int16: pulsating ascending and descending
    aortic disks in noise (the geometry of tests/phantom.py::ao_phantom)."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    pulse = 1.0 + 0.15 * np.sin(2 * np.pi * np.arange(T) / T)
    image = np.zeros((X, Y, 1, T), np.float32)
    for t in range(T):
        aa = (xx - (X // 2 - 14)) ** 2 + (yy - Y // 2) ** 2 <= (9 * pulse[t]) ** 2
        da = (xx - (X // 2 + 16)) ** 2 + (yy - Y // 2) ** 2 <= (6 * pulse[t]) ** 2
        img = np.where(aa, 900.0, np.where(da, 850.0, 0.0))
        image[..., 0, t] = np.clip(img + rng.randn(X, Y) * 50.0, 0, 1000)
    return np.round(image).astype(np.int16)


@pytest.mark.cuda
def test_aortic_engine_on_card_matches_cpu(card, tmp_path):
    """The trained UNet-LSTM's full-scan deploy on the card against the
    port's CPU path: labels on >= 99.9 % of voxels, the area row at rtol
    1e-6."""
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import load_aortic_engine
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.phenotype.aorta import (aortic_area_measures,
                                                        aortic_row)

    image = _ao_cine(120, 98, 8)
    rows = {}
    segs = {}
    for dev in ("cpu", "cuda"):
        pending = load_aortic_engine(os.path.join(
            WEIGHTS, "UNet-LSTM_ao.npz"), dev).segment_cine_dispatch(image)
        segs[dev] = pending.result()
        assert (pending.device_ms is not None) == (dev == "cuda")
        d = tmp_path / dev
        d.mkdir()
        hdr = nifti.Nifti1Header()
        hdr.dim[0] = 4
        hdr.dim[1:5] = image.shape
        hdr.pixdim[1:5] = (1.8, 1.8, 10.0, 0.03)
        affine = np.diag([-1.8, -1.8, 10.0, 1.0])
        nifti.save(nifti.Nifti1Image(image, affine, hdr), str(d / "ao.nii.gz"))
        nifti.save(nifti.Nifti1Image(segs[dev].astype(np.float64), affine,
                                     hdr), str(d / "seg_ao.nii.gz"))
        rows[dev] = aortic_row(aortic_area_measures(str(d), 40.0))
    assert segs["cpu"].shape == image.shape and segs["cpu"].max() == 2
    assert (segs["cpu"] == segs["cuda"]).mean() >= 0.999
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-6)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(card):
    """One float32 training step from the same weights and batch on the
    card and on the CPU.  A random net's weight gradients sum terms that
    cancel, so float32 summation order alone moves them by about 1e-3 of
    a tensor's largest value (on the CPU, contiguous against
    channels-last: 1.5e-3).  The card must differ from the CPU by at most
    4x that spread of the CPU against itself (worst tensor, relative to
    its largest value), and the loss by 1e-5 relative."""
    from ukbb_cardiac_tpu_torch.train.sa import make_fcn_loss

    net = _random_fcn(n_level=3)
    rng = np.random.RandomState(0)
    xx, yy = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    r = rng.uniform(8, 20, (8, 1, 1))
    disk = ((xx - 32) ** 2 + (yy - 30) ** 2 < r ** 2).astype(np.uint8)
    image = 0.8 * disk + 0.05 * rng.randn(8, 64, 64)
    batch = {"image": torch.from_numpy(image[..., None].astype(np.float32)),
             "label": torch.from_numpy(disk)}
    grads, losses = {}, {}
    for name, dev, fmt in (("cpu", "cpu", torch.contiguous_format),
                           ("cpu_nhwc", "cpu", torch.channels_last),
                           ("cuda", card, torch.contiguous_format)):
        model = tfcn.FCN(net.cfg).to(dev, memory_format=fmt)
        model.load_state_dict(net.state_dict())
        loss, _ = make_fcn_loss(model, net.cfg)(
            {k: v.to(dev) for k, v in batch.items()}, 1)
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {k: p.grad.cpu() for k, p in model.named_parameters()}

    def worst(a):
        return max(float((grads[a][k] - g).abs().max() / g.abs().max())
                   for k, g in grads["cpu"].items())

    assert abs(losses["cpu"] - losses["cuda"]) <= 1e-5 * losses["cpu"]
    spread = worst("cpu_nhwc")
    assert 0 < spread < 1e-2
    assert worst("cuda") <= 4 * spread


@pytest.mark.cuda
def test_pool_upload_is_ordered_after_queued_gathers(card):
    """A slot re-uploaded right after a queued gather reads it: the gather
    sees the old volume (the upload is on the step's stream)."""
    from ukbb_cardiac_tpu_torch.train.device_pool import (DeviceCinePool,
                                                          _gather_slices)

    pool = DeviceCinePool(1, 2, 256, 256, card)
    ones = np.ones((2, 256, 256), np.float32)
    pool.ensure("a", lambda: (ones, ones.astype(np.uint8)))
    img, lab = pool.snapshot()
    idx = {"slot": torch.zeros(64, dtype=torch.int32, device=card),
           "zidx": torch.ones(64, dtype=torch.int32, device=card)}
    torch.cuda._sleep(50_000_000)  # keep the stream busy
    got = _gather_slices(img.reshape(-1, 256, 256), lab.reshape(-1, 256, 256),
                         idx, 2)
    pool.ensure("b", lambda: (2 * ones, 2 * ones.astype(np.uint8)))
    assert float(got["image"].float().min()) == 1.0
    assert int(got["label"].min()) == 1
    assert float(pool.snapshot()[0].float().min()) == 2.0


@pytest.mark.cuda
def test_raw_upload_of_every_dtype_on_card(card):
    """The raw up-leg on the card: ``upload_cine`` hands the engines the
    cine's (T, Z, Y, X) transpose in the dtype they ship (uint16 and
    float64 as float32), and the SA and aortic engines give one cine's
    labels byte for byte in every host dtype and memory order, read back
    Fortran-contiguous, with a device span."""
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import load_aortic_engine
    from ukbb_cardiac_tpu_torch.infer.engine import upload_cine

    rng = np.random.RandomState(4)
    sa = (rng.rand(64, 72, 2, 10) * 120).astype(np.int16)
    ao = np.clip(_ao_cine(120, 98, 12) // 8, 0, 120).astype(np.int16)
    dtypes = (np.int16, np.uint16, np.float32, np.float64, np.uint8, np.int8)
    for dt in dtypes:
        host = sa.astype(dt)
        got = upload_cine(np.asfortranarray(host), card)
        assert got.device.type == "cuda" and got.is_contiguous()
        assert got.dtype == torch.from_numpy(host.astype(
            np.float32 if dt in (np.uint16, np.float64) else dt)).dtype
        np.testing.assert_array_equal(got.cpu().numpy(), host.T)
    engines = [
        (InferenceEngine(SegmentationModel.from_fcn(_random_fcn(), card)),
         lambda e, c: e.segment_sequence_dispatch(c), sa),
        (load_aortic_engine(os.path.join(WEIGHTS, "UNet-LSTM_ao.npz"), card),
         lambda e, c: e.segment_cine_dispatch(c), ao)]
    for eng, dispatch, cine in engines:
        want = None
        for dt in dtypes:
            for order in ("C", "F"):
                pending = dispatch(eng, np.asarray(cine.astype(dt),
                                                   order=order))
                labels = pending.result()
                assert labels.flags.f_contiguous and pending.device_ms > 0
                if want is None:
                    want = labels
                    assert len(np.unique(want)) > 1
                np.testing.assert_array_equal(labels, want, err_msg=str(dt))
        eng.release_programs()


def _write_ao_annotated(d, X=64, Y=64, T=8, seed=3, pulse_amp=0.45):
    """An aortic subject for the propagation (the geometry of
    tests/phantom.py::ao_phantom, the vessel radii swinging by
    ``pulse_amp``): the float cine, its ED/ES-annotated 4D label and the
    ED/ES stills.  Returns the truth (X, Y, 1, T)."""
    from ukbb_cardiac_tpu_torch.io import nifti

    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    pulse = 1.0 + pulse_amp * np.sin(2 * np.pi * np.arange(T) / T)
    off_aa = max(14, int(np.ceil(9 * (1 + pulse_amp))) + 2)
    off_da = max(16, int(np.ceil(6 * (1 + pulse_amp))) + 2)
    image = np.zeros((X, Y, 1, T), np.float32)
    seg = np.zeros((X, Y, 1, T), np.int16)
    for t in range(T):
        aa = ((xx - (X // 2 - off_aa)) ** 2 + (yy - Y // 2) ** 2
              <= (9 * pulse[t]) ** 2)
        da = ((xx - (X // 2 + off_da)) ** 2 + (yy - Y // 2) ** 2
              <= (6 * pulse[t]) ** 2)
        seg[..., 0, t][aa] = 1
        seg[..., 0, t][da & ~aa] = 2
        img = np.where(aa, 900.0, np.where(da, 850.0, 0.0))
        image[..., 0, t] = np.clip(img + rng.randn(X, Y) * 20.0, 0, 1000)
    os.makedirs(d, exist_ok=True)
    affine = np.diag([1.8, 1.8, 10.0, 1.0])
    hdr = nifti.Nifti1Header()
    hdr.dim[0] = 4
    hdr.dim[1:5] = image.shape
    hdr.pixdim[1:5] = (1.8, 1.8, 10.0, 0.04)
    nifti.save(nifti.Nifti1Image(image, affine, hdr),
               os.path.join(d, "ao.nii.gz"))
    label = np.zeros_like(seg)
    label[..., 0], label[..., T // 2] = seg[..., 0], seg[..., T // 2]
    nifti.save(nifti.Nifti1Image(label.astype(np.float64), affine, hdr),
               os.path.join(d, "label_ao.nii.gz"))
    for fr, t in (("ED", 0), ("ES", T // 2)):
        nifti.save(nifti.Nifti1Image(image[..., t], affine),
                   os.path.join(d, f"ao_{fr}.nii.gz"))
        nifti.save(nifti.Nifti1Image(seg[..., t].astype(np.float64), affine),
                   os.path.join(d, f"label_ao_{fr}.nii.gz"))
    return seg


@pytest.mark.cuda
def test_propagate_subject_on_card_matches_cpu(card, tmp_path):
    """The NMI propagation on the card (both B-spline kernels in every
    Adam step) against the port's CPU path, within the bounds the CPU
    tests set from the JAX package's own drift (tests/
    test_torch_propagate.py): at most 2.62 % of the voxels differ, the
    mean per-frame Dice is at least 0.764; against the truth, the mean
    Dice over the propagated frames is at least 0.744 and every frame's
    AAo Dice above 0.75.  A propagation with every field zero (the
    control) must miss the last three."""
    from ukbb_cardiac_tpu_torch.data import propagate_aortic as prop
    from ukbb_cardiac_tpu_torch.io import nifti
    from ukbb_cardiac_tpu_torch.reg.bspline_field import bspline_field

    labels = {}
    for dev in ("cpu", "cuda", "zero field"):
        d = str(tmp_path / dev)
        seg = _write_ao_annotated(d)
        before = (bspline_field.launches, bspline_field.adjoint_launches)
        if dev == "zero field":
            real = prop.register_pairs
            prop.register_pairs = lambda crop, pairs, cfg, device: np.zeros(
                (len(pairs),) + crop.shape[:2] + (2,), np.float32)
            try:
                out = prop.propagate_subject(d, device="cpu")
            finally:
                prop.register_pairs = real
        else:
            out = prop.propagate_subject(d, device=dev)
        launched = (bspline_field.launches - before[0],
                    bspline_field.adjoint_launches - before[1])
        # 100 Adam steps (forward + adjoint each) and the densify
        assert launched == ((101, 100) if dev == "cuda" else (0, 0))
        labels[dev] = np.asanyarray(nifti.load(out).dataobj)

    def dice(a, b, k):
        x, y = a == k, b == k
        return 2 * np.sum(x & y) / max(np.sum(x) + np.sum(y), 1)

    def missed(got, ref):
        moving = [t for t in range(8) if t not in (0, 4)]
        return [name for name, ok in (
            ("disagree", np.mean(got != ref) <= 2 * 0.0131),
            ("mean_dice", np.mean([dice(got[..., t], ref[..., t], k)
                                   for t in range(8) for k in (1, 2)])
             >= 1 - 2 * (1 - 0.882)),
            ("truth_dice", np.mean([dice(got[..., t], seg[..., t], k)
                                    for t in moving for k in (1, 2)])
             >= 1 - 2 * (1 - 0.872)),
            ("frame_dice", min(dice(got[..., t], seg[..., t], 1)
                               for t in range(8)) > 0.75)) if not ok]

    assert missed(labels["cuda"], labels["cpu"]) == []
    assert {"mean_dice", "truth_dice", "frame_dice"} <= set(
        missed(labels["zero field"], labels["cpu"]))


@pytest.mark.cuda
def test_aortic_train_step_on_card_matches_cpu(card):
    """One float32 joint UNet-LSTM step (the U-Net takes gradients too)
    from the trained ``UNet-LSTM_ao`` weights on a 9-frame window, card
    against CPU: every gradient within 1e-3 of its tensor's largest value
    (a random net's gradients cancel so much that float32 summation order
    alone moved one by 3e-2 on the CPU, contiguous against channels-last:
    trained weights, as chip_smoke.py's phase 9 uses, are the fair test),
    the loss within 1e-5 relative."""
    from ukbb_cardiac_tpu_torch.ckpt import convert, store
    from ukbb_cardiac_tpu_torch.models.wrappers import UNetLSTM
    from ukbb_cardiac_tpu_torch.train import ao as tao

    _, ucfg, names, params, state = store.load_model(
        os.path.join(WEIGHTS, "UNet-LSTM_ao.npz"))
    cfg = tao.AoTrainConfig(model="UNet-LSTM", joint_train=True)
    cine = _ao_cine(64, 64, cfg.time_window).astype(np.float32)
    image = (cine[:, :, 0] - cine.mean()) / cine.std()
    label = np.where(cine[:, :, 0] > 400, 1 + (np.arange(64) >= 32)[:, None,
                                                                     None],
                     0)
    batch = {"image": torch.from_numpy(
                 np.ascontiguousarray(image.transpose(2, 0, 1))[None, ..., None]),
             "label": torch.from_numpy(
                 np.ascontiguousarray(label.transpose(2, 0, 1))[None])}
    grads, losses = {}, {}
    for dev in ("cpu", card):
        net = UNetLSTM(convert.unet_from_jax(params, state, names, ucfg),
                       convert.convlstm_from_jax(params, True)).to(dev)
        loss, _ = tao.make_ao_loss(cfg, net)(
            {k: v.to(dev) for k, v in batch.items()}, 1)
        loss.backward()
        losses[str(dev)] = float(loss.detach())
        grads[str(dev)] = {k: p.grad.cpu() for k, p in
                           net.named_parameters() if p.grad is not None}
    assert len(grads["cuda"]) == len(grads["cpu"]) > 60
    worst = max(float((grads["cuda"][k] - g).abs().max() / g.abs().max())
                for k, g in grads["cpu"].items())
    assert worst <= 1e-3, worst
    assert abs(losses["cpu"] - losses["cuda"]) <= 1e-5 * losses["cpu"]


def _sax_cine(X=128, Y=128, Z=6, T=10, seed=0):
    """An SA cine (int16, values 0-1000) of the cohort phantoms' geometry:
    an LV disk of radius 20 contracting by 30 %, a myocardial ring of 8,
    an RV crescent, Gaussian noise."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    cine = np.zeros((X, Y, Z, T), np.float32)
    for t in range(T):
        r = 20.0 * (1 - 0.3 * np.sin(np.pi * t / T) ** 2)
        d2 = (xx - X // 2) ** 2 + (yy - Y // 2) ** 2
        base = np.zeros((X, Y), np.float32)
        base[((xx - X // 2 + r + 12) ** 2 + (yy - Y // 2) ** 2
              <= (0.9 * r + 3) ** 2) & (d2 > (r + 8) ** 2)] = 700.0
        base[(d2 <= (r + 8) ** 2) & (d2 > r * r)] = 300.0
        base[d2 <= r * r] = 800.0
        cine[..., t] = base[:, :, None] + rng.randn(X, Y, Z) * 50.0
    return np.round(np.clip(cine, 0, 1000)).astype(np.int16)


@pytest.mark.cuda
def test_converted_subject_runs_the_cohort_on_card(card, tmp_path):
    """One synthetic subject written as DICOMs (one slice SOF3-compressed),
    converted to NIfTI by ``data/download.py::convert_subject``, then
    ``run_cohort --device cuda`` in SA mode: the same labels and volume
    table as the same run from the cine written straight to NIfTI."""
    from ukbb_cardiac_tpu_torch.cli import run_cohort
    from ukbb_cardiac_tpu_torch.data import download
    from ukbb_cardiac_tpu_torch.data.dicom import dcmwrite_minimal
    from ukbb_cardiac_tpu_torch.io import nifti

    cine = _sax_cine()
    X, Y, Z, T = cine.shape
    eid = "6000001"
    for z in range(Z):
        folder = tmp_path / "dicom" / f"CINE_segmented_SAX_b{z + 1}"
        folder.mkdir(parents=True)
        for t in range(T):
            dcmwrite_minimal(
                str(folder / f"1.{z}.{t}.dcm"),
                {"SOPInstanceUID": f"1.{z}.{t}", "SeriesInstanceUID": f"2.{z}",
                 "CardiacNumberOfImages": T, "Rows": Y, "Columns": X,
                 "PixelSpacing": [1.8, 1.8], "SpacingBetweenSlices": 10.0,
                 "SliceThickness": 8.0, "TriggerTime": 40.0 * t,
                 "ImagePositionPatient": [-80.0, -90.0, -40.0 + 10.0 * z],
                 "ImageOrientationPatient": [1, 0, 0, 0, 1, 0],
                 "BitsAllocated": 16, "PixelRepresentation": 0},
                cine[:, :, z, t].T.astype(np.uint16),
                transfer_syntax=("1.2.840.10008.1.2.4.70" if z == 1
                                 else "1.2.840.10008.1.2.1"))
    converted = tmp_path / "converted"
    download.convert_subject(str(tmp_path / "dicom"), str(converted / eid))
    img = nifti.load(str(converted / eid / "sa.nii.gz"))
    np.testing.assert_array_equal(np.asarray(img.dataobj),
                                  cine.astype(np.float32))
    np.testing.assert_allclose(img.affine, [[-1.8, 0, 0, 80], [0, -1.8, 0, 90],
                                            [0, 0, 10, -40], [0, 0, 0, 1]])
    phantom = tmp_path / "phantom"
    (phantom / eid).mkdir(parents=True)
    direct = nifti.Nifti1Image(cine, img.affine)
    direct.header["pixdim"][4] = img.header["pixdim"][4]
    nifti.save(direct, str(phantom / eid / "sa.nii.gz"))
    segs, tables = {}, {}
    for tree in (converted, phantom):
        out = tmp_path / f"{tree.name}_csv"
        assert run_cohort.main([
            "--data_dir", str(tree), "--model_path",
            os.path.join(WEIGHTS, "FCN_sa.npz"), "--output_dir", str(out),
            "--device", "cuda"]) == 0
        segs[tree.name] = np.asarray(nifti.load(
            str(tree / eid / "seg_sa.nii.gz")).dataobj)
        tables[tree.name] = (out / "table_ventricular_volume.csv").read_text()
    np.testing.assert_array_equal(segs["converted"], segs["phantom"])
    assert tables["converted"] == tables["phantom"]
    assert {1, 2, 3} <= set(np.unique(segs["converted"]))


def _deployed_sax_subject(root, card, T=6):
    """``_sax_cine`` as subject ``1`` under ``root``, deployed on the card
    with the trained FCN_sa bundle (seg_sa, sa_ED, seg_sa_ED written)."""
    from ukbb_cardiac_tpu_torch.infer.deploy import deploy_dataset
    from ukbb_cardiac_tpu_torch.io import nifti

    d = os.path.join(root, "1")
    os.makedirs(d)
    affine = np.diag([1.8, 1.8, 10.0, 1.0])
    nifti.save(nifti.Nifti1Image(_sax_cine(Z=6, T=T), affine),
               os.path.join(d, "sa.nii.gz"))
    deploy_dataset(os.path.join(WEIGHTS, "FCN_sa.npz"), root, device=card)
    return d


@pytest.mark.cuda
def test_deploy_trace_on_card(card, tmp_path):
    """``deploy_network --trace_dir`` writes a Chrome trace of the deploy
    that names both kernels of the fused head."""
    import glob

    from ukbb_cardiac_tpu_torch.cli import deploy_network
    from ukbb_cardiac_tpu_torch.io import nifti

    d = tmp_path / "data" / "1"
    d.mkdir(parents=True)
    nifti.save(nifti.Nifti1Image(_sax_cine(Z=2, T=4),
                                 np.diag([1.8, 1.8, 10.0, 1.0])),
               str(d / "sa.nii.gz"))
    before = tfh.fused_head.launches
    deploy_network.main(["--data_dir", str(tmp_path / "data"),
                         "--model_path", os.path.join(WEIGHTS, "FCN_sa.npz"),
                         "--trace_dir", str(tmp_path / "trace")])
    assert tfh.fused_head.launches > before
    assert (d / "seg_sa.nii.gz").exists()
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1
    text = open(traces[0]).read()
    assert "head_kernel" in text and "coarse_kernel" in text


@pytest.mark.cuda
def test_both_directions_strain_on_card_matches_cpu(card, tmp_path):
    """The both-directions SA strain (2(T-1) pairs a slice) on the card
    against the port's CPU path, within the CPU tests' bounds for this
    scheme (tests/test_torch_strain_both.py: 5.2 pp per segment, 0.5
    Global, warp-Dice 0.005); both B-spline kernels launch on the card."""
    import pandas as pd

    from ukbb_cardiac_tpu_torch.phenotype import strain

    d = _deployed_sax_subject(str(tmp_path / "data"), card)
    cfg = tr.RegConfig.cine_2d_motion()
    out = {}
    for dev in ("cpu", "cuda"):
        motion = tmp_path / dev
        motion.mkdir()
        before = (bspline_field.launches, bspline_field.adjoint_launches)
        dice = strain.cine_2d_sa_motion_and_strain_analysis(
            d, str(motion), str(tmp_path / f"{dev}_strain"), cfg,
            eval_dice=True, device=dev, inverse_consistent=False)
        launched = (bspline_field.launches - before[0],
                    bspline_field.adjoint_launches - before[1])
        assert (min(launched) > 0) == (dev == "cuda"), launched
        out[dev] = (dice.values, {k: pd.read_csv(
            tmp_path / f"{dev}_strain_{k}.csv", index_col=0).values
            for k in ("radial", "circum")})
    for k in ("radial", "circum"):
        diff = np.abs(out["cuda"][1][k] - out["cpu"][1][k])
        assert np.nanmax(diff) <= 5.2, (k, np.nanmax(diff))
        assert diff[-1].max() <= 0.5, (k, diff[-1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=0.005,
                               rtol=0)


@pytest.mark.cuda
def test_mesh_on_one_card_matches_unsharded(card):
    """A 4-subject cine stack and a 6-pair registration split over
    ``make_mesh(["cuda:0", "cuda:0"])``: the labels equal the per-subject
    path's byte for byte through the head kernel, and the lattices equal
    the unsharded run's through both B-spline kernels."""
    from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(["cuda:0", "cuda:0"])
    engine = InferenceEngine(SegmentationModel.from_fcn(_random_fcn(), card))
    cines = (np.random.RandomState(4).rand(4, 64, 80, 2, 3) * 900).astype(
        np.int16)
    before = tfh.fused_head.launches
    segs = engine.segment_subjects_sharded(cines, mesh)
    assert tfh.fused_head.launches > before
    assert segs.shape == cines.shape and segs.dtype == np.uint8
    for i in range(4):
        np.testing.assert_array_equal(segs[i],
                                      engine.segment_sequence_fused(cines[i]))

    X = Y = 48
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    rng = np.random.RandomState(6)
    frames = np.stack([np.exp(-((gx - 24 - s) ** 2 + (gy - 22 - s / 2) ** 2)
                              / 72.0) for s in (0, 1.5, 3.0, 1.0, 0.5, 2.0,
                                                2.5)])
    frames = (frames + 0.01 * rng.randn(*frames.shape)).astype(np.float32)
    cfg = tr.RegConfig(spacing=8, levels=2, iters=30, lr=0.5, be_weight=1e-2)
    before = (bspline_field.launches, bspline_field.adjoint_launches)
    got = tr.make_register_batch((X, Y), cfg, mesh=mesh)(frames[:-1],
                                                         frames[1:])
    assert bspline_field.launches > before[0]
    assert bspline_field.adjoint_launches > before[1]
    want = tr.make_register_batch((X, Y), cfg, device=card)(frames[:-1],
                                                            frames[1:])
    for g, w in zip(got, want):
        assert g.device == w.device and g.shape == w.shape
        assert torch.equal(g, w)



def _dp_case(K=2, B=8, size=64):
    """A K-step pool-slice case at small widths: a 3-level FCN at the
    released filters, a random float16 slice pool and index batches,
    bf16, the device augmenter on (``distributed.replica_steps``'s
    keywords)."""
    from ukbb_cardiac_tpu_torch.train import sa as tsa

    net = _random_fcn(n_level=3)
    rng = np.random.RandomState(1)
    pool = (rng.rand(3, 4, size, size).astype(np.float16),
            rng.randint(0, 4, (3, 4, size, size)).astype(np.uint8))
    batches = {"slot": rng.randint(0, 3, (K, B)).astype(np.int32),
               "zidx": rng.randint(0, 4, (K, B)).astype(np.int32)}
    return dict(net=net, make_loss=functools.partial(
        tsa.make_fcn_loss, cfg=net.cfg, device_augment=True,
        compute_dtype=torch.bfloat16), batches=batches,
        seeds=list(range(1, K + 1)), builder="pool_slice", pool=pool,
        channels_last=True)


@pytest.mark.cuda
def test_nccl_world_of_one_is_bitwise_the_single_card_step(card):
    """A world of one NCCL rank on cuda:0 runs the DP pool step (the
    gradient all-reduce, the division by one) and leaves the loss,
    weights, BN state and Adam state of the single-card step bit for bit
    (cuDNN deterministic in both: the rank takes the caller's
    setting)."""
    from ukbb_cardiac_tpu_torch.train import distributed

    case = _dp_case()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = distributed.run(distributed.replica_steps, (), ["cuda:0"],
                              backend="nccl", kwargs=case)
        want = distributed.replica_steps(None, **case, device=card)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert torch.equal(got["losses"], want["losses"])
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    for i, st in want["adam"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["adam"]["state"][i][k], v), (i, k)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_single_card_step(card):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card),
    each on half of a float32 batch: global BatchNorm statistics and the
    gradient all-reduce through gloo's host staging of CUDA tensors.  As
    in ``test_train_step_on_card_matches_cpu``, a random net's weight
    gradients move by about 1e-3 of a tensor's largest value with the
    summation order alone: the ranks' gradients must differ from the
    single-card step's by at most 4x the single card's own spread
    (channels-last against contiguous), the BN statistics by 1e-5 of
    each tensor's largest, the loss by 1e-5 relative and the aux by
    1e-6."""
    from ukbb_cardiac_tpu_torch.train import distributed

    case = _dp_case(K=1)
    case["make_loss"] = functools.partial(case["make_loss"].func,
                                          **{**case["make_loss"].keywords,
                                             "compute_dtype": None})
    got = distributed.run(distributed.replica_steps, (),
                          ["cuda:0", "cuda:0"], backend="gloo", kwargs=case)
    want = distributed.replica_steps(None, **case, device=card)
    nchw = distributed.replica_steps(None, **{**case,
                                              "channels_last": False},
                                     device=card)

    def worst(a, part="grads", keys=None):
        return max(float((a[part][k] - v).abs().max())
                   / max(float(v.abs().max()), 1e-30)
                   for k, v in want[part].items() if keys is None or keys(k))

    spread = worst(nchw)
    assert 0 < spread < 1e-2
    assert set(got["grads"]) == set(want["grads"])
    assert worst(got) <= 4 * spread
    assert worst(got, "state", lambda k: "moving" in k) <= 1e-5
    assert abs(float(got["losses"][0]) - float(want["losses"][0])) <= \
        1e-5 * float(want["losses"][0])
    for k, v in want["aux"].items():
        assert abs(float(got["aux"][k]) - float(v)) <= 1e-6, k


# --- the registration's CUDA graphs ----------------------------------------

# (cfg, pairs, image shape, B-spline forward and adjoint launches a call):
# the SA strain registration (3 levels x 30 Adam steps, the finished levels
# synthesised at levels 1 and 2) and the aortic propagation's (1 level x
# 100 NMI steps) at their strain and propagation shapes
GRAPH_CASES = {
    "sa": (tr.RegConfig.cine_2d_motion(), 150, (96, 96), (93, 90)),
    "propagation": (tr.RegConfig.aortic_motion(), 98, (100, 57),
                    (100, 100)),
}


def _moving_blobs(B, shape, seed):
    """B (target, source) pairs of a Gaussian blob moved by up to 2 px,
    with a little noise, float32."""
    X, Y = shape
    rng = np.random.RandomState(seed)
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")

    def blobs(shifts):
        return np.stack([np.exp(-((gx - X / 2 - sx) ** 2
                                  + (gy - Y / 2 - sy) ** 2) / (X * Y / 20))
                         for sx, sy in shifts])

    shifts = rng.uniform(-2, 2, size=(2, B, 2))
    return tuple((blobs(s) + 0.01 * rng.randn(B, X, Y)).astype(np.float32)
                 for s in shifts)


def _counted(call):
    """``call()`` and the B-spline forward and adjoint launches it
    counted."""
    before = (bspline_field.launches, bspline_field.adjoint_launches)
    out = call()
    torch.cuda.synchronize()
    return out, (bspline_field.launches - before[0],
                 bspline_field.adjoint_launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_registration_is_bitwise_the_eager_route(card, case):
    """The registration replaying its graphs (one for the inputs, one per
    level) against the eager route on the same card, for the inputs it
    was captured with and for others: lattices bitwise equal, and the
    capturing call's equal to a replay's; each call counts the launches
    that ran, as the eager route does."""
    cfg, B, shape, want_launches = GRAPH_CASES[case]
    programs.clear()
    reg = tr.make_register_batch(shape, cfg, device=card)
    assert reg is tr.make_register_batch(shape, cfg, device=card)
    for seed in (7, 8):
        tgt, src = _moving_blobs(B, shape, seed)
        with programs._eager_route():
            eager, n_eager = _counted(lambda: reg(tgt, src))
        graphed, n_graphed = _counted(lambda: reg(tgt, src))
        replayed, n_replayed = _counted(lambda: reg(tgt, src))
        assert n_eager == n_graphed == n_replayed == want_launches
        for e, g, r in zip(eager, graphed, replayed):
            assert torch.equal(e, g) and torch.equal(e, r)
        assert float(eager[-1].abs().max()) > 0.1   # the lattices moved
    progs = programs.programs()
    assert len(progs) == 1 + cfg.levels
    assert all(p.graph is not None and p.replays == 3 for p in progs)


@pytest.mark.cuda
def test_graphed_fields_are_bitwise_the_eager_route(card):
    """The SA field program (densify + invert + both compositions + blend,
    Z = 3, T = 50) and ``combine_fields`` replayed against the eager
    route; the densify's 3 forward launches counted per call."""
    cfg = tr.RegConfig.cine_2d_motion()
    Z, T, X = 3, 50, 96
    g = torch.Generator().manual_seed(3)
    controls = [(0.5 * torch.randn((Z * T,) + tb.lattice_shape(
        (X // f, X // f), cfg.spacing) + (2,), generator=g)).to(card)
        for f in (4, 2, 1)]
    controls = [c * f for c, f in zip(controls, (4, 2, 1))]
    fields = tr.total_field(controls, (X, X), cfg)
    programs.clear()
    with torch.no_grad():
        with programs._eager_route():
            (want, n_eager) = _counted(lambda: tstrain._field_program(
                controls, (X, X), Z, T, cfg))
            want_combined = tstrain.combine_fields(fields, Z, T)
        for _ in range(2):
            got, n = _counted(lambda: tstrain._field_program(
                controls, (X, X), Z, T, cfg))
            assert torch.equal(got, want) and n == n_eager == (3, 0)
            assert torch.equal(tstrain.combine_fields(fields, Z, T),
                               want_combined)
    assert torch.equal(want, want_combined)
    assert all(p.graph is not None for p in programs.programs())


@pytest.mark.cuda
def test_graphed_registration_under_threads(card):
    """Three threads register different pairs through one cached factory
    at once (the cohort's workers sharing the card, on the default stream
    and on streams of their own): each gets its eager route's lattices
    bitwise."""
    cfg, B, shape, _ = GRAPH_CASES["sa"]
    inputs = [_moving_blobs(B, shape, seed) for seed in (11, 12, 13)]
    reg = tr.make_register_batch(shape, cfg, device=card)
    with programs._eager_route():
        want = [reg(*pair) for pair in inputs]
    got = [None] * 3

    def worker(i, own_stream):
        with torch.cuda.stream(torch.cuda.Stream() if own_stream
                               else torch.cuda.current_stream()):
            for _ in range(2):
                got[i] = reg(*inputs[i])
            torch.cuda.current_stream().synchronize()

    for own_stream in (False, True):
        threads = [threading.Thread(target=worker, args=(i, own_stream))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for w, gl in zip(want, got):
            assert all(torch.equal(a, b) for a, b in zip(w, gl))


_FAILED_CAPTURE = """
import torch
from ukbb_cardiac_tpu_torch.reg import programs

def syncs(x):
    # .item() waits for the card: refused inside a capture
    return (x * float(x.sum().item()),)

x = torch.ones(8, device="cuda")
try:
    programs.run(("syncs",), syncs, x)
except RuntimeError as err:
    print("raised:", str(err).splitlines()[0])
else:
    print("no error")
"""


@pytest.mark.cuda
def test_a_failed_capture_raises(card):
    """A function that synchronises with the host cannot be captured: the
    program raises (in a process of its own, whose CUDA context the
    invalidated capture leaves behind)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:"), out.stdout


# --- the deploy engines' programs (CUDA graphs) ----------------------------

def _head_launches():
    return dict(tfh.fused_head.launches_by_class)


def _routes(call):
    """``call()`` on the eager route, then twice through the graphs (the
    first captures, the second replays): the three results and the head
    launches by class that each counted."""
    out = []
    for eager in (True, False, False):
        before = _head_launches()
        with (programs._eager_route() if eager
              else contextlib.nullcontext()):
            got = call()
        torch.cuda.synchronize()
        after = _head_launches()
        out.append((got, {k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)}))
    return out


def _la_cine(T=50, seed=0):
    """An LA cine (192, 208, 1, T) int16: two atria in noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(208), np.arange(192))
    cine = np.zeros((192, 208, 1, T), np.float32)
    for t in range(T):
        r = 22 * (1 + 0.3 * np.sin(2 * np.pi * t / T))
        img = 750.0 * (((xx - 80) ** 2 + (yy - 104) ** 2) < r * r)
        img += 650.0 * (((xx - 130) ** 2 + (yy - 104) ** 2) < (0.8 * r) ** 2)
        cine[..., 0, t] = img + 50.0 * rng.randn(192, 208)
    return np.round(np.clip(cine, 0, 1000)).astype(np.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("bundle, n_class", [("FCN_sa.npz", 4),
                                             ("FCN_la_2ch.npz", 2),
                                             ("FCN_la_4ch.npz", 3),
                                             ("FCN_la_4ch_seg4.npz", 6)])
def test_graphed_dispatch_is_bitwise_the_eager_route(card, bundle, n_class):
    """The SA dispatch (a (192, 208, 10, 20) cine: chunks of 64, the last
    padded) and an LA cine per class count (192, 208, 1, 50): prep, chunk
    forward and pack replayed against the eager route, labels bitwise;
    each call counts the head launches that ran."""
    eng = InferenceEngine(load_segmentation_model(
        os.path.join(WEIGHTS, bundle), card))
    cine = _sax_cine(192, 208, 10, 20) if n_class == 4 else _la_cine()
    runs = _routes(lambda: eng.segment_sequence_dispatch(cine).result())
    (want, n_eager), *graphed = runs
    n_chunks = -(-cine.shape[2] * cine.shape[3] // eng._chunk(
        cine.shape[2] * cine.shape[3]))
    assert n_eager == {n_class: n_chunks * eng.model.head.n_level}
    for got, n in graphed:
        assert np.array_equal(got, want) and n == n_eager
    assert want.max() > 0
    progs = eng.programs()
    assert sorted(p.key[0][0] for p in progs) == ["chunk-forward", "pack",
                                                   "prep"]
    # the first graphed call runs each program once and captures it
    for p in progs:
        calls = 2 * (n_chunks if p.key[0][0] == "chunk-forward" else 1)
        assert p.graph is not None and p.replays == calls - 1


@pytest.mark.cuda
def test_graphed_aortic_dispatch_is_bitwise_the_eager_route(card):
    """The trained UNet-LSTM's dispatch on a (120, 98, 1, 12) cine (the
    U-Net over every frame and the ConvLSTM's 2 x 12 steps in one graph)
    and ``pred_sequence`` through the same full-sequence program: labels
    bitwise the eager route's."""
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import (AO_SIZE,
                                                        load_aortic_engine)

    eng = load_aortic_engine(os.path.join(WEIGHTS, "UNet-LSTM_ao.npz"), card)
    cine = _ao_cine(120, 98, 12)
    (want, _), *graphed = _routes(
        lambda: eng.segment_cine_dispatch(cine).result())
    for got, _ in graphed:
        assert np.array_equal(got, want)
    assert want.max() == 2
    padded = np.random.RandomState(1).randn(AO_SIZE, AO_SIZE, 1, 12).astype(
        np.float32)
    (want, _), *graphed = _routes(lambda: eng.pred_sequence(padded))
    assert all(np.array_equal(got, want) for got, _ in graphed)
    full = [p for p in eng.programs() if p.key[0][0] == "full-prob"]
    assert len(full) == 1 and full[0].replays == 3


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sa", "ao"])
def test_graphed_dispatch_reads_back_in_file_order(card, which):
    """Cines whose voxel count leaves the packed tail part full (SA
    (97, 101, 3, 5) with the trained FCN; aortic (119, 97, 1, 7) with the
    UNet-LSTM), on the eager route, captured and replayed: ``result()``
    is an F-contiguous (X, Y, Z, T) array, bitwise across the routes,
    its packed bytes the labels in the NIfTI file's voxel order, and
    equal to the CPU engine's labels on >= 99.9 % of voxels."""
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import load_aortic_engine

    if which == "sa":
        bundle = os.path.join(WEIGHTS, "FCN_sa.npz")
        engines = [InferenceEngine(load_segmentation_model(bundle, dev))
                   for dev in (card, "cpu")]
        cine = _sax_cine(97, 101, 3, 5)

        def dispatch(eng):
            return eng.segment_sequence_dispatch(cine)
    else:
        bundle = os.path.join(WEIGHTS, "UNet-LSTM_ao.npz")
        engines = [load_aortic_engine(bundle, dev) for dev in (card, "cpu")]
        cine = _ao_cine(119, 97, 7)

        def dispatch(eng):
            return eng.segment_cine_dispatch(cine)
    pending = []

    def call():
        pending.append(dispatch(engines[0]))
        return pending[-1].result()

    runs = _routes(call)
    want = runs[0][0]
    assert want.size % 4 != 0 and want.max() > 0
    for (got, _), p in zip(runs, pending):
        assert got.shape == cine.shape and got.dtype == np.uint8
        assert got.flags.f_contiguous and np.array_equal(got, want)
        # the voxels in the file's order, x fastest, packed on the CPU
        file_order = torch.from_numpy(got.ravel(order="F"))
        assert torch.equal(p._packed, pack_bits(file_order, p._bits))
    cpu = dispatch(engines[1]).result()
    assert cpu.flags.f_contiguous
    assert (cpu == want).mean() >= 0.999


@pytest.mark.cuda
def test_graphed_sampling_is_bitwise_the_eager_route(card):
    """The strain's point sampling and warp-Dice (3 slices x 50 frames at
    the SA bucket 96^2, 256 points) replayed against the eager route, at
    two valid regions through one warp-Dice program."""
    rng = np.random.RandomState(4)
    fields = torch.from_numpy(2 * rng.randn(3, 50, 96, 96, 2).astype(
        np.float32)).to(card)
    pts = torch.from_numpy(rng.uniform(0, 95, (3, 256, 2)).astype(
        np.float32)).to(card)
    seg = torch.from_numpy(rng.randint(0, 3, (3, 50, 96, 96)).astype(
        np.int32)).to(card)
    programs.clear()
    with torch.no_grad():
        for xv, yv in ((93, 90), (94, 93)):
            (want, _), *graphed = _routes(lambda: (
                tstrain.sample_points(fields, pts),
                tstrain.warp_dice(seg, fields, xv, yv)))
            for got, _ in graphed:
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sorted(p.key[0][0] for p in programs.programs()) == [
        "sample-points", "warp-dice"]


@pytest.mark.cuda
def test_graphed_engines_read_their_own_weights(card):
    """Two engines with different weights on one shape: each engine's
    programs hold its own weights, and each gives its own eager route's
    labels."""
    engines = [InferenceEngine(SegmentationModel.from_fcn(
        _random_fcn(4, seed=s), card), chunk=16) for s in (5, 6)]
    cine = (np.random.RandomState(3).rand(64, 80, 3, 10) * 1000).astype(
        np.int16)
    want = []
    for eng in engines:
        with programs._eager_route():
            want.append(eng.segment_sequence_dispatch(cine).result())
    assert not np.array_equal(want[0], want[1])
    for _ in range(2):
        for eng, w in zip(engines, want):
            assert np.array_equal(eng.segment_sequence_dispatch(cine)
                                  .result(), w)
    ids = [{id(p) for p in eng.programs()} for eng in engines]
    assert len(ids[0]) == 3 and not ids[0] & ids[1]


@pytest.mark.cuda
@pytest.mark.parametrize("capture_inside", [True, False])
def test_graphed_chunk_forward_in_and_out_of_inference_mode(card,
                                                            capture_inside):
    """A chunk-forward program captured inside ``torch.inference_mode``
    replays from outside it, and one captured outside replays from
    inside: labels bitwise the eager route's."""
    eng = InferenceEngine(SegmentationModel.from_fcn(_random_fcn(4), card),
                          chunk=16)
    x = torch.from_numpy(np.random.RandomState(7).rand(
        32, 64, 80, 1).astype(np.float32)).to(card)
    with programs._eager_route():
        (want,) = eng._labels(x, 16)
    modes = [True, False] if capture_inside else [False, True]
    for inside in modes + modes:
        with torch.inference_mode(inside):
            (got,) = eng._labels(x, 16)
        assert torch.equal(got, want)
    (prog,) = eng.programs()
    assert prog.replays == 2 * len(modes + modes) - 1   # 2 chunks a call


@pytest.mark.cuda
def test_graphed_engine_under_threads(card):
    """Three threads dispatch through one engine at once (the cohort's
    workers), on the default stream and on streams of their own: each
    gets the eager route's labels bitwise."""
    eng = InferenceEngine(load_segmentation_model(
        os.path.join(WEIGHTS, "FCN_la_4ch.npz"), card))
    cines = [_la_cine(seed=s) for s in range(3)]
    with programs._eager_route():
        want = [eng.segment_sequence_dispatch(c).result() for c in cines]
    got = [None] * 3

    def worker(i, own_stream):
        with torch.cuda.stream(torch.cuda.Stream() if own_stream
                               else torch.cuda.current_stream()):
            for _ in range(2):
                got[i] = eng.segment_sequence_dispatch(cines[i]).result()

    for own_stream in (False, True):
        threads = [threading.Thread(target=worker, args=(i, own_stream))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


_FAILED_ENGINE_CAPTURE = """
import numpy as np
import torch
from ukbb_cardiac_tpu_torch.infer import engine as engine_mod
from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model

forward = engine_mod._chunk_forward

def syncs(model, want_prob, images):
    # a host read of a device value: refused inside a capture
    if float(images.sum()) < 0:
        images = -images
    return forward(model, want_prob, images)

engine_mod._chunk_forward = syncs
eng = engine_mod.InferenceEngine(load_segmentation_model(
    "tests/fixtures/bench_weights/FCN_la_2ch.npz", "cuda"))
cine = (np.random.RandomState(0).rand(96, 96, 1, 8) * 900).astype(np.int16)
try:
    eng.segment_sequence_dispatch(cine).result()
except RuntimeError as err:
    print("raised:", str(err).splitlines()[0])
else:
    print("no error")
"""


@pytest.mark.cuda
def test_a_failed_engine_capture_raises(card):
    """An engine's chunk forward that reads a device value on the host
    cannot be captured: the dispatch raises, and nothing falls back to the
    eager route (in a process of its own, as above)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FAILED_ENGINE_CAPTURE],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:"), out.stdout


@pytest.mark.cuda
def test_graphed_engine_programs_bounded_and_released(card):
    """Cines of four shapes through an engine bounded to half of what an
    unbounded engine's programs reserve: the least recently used are
    dropped (the cache stays under its bound), every shape's labels stay
    bitwise the eager route's, recaptured after a drop too, and
    ``release_programs`` hands the graphs' pools back to the card."""
    model = SegmentationModel.from_fcn(_random_fcn(4, seed=8), card)
    shapes = [(64, 80, 3, 10), (64, 80, 4, 10), (72, 96, 3, 10),
              (64, 80, 3, 12)]
    cines = [(np.random.RandomState(i).rand(*s) * 1000).astype(np.int16)
             for i, s in enumerate(shapes)]
    free = InferenceEngine(model, chunk=16)
    free._programs.max_bytes = None
    with programs._eager_route():
        want = [free.segment_sequence_dispatch(c).result() for c in cines]
    for c in cines:
        free.segment_sequence_dispatch(c).result()
    bound = free._programs.nbytes() // 2
    assert bound > 0
    free.release_programs()
    eng = InferenceEngine(model, chunk=16)
    eng._programs.max_bytes = bound
    for _ in range(2):
        for c, w in zip(cines, want):
            assert np.array_equal(eng.segment_sequence_dispatch(c).result(),
                                  w)
            assert (eng._programs.nbytes() <= bound
                    or len(eng.programs()) == 1)
    assert eng._programs.dropped > 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(card)
    eng.release_programs()
    assert eng.programs() == []
    assert torch.cuda.memory_reserved(card) < before


# --- the trainers' programs (CUDA graphs) ----------------------------------

def _fcn_pool_case(K=3, B=16, size=64, bf16=True):
    """The FCN production step at small size: a 3-level FCN at the
    released filters, channels-last, a float16 slice pool and (K, B) index
    batches, the device augmenter (``distributed.replica_steps``'s
    keywords)."""
    case = _dp_case(K=K, B=B, size=size)
    if not bf16:
        case["make_loss"] = functools.partial(
            case["make_loss"].func, **{**case["make_loss"].keywords,
                                       "compute_dtype": None})
    return case


def _fcn_reference_case(K=1, B=12, size=64):
    """The FCN reference step: float32, host-augmented batches (here
    random), one step a call."""
    from ukbb_cardiac_tpu_torch.train import sa as tsa

    net = _random_fcn(n_level=3)
    rng = np.random.RandomState(2)
    return dict(net=net, make_loss=functools.partial(tsa.make_fcn_loss,
                                                     cfg=net.cfg),
                batches={"image": rng.rand(K, B, size, size, 1).astype(
                    np.float32),
                         "label": rng.randint(0, 4, (K, B, size, size))
                         .astype(np.int32)},
                seeds=list(range(1, K + 1)), builder="single",
                channels_last=True)


def _ao_train_case(model, K=2, B=4, size=64, joint=False):
    """The aortic steps at small widths: the U-Net on window-grouped
    float16 batches, or the UNet-LSTM (phase 2: Adam over the LSTM, the
    U-Net frozen, unless ``joint``) from a window pool; bf16, the device
    augmenter."""
    from ukbb_cardiac_tpu_torch.train import ao as tao

    cfg = tao.AoTrainConfig(model=model, num_filter=8, num_level=3,
                            num_hidden=8, weight_R=2, image_size=size,
                            joint_train=joint, device="cuda")
    _, net, _ = tao.init_ao_model(cfg, torch.Generator().manual_seed(3))
    make_loss = functools.partial(tao.make_ao_loss, cfg,
                                  device_augment=True,
                                  compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(4)
    tw = cfg.time_window
    case = dict(net=net, make_loss=make_loss, seeds=list(range(1, K + 1)),
                make_optimizer=functools.partial(tao.make_ao_optimizer, cfg),
                channels_last=True)
    if model == "UNet":
        case.update(builder="multi", batches={
            "image": rng.rand(K, B, tw, size, size, 1).astype(np.float16),
            "label": rng.randint(0, 3, (K, B, tw, size, size)).astype(
                np.uint8)})
        return case
    pool = (rng.rand(3, 6, size, size).astype(np.float16),
            rng.randint(0, 3, (3, 6, size, size)).astype(np.uint8))
    tidx = ((rng.randint(0, 6, (K, B, 1)) + np.arange(tw)) % 6).astype(
        np.int32)
    case.update(builder="pool_window", pool=pool, batches={
        "slot": rng.randint(0, 3, (K, B)).astype(np.int32), "tidx": tidx,
        "lidx": tidx})
    return case


TRAIN_CASES = {
    "fcn_production": _fcn_pool_case,
    "fcn_reference": _fcn_reference_case,
    "unet": functools.partial(_ao_train_case, "UNet"),
    "unet_lstm_phase2": functools.partial(_ao_train_case, "UNet-LSTM"),
    "unet_lstm_joint": functools.partial(_ao_train_case, "UNet-LSTM",
                                         joint=True),
}


def _flat(result) -> dict:
    """A ``replica_steps`` result as {name: tensor}: losses, aux, the last
    step's gradients, every parameter and buffer, the Adam state."""
    out = {"losses": result["losses"]}
    out.update({f"aux.{k}": v for k, v in result["aux"].items()})
    out.update({f"grad.{k}": v for k, v in result["grads"].items()})
    out.update({f"state.{k}": v for k, v in result["state"].items()})
    for i, st in result["adam"]["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return out


def _spread(a: dict, b: dict) -> dict:
    assert a.keys() == b.keys()
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a}


def _train_on_routes(card, case, calls=3):
    """The case's ``calls`` K-step calls from the same start on the eager
    route, through the graphs (the first call eager, then captured; later
    calls replayed) and on the eager route again: their flattened
    results."""
    out = []
    for name in ("eager", "graphs", "eager"):
        with (programs._eager_route() if name == "eager"
              else contextlib.nullcontext()):
            out.append(_flat(_replica_steps(case, card, calls)))
    return out


def _replica_steps(case, card, calls):
    from ukbb_cardiac_tpu_torch.train import distributed

    return distributed.replica_steps(None, **case, device=card, calls=calls)


@contextlib.contextmanager
def _deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_graphed_train_steps_are_bitwise_the_eager_route(card, name):
    """Three K-step calls of each trainer's step (the FCN production pool
    step, K = 3, bf16; the reference's single f32 step; the U-Net's and
    the UNet-LSTM's, phase 2 and joint, the ConvLSTM's scan forward and
    backward inside) through the graphs against the eager route from the
    same start: the losses, aux, gradients, parameters, BatchNorm buffers
    and Adam state bit for bit.  cuDNN is held to its deterministic
    algorithms for the comparison: with its default ones the eager route
    is not bitwise against itself here (the f32 FCN's and the ConvLSTM's
    backward), and the eager route run twice is the control."""
    with _deterministic_cudnn():
        eager, graphs, again = _train_on_routes(card, TRAIN_CASES[name]())
    assert len(eager) > 20
    assert {k: v for k, v in _spread(eager, again).items() if v} == {}
    assert {k: v for k, v in _spread(graphs, eager).items() if v} == {}
    assert torch.isfinite(graphs["losses"]).all()


@pytest.mark.cuda
def test_graphed_nccl_world_of_one_replays_bitwise(card):
    """A world of one NCCL rank runs the DP pool step as graphs with the
    gradient all-reduce captured (three calls: eager, capture, replays)
    and leaves what the single card's graphs leave, bit for bit (cuDNN
    deterministic in both, as the existing world-of-one test has it)."""
    from ukbb_cardiac_tpu_torch.train import distributed

    case = dict(_fcn_pool_case(K=2, B=8), calls=3)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = distributed.run(distributed.replica_steps, (), ["cuda:0"],
                              backend="nccl", kwargs=case)
        want = distributed.replica_steps(None, **case, device=card)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert got["route"] == "nccl group (graphs)"
    assert want["route"] == "single"
    a, b = _flat(got), _flat(want)
    assert {k: v for k, v in _spread(a, b).items() if v} == {}


@pytest.mark.cuda
def test_gloo_rank_on_the_card_runs_uncaptured(card):
    """A gloo group's steps run uncaptured on the card, chosen when the
    step is built (gloo stages CUDA tensors through the host); the
    result is the single card's to the two-rank test's bounds."""
    from ukbb_cardiac_tpu_torch.train import distributed

    case = dict(_fcn_pool_case(K=2, B=8, bf16=False), calls=2)
    got = distributed.run(distributed.replica_steps, (), ["cuda:0"],
                          backend="gloo", kwargs=case)
    assert got["route"] == "gloo group (uncaptured)"
    want = distributed.replica_steps(None, **case, device=card)
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(),
                               rtol=1e-5)


def _head_launch_count():
    return tfh.fused_head.launches


@pytest.mark.cuda
def test_graphed_validations_are_bitwise_the_eager_route(card):
    """The SA validation program (fold and pack on the device, encoder,
    head kernel, argmax) between training steps, and the aortic
    validation loss of a jointly trained UNet-LSTM (its U-Net's buffers
    saved and restored inside), through the graphs against the eager
    route: labels and losses bitwise, the head kernel's launches equal,
    the U-Net's buffers unchanged by the evaluation."""
    from ukbb_cardiac_tpu_torch.reg.programs import ProgramCache
    from ukbb_cardiac_tpu_torch.train import ao as tao
    from ukbb_cardiac_tpu_torch.train import sa as tsa
    from ukbb_cardiac_tpu_torch.train import steps as tsteps

    images = np.random.RandomState(5).rand(3, 64, 96, 1).astype(np.float32)
    runs = {}
    for name in ("eager", "graphs"):
        net = _random_fcn(n_level=3).to(card,
                                        memory_format=torch.channels_last)
        cache = ProgramCache()
        step = tsteps.make_train_step(
            tsa.make_fcn_loss(net, net.cfg),
            tsteps.Adam(net.parameters(), lr=1e-2), programs=cache)
        batch = {"image": torch.from_numpy(images[:, :, :64]).to(card),
                 "label": torch.from_numpy(images[:, :, :64, 0] > 0.5).to(
                     card, torch.int32)}
        labels, before = [], _head_launch_count()
        with (programs._eager_route() if name == "eager"
              else contextlib.nullcontext()):
            for i in range(4):
                labels.append(tsa.validation_predict(net, images, card,
                                                     cache))
                step(batch, i + 1)
        runs[name] = (labels, _head_launch_count() - before)
        if name == "graphs":
            assert any(p.key[0] == ("sa_validation",) and p.replays == 3
                       for p in cache.programs())
        cache.clear()
    (eager, n_eager), (graphs, n_graphs) = runs["eager"], runs["graphs"]
    assert all(np.array_equal(a, b) for a, b in zip(eager, graphs))
    assert not np.array_equal(eager[0], eager[-1])  # the head refolds
    assert n_eager == n_graphs == 4 * 3

    case = _ao_train_case("UNet-LSTM", joint=True)
    cfg = case["make_loss"].args[0]
    net = case["net"].to(card, memory_format=torch.channels_last)
    eval_loss = tao.make_ao_loss(cfg, net, train=False)
    tw = cfg.time_window
    rng = np.random.RandomState(6)
    batch = {"image": torch.from_numpy(rng.rand(2, tw, 64, 64, 1).astype(
                 np.float32)).to(card),
             "label": torch.from_numpy(rng.randint(0, 3, (2, tw, 64, 64))
                                       .astype(np.int32)).to(card)}
    buffers = [b.clone() for b in net.unet.buffers()]
    with programs._eager_route():
        want = tsteps.make_eval_step(lambda b: eval_loss(b, 0))(batch)
    cache = ProgramCache()
    step = tsteps.make_eval_step(lambda b: eval_loss(b, 0), programs=cache)
    for _ in range(3):
        got = step(batch)
        assert torch.equal(got[0], want[0])
        for k, v in want[1].items():
            assert torch.equal(got[1][k], v), k
    assert [p.replays for p in cache.programs()] == [2]
    assert all(torch.equal(a, b) for a, b in zip(buffers,
                                                 net.unet.buffers()))
    cache.clear()


@pytest.mark.cuda
def test_resume_after_a_graphed_chunk_continues_bitwise(card, tmp_path):
    """Two graphed K-step calls of the FCN production step, a checkpoint
    (the bundle both packages read, Adam state included), a fresh net and
    optimizer restored from it as the trainer restores them (programs
    built after ``load_adam_leaves``), two more graphed calls: bitwise
    the same as four calls straight through."""
    from ukbb_cardiac_tpu_torch.ckpt import convert, store
    from ukbb_cardiac_tpu_torch.train import device_pool
    from ukbb_cardiac_tpu_torch.train import sa as tsa
    from ukbb_cardiac_tpu_torch.train import steps as tsteps

    case = _fcn_pool_case(K=2, B=8)
    img, lab = (torch.from_numpy(a).to(card) for a in case["pool"])
    batches = {k: torch.from_numpy(v).to(card)
               for k, v in case["batches"].items()}
    names = convert.fcn_names(case["net"].cfg)
    layout = convert.fcn_layout(names, case["net"].cfg)

    def start(net, optimizer):
        step = device_pool.make_pool_slice_multi_step(
            case["make_loss"](net), optimizer)
        return lambda c: step(img, lab, batches, [2 * c + 1, 2 * c + 2])

    def fresh():
        net = _copy_net(case["net"]).to(card,
                                       memory_format=torch.channels_last)
        return net, tsteps.Adam(net.parameters(), lr=1e-3)

    net, opt = fresh()
    call = start(net, opt)
    straight = [call(c)[0] for c in range(4)]
    want = {k: v.clone() for k, v in net.state_dict().items()}
    want_adam = [opt.state[p]["exp_avg_sq"].clone() for p in net.parameters()]

    net, opt = fresh()
    call = start(net, opt)
    first = [call(c)[0] for c in range(2)]
    path = str(tmp_path / "model-4.npz")
    tsa.save_checkpoint(path, net, names, opt, layout, {"iteration": 4})
    kind, mcfg, bnames, params, state, _ = store.load_model_with_extra(path)
    net = convert.fcn_from_jax(params, state, bnames, mcfg).to(
        card, memory_format=torch.channels_last)
    opt = tsteps.Adam(net.parameters(), lr=1e-3)
    convert.load_adam_leaves(opt, net, layout, store.load_opt_state(path))
    assert all(st["step"].device == card or st["step"].is_cuda
               for st in opt.state.values())
    call = start(net, opt)
    second = [call(c)[0] for c in range(2, 4)]
    assert all(torch.equal(a, b) for a, b in zip(straight, first + second))
    for k, v in want.items():
        assert torch.equal(net.state_dict()[k], v), k
    assert all(torch.equal(opt.state[p]["exp_avg_sq"], v)
               for p, v in zip(net.parameters(), want_adam))


def _copy_net(net):
    import copy

    return copy.deepcopy(net)


_TORCH_ADAM_CAPTURE = """
import numpy as np, torch
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.train import sa as tsa, steps as tsteps
cfg = tfcn.FCNConfig(n_class=4, n_level=3, n_filter=(16, 32, 64),
                     n_block=(2, 2, 3))
net = tfcn.FCN(cfg).cuda()
step = tsteps.make_train_step(tsa.make_fcn_loss(net, cfg),
                              torch.optim.Adam(net.parameters(), lr=1e-3))
batch = {"image": torch.rand(4, 64, 64, 1, device="cuda"),
         "label": torch.zeros(4, 64, 64, dtype=torch.int32, device="cuda")}
try:
    step(batch, 1)  # runs eagerly, then captures
except RuntimeError as err:
    print("raised:", str(err).splitlines()[0])
else:
    print("no error")
"""


@pytest.mark.cuda
def test_a_train_step_that_cannot_be_captured_raises(card):
    """A step whose optimizer refuses a capture (``torch.optim.Adam``
    without ``capturable``) raises at its first call, which runs eagerly
    and then captures; nothing falls back to the eager route (in a
    process of its own, whose CUDA context the invalidated capture leaves
    behind)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _TORCH_ADAM_CAPTURE],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:"), out.stdout


@pytest.mark.cuda
def test_program_spans_around_capture_and_replay(card):
    """Under the profiler a program opens ``ukbb.program.warmup`` and
    ``.capture`` at its key's first call and ``.replay`` at each later
    one; a bound that drops a program opens ``.release``.  The captured
    function runs inside the warm-up and the capture only, so no span of
    its own would show at a replay."""
    from torch.profiler import ProfilerActivity, profile
    cache = programs.ProgramCache(max_programs=1)

    def fn(x):
        with torch.profiler.record_function("test.captured"):
            return (x * 2 + 1,)

    x = torch.arange(8.0, device=card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            (y,) = cache.run(("double",), fn, x)
        cache.run(("other",), fn, x[:4])     # drops "double"
        torch.cuda.synchronize()
    assert torch.equal(y, x * 2 + 1)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type.name == "CPU"
             and (e.name.startswith("ukbb.program.")
                  or e.name == "test.captured")]
    count = {n: sum(s[0] == n for s in spans) for n in (
        "ukbb.program.warmup", "ukbb.program.capture",
        "ukbb.program.replay", "ukbb.program.release", "test.captured")}
    assert count == {"ukbb.program.warmup": 2, "ukbb.program.capture": 2,
                     "ukbb.program.replay": 2, "ukbb.program.release": 1,
                     "test.captured": 4}
    for name, a, b in spans:
        if name == "test.captured":
            assert any(o[0] in ("ukbb.program.warmup",
                                "ukbb.program.capture")
                       and o[1] <= a and b <= o[2] for o in spans)
