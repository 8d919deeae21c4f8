"""The port's aortic stage against the JAX package's, end to end on the
CPU: z-score normalisation, the fixed 256 x 256 padding, the aortic
deploy with the trained ``UNet-LSTM_ao`` bundle in both window modes, the
``unet`` and ``temporal_unet`` kinds, the aorta QC gate, aortic areas and
distensibility, their CLI, and the full cohort with the aortic stage.

Phantoms: ``tests/phantom.py::ao_phantom`` at 96 x 96 (int16, as UK
Biobank cines are), padded to 256 x 256 by both deploys.  Seg NIfTIs
must be byte-identical; the area rows agree at rtol 1e-6;
``normalise_intensity_torch`` is within 1e-6 of the output's range of the
float64 result (the JAX version's float32 sums are further off; see the
test).
"""

import io
import os
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phantom import ao_phantom
from test_torch_la import BUNDLES, write_full_subject
from ukbb_cardiac_tpu.ckpt import store as jstore
from ukbb_cardiac_tpu.infer import deploy_ao as jdeploy_ao
from ukbb_cardiac_tpu.infer.deploy import \
    load_segmentation_model as jax_load
from ukbb_cardiac_tpu.infer.engine import InferenceEngine as JEngine
from ukbb_cardiac_tpu.infer.engine import SegmentationModel as JModel
from ukbb_cardiac_tpu.io import nifti
from ukbb_cardiac_tpu.models import unet as junet
from ukbb_cardiac_tpu.ops import intensity as jintensity
from ukbb_cardiac_tpu.ops.crop import pad_to_size as jpad_to_size
from ukbb_cardiac_tpu.parallel import run_cohort_full as jax_run_cohort_full
from ukbb_cardiac_tpu.phenotype import aorta as jaorta
from ukbb_cardiac_tpu.phenotype import qc as jqc
from ukbb_cardiac_tpu_torch.ckpt import convert, tf_reader
from ukbb_cardiac_tpu_torch.ckpt.store import load_model
from ukbb_cardiac_tpu_torch.cli import deploy_network_ao, run_cohort
from ukbb_cardiac_tpu_torch.cli import eval_aortic_area as tcli_aorta
from ukbb_cardiac_tpu_torch.infer import deploy_ao as tdeploy_ao
from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine as TEngine
from ukbb_cardiac_tpu_torch.infer.engine import SegmentationModel as TModel
from ukbb_cardiac_tpu_torch.ops import intensity as tintensity
from ukbb_cardiac_tpu_torch.ops.crop import pad_to_size
from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh
from ukbb_cardiac_tpu_torch.phenotype import aorta as taorta
from ukbb_cardiac_tpu_torch.phenotype import qc as tqc

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(__file__), "fixtures", "bench_weights")
AO_BUNDLE = os.path.join(WEIGHTS, "UNet-LSTM_ao.npz")
AFFINE_AO = np.diag([-1.8, -1.8, 10.0, 1.0])
NORM_RTOL = 1e-6
AREA_RTOL = 1e-6
PRESSURE_COLUMN = "Central pulse pressure during PWA"


def _save(path, data, dt=0.04):
    hdr = nifti.Nifti1Header()
    hdr.dim[0] = data.ndim
    hdr.dim[1:1 + data.ndim] = data.shape
    hdr.pixdim[1:4] = (1.8, 1.8, 10.0)
    if data.ndim == 4:
        hdr.pixdim[4] = dt
    nifti.save(nifti.Nifti1Image(data, AFFINE_AO, hdr), str(path))


def write_ao_subject(d, seed, T, with_seg=False):
    """An aortic cine (96, 96, 1, T) int16 and, with ``with_seg``, its
    truth as ``seg_ao.nii.gz``.  Returns the truth labels."""
    os.makedirs(d, exist_ok=True)
    image, seg = ao_phantom(96, 96, T, rng=np.random.RandomState(seed))
    _save(os.path.join(d, "ao.nii.gz"), np.round(image).astype(np.int16))
    if with_seg:
        _save(os.path.join(d, "seg_ao.nii.gz"), seg.astype(np.float64))
    return seg


def _read(path):
    return np.asanyarray(nifti.load(str(path)).dataobj)


def _same_bytes(a, b):
    with open(a, "rb") as f:
        want = f.read()
    with open(b, "rb") as f:
        return f.read() == want


def _twin(tmp_path, subjects, T):
    ref, port = tmp_path / "jax", tmp_path / "port"
    truth = {eid: write_ao_subject(str(ref / eid), i + 10, T)
             for i, eid in enumerate(subjects)}
    shutil.copytree(ref, port)
    return ref, port, truth


# --- intensity and padding --------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_normalise_intensity_matches_jax(dtype):
    """Both device versions sum the ROI in float32, in different orders.
    Against the float64 host result the port is within 1e-6 of the
    output's range (measured 4e-7 / 3e-7 of 5.3); the JAX version is
    1.2e-4 off it on this phantom (its float32 sums), so the port is held
    to the JAX version at that measured error plus the port's bound."""
    image, _ = ao_phantom(96, 80, 12, rng=np.random.RandomState(1))
    image = (np.round(image) if dtype == np.int16 else image).astype(dtype)
    exact = jintensity.normalise_intensity(image.astype(np.float64))
    want = np.asarray(jintensity.normalise_intensity_jax(jnp.asarray(image)))
    got = tintensity.normalise_intensity_torch(torch.from_numpy(image))
    assert got.dtype == torch.float32
    span = exact.max() - exact.min()
    np.testing.assert_allclose(got.numpy(), exact, rtol=0,
                               atol=NORM_RTOL * span)
    jax_err = np.abs(want - exact).max()
    assert jax_err < 3e-5 * span
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=jax_err + NORM_RTOL * span)
    host = tintensity.normalise_intensity(image)
    np.testing.assert_array_equal(host, jintensity.normalise_intensity(image))


def test_normalise_intensity_of_a_constant_image_is_finite():
    """Every voxel in the ROI: sigma is 0 and eps keeps the output finite."""
    flat = torch.full((8, 8, 1, 3), 7, dtype=torch.int16)
    got = tintensity.normalise_intensity_torch(flat)
    want = np.asarray(jintensity.normalise_intensity_jax(
        jnp.asarray(flat.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("X, Y, size", [(240, 196, 256), (96, 95, 256),
                                        (256, 256, 256), (7, 10, 16)])
def test_pad_to_size_matches_jax(X, Y, size):
    pads = pad_to_size(X, Y, size)
    assert pads == jpad_to_size(X, Y, size)
    assert pads[0] + pads[1] + X == size and pads[2] + pads[3] + Y == size


# --- the aortic deploy ------------------------------------------------------

def test_deploy_full_matches_jax(tmp_path, capsys):
    """Two subjects through the one-deep pipeline of both packages' full
    mode (device z-score, pad, U-Net over all frames, bidirectional
    ConvLSTM scan, softmax, argmax, crop, 2-bit pack): seg NIfTIs byte
    for byte, labels near the truth."""
    ref, port, truth = _twin(tmp_path, ("1000001", "1000002"), 6)
    jdeploy_ao.deploy_dataset_ao(AO_BUNDLE, str(ref))
    jax_out = capsys.readouterr().out
    records = tdeploy_ao.deploy_dataset_ao(AO_BUNDLE, str(port),
                                           device="cpu")
    port_out = capsys.readouterr().out
    assert [r["subject"] for r in records] == ["1000001", "1000002"]
    assert all(r["device_ms"] is None for r in records)
    for eid, seg_true in truth.items():
        assert _same_bytes(ref / eid / "seg_ao.nii.gz",
                           port / eid / "seg_ao.nii.gz"), eid
        seg = _read(port / eid / "seg_ao.nii.gz")
        for label in (1, 2):
            a, b = seg == label, seg_true == label
            assert 2 * (a & b).sum() / (a.sum() + b.sum()) > 0.9
    # the printed lines, times and roots aside
    def lines(out, root):
        return [ln.split("=")[0].replace(str(root), "<root>")
                for ln in out.splitlines() if not ln.startswith("It took")]
    assert lines(port_out, port) == lines(jax_out, ref)
    # idempotent: existing segs are skipped
    assert tdeploy_ao.deploy_dataset_ao(AO_BUNDLE, str(port),
                                        device="cpu") == []


def test_deploy_compat_window_matches_jax(tmp_path):
    """The reference's circular sliding window (weight_R = 2: 3-frame
    windows over a 4-frame cine), blended on the host."""
    ref, port, _ = _twin(tmp_path, ("1000003",), 4)
    jdeploy_ao.deploy_dataset_ao(AO_BUNDLE, str(ref), window="compat",
                                 weight_R=2, weight_r=1.0)
    deploy_network_ao.main(["--data_dir", str(port), "--model_path",
                            AO_BUNDLE, "--window", "compat", "--weight_R",
                            "2", "--weight_r", "1.0", "--device", "cpu"])
    assert _same_bytes(ref / "1000003" / "seg_ao.nii.gz",
                       port / "1000003" / "seg_ao.nii.gz")


def test_compat_window_counts_duplicate_frames(tmp_path):
    """A window wider than the cine repeats frames: each repeat adds its
    weight (``np.add.at``), as the JAX engine blends."""
    rng = np.random.RandomState(3)
    image = rng.randn(256, 256, 1, 2).astype(np.float32)
    jeng = jdeploy_ao.load_aortic_engine(AO_BUNDLE)
    teng = tdeploy_ao.load_aortic_engine(AO_BUNDLE, "cpu")
    want = jeng.prob_sequence(image, "compat", weight_R=2, weight_r=1.0)
    got = teng.prob_sequence(image, "compat", weight_R=2, weight_r=1.0)
    assert got.shape == want.shape == (256, 256, 1, 2, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_window_weights_match_jax():
    for R, r in ((5, 0.0), (2, 1.0), (3, 2.5)):
        np.testing.assert_array_equal(tdeploy_ao.window_weights(R, r),
                                      jdeploy_ao.window_weights(R, r))


class _Converted(Exception):
    pass


def _refuse_conversion(prefix):
    raise _Converted(prefix)


def test_deploy_refusals(tmp_path, monkeypatch):
    engine = tdeploy_ao.load_aortic_engine(AO_BUNDLE, "cpu")
    with pytest.raises(ValueError, match="exceeds"):
        engine.segment_cine_dispatch(np.zeros((300, 10, 1, 2), np.int16))
    # the fleet deploy refuses an empty stack, and a cine too large for
    # the grid as the per-subject path does
    mesh = make_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="empty"):
        engine.segment_subjects_sharded(np.zeros((0, 8, 8, 1, 2), np.int16),
                                        mesh)
    with pytest.raises(ValueError, match="exceeds"):
        engine.segment_subjects_sharded(np.zeros((1, 300, 10, 1, 2),
                                                 np.int16), mesh)
    with pytest.raises(ValueError, match="frame-wise"):
        tdeploy_ao.deploy_subject_ed_es_ao(engine, str(tmp_path))
    # a TF checkpoint prefix is converted first (tests/test_torch_tf.py
    # converts real ones): the CLI hands it to the converter
    monkeypatch.setattr(tf_reader, "convert_tf_checkpoint",
                        _refuse_conversion)
    with pytest.raises(_Converted, match="model.ckpt"):
        deploy_network_ao.main(["--data_dir", str(tmp_path), "--model_path",
                                "model.ckpt", "--device", "cpu"])


def test_deploy_raises_without_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy_network_ao.main(["--data_dir", str(tmp_path), "--model_path",
                                AO_BUNDLE])


@pytest.fixture(scope="module")
def unet_bundle(tmp_path_factory):
    """The trained bundle's U-Net alone, as a bundle of kind ``unet``."""
    kind, cfg, names, params, state, _ = jstore.load_model(AO_BUNDLE)
    path = str(tmp_path_factory.mktemp("ao_unet") / "unet.npz")
    jstore.save_model(path, "unet", cfg, names, {"UNet": params["UNet"]},
                      state, {})
    return path


def test_unet_kind_probabilities_and_ed_es_mode_match_jax(tmp_path,
                                                          unet_bundle):
    """The ``unet`` kind: softmax probabilities from the slice engine
    (``want_prob``), the full-sequence deploy, and the ED/ES-only mode —
    seg NIfTIs byte for byte."""
    kind, cfg, names, params, state = load_model(unet_bundle)
    assert kind == "unet"
    teng = TEngine(TModel.from_unet(
        convert.unet_from_jax(params, state, names, cfg), "cpu"))
    jk, jcfg, jnames, jparams, jstate, _ = jstore.load_model(unet_bundle)
    jeng = JEngine(JModel.from_unet(jparams, jstate, jnames, jcfg))
    image, _ = ao_phantom(64, 48, 3, rng=np.random.RandomState(4))
    image = jintensity.normalise_intensity(image)
    seg, prob = teng.segment_sequence(image, want_prob=True)
    jseg, jprob = jeng.segment_sequence(image, want_prob=True)
    assert prob.shape == jprob.shape == (64, 48, 1, 3, 3)
    np.testing.assert_allclose(prob, jprob, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(seg, jseg)
    vseg, vprob = teng.segment_volume(image[..., 0], want_prob=True)
    np.testing.assert_array_equal(vseg, jseg[..., 0])
    np.testing.assert_allclose(vprob, jprob[..., 0, :], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(teng.segment_sequence(image), jseg)

    ref, port, _ = _twin(tmp_path, ("1000004",), 3)
    for root in (ref, port):
        cine = _read(root / "1000004" / "ao.nii.gz")
        for fr, t in (("ED", 0), ("ES", 2)):
            _save(root / "1000004" / f"ao_{fr}.nii.gz", cine[..., t])
    for mode in ({}, {"process_seq": False}):
        jdeploy_ao.deploy_dataset_ao(unet_bundle, str(ref), **mode)
        tdeploy_ao.deploy_dataset_ao(unet_bundle, str(port), device="cpu",
                                     **mode)
    for name in ("seg_ao.nii.gz", "seg_ao_ED.nii.gz", "seg_ao_ES.nii.gz"):
        assert _same_bytes(ref / "1000004" / name, port / "1000004" / name), \
            name


def test_temporal_unet_kind_matches_jax(tmp_path):
    """A ``temporal_unet`` bundle (3D convs, stride (1, 2, 2)) through the
    full-scan deploy and both window modes' probabilities."""
    cfg = junet.UNetConfig(n_class=3, n_level=3, n_filter=(2, 4, 4),
                           n_block=(1, 1, 1))
    names = {}

    def init(key):  # one compiled program instead of one per random draw
        p, s, names["n"] = junet.init_unet(key, cfg, conv3d_=True)
        return p, s

    p, s = jax.jit(init)(jax.random.PRNGKey(0))
    n = names["n"]
    path = str(tmp_path / "tunet.npz")
    jstore.save_model(path, "temporal_unet", cfg, n, p, s, {})
    jeng = jdeploy_ao.load_aortic_engine(path)
    teng = tdeploy_ao.load_aortic_engine(path, "cpu")
    image = np.random.RandomState(5).randn(256, 256, 1, 3).astype(np.float32)
    for window in ("full", "compat"):
        got = teng.prob_sequence(image, window, weight_R=2)
        want = jeng.prob_sequence(image, window, weight_R=2)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(teng.pred_sequence(image),
                                  jeng.pred_sequence(image))
    ref, port, _ = _twin(tmp_path, ("1000005",), 3)
    jdeploy_ao.deploy_dataset_ao(path, str(ref))
    tdeploy_ao.deploy_dataset_ao(path, str(port), device="cpu")
    assert _same_bytes(ref / "1000005" / "seg_ao.nii.gz",
                       port / "1000005" / "seg_ao.nii.gz")


# --- aortic areas and QC ----------------------------------------------------

def _vessels(areas_aa, area_da=120.0, X=64, Y=64):
    """Labels (X, Y, 1, T) with an AAo disk of the given area per frame
    and a fixed DAo disk, and a matching image."""
    T = len(areas_aa)
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    seg = np.zeros((X, Y, 1, T), np.int16)
    for t, a in enumerate(areas_aa):
        seg[..., 0, t][(xx - 20) ** 2 + (yy - 32) ** 2 <= a / np.pi] = 1
        seg[..., 0, t][(xx - 46) ** 2 + (yy - 32) ** 2 <= area_da / np.pi] = 2
    image = np.where(seg == 1, 900.0, np.where(seg == 2, 850.0, 50.0))
    return image.astype(np.float32), seg


def _failing_segs():
    """One (image, seg) per gate of the aorta QC, in gate order, with the
    message each must print."""
    image, seg = _vessels([150.0, 160.0, 170.0, 160.0, 150.0, 145.0])
    empty = seg.copy()
    empty[..., 2][empty[..., 2] == 2] = 0               # DAo gone at frame 2
    noisy = image.copy()
    noisy[20, 32, 0, 3] = 3000.0                        # >= 3x the ED mean
    split = seg.copy()
    split[2:7, 2:7, 0, 1] = 1                           # a second AAo part
    jump = seg.copy()
    jump[..., 3][jump[..., 3] == 1] = 0
    jump[18:23, 30:35, 0, 3] = 1                        # 25 px after 160
    img_g, grow = _vessels([100.0, 130.0, 170.0, 220.0, 220.0, 170.0, 130.0])
    return [(image, empty, "area of DAo is 0"),
            (noisy, seg, "very noisy"),
            (image, split, "two connected"),
            (image, jump, "abrupt change"),
            (img_g, grow, "maximum and minimum")]


@pytest.mark.parametrize("case", range(5))
def test_aorta_qc_gates_match_jax(case):
    image, seg, message = _failing_segs()[case]
    out = io.StringIO()
    with redirect_stdout(out):
        got = tqc.aorta_pass_quality_control(image, seg)
    assert got is jqc.aorta_pass_quality_control(image, seg) is False
    assert message in out.getvalue()


def test_aorta_qc_passes_the_phantom():
    image, seg = ao_phantom(96, 96, 12, rng=np.random.RandomState(2))
    assert tqc.aorta_pass_quality_control(image, seg) is \
        jqc.aorta_pass_quality_control(image, seg) is True


def _qc_case(case):
    """(image, seg, what stdout holds) for a case of the aorta QC; None:
    the gate passes and prints nothing."""
    if case.startswith("gate"):
        image, seg, message = _failing_segs()[int(case[4:])]
        return image, seg, message
    image, seg = _vessels([150.0, 160.0, 170.0, 160.0, 150.0, 145.0])
    T = seg.shape[3]
    if case == "ratio_wraps_to_t0":                     # 140 px after 300
        image, seg = _vessels([140.0, 190.0, 240.0, 300.0])
        return image, seg, "abrupt change of area at time frame 0."
    if case == "split_at_last_frame":
        seg[2:7, 2:7, 0, T - 1] = 1
        return image, seg, f"components with more than 10 pixels at " \
                           f"time frame {T - 1}."
    if case == "noisy_in_dao_only":
        image[46, 32, 0, 4] = 3000.0                    # DAo's centre
        return image, seg, "very noisy at time frame 4."
    if case == "int16_image_noisy":
        image = np.round(image).astype(np.int16)
        image[20, 32, 0, 2] = 2800                      # >= 3x 900
        return image, seg, "very noisy at time frame 2."
    if case == "int16_image_passes":
        image, seg = ao_phantom(96, 80, 10, rng=np.random.RandomState(5))
        return np.round(image).astype(np.int16), seg, None
    if case == "fortran_uint8_split":                   # as NIfTI loads it
        seg[40:45, 2:7, 0, 3] = 2
        return (np.asfortranarray(image),
                np.asfortranarray(seg.astype(np.uint8)),
                "components with more than 10 pixels at time frame 3.")
    if case == "float_seg_empty_dao":
        seg = seg.astype(np.float64)
        seg[..., T - 1][seg[..., T - 1] == 2] = 0
        return image, seg, "The area of DAo is 0 at time frame 5."
    if case == "two_slices_split":                      # the per-frame route
        seg[2:7, 2:7, 0, 1] = 1
        return (np.concatenate([image, image], axis=2),
                np.concatenate([seg, seg], axis=2),
                "components with more than 10 pixels at time frame 1.")
    raise KeyError(case)


@pytest.mark.parametrize("case", [f"gate{i}" for i in range(5)] + [
    "ratio_wraps_to_t0", "split_at_last_frame", "noisy_in_dao_only",
    "int16_image_noisy", "int16_image_passes", "fortran_uint8_split",
    "float_seg_empty_dao", "two_slices_split"])
def test_aorta_qc_stdout_matches_jax(case):
    """The gate's verdict and its whole stdout equal the JAX package's,
    on each route: single-slice cines take the one pass over the frames,
    a two-slice cine the per-frame loop."""
    image, seg, message = _qc_case(case)
    got, want = io.StringIO(), io.StringIO()
    with redirect_stdout(got):
        verdict = tqc.aorta_pass_quality_control(image, seg)
    with redirect_stdout(want):
        jverdict = jqc.aorta_pass_quality_control(image, seg)
    assert verdict is jverdict is (message is None)
    assert got.getvalue() == want.getvalue()
    assert (got.getvalue() == "") if message is None else \
        (message in got.getvalue())


@pytest.mark.parametrize("pp", [40.0, float("nan"), 0.0])
def test_aortic_area_measures_match_jax(tmp_path, pp):
    d = tmp_path / "1000006"
    write_ao_subject(str(d), 6, 10, with_seg=True)
    got = taorta.aortic_area_measures(str(d), pp)
    want = jaorta.aortic_area_measures(str(d), pp)
    row, jrow = taorta.aortic_row(got), [want[v][k] for v in ("AAo", "DAo")
                                         for k in ("max area", "min area",
                                                   "distensibility")]
    np.testing.assert_allclose(row, jrow, rtol=AREA_RTOL, atol=0)
    assert np.isfinite(row[2]) == (pp > 0)
    assert taorta.aortic_area_measures(str(tmp_path / "none"), pp) is None


def _pressure_csv(path, rows):
    cols = pd.MultiIndex.from_tuples([(PRESSURE_COLUMN, "12678-2.0"),
                                      (PRESSURE_COLUMN, "12678-2.1")])
    pd.DataFrame(list(rows.values()), index=pd.Index(list(rows), name="eid"),
                 columns=cols).to_csv(path)
    return str(path)


def test_eval_aortic_area_cli_matches_jax(tmp_path):
    """The CLI's CSV: two-row-header pressures (one mean below 10 mmHg,
    so NaN), a subject missing from the pressures, one with no seg."""
    data = tmp_path / "data"
    for i, eid in enumerate(("1000007", "1000008", "1000009")):
        write_ao_subject(str(data / eid), 20 + i, 8, with_seg=True)
    write_ao_subject(str(data / "1000010"), 23, 8)      # no seg: skipped
    bp = _pressure_csv(tmp_path / "bp.csv", {1000007: [40.0, 44.0],
                                             1000008: [8.0, 9.0]})
    pd.testing.assert_series_equal(taorta.load_central_pulse_pressure(bp),
                                   jaorta.load_central_pulse_pressure(bp))
    jaorta.evaluate_aortic_area_dataset(str(data), bp, str(tmp_path / "j.csv"))
    tcli_aorta.main(["--data_dir", str(data), "--pressure_csv", bp,
                     "--output_csv", str(tmp_path / "t.csv")])
    got = pd.read_csv(tmp_path / "t.csv", index_col=0)
    want = pd.read_csv(tmp_path / "j.csv", index_col=0)
    assert list(got.columns) == list(want.columns) == taorta.COLUMNS
    assert list(got.index) == list(want.index) == [1000007, 1000008, 1000009]
    np.testing.assert_allclose(got.values, want.values, rtol=AREA_RTOL)
    assert np.isfinite(got.values[0]).all()
    assert np.isnan(got.values[1:, [2, 5]]).all()


# --- the cohort with the aortic stage ---------------------------------------

def test_full_cohort_with_the_aortic_stage_matches_jax(tmp_path):
    """Two complete subjects through the JAX package's ``run_cohort_full``
    and the port's cohort CLI with ``--model_path_ao`` and
    ``--pressure_csv``: one subject has its aortic truth seg (the deploy
    skips), the other has none (the trained bundle segments it).  Every
    table and the deployed seg_ao agree."""
    ref, port = tmp_path / "jax", tmp_path / "port"
    for i, eid in enumerate(("1000001", "1000002")):
        write_full_subject(str(ref / eid), i)
        write_ao_subject(str(ref / eid), 30 + i, 6, with_seg=i == 0)
    shutil.copytree(ref, port)
    bp = _pressure_csv(tmp_path / "bp.csv", {1000001: [40.0, 42.0],
                                             1000002: [35.0, 36.0]})
    engines = {k: JEngine(jax_load(os.path.join(WEIGHTS, b)))
               for k, b in BUNDLES.items()}
    engines["ao"] = jdeploy_ao.load_aortic_engine(AO_BUNDLE)
    jres = jax_run_cohort_full(
        str(ref), engines, workers=2, output_dir=str(tmp_path / "jax_csv"),
        pressure=jaorta.load_central_pulse_pressure(bp), verbose=False)
    assert len(jres.fleet.succeeded) == 2
    manifest = str(tmp_path / "manifest.json")
    rc = run_cohort.main(
        ["--data_dir", str(port), "--output_dir", str(tmp_path / "port_csv"),
         "--workers", "2", "--device", "cpu", "--manifest", manifest,
         "--model_path_ao", AO_BUNDLE, "--pressure_csv", bp]
        + [x for k, flag in (("sa", "--model_path"),
                             ("la_2ch", "--model_path_la_2ch"),
                             ("la_4ch", "--model_path_la_4ch"),
                             ("seg4", "--model_path_seg4"))
           for x in (flag, os.path.join(WEIGHTS, BUNDLES[k]))])
    assert rc == 0
    stages = pd.read_json(manifest, typ="series")["stage_seconds"]
    assert all("aortic" in st for st in stages.values())
    assert _same_bytes(ref / "1000002" / "seg_ao.nii.gz",
                       port / "1000002" / "seg_ao.nii.gz")

    def table(tag, name):
        return pd.read_csv(tmp_path / f"{tag}_csv" / name,
                           index_col=0).sort_index()

    names = sorted(os.listdir(tmp_path / "port_csv"))
    assert names == sorted(os.listdir(tmp_path / "jax_csv"))
    assert "table_aortic_area.csv" in names and len(names) == 7
    got, want = table("port", "table_aortic_area.csv"), table(
        "jax", "table_aortic_area.csv")
    assert list(got.columns) == list(want.columns) == taorta.COLUMNS
    assert list(got.index) == list(want.index) == [1000001, 1000002]
    np.testing.assert_allclose(got.values, want.values, rtol=AREA_RTOL)
    assert np.isfinite(got.values).all()
    got, want = (table(t, "table_ventricular_volume.csv")
                 for t in ("port", "jax"))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    for name in ("table_wall_thickness.csv", "table_wall_thickness_max.csv",
                 "table_atrial_volume.csv"):
        np.testing.assert_allclose(table("port", name).values,
                                   table("jax", name).values, rtol=1e-6)
