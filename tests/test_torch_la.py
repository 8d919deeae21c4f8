"""The port's long-axis chain against the JAX package's, end to end on the
CPU: the LA deploys (la_2ch, la_4ch, seg4) with the trained bundles, the
LA and atrium QC gates, atrial volumes, LA strain, and the full cohort
(SA chain + LA chain) through the port's cohort CLI.

Phantoms: ``tests/phantom.py``'s LA phantoms at 96² × 1 × 6 with the
world-consistent SA and LA affines of ``tests/test_cohort.py``.  Integer
outputs (seg NIfTIs, landmark VTKs) must be identical; float tables are
held to the bounds below.
"""

import filecmp
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from phantom import la_phantom, sax_phantom, seg4_la_phantom
from ukbb_cardiac_tpu.infer.deploy import deploy_dataset as jax_deploy
from ukbb_cardiac_tpu.io import nifti
from ukbb_cardiac_tpu.parallel import run_cohort_full as jax_run_cohort_full
from ukbb_cardiac_tpu.phenotype import atrium as jatrium
from ukbb_cardiac_tpu.phenotype import qc as jqc
from ukbb_cardiac_tpu.phenotype import strain_la as jla
from ukbb_cardiac_tpu.infer.deploy import \
    load_segmentation_model as jax_load
from ukbb_cardiac_tpu.infer.engine import InferenceEngine as JEngine
from ukbb_cardiac_tpu.cli import eval_strain_lax as jcli_lax
from ukbb_cardiac_tpu_torch.cli import deploy_network, run_cohort
from ukbb_cardiac_tpu_torch.cli import eval_atrial_volume as tcli_atrial
from ukbb_cardiac_tpu_torch.cli import eval_strain_lax as tcli_lax
from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine, pack_bits
from ukbb_cardiac_tpu_torch.phenotype import atrium as tatrium
from ukbb_cardiac_tpu_torch.phenotype import qc as tqc
from ukbb_cardiac_tpu_torch.phenotype import strain_la as tla

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(__file__), "fixtures", "bench_weights")
BUNDLES = {"sa": "FCN_sa.npz", "la_2ch": "FCN_la_2ch.npz",
           "la_4ch": "FCN_la_4ch.npz", "seg4": "FCN_la_4ch_seg4.npz"}
# LA longitudinal strain, measured on this phantom (96^2, T = 6,
# RegConfig()): the port is 0.25 percentage points from the JAX package
# per segment and 0.03 on the Global row.  The JAX package itself, fed the
# same cine plus 1e-4 of noise (1e-7 of the intensity range), moved 0.43 /
# 0.024, and with 1e-3 of noise 0.71 / 0.077 -- the spread of an Adam run
# over float noise.
LA_STRAIN_SEGMENT_ATOL = 1.5
LA_STRAIN_GLOBAL_ATOL = 0.3
# the SA bounds of tests/test_torch_strain.py
SA_STRAIN_SEGMENT_ATOL, SA_STRAIN_GLOBAL_ATOL = 2.0, 0.5
LA_DICE_ATOL = 0.01                    # measured 0.0054 (JAX at 1e-4: 0.0068)

AFFINE_SA = np.diag([-1.8, -1.8, 10.0, 1.0])
AFFINE_SA[:3, 3] = (80.0, 90.0, -40.0)
# 4ch LA plane: the world long axis runs along the in-plane y axis
AFFINE_LA = np.array([[-1.8, 0, 0, 80.0],
                      [0, 0, 10.0, 0.0],
                      [0, -1.8, 0, 90.0],
                      [0, 0, 0, 1.0]])


def _save(d, name, data, affine, dt=0.04):
    hdr = nifti.Nifti1Header()
    hdr.dim[0] = data.ndim
    hdr.dim[1:1 + data.ndim] = data.shape
    hdr.pixdim[1:4] = (1.8, 1.8, 10.0)
    if data.ndim == 4:
        hdr.pixdim[4] = dt
    nifti.save(nifti.Nifti1Image(data, affine, hdr), os.path.join(d, name))


def write_full_subject(d, i, X=96, Y=96, T=6, with_seg=True):
    """The cines of one subject (sa, la_2ch, la_4ch) and, with
    ``with_seg``, their ground-truth segs as the deploys would write them
    (the ``tests/test_cohort.py::_full_cohort`` construction).  Returns
    the truth {'la_2ch', 'la_4ch', 'seg4'}."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(i)
    sa_img, sa_seg = sax_phantom(X, Y, 8, T, rng=rng)
    la4_img, seg4 = seg4_la_phantom(X, Y, T, rng=rng)
    seg_la4 = np.zeros_like(seg4)
    seg_la4[seg4 == 4] = 1
    seg_la4[seg4 == 5] = 2
    la2_img, seg_la2 = la_phantom(X, Y, T, n_class=2, rng=rng)
    _save(d, "sa.nii.gz", sa_img, AFFINE_SA)
    _save(d, "la_4ch.nii.gz", la4_img, AFFINE_LA)
    _save(d, "la_2ch.nii.gz", la2_img, AFFINE_LA)
    if with_seg:
        _save(d, "seg_sa.nii.gz", sa_seg.astype(np.float64), AFFINE_SA)
        es = int(np.argmin(np.sum(sa_seg == 1, axis=(0, 1, 2))))
        for name, fr in (("ED", 0), ("ES", es)):
            _save(d, f"sa_{name}.nii.gz", sa_img[:, :, :, fr], AFFINE_SA)
            _save(d, f"seg_sa_{name}.nii.gz",
                  sa_seg[:, :, :, fr].astype(np.float64), AFFINE_SA)
        _save(d, "seg4_la_4ch.nii.gz", seg4.astype(np.float64), AFFINE_LA)
        _save(d, "seg4_la_4ch_ED.nii.gz", seg4[:, :, :, 0].astype(np.float64),
              AFFINE_LA)
        _save(d, "seg_la_4ch.nii.gz", seg_la4.astype(np.float64), AFFINE_LA)
        _save(d, "seg_la_2ch.nii.gz", seg_la2.astype(np.float64), AFFINE_LA)
    return {"la_2ch": seg_la2, "la_4ch": seg_la4, "seg4": seg4}


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_la") / "1000001"
    write_full_subject(str(d), 0)
    return d


def _read(path):
    return np.asanyarray(nifti.load(str(path)).dataobj)


def _dice(a, b, label):
    a, b = a == label, b == label
    return 2.0 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1)


@pytest.mark.parametrize("seq, seg4, key", [("la_2ch", False, "la_2ch"),
                                            ("la_4ch", False, "la_4ch"),
                                            ("la_4ch", True, "seg4")])
def test_la_deploys_match_jax(tmp_path, seq, seg4, key):
    """The trained LA bundles (2, 3 and 6 classes) through both deploys:
    seg NIfTIs byte for byte, ES by the view's rule (argmax of the LA
    count, argmin of the LV count for seg4), labels near the truth."""
    ref, port = tmp_path / "jax", tmp_path / "port"
    truth = write_full_subject(str(ref / "1000001"), 3, with_seg=False)[key]
    shutil.copytree(ref, port)
    bundle = os.path.join(WEIGHTS, BUNDLES[key])
    jax_deploy(bundle, str(ref), seq_name=seq, seg4=seg4)
    deploy_network.main(["--seq_name", seq, "--data_dir", str(port),
                         "--model_path", bundle, "--device", "cpu"]
                        + (["--seg4"] if seg4 else []))
    prefix = "seg4" if seg4 else "seg"
    names = [f"{prefix}_{seq}.nii.gz"] + [
        f"{stem}_{fr}.nii.gz" for stem in (seq, f"{prefix}_{seq}")
        for fr in ("ED", "ES")]
    for name in names:
        assert ((port / "1000001" / name).read_bytes()
                == (ref / "1000001" / name).read_bytes()), name
    seg = _read(port / "1000001" / f"{prefix}_{seq}.nii.gz")
    for label in range(1, int(truth.max()) + 1):
        assert _dice(seg, truth, label) >= 0.9, label


def test_seg4_packs_four_bits_in_the_jax_layout(subject):
    """Six classes take 4-bit fields, low field first: the packed bytes of
    a seg4 cine are the JAX engine's packing of the same labels, taken in
    the NIfTI file's voxel order."""
    engine = InferenceEngine(load_segmentation_model(
        os.path.join(WEIGHTS, BUNDLES["seg4"]), "cpu"))
    cine = _read(subject / "la_4ch.nii.gz")
    pending = engine.segment_sequence_dispatch(cine)
    labels = pending.result()
    assert pending._bits == 4 and int(labels.max()) == 5
    # the voxels in the NIfTI file's order, x fastest
    flat = labels.ravel(order="F").astype(np.uint8)
    flat = np.concatenate([flat, np.zeros(-flat.size % 2, np.uint8)])
    want = (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8)
    np.testing.assert_array_equal(pending._packed.numpy(), want)
    np.testing.assert_array_equal(
        pack_bits(torch.from_numpy(flat), 4).numpy(), want)
    jlabels = JEngine(jax_load(os.path.join(
        WEIGHTS, BUNDLES["seg4"]))).segment_sequence_dispatch(
            cine, rescale="percentile").result()
    np.testing.assert_array_equal(labels, jlabels)


def test_la_and_atrium_qc_match_jax(subject):
    seg4 = _read(subject / "seg4_la_4ch.nii.gz")
    assert tqc.la_pass_quality_control(seg4) is jqc.la_pass_quality_control(
        seg4) is True
    path = str(subject / "seg4_la_4ch_ED.nii.gz")
    assert tqc.la_pass_quality_control(path) is True
    no_ra = np.where(seg4 == 5, 0, seg4)
    thin = np.where(seg4 == 2, 1, seg4)              # no myocardium left
    for bad in (no_ra, thin):
        assert (tqc.la_pass_quality_control(bad)
                is jqc.la_pass_quality_control(bad) is False)

    la4 = _read(subject / "seg_la_4ch.nii.gz")
    chambers = {"LA": 1, "RA": 2}
    assert (tqc.atrium_pass_quality_control(la4, chambers)
            is jqc.atrium_pass_quality_control(la4, chambers) is True)
    empty = la4.copy()
    empty[..., 2][empty[..., 2] == 2] = 0            # RA gone at frame 2
    split = la4.copy()
    split[2:8, 2:8, 0, 1] = 1                        # a second LA component
    jump = la4.copy()
    jump[..., 3][jump[..., 3] == 1] = 0
    jump[40:47, 40:47, 0, 3] = 1                     # LA area drops >2x
    for bad in (empty, split, jump):
        assert (tqc.atrium_pass_quality_control(bad, chambers)
                is jqc.atrium_pass_quality_control(bad, chambers) is False)


def test_atrial_volumes_match_jax(subject, tmp_path):
    ref, port = tmp_path / "jax", tmp_path / "port"
    for d in (ref, port):
        shutil.copytree(subject, d / subject.name)
    want = jatrium.atrial_volume_measures(str(ref / subject.name))
    got = tatrium.atrial_volume_measures(str(port / subject.name))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert np.isfinite(list(got.values())).all()
    for name in ("lm_la_2ch_00.vtk", "lm_la_4ch_00.vtk"):
        assert filecmp.cmp(ref / subject.name / name,
                           port / subject.name / name, shallow=False), name

    jatrium.evaluate_atrial_volume_dataset(str(ref), str(tmp_path / "j.csv"))
    tcli_atrial.main(["--data_dir", str(port), "--output_csv",
                      str(tmp_path / "t.csv")])
    got = pd.read_csv(tmp_path / "t.csv", index_col=0)
    want = pd.read_csv(tmp_path / "j.csv", index_col=0)
    assert list(got.columns) == list(want.columns) == tatrium.COLUMNS
    assert list(got.index) == list(want.index) == [1000001]
    np.testing.assert_allclose(got.values, want.values, rtol=1e-6)


def _within_la_bounds(got, want):
    assert got.shape == want.shape
    diff = np.abs(np.asarray(got, float) - np.asarray(want, float))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.nanmax(diff) <= LA_STRAIN_SEGMENT_ATOL, np.nanmax(diff)
    return diff


def test_la_strain_matches_jax(subject, tmp_path):
    out = {}
    for tag, fn, kw in (("jax", jla.cine_2d_la_motion_and_strain_analysis,
                         {}),
                        ("port", tla.cine_2d_la_motion_and_strain_analysis,
                         {"device": "cpu"})):
        motion = tmp_path / tag
        motion.mkdir()
        dice = fn(str(subject), str(motion), str(tmp_path / f"{tag}_strain"),
                  eval_dice=True, **kw)
        out[tag] = (pd.read_csv(tmp_path / f"{tag}_strain_longit.csv",
                                index_col=0), dice.values, motion)
    (got, gdice, gm), (want, wdice, wm) = out["port"], out["jax"]
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    diff = _within_la_bounds(got.values, want.values)
    assert diff[-1].max() <= LA_STRAIN_GLOBAL_ATOL, diff[-1]
    assert (got.loc["Global"].values[1:] < 0).all()
    np.testing.assert_allclose(gdice, wdice, atol=LA_DICE_ATOL, rtol=0)
    assert gdice[:, 0].mean() > 0.9
    # the ED contour is host code: the same bytes
    assert filecmp.cmp(gm / "la_4ch_myo_contour_ED.vtk",
                       wm / "la_4ch_myo_contour_ED.vtk", shallow=False)
    assert sorted(os.listdir(gm)) == sorted(os.listdir(wm))


def test_la_strain_cli_matches_jax(tmp_path):
    tables = {}
    for tag, cli, extra in (("jax", jcli_lax, []),
                            ("port", tcli_lax, ["--device", "cpu"])):
        data = tmp_path / tag
        for i, eid in enumerate(("77", "78")):
            write_full_subject(str(data / eid), i, T=4)
        (data / "79").mkdir()                        # no seg: skipped
        cli.main(["--data_dir", str(data), "--output_csv",
                  str(tmp_path / f"{tag}.csv")] + extra)
        tables[tag] = pd.read_csv(tmp_path / f"{tag}.csv", index_col=0)
        assert not (data / "77" / "cine_motion").exists()
    got, want = tables["port"], tables["jax"]
    assert list(got.columns) == list(want.columns) == tcli_lax.COLUMNS
    assert list(got.index) == list(want.index) == [77, 78]
    _within_la_bounds(got.values, want.values)


def test_la_strain_cli_on_a_cpu_mesh_matches_one_device(tmp_path):
    """``--device cpu --mesh_devices 2`` splits the pairs over two CPU
    replicas: the table equals the one-device run's."""
    tables = {}
    for tag, extra in (("one", []), ("mesh", ["--mesh_devices", "2"])):
        write_full_subject(str(tmp_path / tag / "77"), 0, T=4)
        tcli_lax.main(["--data_dir", str(tmp_path / tag), "--output_csv",
                       str(tmp_path / f"{tag}.csv"), "--device", "cpu"]
                      + extra)
        tables[tag] = pd.read_csv(tmp_path / f"{tag}.csv", index_col=0)
    assert tables["mesh"].shape == (1, 7)
    np.testing.assert_array_equal(tables["mesh"].values, tables["one"].values)


def test_la_strain_raises_without_card_and_for_mesh(subject, monkeypatch,
                                                    tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # a mesh of cards without a card raises; it never becomes a CPU mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli_lax.main(["--data_dir", str(tmp_path), "--output_csv",
                       str(tmp_path / "o.csv"), "--mesh_devices", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli_lax.main(["--data_dir", str(tmp_path), "--output_csv",
                       str(tmp_path / "o.csv")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tla.start_la_motion_dispatch(str(subject), str(tmp_path))


def test_full_cohort_cli_matches_jax(tmp_path):
    """Two complete subjects (truth segs present, so the deploys skip)
    through the JAX package's ``run_cohort_full`` and the port's cohort
    CLI in full mode: every table within its bound."""
    ref, port = tmp_path / "jax", tmp_path / "port"
    for i, eid in enumerate(("1000001", "1000002")):
        write_full_subject(str(ref / eid), i)
    shutil.copytree(ref, port)
    engines = {k: JEngine(jax_load(os.path.join(WEIGHTS, b)))
               for k, b in BUNDLES.items()}
    jres = jax_run_cohort_full(str(ref), engines, workers=2,
                               output_dir=str(tmp_path / "jax_csv"),
                               verbose=False)
    assert len(jres.fleet.succeeded) == 2
    rc = run_cohort.main(
        ["--data_dir", str(port), "--output_dir", str(tmp_path / "port_csv"),
         "--workers", "2", "--device", "cpu"]
        + [x for k, flag in (("sa", "--model_path"),
                             ("la_2ch", "--model_path_la_2ch"),
                             ("la_4ch", "--model_path_la_4ch"),
                             ("seg4", "--model_path_seg4"))
           for x in (flag, os.path.join(WEIGHTS, BUNDLES[k]))])
    assert rc == 0

    def table(tag, name):
        return pd.read_csv(tmp_path / f"{tag}_csv" / name,
                           index_col=0).sort_index()

    assert sorted(os.listdir(tmp_path / "port_csv")) == sorted(
        os.listdir(tmp_path / "jax_csv")) == [
            "table_atrial_volume.csv", "table_strain_lax.csv",
            "table_strain_sax.csv", "table_ventricular_volume.csv",
            "table_wall_thickness.csv", "table_wall_thickness_max.csv"]
    got, want = (table(t, "table_ventricular_volume.csv")
                 for t in ("port", "jax"))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    for name in ("table_wall_thickness.csv", "table_wall_thickness_max.csv",
                 "table_atrial_volume.csv"):
        got, want = table("port", name), table("jax", name)
        assert list(got.columns) == list(want.columns)
        assert list(got.index) == list(want.index) == [1000001, 1000002]
        np.testing.assert_allclose(got.values, want.values, rtol=1e-6)
    got, want = table("port", "table_strain_sax.csv"), table(
        "jax", "table_strain_sax.csv")
    diff = np.abs(got.values - want.values)
    assert np.nanmax(diff) <= SA_STRAIN_SEGMENT_ATOL
    assert diff[:, [16, 33]].max() <= SA_STRAIN_GLOBAL_ATOL
    got, want = table("port", "table_strain_lax.csv"), table(
        "jax", "table_strain_lax.csv")
    assert got.shape == (2, 7) and list(got.columns) == list(want.columns)
    diff = _within_la_bounds(got.values, want.values)
    assert diff[:, -1].max() <= LA_STRAIN_GLOBAL_ATOL
    assert (got["Ell_Global (%)"] < 0).all()
