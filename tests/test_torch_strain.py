"""The port's SA wall thickness and strain (``phenotype/*``, ``cli/*``,
``io/vtkio.py``, ``ops/{cc,crop}.py``) against the JAX package's, end to
end on the CPU, on the ``tests/test_strain.py`` phantom (96x96x8x6).

Host stages (contours, AHA geometry, QC, wall thickness, VTK I/O) are
copies and must give the same bytes.  The strain tables come out of a
chain of Adam-optimised registrations, where float noise in a gradient
near zero moves a control by up to lr per step; their bounds are set
against the JAX package's own spread (see ``STRAIN_SEGMENT_ATOL``).
"""

import dataclasses
import filecmp
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ukbb_cardiac_tpu.cli import eval_strain_sax as jcli_strain
from ukbb_cardiac_tpu.cli import eval_wall_thickness as jcli_wt
from ukbb_cardiac_tpu.io import nifti
from ukbb_cardiac_tpu.io import vtkio as jvtk
from ukbb_cardiac_tpu.ops import cc as jcc
from ukbb_cardiac_tpu.ops.crop import foreground_bbox as jbbox
from ukbb_cardiac_tpu.phenotype import aha as jaha
from ukbb_cardiac_tpu.phenotype import contours as jcontours
from ukbb_cardiac_tpu.phenotype import strain as jstrain
from ukbb_cardiac_tpu.phenotype.qc import sa_pass_quality_control as jqc
from ukbb_cardiac_tpu.phenotype.wall_thickness import \
    evaluate_wall_thickness as jwt
from ukbb_cardiac_tpu.reg import RegConfig as JCfg
from ukbb_cardiac_tpu_torch.cli import eval_strain_sax as tcli_strain
from ukbb_cardiac_tpu_torch.cli import eval_wall_thickness as tcli_wt
from ukbb_cardiac_tpu_torch.io import vtkio as tvtk
from ukbb_cardiac_tpu_torch.ops import cc as tcc
from ukbb_cardiac_tpu_torch.ops.crop import foreground_bbox as tbbox
from ukbb_cardiac_tpu_torch.phenotype import aha as taha
from ukbb_cardiac_tpu_torch.phenotype import contours as tcontours
from ukbb_cardiac_tpu_torch.phenotype import strain as tstrain
from ukbb_cardiac_tpu_torch.phenotype.qc import \
    sa_pass_quality_control as tqc
from ukbb_cardiac_tpu_torch.phenotype.wall_thickness import \
    evaluate_wall_thickness as twt
from ukbb_cardiac_tpu_torch.reg.register import RegConfig as TCfg

from phantom import write_subject

torch.set_num_threads(1)

CFG = JCfg(spacing=8, levels=2, iters=30, lr=0.5, be_weight=1e-2)
# Measured on this phantom: the port's per-segment strain is 0.67
# percentage points from the JAX package's, its global strain 0.07.  The
# JAX package itself, fed the same cine plus 1e-4 of noise (1e-7 of the
# intensity range), moved 0.39 / 0.018, and with 1e-3 of noise 2.5 / 0.32
# -- the spread of an Adam run over float noise, not a fault of the port.
STRAIN_SEGMENT_ATOL = 2.0     # percentage points, per AHA segment and frame
STRAIN_GLOBAL_ATOL = 0.5      # percentage points, the Global rows
DICE_ATOL = 0.005             # measured 0.0033 (JAX itself: 0.0023 at 1e-4)


def _write_ed(subj):
    for name in ("sa", "seg_sa"):
        nim = nifti.load(str(subj / f"{name}.nii.gz"))
        data = np.asanyarray(nim.dataobj)
        nifti.save(nifti.Nifti1Image(data[:, :, :, 0], nim.affine),
                   str(subj / f"{name}_ED.nii.gz"))


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    subj = tmp_path_factory.mktemp("torch_strain") / "1000001"
    write_subject(str(subj), seqs=("sa",), X=96, Y=96, Z=8, T=6,
                  with_seg=True)
    _write_ed(subj)
    return subj


@pytest.fixture(scope="module")
def runs(subject, tmp_path_factory):
    """Both drivers once on the phantom, with eval_dice."""
    root = tmp_path_factory.mktemp("torch_strain_runs")
    out = {}
    for tag, fn, cfg, kw in (
            ("jax", jstrain.cine_2d_sa_motion_and_strain_analysis, CFG, {}),
            ("port", tstrain.cine_2d_sa_motion_and_strain_analysis,
             TCfg(**dataclasses.asdict(CFG)), {"device": "cpu"})):
        motion = root / tag
        motion.mkdir()
        df = fn(str(subject), str(motion), str(root / f"{tag}_strain"), cfg,
                eval_dice=True, **kw)
        out[tag] = {"motion": motion, "dice": df.values,
                    "stem": root / f"{tag}_strain"}
    return out


def test_ed_contour_vtks_identical(runs):
    names = sorted(p for p in os.listdir(runs["jax"]["motion"])
                   if p.startswith("myo_contour_ED_z"))
    assert len(names) == 3
    assert sorted(p for p in os.listdir(runs["port"]["motion"])) == sorted(
        os.listdir(runs["jax"]["motion"]))
    for name in names:
        assert filecmp.cmp(runs["jax"]["motion"] / name,
                           runs["port"]["motion"] / name, shallow=False), name


@pytest.mark.parametrize("kind", ["radial", "circum"])
def test_strain_tables_within_bound(runs, kind):
    ref = pd.read_csv(f"{runs['jax']['stem']}_{kind}.csv", index_col=0)
    got = pd.read_csv(f"{runs['port']['stem']}_{kind}.csv", index_col=0)
    assert list(got.index) == list(ref.index)
    assert list(got.columns) == list(ref.columns)
    diff = np.abs(got.values - ref.values)
    assert np.array_equal(np.isnan(got.values), np.isnan(ref.values))
    assert np.nanmax(diff) <= STRAIN_SEGMENT_ATOL, np.nanmax(diff)
    assert diff[-1].max() <= STRAIN_GLOBAL_ATOL, diff[-1]
    assert np.all(np.isfinite(got.loc["Global"].values))


def test_warp_dice_within_bound(runs):
    ref, got = runs["jax"]["dice"], runs["port"]["dice"]
    assert got.shape == ref.shape == (3 * 6, 2)
    np.testing.assert_allclose(got, ref, atol=DICE_ATOL, rtol=0)
    assert np.nanmean(got[:, 0]) > 0.9


def test_wall_thickness_identical(subject, tmp_path):
    seg = str(subject / "seg_sa_ED.nii.gz")
    jwt(seg, str(tmp_path / "jax_wt"))
    twt(seg, str(tmp_path / "port_wt"))
    for suffix in (".vtk", "_epi.vtk"):
        assert filecmp.cmp(tmp_path / f"jax_wt{suffix}",
                           tmp_path / f"port_wt{suffix}", shallow=False)
    for suffix in (".csv", "_max.csv"):
        ref = pd.read_csv(tmp_path / f"jax_wt{suffix}", index_col=0)
        got = pd.read_csv(tmp_path / f"port_wt{suffix}", index_col=0)
        assert list(got.index) == list(ref.index)
        np.testing.assert_allclose(got.values, ref.values, rtol=1e-6)


def test_wall_thickness_cli_matches_jax(subject, tmp_path):
    ref_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    for d in (ref_dir, port_dir):
        shutil.copytree(subject, d / subject.name)
    jcli_wt.main(["--data_dir", str(ref_dir),
                  "--output_csv", str(tmp_path / "jax.csv")])
    tcli_wt.main(["--data_dir", str(port_dir), "--output_csv",
                  str(tmp_path / "port.csv"), "--device", "cpu"])
    for name in ("jax.csv", "jax_max.csv"):
        ref = pd.read_csv(tmp_path / name, index_col=0)
        got = pd.read_csv(tmp_path / name.replace("jax", "port"), index_col=0)
        assert list(got.columns) == list(ref.columns)
        assert list(got.index) == list(ref.index) == [1000001]
        np.testing.assert_allclose(got.values, ref.values, rtol=1e-6)


def test_strain_cli_matches_jax(tmp_path):
    """Two subjects through both CLIs (the one-deep pipeline): the same
    Ecc/Err table schema, rows and subjects, values within the bound."""
    tables = {}
    for tag, cli, extra in (("jax", jcli_strain, []),
                            ("port", tcli_strain, ["--device", "cpu"])):
        data = tmp_path / tag
        for eid in ("77", "78"):
            write_subject(str(data / eid), seqs=("sa",), X=96, Y=96, Z=8,
                          T=4, with_seg=True)
            _write_ed(data / eid)
        cli.main(["--data_dir", str(data), "--output_csv",
                  str(tmp_path / f"{tag}.csv")] + extra)
        tables[tag] = pd.read_csv(tmp_path / f"{tag}.csv", index_col=0)
        assert not (data / "77" / "cine_motion").exists()
        assert (data / "77" / "strain_sa_radial.csv").exists()
    ref, got = tables["jax"], tables["port"]
    assert list(got.columns) == list(ref.columns)
    assert len(got.columns) == 34
    assert list(got.index) == list(ref.index) == [77, 78]
    diff = np.abs(got.values - ref.values)
    assert np.nanmax(diff) <= STRAIN_SEGMENT_ATOL, np.nanmax(diff)


def test_clis_raise_without_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--data_dir", str(tmp_path), "--output_csv",
            str(tmp_path / "out.csv")]
    for cli in (tcli_strain, tcli_wt):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args)
    # a mesh of cards without a card raises; it never becomes a CPU mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli_strain.main(args + ["--mesh_devices", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstrain.start_sa_motion_dispatch(str(tmp_path), str(tmp_path))


def test_strain_cli_on_a_cpu_mesh_matches_one_device(subject, tmp_path):
    """``--device cpu --mesh_devices 2`` splits each subject's pairs over
    two CPU replicas: the table equals the one-device run's."""
    tables = {}
    for tag, extra in (("one", []), ("mesh", ["--mesh_devices", "2"])):
        shutil.copytree(subject, tmp_path / tag / subject.name)
        tcli_strain.main(["--data_dir", str(tmp_path / tag), "--output_csv",
                          str(tmp_path / f"{tag}.csv"), "--device", "cpu"]
                         + extra)
        tables[tag] = pd.read_csv(tmp_path / f"{tag}.csv", index_col=0)
    assert tables["mesh"].shape == (1, 34)
    np.testing.assert_array_equal(tables["mesh"].values, tables["one"].values)


@pytest.mark.parametrize("exc, stops", [(ValueError("bad subject"), False),
                                        (RuntimeError("CUDA error"), True)])
def test_strain_cli_skips_bad_data_but_stops_on_device_errors(
        subject, tmp_path, monkeypatch, exc, stops):
    """A subject whose data fails is skipped and the run goes on; a
    RuntimeError (a kernel launch or CUDA failure) ends the run."""
    shutil.copytree(subject, tmp_path / "data" / subject.name)

    def fail(*args, **kwargs):
        raise exc

    monkeypatch.setattr(tcli_strain, "start_sa_motion_dispatch", fail)
    args = ["--data_dir", str(tmp_path / "data"), "--output_csv",
            str(tmp_path / "out.csv"), "--device", "cpu"]
    if stops:
        with pytest.raises(RuntimeError, match="CUDA error"):
            tcli_strain.main(args)
        assert not (tmp_path / "out.csv").exists()
    else:
        tcli_strain.main(args)
        assert len(pd.read_csv(tmp_path / "out.csv", index_col=0)) == 0
        assert not (tmp_path / "data" / subject.name / "cine_motion").exists()


def test_host_stages_match_jax(subject):
    """QC gate, connected components, bounding box, contours and AHA axes:
    copies, so identical results."""
    seg = np.asanyarray(nifti.load(str(subject / "seg_sa_ED.nii.gz")).dataobj)
    assert tqc(seg) is jqc(seg) is True
    broken = seg.copy()
    broken[:, :, 3] = 0                          # a gap between LV slices
    assert tqc(broken) is jqc(broken) is False
    rng = np.random.RandomState(0)
    for _ in range(5):
        mask = rng.rand(40, 44) > 0.55
        np.testing.assert_array_equal(tcc.get_largest_cc(mask),
                                      jcc.get_largest_cc(mask))
        np.testing.assert_array_equal(tcc.remove_small_cc(mask, 5),
                                      jcc.remove_small_cc(mask, 5))
        for conn in (1, 2):
            assert (tcc.count_significant_cc(mask, 4, conn)
                    == jcc.count_significant_cc(mask, 4, conn))
    assert tbbox(seg, 20) == jbbox(seg, 20)
    affine = nifti.load(str(subject / "seg_sa_ED.nii.gz")).affine
    for z in (2, 5):
        endo, _, epi = tcontours.lv_slice_masks(seg[:, :, z])
        for m in (endo, epi):
            np.testing.assert_array_equal(tcontours.extract_contour(m),
                                          jcontours.extract_contour(m))
    t_axis = taha.determine_aha_coordinate_system(seg, affine)
    j_axis = jaha.determine_aha_coordinate_system(seg, affine)
    for k in j_axis:
        np.testing.assert_array_equal(t_axis[k], j_axis[k])
    assert (taha.determine_aha_part(seg, affine, three_slices=True)
            == jaha.determine_aha_part(seg, affine, three_slices=True))


def test_vtkio_writes_the_same_bytes(tmp_path):
    rng = np.random.RandomState(1)
    poly = dict(points=rng.randn(7, 3),
                lines=[np.array([i, (i + 1) % 7]) for i in range(7)],
                point_scalars={"Label": np.arange(7, dtype=np.int32)},
                point_vectors={"Dir": rng.randn(7, 3)},
                cell_scalars={"Strain": rng.randn(7)})
    for ascii_ in (False, True):
        jvtk.save_polydata(jvtk.PolyData(**poly), str(tmp_path / "j.vtk"),
                           ascii=ascii_)
        tvtk.save_polydata(tvtk.PolyData(**poly), str(tmp_path / "t.vtk"),
                           ascii=ascii_)
        assert ((tmp_path / "j.vtk").read_bytes()
                == (tmp_path / "t.vtk").read_bytes())
        back = tvtk.load_polydata(str(tmp_path / "t.vtk"))
        np.testing.assert_allclose(back.points, poly["points"], atol=1e-6)
    merged = tvtk.append_polydata([tvtk.PolyData(**poly)] * 2)
    ref = jvtk.append_polydata([jvtk.PolyData(**poly)] * 2)
    np.testing.assert_array_equal(np.asarray(merged.lines),
                                  np.asarray(ref.lines))
    np.testing.assert_array_equal(merged.points, ref.points)


def test_strain_by_length_matches_jax(tmp_path):
    pts = np.array([[0, 0, 0], [10, 0, 0], [10, 10, 0], [0, 10, 0]], float)
    lines = [np.array([0, 1]), np.array([1, 2]), np.array([2, 3])]
    cells = {"Segment_ID": np.array([1, 1, 2], np.int32),
             "Direction_ID": np.array([1, 2, 2], np.int32)}
    for tag, vtk, fn in (("j", jvtk, jstrain.evaluate_strain_by_length),
                         ("t", tvtk, tstrain.evaluate_strain_by_length)):
        stem = str(tmp_path / f"{tag}_fr")
        for fr, scale in enumerate((1.0, 1.1, 0.95)):
            vtk.save_polydata(vtk.PolyData(points=pts * scale, lines=lines,
                                           cell_scalars=dict(cells)),
                              f"{stem}{fr:02d}.vtk")
        fn(stem, 3, 0.03, str(tmp_path / f"{tag}_out"))
    for kind in ("radial", "circum"):
        assert ((tmp_path / f"t_out_{kind}.csv").read_text()
                == (tmp_path / f"j_out_{kind}.csv").read_text())
    for fr in range(3):
        assert filecmp.cmp(tmp_path / f"t_fr{fr:02d}.vtk",
                           tmp_path / f"j_fr{fr:02d}.vtk", shallow=False)


def _fields(shape, amp, seed):
    rng = np.random.RandomState(seed)
    *lead, X, Y = shape
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    out = np.zeros(tuple(lead) + (X, Y, 2), np.float32)
    for idx in np.ndindex(*lead):
        for k in range(2):
            a, b, p = rng.uniform(0.05, 0.2, 3)
            out[idx + (Ellipsis, k)] = amp * np.sin(a * gx + b * gy + 6 * p)
    return out


def test_combine_fields_matches_jax():
    Z, T, X, Y = 2, 5, 20, 24
    fields = _fields((Z * T, X, Y), 1.5, 2)
    _, combine = jstrain._field_programs(Z, T, X, Y, CFG, True)
    ref = np.asarray(combine(jnp.asarray(fields)))
    got = tstrain.combine_fields(torch.from_numpy(fields), Z, T).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_point_sampler_and_warp_dice_match_jax():
    Zsel, T, X, Y, N = 3, 4, 24, 28, 20
    fields = _fields((Zsel, T, X, Y), 3.0, 3)
    rng = np.random.RandomState(4)
    pts = rng.uniform(-2, 30, (Zsel, N, 2)).astype(np.float32)
    ref = np.asarray(jstrain._sample_program(Zsel, T, X, Y, N)(
        jnp.asarray(fields), jnp.asarray(pts)))
    got = tstrain.sample_points(torch.from_numpy(fields),
                                torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    seg = np.zeros((Zsel, T, X, Y), np.int32)
    seg[:, :, 5:17, 6:20] = 2
    seg[:, :, 8:14, 9:17] = 1
    ref = np.asarray(jstrain._warp_dice_program(T, X, Y)(
        jnp.asarray(seg), jnp.asarray(fields), 21, 25))
    got = tstrain.warp_dice(torch.from_numpy(seg), torch.from_numpy(fields),
                            21, 25).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
