"""The port's cohort driver (``parallel/``, ``cli/run_cohort.py``) against
the JAX package's, end to end on the CPU; the thread safety of the
kernels' first use and launch counters.

The tiny FCN of ``tests/test_cohort.py`` goes into an npz bundle that
both packages load; 3 SA phantom subjects (64², Z = 8, T = 6) are copied
twice and each package's ``run_cohort_sa`` runs on one copy.  Volume
tables must be identical, wall thickness within rtol 1e-6, and SA strain
within the bounds ``tests/test_torch_strain.py`` measured (Adam turns
float noise into steps of up to lr).
"""

import json
import os
import shutil
import sys
import threading
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from phantom import ao_phantom, write_subject
from ukbb_cardiac_tpu.ckpt import store as jstore
from ukbb_cardiac_tpu.infer.deploy import \
    load_segmentation_model as jax_load
from ukbb_cardiac_tpu.infer.engine import InferenceEngine as JEngine
from ukbb_cardiac_tpu.io import nifti
from ukbb_cardiac_tpu.models import fcn as jfcn
from ukbb_cardiac_tpu.parallel import run_cohort_sa as jax_run_cohort_sa
from ukbb_cardiac_tpu_torch import kernels
from ukbb_cardiac_tpu_torch.cli import run_cohort
from ukbb_cardiac_tpu_torch.infer.deploy import \
    load_segmentation_model as port_load
from ukbb_cardiac_tpu_torch.infer.deploy_ao import load_aortic_engine
from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine as TEngine
from ukbb_cardiac_tpu_torch.parallel import cohort as tcohort
from ukbb_cardiac_tpu_torch.parallel import run_cohort_full, run_cohort_sa
from ukbb_cardiac_tpu_torch.parallel.fleet import run_fleet, shard_subjects
from ukbb_cardiac_tpu_torch.reg import register as treg

torch.set_num_threads(1)

# tests/test_torch_strain.py: the port's SA strain is 0.67 / 0.07 points
# from the JAX package's on its phantom; the JAX package itself moves
# 0.39 / 0.018 under 1e-7 relative input noise
STRAIN_SEGMENT_ATOL = 2.0
STRAIN_GLOBAL_ATOL = 0.5
SA_STAGES = {"segment", "volumes", "wall_thickness", "strain"}
AO_BUNDLE = os.path.join(os.path.dirname(__file__), "fixtures",
                         "bench_weights", "UNet-LSTM_ao.npz")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The tiny FCN of tests/test_cohort.py as an npz bundle."""
    cfg = jfcn.FCNConfig(n_class=4, n_level=3, n_filter=(2, 4, 4),
                         n_block=(1, 1, 1), same_dim=4, fc=4)
    p, s, n = jfcn.init_fcn(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path_factory.mktemp("cohort_bundle") / "fcn.npz")
    jstore.save_model(path, "fcn", cfg, n, p, s, {})
    return path


@pytest.fixture(scope="module")
def engines(bundle):
    return (JEngine(jax_load(bundle)), TEngine(port_load(bundle, "cpu")))


def _cohort(root, n, with_seg=True, T=6):
    for i in range(n):
        d = os.path.join(root, f"subj{i:02d}")
        write_subject(d, seqs=("sa",), X=64, Y=64, Z=8, T=T,
                      with_seg=with_seg, rng=np.random.RandomState(i))
        if with_seg:
            # the deploy stage would write the ED/ES extracts; mirror it
            nim = nifti.load(os.path.join(d, "seg_sa.nii.gz"))
            seg = np.asanyarray(nim.dataobj)
            es = int(np.argmin(np.sum(seg == 1, axis=(0, 1, 2))))
            for name, fr in (("ED", 0), ("ES", es)):
                nifti.save(nifti.Nifti1Image(seg[:, :, :, fr], nim.affine),
                           os.path.join(d, f"seg_sa_{name}.nii.gz"))
    return root


def _twin(tmp_path, n, with_seg=True):
    ref = _cohort(str(tmp_path / "jax"), n, with_seg=with_seg)
    port = str(tmp_path / "port")
    shutil.copytree(ref, port)
    return ref, port


def _csv(root, name):
    return pd.read_csv(os.path.join(root, name), index_col=0)


def test_run_cohort_sa_matches_jax(tmp_path, engines):
    ref, port = _twin(tmp_path, 3)
    jres = jax_run_cohort_sa(ref, engines[0], workers=2,
                             output_dir=str(tmp_path / "jax_csv"),
                             verbose=False)
    tres = run_cohort_sa(port, engines[1], workers=2, device="cpu",
                         output_dir=str(tmp_path / "port_csv"),
                         verbose=False)
    assert sorted(tres.fleet.succeeded) == sorted(jres.fleet.succeeded) == [
        "subj00", "subj01", "subj02"]
    assert not tres.fleet.failed
    for stages in tres.stage_seconds.values():
        assert set(stages) == SA_STAGES
    assert tres.subjects_per_s > 0
    j_csv, t_csv = str(tmp_path / "jax_csv"), str(tmp_path / "port_csv")
    assert sorted(os.listdir(t_csv)) == sorted(os.listdir(j_csv))
    # rows come in the order the workers finish: compare by subject
    got, want = ((tmp_path / d / "table_ventricular_volume.csv")
                 .read_text().splitlines() for d in ("port_csv", "jax_csv"))
    assert got[0] == want[0] and sorted(got[1:]) == sorted(want[1:])
    assert len(got) == 4
    for name in ("table_wall_thickness.csv", "table_wall_thickness_max.csv"):
        got, want = _csv(t_csv, name).sort_index(), _csv(j_csv, name).sort_index()
        assert list(got.columns) == list(want.columns)
        assert list(got.index) == list(want.index)
        np.testing.assert_allclose(got.values, want.values, rtol=1e-6)
    got, want = (_csv(d, "table_strain_sax.csv").sort_index()
                 for d in (t_csv, j_csv))
    assert got.shape == want.shape == (3, 34)
    assert list(got.columns) == list(want.columns)
    assert list(got.index) == list(want.index)
    diff = np.abs(got.values - want.values)
    assert np.nanmax(diff) <= STRAIN_SEGMENT_ATOL, np.nanmax(diff)
    glob = [want.columns.get_loc(c) for c in ("Ecc_Global (%)",
                                              "Err_Global (%)")]
    assert diff[:, glob].max() <= STRAIN_GLOBAL_ATOL, diff[:, glob]
    assert (got["Ecc_Global (%)"] < 0).all()
    # the cohort leaves no motion directory behind
    assert not os.path.exists(os.path.join(port, "subj00", "cine_motion"))


def test_failure_isolation_and_deploy_stage_match_jax(tmp_path, engines):
    """Without seg files the deploy stage segments for real (random
    weights: QC fails, so the volume row is made and strain is skipped);
    a broken subject fails alone.  The seg NIfTIs are the JAX package's
    byte for byte."""
    ref, port = _twin(tmp_path, 2, with_seg=False)
    for root in (ref, port):
        os.makedirs(os.path.join(root, "subj_bad"))
        with open(os.path.join(root, "subj_bad", "sa.nii.gz"), "wb") as f:
            f.write(b"not a nifti")
    jres = jax_run_cohort_sa(ref, engines[0], workers=2, verbose=False)
    tres = run_cohort_sa(port, engines[1], workers=2, device="cpu",
                         verbose=False)
    assert set(tres.fleet.succeeded) == set(jres.fleet.succeeded) == {
        "subj00", "subj01"}
    assert set(tres.fleet.failed) == set(jres.fleet.failed) == {"subj_bad"}
    assert tres.volume_rows.keys() == jres.volume_rows.keys()
    for subj in ("subj00", "subj01"):
        for name in ("seg_sa.nii.gz", "seg_sa_ED.nii.gz", "seg_sa_ES.nii.gz",
                     "sa_ED.nii.gz", "sa_ES.nii.gz"):
            with open(os.path.join(ref, subj, name), "rb") as f:
                want = f.read()
            with open(os.path.join(port, subj, name), "rb") as f:
                assert f.read() == want, (subj, name)
        # NaN measures (QC-failing segs) count as equal
        np.testing.assert_equal(tres.volume_rows[subj], jres.volume_rows[subj])


def test_cli_summary_manifest_and_exit_code(tmp_path, bundle, capsys):
    root = _cohort(str(tmp_path / "data"), 2, with_seg=False)
    os.makedirs(os.path.join(root, "subj_bad"))
    with open(os.path.join(root, "subj_bad", "sa.nii.gz"), "wb") as f:
        f.write(b"not a nifti")
    manifest = str(tmp_path / "manifest.json")
    args = ["--data_dir", root, "--model_path", bundle, "--output_dir",
            str(tmp_path / "csv"), "--workers", "2", "--manifest", manifest,
            "--device", "cpu"]
    assert run_cohort.main(args) == 1
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("cohort:")]
    assert len(line) == 1
    assert line[0].startswith("cohort: 2 succeeded, 1 failed, 0 skipped in ")
    assert line[0].endswith(" subjects/s)")
    m = json.load(open(manifest))
    assert set(m) == {"succeeded", "failed", "skipped", "seconds",
                      "wall_seconds", "stage_seconds"}
    assert set(m["failed"]) == {"subj_bad"}
    assert all(set(v) == SA_STAGES for v in m["stage_seconds"].values())
    assert os.path.exists(tmp_path / "csv" / "table_ventricular_volume.csv")

    # --start_idx/--end_idx shard the sorted subject list
    assert run_cohort.main(args + ["--start_idx", "1", "--end_idx",
                                   "2"]) == 0
    assert json.load(open(manifest))["succeeded"] == ["subj01"]


@pytest.mark.parametrize("extra, error, match", [
    # as the JAX CLI: pressures without the aortic model are a usage error
    (["--pressure_csv", "bp.csv"], SystemExit, "2"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, bundle, extra, error,
                                        match):
    with pytest.raises(error, match=match):
        run_cohort.main(["--data_dir", str(tmp_path), "--model_path", bundle,
                         "--output_dir", str(tmp_path / "csv"),
                         "--device", "cpu"] + extra)


def test_cli_mesh_devices_on_the_cpu_matches_one_device(tmp_path, bundle,
                                                       monkeypatch):
    """``--device cpu --mesh_devices 2`` splits each subject's strain pairs
    over two CPU replicas: every table equals the one-device run's.  A
    mesh of cards without a card raises."""
    for tag, extra in (("one", []), ("mesh", ["--mesh_devices", "2"])):
        _cohort(str(tmp_path / tag), 1)
        assert run_cohort.main(["--data_dir", str(tmp_path / tag),
                                "--model_path", bundle, "--output_dir",
                                str(tmp_path / f"{tag}_csv"), "--device",
                                "cpu"] + extra) == 0
    names = sorted(os.listdir(tmp_path / "one_csv"))
    assert names == sorted(os.listdir(tmp_path / "mesh_csv"))
    assert "table_strain_sax.csv" in names
    for name in names:
        assert ((tmp_path / "mesh_csv" / name).read_text()
                == (tmp_path / "one_csv" / name).read_text()), name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cohort.main(["--data_dir", str(tmp_path / "one"), "--model_path",
                         bundle, "--output_dir", str(tmp_path / "x"),
                         "--mesh_devices", "2"])


def _ao_only_subject(root, eid="1000001", T=3):
    """A subject with an aortic cine and nothing else: the SA and LA
    stages skip on the missing files, the aortic stage runs."""
    image, _ = ao_phantom(96, 96, T, rng=np.random.RandomState(0))
    d = os.path.join(root, eid)
    os.makedirs(d)
    hdr = nifti.Nifti1Header()
    hdr.dim[0] = 4
    hdr.dim[1:5] = image.shape
    hdr.pixdim[1:5] = (1.8, 1.8, 10.0, 0.04)
    nifti.save(nifti.Nifti1Image(np.round(image).astype(np.int16),
                                 np.diag([-1.8, -1.8, 10.0, 1.0]), hdr),
               os.path.join(d, "ao.nii.gz"))
    return d


@pytest.mark.parametrize("with_pressure", [False, True])
def test_cli_runs_the_aortic_flags(tmp_path, bundle, with_pressure):
    """``--model_path_ao`` alone selects full mode; with ``--pressure_csv``
    the distensibility columns are finite."""
    d = _ao_only_subject(str(tmp_path / "data"))
    extra = ["--model_path_ao", AO_BUNDLE]
    if with_pressure:
        bp = tmp_path / "bp.csv"
        col = "Central pulse pressure during PWA"
        bp.write_text(f"eid,{col},{col}\n,12678-2.0,12678-2.1\n"
                      f"1000001,40,44\n")
        extra += ["--pressure_csv", str(bp)]
    assert run_cohort.main(["--data_dir", str(tmp_path / "data"),
                            "--model_path", bundle, "--output_dir",
                            str(tmp_path / "csv"), "--device", "cpu"]
                           + extra) == 0
    assert os.path.exists(os.path.join(d, "seg_ao.nii.gz"))
    assert sorted(os.listdir(tmp_path / "csv")) == ["table_aortic_area.csv"]
    tab = pd.read_csv(tmp_path / "csv" / "table_aortic_area.csv",
                      index_col=0)
    assert tab.shape == (1, 6)
    assert np.isfinite(tab.values[0, [0, 1, 3, 4]]).all()
    assert np.isfinite(tab.values[0, [2, 5]]).all() == with_pressure


def test_cli_and_drivers_raise_without_card(tmp_path, bundle, engines,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cohort.main(["--data_dir", str(tmp_path), "--model_path", bundle,
                         "--output_dir", str(tmp_path / "csv")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cohort_sa(str(tmp_path), engines[1], verbose=False)


def test_full_mode_runs_the_aortic_stage(tmp_path, engines):
    """An ``'ao'`` engine and ``pressure=`` (eid -> central pulse
    pressure) give the aortic row; a subject without a pressure gets NaN
    distensibilities."""
    _ao_only_subject(str(tmp_path), "1000001")
    _ao_only_subject(str(tmp_path), "1000002")
    engine = load_aortic_engine(AO_BUNDLE, "cpu")
    res = run_cohort_full(str(tmp_path), {"sa": engines[1], "ao": engine},
                          pressure={1000001: 40.0}, device="cpu",
                          verbose=False)
    assert sorted(res.fleet.succeeded) == ["1000001", "1000002"]
    assert all("aortic" in st for st in res.stage_seconds.values())
    rows = res.aortic_rows
    assert np.isfinite(rows["1000001"]).all()
    assert np.isnan(np.asarray(rows["1000002"])[[2, 5]]).all()


def test_select_subjects_and_shards(tmp_path):
    for name in ("b", "a", "c"):
        os.makedirs(tmp_path / name)
    (tmp_path / "not_a_dir.txt").write_text("x")
    root = str(tmp_path)
    sel = tcohort._select_subjects
    assert sel(root, None, 0, -1) == ["a", "b", "c"]
    assert sel(root, None, 1, 2) == ["b"]
    assert sel(root, None, 2, 1) == []
    assert sel(root, ["z", "y"], 0, -1) == ["y", "z"]
    assert shard_subjects(["a", "b", "c", "d", "e"], 2, 1) == ["b", "d"]


def test_fleet_done_check_skips_and_failing_check_fails(tmp_path):
    seen = []
    res = run_fleet(["a", "b", "c"], seen.append, workers=2,
                    done_check=lambda s: {"a": True, "b": False}[s],
                    manifest_path=str(tmp_path / "m.json"), verbose=False)
    assert res.skipped == ["a"] and res.succeeded == ["b"]
    assert set(res.failed) == {"c"} and "KeyError" in res.failed["c"]
    assert seen == ["b"]
    assert json.load(open(tmp_path / "m.json"))["skipped"] == ["a"]


def test_registration_ignores_the_callers_inference_mode():
    """A worker's engine runs under ``torch.inference_mode()``; the
    registration records autograd whatever mode its caller entered."""
    rng = np.random.RandomState(0)
    tgt = rng.rand(2, 32, 32).astype(np.float32)
    src = np.roll(tgt, 1, axis=1)
    reg = treg.make_register_batch(
        (32, 32), treg.RegConfig(spacing=8, levels=2, iters=3), device="cpu")
    want = reg(tgt, src)
    with torch.inference_mode():
        got = reg(torch.from_numpy(tgt), torch.from_numpy(src))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --- the kernels' first use under threads ----------------------------------

class _FakeCompiler:
    """Stands in for ``subprocess.Popen`` of nvcc: records each command,
    takes a moment, and writes the ``-o`` file."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, cmd, **kwargs):
        with self.lock:
            self.calls.append(list(cmd))

        class Proc:
            returncode = 0

            def communicate(self):
                time.sleep(0.05)
                out = cmd[cmd.index("-o") + 1]
                assert not os.path.exists(out), "temporary file shared"
                with open(out, "w") as f:
                    f.write("lib")
                return "ptxas info    : Used 32 registers", None

        return Proc()


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    fake = _FakeCompiler()
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", fake)
    return fake


def _threads(fn, n):
    errors = []

    def run():
        try:
            fn()
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_build_from_threads_compiles_each_source_once(fake_build, tmp_path):
    _threads(kernels.build, 4)
    sources = sorted(os.path.basename(c[-1]) for c in fake_build.calls)
    assert sources == ["bspline_field.cu", "fused_head.cu"]
    tmps = [c[c.index("-o") + 1] for c in fake_build.calls]
    assert len(set(tmps)) == len(tmps)
    built = sorted(os.listdir(tmp_path / "kernels"))
    assert len(built) == 2 and not any(p.endswith(".tmp") for p in built)


def test_load_from_threads_builds_and_binds_once(fake_build, monkeypatch):
    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(kernels, "_LIBS", {})
    libs = []
    _threads(lambda: libs.append(kernels.load("fused_head")), 4)
    assert len(fake_build.calls) == 1 and len(opened) == 1
    assert all(lib is libs[0] for lib in libs)


def test_launch_counters_lose_no_counts_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.adjoint_launches = 0
    wrapper.launches_by_class = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(2000):
                kernels.count_launches(wrapper, 5, n_class=3)
                kernels.count_launches(wrapper, 1, "adjoint_launches")
        _threads(hammer, 16)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000 * 5
    assert wrapper.launches_by_class == {3: 16 * 2000 * 5}
    assert wrapper.adjoint_launches == 16 * 2000
