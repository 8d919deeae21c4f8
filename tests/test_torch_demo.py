"""The port's ``cli/demo_pipeline`` against the JAX package's.

Both demos run their nine stages on the same phantom subjects with the
same tiny bundles (random weights made by the JAX package, read by both),
the port on the CPU: every seg NIfTI is byte-identical and the volume,
wall-thickness and atrial tables identical; the aortic-area table agrees
at rtol 1e-6 (the CPU tests' bound on area rows, ``tests/test_torch_ao.py``;
random weights' segmentations fail the aortic QC gate, so it may hold no
row).
With segmentations that pass the QC gates, the port's demo runs the SA
strain stage for real.  ``--download`` is tested with the fetch stubbed:
the same URLs and layout as the JAX package's, each file fetched once.
"""

import os
import shutil
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from ukbb_cardiac_tpu.cli import demo_pipeline as jdemo
from ukbb_cardiac_tpu.io import nifti
from ukbb_cardiac_tpu_torch.cli import demo_pipeline as tdemo

from phantom import write_subject
from test_demo_pipeline import _tiny_models

torch.set_num_threads(1)

SEGS = ("seg_sa.nii.gz", "seg_sa_ED.nii.gz", "seg_sa_ES.nii.gz",
        "seg_la_2ch.nii.gz", "seg_la_4ch.nii.gz", "seg4_la_4ch.nii.gz",
        "seg_ao.nii.gz")
PRESSURE_COLUMN = "Central pulse pressure during PWA"


def _pressures(csv_dir, eids):
    os.makedirs(csv_dir, exist_ok=True)
    cols = pd.MultiIndex.from_tuples([(PRESSURE_COLUMN, "12678-2.0"),
                                      (PRESSURE_COLUMN, "12678-2.1")])
    pd.DataFrame([[45.0 + i, 47.0 + i] for i in range(len(eids))],
                 index=pd.Index([int(e) for e in eids], name="eid"),
                 columns=cols).to_csv(
        os.path.join(csv_dir, "blood_pressure_info.csv"))


def test_demo_matches_jax(tmp_path):
    models = str(tmp_path / "trained_model")
    _tiny_models(models)
    runs = {}
    for tag in ("jax", "port"):
        data = tmp_path / tag / "demo_image"
        for i in (1, 2):
            write_subject(str(data / str(i)),
                          seqs=("sa", "la_2ch", "la_4ch", "ao"),
                          X=64, Y=64, Z=4, T=4, rng=np.random.RandomState(i))
        csv = tmp_path / tag / "demo_csv"
        _pressures(str(csv), ("1", "2"))
        runs[tag] = (data, csv)
    jdemo.main(["--data_dir", str(runs["jax"][0]), "--model_dir", models,
                "--csv_dir", str(runs["jax"][1]), "--skip_strain"])
    stages = tdemo.main(["--data_dir", str(runs["port"][0]),
                         "--model_dir", models, "--csv_dir",
                         str(runs["port"][1]), "--skip_strain",
                         "--device", "cpu"])
    assert list(stages) == ["deploy_sa", "ventricular_volume",
                            "wall_thickness", "deploy_la", "atrial_volume",
                            "deploy_ao", "aortic_area"]
    for i in ("1", "2"):
        for name in SEGS:
            assert (runs["jax"][0] / i / name).read_bytes() == \
                (runs["port"][0] / i / name).read_bytes(), (i, name)
    for name in ("table_ventricular_volume.csv", "table_wall_thickness.csv",
                 "table_atrial_volume.csv"):
        assert (runs["jax"][1] / name).read_bytes() == \
            (runs["port"][1] / name).read_bytes(), name
    want = pd.read_csv(runs["jax"][1] / "table_aortic_area.csv", index_col=0)
    got = pd.read_csv(runs["port"][1] / "table_aortic_area.csv", index_col=0)
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-6)


def test_demo_runs_sa_strain_on_quality_segmentations(tmp_path):
    """Segmentations already present (the deploy's idempotent skip) pass
    the QC gates, so the SA strain stage runs and writes its table."""
    data, models = tmp_path / "demo_image", str(tmp_path / "trained_model")
    sub = data / "1"
    write_subject(str(sub), seqs=("sa", "la_2ch", "la_4ch", "ao"),
                  X=96, Y=96, Z=8, T=6, with_seg=True)
    for name in ("sa", "seg_sa"):
        nim = nifti.load(str(sub / f"{name}.nii.gz"))
        nifti.save(nifti.Nifti1Image(np.asanyarray(nim.dataobj)[:, :, :, 0],
                                     nim.affine),
                   str(sub / f"{name}_ED.nii.gz"))
    for name in ("la_2ch", "la_4ch", "ao"):     # leave the LA / aortic
        os.remove(str(sub / f"seg_{name}.nii.gz"))   # deploys their work
    _tiny_models(models)
    csv = tmp_path / "demo_csv"
    stages = tdemo.main(["--data_dir", str(data), "--model_dir", models,
                         "--csv_dir", str(csv), "--device", "cpu"])
    assert "strain_sax" in stages and "strain_lax" in stages
    df = pd.read_csv(csv / "table_strain_sax.csv", index_col=0)
    assert len(df) == 1 and np.isfinite(df["Ecc_Global (%)"].values).all()
    assert not (csv / "table_aortic_area.csv").exists()   # no pressures


def test_demo_needs_a_card_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models = str(tmp_path / "m")
    _tiny_models(models)
    write_subject(str(tmp_path / "d" / "1"), X=64, Y=64, Z=2, T=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdemo.main(["--data_dir", str(tmp_path / "d"), "--model_dir",
                    models, "--csv_dir", str(tmp_path / "c")])
    with pytest.raises(FileNotFoundError, match="no model FCN_x"):
        tdemo.resolve_model(models, "FCN_x")


class _Stopped(Exception):
    pass


def _stop_at_model(model_dir, name):
    raise _Stopped(name)


def test_download_contract_stubbed(tmp_path, monkeypatch):
    """The same URLs, destinations and idempotency as the JAX package's
    ``download_demo_data``, with ``urlretrieve`` stubbed (nothing is
    fetched)."""
    fetched = []

    def fake_urlretrieve(url, dest):
        fetched.append((url, os.path.relpath(dest, str(tmp_path))))
        with open(dest, "wb") as f:
            f.write(b"stub")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    calls = {}
    for tag, mod in (("jax", jdemo), ("port", tdemo)):
        fetched.clear()
        root = tmp_path / tag
        mod.download_demo_data(str(root / "img"), str(root / "model"),
                               str(root / "csv"))
        calls[tag] = [(u, d.split(os.sep, 1)[1]) for u, d in fetched]
    assert tdemo.URL_BASE == jdemo.URL_BASE
    assert tdemo.DEMO_MODELS == jdemo.DEMO_MODELS
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 24
    fetched.clear()
    root = tmp_path / "port"
    tdemo.download_demo_data(str(root / "img"), str(root / "model"),
                             str(root / "csv"))
    assert fetched == []
    # --download goes through the same fetch before the stages
    fetched.clear()
    shutil.rmtree(str(root / "img" / "2"))
    monkeypatch.setattr(tdemo, "resolve_model", _stop_at_model)
    with pytest.raises(_Stopped, match="FCN_sa"):
        tdemo.main(["--download", "--data_dir", str(root / "img"),
                    "--model_dir", str(root / "model"), "--csv_dir",
                    str(root / "csv"), "--device", "cpu"])
    assert [u for u, _ in fetched] == [
        f"{tdemo.URL_BASE}demo_image/2/{s}.nii.gz"
        for s in ("sa", "la_2ch", "la_4ch", "ao")]
