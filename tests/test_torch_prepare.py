"""The port's training-set preparation (``data/prepare.py``) and its three
ingestion CLIs (``cli/convert_data.py``, ``cli/prepare_data.py``,
``cli/download_data.py``) against the JAX package's.

The same seeded inputs go through both packages, each in its own copy of
the tree: ED/ES choices, NIfTI bytes, symlinks (by their target inside
the tree) and CSVs must be identical.  ``download_data`` runs against a
stub ``ukbfetch`` on ``PATH`` that serves local zips: nothing is
downloaded.
"""

import os
import shutil
import stat
import sys
import zipfile

import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.cli import convert_data as jconvert_cli
from ukbb_cardiac_tpu.cli import download_data as jdownload_cli
from ukbb_cardiac_tpu.cli import prepare_data as jprepare_cli
from ukbb_cardiac_tpu.data import dicom as jdicom
from ukbb_cardiac_tpu.data import prepare as jprepare
from ukbb_cardiac_tpu_torch.cli import convert_data, download_data, prepare_data
from ukbb_cardiac_tpu_torch.data import dicom, prepare
from ukbb_cardiac_tpu_torch.io import nifti

torch.set_num_threads(1)

AFFINE = np.diag([1.8, 1.8, 10.0, 1.0])


def _disk(X, Y, cx, cy, r):
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    return (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r


def _cine(seq, X=24, Y=24, Z=2, T=8, seed=0):
    """A contracting phantom cine and its labels with the classes of
    ``seq`` (sa: LV, myo, RV; la_2ch: LA; la_4ch: LA, RA)."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(X, Y, Z, T) * 50).astype(np.int16)
    seg = np.zeros((X, Y, Z, T), np.int16)
    for t in range(T):
        r = 6 * (1 - 0.3 * np.sin(np.pi * t / T))
        for z in range(Z):
            if seq == "sa":
                seg[..., z, t][_disk(X, Y, 12, 12, r + 2)] = 2
                seg[..., z, t][_disk(X, Y, 12, 12, r)] = 1
                seg[..., z, t][_disk(X, Y, 12, 21, 2)] = 3
            else:
                seg[..., z, t][_disk(X, Y, 9, 12, r * 0.8)] = 1
                if seq == "la_4ch":
                    seg[..., z, t][_disk(X, Y, 18, 12, 3)] = 2
    img[seg > 0] += 200 * seg[seg > 0]
    return img, seg


@pytest.mark.parametrize("case", ["sa_two", "sa_three", "la_2ch_three",
                                  "la_4ch_three", "no_ed", "ed_partial",
                                  "one_frame", "four_frames"])
def test_find_annotated_ed_es(case):
    seq = case.rsplit("_", 1)[0] if case.startswith("la") else "sa"
    _, seg = _cine(seq, seed=1)
    label = np.zeros_like(seg)
    frames = {"sa_two": (0, 4), "sa_three": (0, 4, 6),
              "la_2ch_three": (0, 3, 5), "la_4ch_three": (0, 2, 6),
              "no_ed": (4, 6), "ed_partial": (4, 6), "one_frame": (0,),
              "four_frames": (0, 2, 4, 6)}[case]
    for t in frames:
        label[..., t] = seg[..., t]
    if case == "ed_partial":
        label[..., 0] = (seg[..., 0] == 1)
    got = prepare.find_annotated_ed_es(label, seq)
    assert got == jprepare.find_annotated_ed_es(label, seq)
    assert (got is None) == (case in ("no_ed", "ed_partial", "one_frame"))


@pytest.mark.parametrize("seed,n_val,n_test", [(0, 20, 30), (3, 0, 10),
                                               (None, 5, 5)])
def test_split_dataset(seed, n_val, n_test):
    data = list(range(100, 200))
    icc = [103, 107, 199, 5000]
    if seed is None:
        got = prepare.split_dataset(data, n_val, n_test, icc, seed=7)
        assert got == jprepare.split_dataset(data, n_val, n_test, icc,
                                             seed=7)
        return
    got = prepare.split_dataset(data, n_val, n_test, icc, seed=seed)
    assert got == jprepare.split_dataset(data, n_val, n_test, icc, seed=seed)
    assert sorted(got["train"] + got["validation"] + got["test"]) == data
    assert {103, 107, 199} <= set(got["test"])


def _write_orig(root, n_subjects=4):
    """A converted tree as ``link_annotated_subjects`` finds it:
    <root>/<group>/<eid>/{seq, label_seq, label_up_seq}.nii.gz and
    <eid>_cvi42.zip for the annotated subjects; one subject blank, one
    not annotated, one without its LA views."""
    for k in range(n_subjects):
        eid = str(1000001 + k)
        d = os.path.join(root, f"g{k % 2}", eid)
        os.makedirs(d)
        if k != 1:
            open(os.path.join(d, f"{eid}_cvi42.zip"), "wb").close()
        for seq in ("sa", "la_2ch", "la_4ch"):
            if k == 3 and seq != "sa":
                continue
            img, seg = _cine(seq, seed=k)
            if k == 2:
                img[:] = 0
            label = np.zeros_like(seg)
            for t in (0, 3):
                label[..., t] = seg[..., t]
            up = np.repeat(np.repeat(label, 4, 0), 4, 1)
            for name, data, aff in (
                    (seq, img, AFFINE), (f"label_{seq}", label, AFFINE),
                    (f"label_up_{seq}", up,
                     AFFINE @ np.diag([0.25, 0.25, 1, 1]))):
                nifti.save(nifti.Nifti1Image(data, aff),
                           os.path.join(d, f"{name}.nii.gz"))


def _tree(root):
    """relative path → bytes, or ('link', target relative to ``root``)."""
    out = {}
    for d, dirs, files in os.walk(root):
        for f in files + [x for x in dirs if os.path.islink(
                os.path.join(d, x))]:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.path.relpath(os.readlink(p), root))
            else:
                out[rel] = open(p, "rb").read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k


def test_prepare_steps_match(tmp_path, monkeypatch):
    """Link, extract, QC, split and link the split, step by step, in two
    copies of one tree: identical trees, good lists and splits."""
    for name, mod in (("port", prepare), ("jax", jprepare)):
        root = tmp_path / name
        _write_orig(str(root / "orig"))
        monkeypatch.chdir(root)   # relative paths: the links resolve
        mod.link_annotated_subjects("orig", "data")
        mod.extract_ed_es_frames("data")
        for seq in ("sa", "la_2ch", "la_4ch"):
            good = mod.quality_control_subjects("data", seq, [1000004])
            split = mod.split_dataset(good, 1, 0, seed=0)
            mod.link_split("data", "split", seq, split)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    link = tmp_path / "port" / "data" / "1000001" / "sa.nii.gz"
    assert link.is_symlink() and link.exists()
    assert sorted(os.listdir(tmp_path / "port" / "data")) == [
        "1000001", "1000003", "1000004"]
    assert os.listdir(tmp_path / "port" / "split" / "la_2ch" /
                      "validation") == ["1000001"]
    ed = nifti.load(str(tmp_path / "port" / "data" / "1000001"
                        / "label_sa_ES.nii.gz"))
    _, seg = _cine("sa", seed=0)
    np.testing.assert_array_equal(np.asarray(ed.dataobj), seg[..., 3])


def test_prepare_data_cli(tmp_path, monkeypatch):
    """``prepare_data`` with linking, a blacklist and an ICC list: the
    same trees, symlinks and CSVs."""
    for name, cli in (("port", prepare_data), ("jax", jprepare_cli)):
        root = tmp_path / name
        _write_orig(str(root / "orig"))
        (root / "csv").mkdir()
        (root / "csv" / "bad_eid_sa.csv").write_text("eid\n1000003\n")
        (root / "icc.csv").write_text("eid,x\n1000004,1\n")
        monkeypatch.chdir(root)
        cli.main(["--orig_dir", "orig", "--data_dir", "data", "--csv_dir",
                  "csv", "--dest_dir", "split", "--n_validation", "1",
                  "--n_test", "0", "--icc_csv", "icc.csv"])
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    csv = (tmp_path / "port" / "csv" / "good_eid_sa.csv").read_text()
    assert csv.split() == ["eid", "1000001", "1000004"]


def _subject_zip(path, eid, write, with_manifest=False):
    """A UK Biobank application zip: SA slices, a LAX 4-chamber view and
    the aortic series, one slice SOF3-compressed; with a manifest, flat
    files that the manifest sorts into series folders."""
    work = str(path) + ".d"
    series = {"CINE_segmented_SAX_b0": ("1.2.840.10008.1.2.1", 0),
              "CINE_segmented_SAX_b1": ("1.2.840.10008.1.2.4.70", 1),
              "CINE_segmented_LAX_4Ch": ("1.2.840.10008.1.2.4.80", 2),
              "CINE_segmented_Ao_dist": ("1.2.840.10008.1.2.5", 3)}
    rows = ["filename,series discription"]
    for name, (syntax, z) in series.items():
        rng = np.random.RandomState(int(eid) + z)
        for t in range(3):
            uid = f"1.{eid}.{z}.{t}"
            fname = f"{uid}.dcm" if with_manifest else f"{name}/{uid}.dcm"
            os.makedirs(os.path.dirname(os.path.join(work, fname)),
                        exist_ok=True)
            write(os.path.join(work, fname), {
                "SOPInstanceUID": uid, "SeriesInstanceUID": f"2.{eid}.{z}",
                "CardiacNumberOfImages": 3, "Rows": 12, "Columns": 14,
                "PixelSpacing": [1.8, 1.8], "SpacingBetweenSlices": 10.0,
                "SliceThickness": 8.0, "TriggerTime": 40.0 * t,
                "ImagePositionPatient": [5.0, 6.0, 7.0 + 10 * z],
                "ImageOrientationPatient": [1, 0, 0, 0, 1, 0],
                "BitsAllocated": 16, "PixelRepresentation": 0},
                (rng.rand(12, 14) * 900).astype(np.uint16),
                transfer_syntax=syntax)
            rows.append(f"{uid}.dcm,{name}")
    if with_manifest:
        with open(os.path.join(work, "manifest.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with zipfile.ZipFile(path, "w") as z:
        for d, _, files in os.walk(work):
            for f in sorted(files):
                z.write(os.path.join(d, f),
                        os.path.relpath(os.path.join(d, f), work))
    shutil.rmtree(work)


CVI42 = """<?xml version="1.0"?>
<Workspace xmlns:Hash="http://www.circlecvi.com/cvi42/Workspace/Hash/"
           xmlns:Point="http://www.circlecvi.com/cvi42/Workspace/Point/">
 <Item Hash:key="ImageStates">
  <Item Hash:key="1.2000002.0.0">
   <Item Hash:key="Contours">
    <Item Hash:key="saendocardialContour">
     <Item Hash:key="Points">
      <Item><Point:x>8</Point:x><Point:y>8</Point:y></Item>
      <Item><Point:x>36</Point:x><Point:y>8</Point:y></Item>
      <Item><Point:x>36</Point:x><Point:y>32</Point:y></Item>
     </Item>
     <Item Hash:key="SubpixelResolution">4</Item>
    </Item>
   </Item>
  </Item>
 </Item>
</Workspace>
"""


def test_convert_data_cli(tmp_path, capsys):
    """Application zips, one with a cvi42 workspace zip: identical NIfTI
    trees; a second run leaves a converted subject alone."""
    for name, cli, mod in (("port", convert_data, dicom),
                           ("jax", jconvert_cli, jdicom)):
        zips = tmp_path / name / "zips"
        zips.mkdir(parents=True)
        for eid in ("2000001", "2000002"):
            _subject_zip(zips / f"{eid}.zip", eid, mod.dcmwrite_minimal)
        with zipfile.ZipFile(zips / "2000002_cvi42.zip", "w") as z:
            z.writestr("2000002.cvi42wsx", CVI42)
        out = tmp_path / name / "nifti"
        cli.main(["--input_dir", str(zips), "--output_dir", str(out)])
        first = _tree(out)
        cli.main(["--input_dir", str(zips), "--output_dir", str(out)])
        assert _tree(out) == first
    _assert_same_tree(tmp_path / "port" / "nifti", tmp_path / "jax" / "nifti")
    got = sorted(os.listdir(tmp_path / "port" / "nifti" / "2000002"))
    assert got == ["ao.nii.gz", "la_4ch.nii.gz", "label_sa.nii.gz",
                   "label_up_sa.nii.gz", "sa.nii.gz"]
    assert sorted(os.listdir(tmp_path / "port" / "nifti")) == [
        "2000001", "2000002"]


STUB = """#!{python}
import os, shutil, sys
batch = [a[2:] for a in sys.argv[1:] if a.startswith("-b")][0]
key = [a[2:] for a in sys.argv[1:] if a.startswith("-a")][0]
assert open(key).read() == "secret"
for line in open(batch):
    eid, field = line.split()
    src = os.path.join({served!r}, eid + "_" + field + ".zip")
    if not os.path.exists(src):
        sys.stderr.write("no such record " + eid + "\\n")
        sys.exit(3)
    shutil.copy(src, eid + "_" + field + ".zip")
"""


def test_download_data_cli_with_stub_ukbfetch(tmp_path, monkeypatch, capsys):
    """``download_data`` against a stub ``ukbfetch`` on PATH that copies
    local zips (flat DICOMs and a manifest): fetch, unzip, sort by the
    manifest, convert, clean up; a subject the stub cannot serve is
    reported and skipped.  Both packages give the same tree."""
    for name, cli, mod in (("port", download_data, dicom),
                           ("jax", jdownload_cli, jdicom)):
        root = tmp_path / name
        served = root / "served"
        served.mkdir(parents=True)
        _subject_zip(served / "3000001_20209_2_0.zip", "3000001",
                     mod.dcmwrite_minimal, with_manifest=True)
        bin_dir = root / "bin"
        bin_dir.mkdir()
        stub = bin_dir / "ukbfetch"
        stub.write_text(STUB.format(python=sys.executable,
                                    served=str(served)))
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                                   f"{os.environ['PATH']}")
        (root / "key").write_text("secret")
        (root / "eids.csv").write_text("eid\n3000001\n3000009\n")
        cli.main(["--eid_csv", str(root / "eids.csv"), "--ukbkey",
                  str(root / "key"), "--work_dir", str(root / "work"),
                  "--out_dir", str(root / "out"), "--fields", "20209"])
        assert "ukbfetch failed for 3000009" in capsys.readouterr().out
    _assert_same_tree(tmp_path / "port" / "out", tmp_path / "jax" / "out")
    assert sorted(os.listdir(tmp_path / "port" / "out" / "3000001")) == [
        "ao.nii.gz", "la_4ch.nii.gz", "sa.nii.gz"]
    assert os.listdir(tmp_path / "port" / "work") == ["3000009"]
