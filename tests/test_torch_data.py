"""The port's UK Biobank ingestion (``ukbb_cardiac_tpu_torch/data``:
DICOM reader and writer, Biobank converter, cvi42 parser, download
helpers) against the JAX package's.

Seeded numpy series go through both packages: written DICOMs are
byte-identical, attribute dicts and pixel arrays equal, and the converted
NIfTIs byte-identical, for every transfer syntax the reader takes (SOF3
JPEG lossless, JPEG-LS lossless and near-lossless, RLE, single-frame and
multi-frame), the mixed SAX and LAX directories, multi-series selection,
manifest sorting and cvi42 labels.
"""

import os
import pickle
import struct

import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.data import biobank as jbiobank
from ukbb_cardiac_tpu.data import cvi42 as jcvi42
from ukbb_cardiac_tpu.data import dicom as jdicom
from ukbb_cardiac_tpu.data import download as jdownload
from ukbb_cardiac_tpu_torch.data import biobank, cvi42, dicom, download
from ukbb_cardiac_tpu_torch.io import nifti

torch.set_num_threads(1)

PORT = {"dicom": dicom, "biobank": biobank, "cvi42": cvi42,
        "download": download}
JAX = {"dicom": jdicom, "biobank": jbiobank, "cvi42": jcvi42,
       "download": jdownload}

SOF3 = "1.2.840.10008.1.2.4.70"        # JPEG lossless, selection value 1
SOF3_P14 = "1.2.840.10008.1.2.4.57"    # JPEG lossless, process 14
JPEG_LS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
RLE = "1.2.840.10008.1.2.5"
EXPLICIT = "1.2.840.10008.1.2.1"
COMPRESSED = [SOF3, SOF3_P14, JPEG_LS, JPEG_LS_NEAR, RLE]


def _attrs(uid, suid, T, t, z, rows=16, cols=20, dz=10.0, spacing=(1.8, 1.9),
           position=(10.0, 20.0, 30.0)):
    return {"SOPInstanceUID": uid, "SeriesInstanceUID": suid,
            "CardiacNumberOfImages": T, "Rows": rows, "Columns": cols,
            "PixelSpacing": [spacing[1], spacing[0]],
            "SpacingBetweenSlices": dz, "SliceThickness": 8.0,
            "TriggerTime": 30.0 * t, "InstanceNumber": t + 1,
            "ImagePositionPatient": [position[0], position[1],
                                     position[2] + z * dz],
            "ImageOrientationPatient": [1, 0, 0, 0, 1, 0],
            "BitsAllocated": 16, "PixelRepresentation": 0}


def _write_series(write, dir_path, z, T=4, rows=16, cols=20, suid="1.2.3.4",
                  syntax=EXPLICIT, names="img", seed=None):
    """One slice's cine as T DICOM files written by ``write`` (either
    package's ``dcmwrite_minimal``); returns the frames."""
    os.makedirs(dir_path, exist_ok=True)
    rng = np.random.RandomState(z if seed is None else seed)
    frames = []
    for t in range(T):
        pixel = (rng.rand(rows, cols) * 3000).astype(np.uint16)
        uid = f"9.8.7.{z}.{t}"
        name = uid if names == "uid" else f"img_{z:02d}_{t:02d}"
        write(os.path.join(dir_path, f"{name}.dcm"),
              _attrs(uid, suid, T, t, z, rows, cols), pixel,
              transfer_syntax=syntax)
        frames.append(pixel)
    return frames


def _tree(root):
    """Every file under ``root``: relative path → bytes (symlinks by
    their target)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            out[rel] = (("link", os.readlink(p)) if os.path.islink(p)
                        else open(p, "rb").read())
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k


def test_dicom_roundtrip_and_writer_bytes(tmp_path):
    pixel = (np.arange(16 * 20) % 7).astype(np.uint16).reshape(16, 20)
    attrs = {"Rows": 16, "Columns": 20, "PixelSpacing": [1.5, 1.25],
             "CardiacNumberOfImages": 3, "TriggerTime": 42.5,
             "SeriesInstanceUID": "1.2.3", "BitsAllocated": 16,
             "PixelRepresentation": 0, "SeriesDescription": "CINE x",
             "ImagePositionPatient": [1.0, 2.0, 3.0],
             "ImageOrientationPatient": [1, 0, 0, 0, 1, 0]}
    p, q = str(tmp_path / "port.dcm"), str(tmp_path / "jax.dcm")
    dicom.dcmwrite_minimal(p, attrs, pixel)
    jdicom.dcmwrite_minimal(q, attrs, pixel)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert dicom.is_dicom_file(p) and not dicom.is_dicom_file(
        str(tmp_path / "missing.dcm"))
    d = dicom.dcmread(p)
    assert d._attrs == jdicom.dcmread(p)._attrs
    assert int(d.Rows) == 16 and d.PixelSpacing == [1.5, 1.25]
    assert float(d.TriggerTime) == 42.5 and d.SeriesInstanceUID == "1.2.3"
    np.testing.assert_array_equal(d.pixel_array, pixel)


def test_dicom_implicit_vr_integer_strings(tmp_path):
    """Implicit-VR IS tags are ASCII: a 2-byte '50' is 50, not a uint16."""
    body = bytearray()
    for group, elem, raw in ((0x0018, 0x1090, b"50"),
                             (0x0028, 0x0010, struct.pack("<H", 16)),
                             (0x0028, 0x0011, struct.pack("<H", 20))):
        body.extend(struct.pack("<HHI", group, elem, len(raw)) + raw)
    path = str(tmp_path / "implicit.dcm")
    with open(path, "wb") as f:
        f.write(bytes(body))
    d = dicom.dcmread(path)
    assert d._attrs == jdicom.dcmread(path)._attrs
    assert int(d.CardiacNumberOfImages) == 50
    assert int(d.Rows) == 16 and int(d.Columns) == 20


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("syntax", COMPRESSED)
def test_dicom_compressed_roundtrip(tmp_path, syntax, frames):
    """Each compressed syntax, single- and multi-frame: the two writers'
    files are byte-identical; the port's reader (native scanner and
    decoders), its ``_dcmread_pure`` and the JAX package's reader give the
    same attributes and the pixels back."""
    rng = np.random.RandomState(7 + frames)
    pixel = (rng.rand(frames, 24, 30) * 4000).astype(np.uint16)
    pixel[:, :4] = 0
    attrs = {"Rows": 24, "Columns": 30, "PixelSpacing": [1.5, 1.25],
             "SeriesInstanceUID": "1.2.3", "BitsAllocated": 16,
             "PixelRepresentation": 0, "TriggerTime": 10.0,
             "ImagePositionPatient": [1.0, 2.0, 3.0],
             "ImageOrientationPatient": [1, 0, 0, 0, 1, 0]}
    if frames > 1:
        attrs["NumberOfFrames"] = frames
    data = pixel if frames > 1 else pixel[0]
    p, q = str(tmp_path / "port.dcm"), str(tmp_path / "jax.dcm")
    dicom.dcmwrite_minimal(p, attrs, data, transfer_syntax=syntax)
    jdicom.dcmwrite_minimal(q, attrs, data, transfer_syntax=syntax)
    buf = open(p, "rb").read()
    assert buf == open(q, "rb").read()
    reads = [dicom.dcmread(p), dicom._dcmread_pure(buf), jdicom.dcmread(p)]
    assert reads[0].TransferSyntaxUID == syntax
    for d in reads:
        assert d._attrs.keys() == reads[0]._attrs.keys()
        assert d.BasicOffsetTable == [] and \
            d.PixelDataFragments == reads[0].PixelDataFragments
        np.testing.assert_array_equal(d.pixel_array, data)


def test_unsupported_syntax_raises_the_same(tmp_path):
    pixel = np.zeros((2, 2), np.uint16)
    for mod in (dicom, jdicom):
        with pytest.raises(mod.UnsupportedDicom):
            mod.dcmwrite_minimal(str(tmp_path / "x.dcm"), {"Rows": 2},
                                 pixel, transfer_syntax="1.2.3.4.5")
    raw = bytearray(open(_write_one(tmp_path), "rb").read())
    i = raw.index(EXPLICIT.encode())
    raw[i:i + len(EXPLICIT)] = b"1.2.840.10008.1.2.2"  # big endian
    for mod in (dicom, jdicom):
        with pytest.raises(mod.UnsupportedDicom, match="transfer syntax"):
            mod._dcmread_pure(bytes(raw))


def _write_one(tmp_path):
    path = str(tmp_path / "one.dcm")
    dicom.dcmwrite_minimal(path, {"Rows": 2, "Columns": 2},
                           np.zeros((2, 2), np.uint16))
    return path


def _convert_both(tmp_path, make, cvi42_xml=None):
    """Build a subject's DICOM tree twice with ``make(root, pkg)``, convert
    each copy with its package's ``convert_subject``, and hold the NIfTI
    trees byte-identical.  Returns the port's output directory."""
    outs = {}
    for name, mods in (("port", PORT), ("jax", JAX)):
        root = tmp_path / f"dicom_{name}"
        make(str(root), mods)
        out = tmp_path / f"out_{name}"
        mods["download"].convert_subject(str(root), str(out), cvi42_xml)
        outs[name] = str(out)
    _assert_same_tree(outs["port"], outs["jax"])
    return outs["port"]


def test_biobank_conversion_byte_identical(tmp_path, capsys):
    """SAX slices, LAX 2/3/4-chamber and the aortic series: the same
    sequences found, the same NIfTI bytes, geometry as written."""
    T, Z = 4, 3

    def make(root, mods):
        w = mods["dicom"].dcmwrite_minimal
        for z in range(Z):
            _write_series(w, f"{root}/CINE_segmented_SAX_b{z}", z, T=T)
        for i, view in enumerate(("2Ch", "3Ch", "4Ch")):
            _write_series(w, f"{root}/CINE_segmented_LAX_{view}", 9 + i, T=T)
        _write_series(w, f"{root}/CINE_segmented_Ao_dist", 5, T=T)

    out = _convert_both(tmp_path, make)
    assert sorted(os.listdir(out)) == sorted(
        f"{k}.nii.gz" for k in ("sa", "la_2ch", "la_3ch", "la_4ch", "ao"))
    ds = biobank.Biobank_Dataset(str(tmp_path / "dicom_port"))
    jds = jbiobank.Biobank_Dataset(str(tmp_path / "dicom_jax"))
    assert {k: [os.path.basename(d) for d in v]
            for k, v in ds.subdir.items()} == \
        {k: [os.path.basename(d) for d in v] for k, v in jds.subdir.items()}
    nim = nifti.load(os.path.join(out, "sa.nii.gz"))
    assert nim.dataobj.shape == (20, 16, Z, T)
    np.testing.assert_allclose(np.diag(nim.affine)[:3], [-1.8, -1.9, 10.0])
    assert nim.affine[0, 3] == pytest.approx(-10.0)
    assert nim.header["pixdim"][4] == pytest.approx(0.03)


@pytest.mark.parametrize("syntax", [SOF3, JPEG_LS, JPEG_LS_NEAR, RLE])
def test_biobank_mixed_compressed_series(tmp_path, syntax):
    """One SAX slice uncompressed and one compressed: decoded frames, not
    duplicates of the previous frame, and identical NIfTIs."""
    T = 4
    truth = {}

    def make(root, mods):
        w = mods["dicom"].dcmwrite_minimal
        _write_series(w, f"{root}/CINE_segmented_SAX_b0", 0, T=T)
        truth["b1"] = _write_series(w, f"{root}/CINE_segmented_SAX_b1", 1,
                                    T=T, syntax=syntax, seed=99)

    out = _convert_both(tmp_path, make)
    vol = np.asarray(nifti.load(os.path.join(out, "sa.nii.gz")).dataobj)
    for t in range(T):
        np.testing.assert_array_equal(vol[:, :, 1, t], truth["b1"][t].T)


def test_biobank_multiseries_selection(tmp_path):
    """Two series in one folder: the last UID without annotations, the
    annotated one with a cvi42 folder that names one of its files."""
    d = tmp_path / "subject" / "CINE_segmented_LAX_4Ch"
    _write_series(dicom.dcmwrite_minimal, str(d), 0, T=3, suid="1.1.1")
    for t in range(3):
        dicom.dcmwrite_minimal(
            str(d / f"zzz_{t:02d}.dcm"),
            _attrs(f"5.5.{t}", "2.2.2", 3, t, 0),
            np.full((16, 20), t, dtype=np.uint16))
    cvi = tmp_path / "cvi42"
    cvi.mkdir()
    (cvi / "img_00_01.pickle").write_bytes(pickle.dumps({}))
    for cvi42_dir, first in ((None, "zzz"), (str(cvi), "img")):
        got = biobank.Biobank_Dataset(str(tmp_path / "subject"),
                                      cvi42_dir).find_series(str(d), 3)
        ref = jbiobank.Biobank_Dataset(str(tmp_path / "subject"),
                                       cvi42_dir).find_series(str(d), 3)
        assert got == ref and len(got) == 3
        assert all(f.startswith(first) for f in got)


@pytest.mark.parametrize("kind", ["sax", "lax", "lax_unsplittable"])
def test_biobank_mixed_directories(tmp_path, kind):
    """A mixed ``CINE_segmented_SAX`` folder split into per-slice folders
    by CardiacNumberOfImages, and a mixed ``CINE_segmented_LAX`` into the
    3Ch, 4Ch and 2Ch views (a count that is not 3 T is left alone): the
    same folders and the same NIfTIs from both packages."""
    T = 3

    def make(root, mods):
        w = mods["dicom"].dcmwrite_minimal
        if kind == "sax":
            mixed = f"{root}/CINE_segmented_SAX"
            for z in range(2):
                _write_series(w, mixed, z, T=T)
        else:
            mixed = f"{root}/CINE_segmented_LAX"
            for z in range(3 if kind == "lax" else 2):
                _write_series(w, mixed, z, T=T)
            _write_series(w, f"{root}/CINE_segmented_SAX_b0", 7, T=T)

    out = _convert_both(tmp_path, make)
    assert sorted(os.listdir(tmp_path / "dicom_port")) == sorted(
        os.listdir(tmp_path / "dicom_jax"))
    want = {"sax": ["sa.nii.gz"],
            "lax": ["la_2ch.nii.gz", "la_3ch.nii.gz", "la_4ch.nii.gz",
                    "sa.nii.gz"],
            "lax_unsplittable": ["sa.nii.gz"]}[kind]
    assert sorted(os.listdir(out)) == want


def test_process_manifest(tmp_path):
    src = tmp_path / "manifest.csv"
    src.write_text("eid,date\n100,Jan 5, 2015\n101,Feb 15, 2016\n")
    for mod, name in ((biobank, "port.csv"), (jbiobank, "jax.csv")):
        mod.process_manifest(str(src), str(tmp_path / name))
    got = (tmp_path / "port.csv").read_text()
    assert got == (tmp_path / "jax.csv").read_text()
    assert "Jan-5-2015" in got and "Feb-15-2016" in got


@pytest.mark.parametrize("column", ["series discription",
                                    "series description"])
def test_sort_dicoms_by_manifest(tmp_path, column):
    for name, mods in (("port", PORT), ("jax", JAX)):
        d = tmp_path / name
        _write_series(mods["dicom"].dcmwrite_minimal, str(d), 0, T=1)
        raw = (d / "img_00_00.dcm").read_bytes()
        for f in ("a.dcm", "b.dcm"):
            (d / f).write_bytes(raw)
        (d / "manifest.csv").write_text(
            f"filename,{column}\na.dcm,CINE_segmented_SAX_b0\n"
            "b.dcm,CINE_segmented_LAX_4Ch\nmissing.dcm,CINE_x\n")
        mods["download"].sort_dicoms_by_manifest(str(d))
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "CINE_segmented_SAX_b0" / "a.dcm").exists()
    assert (tmp_path / "port" / "CINE_segmented_LAX_4Ch" / "b.dcm").exists()
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (download, jdownload):
        with pytest.raises(FileNotFoundError):
            mod.sort_dicoms_by_manifest(str(empty))


CVI42_XML = """<?xml version="1.0"?>
<Workspace xmlns:Hash="http://www.circlecvi.com/cvi42/Workspace/Hash/"
           xmlns:Point="http://www.circlecvi.com/cvi42/Workspace/Point/">
 <Item Hash:key="StudyMapStates">
  <Item Hash:key="ImageStates">
   <Item Hash:key="UID0">
    <Item Hash:key="Contours">
     <Item Hash:key="saepicardialContour">
      <Item Hash:key="Points">
       <Item><Point:x>8</Point:x><Point:y>8</Point:y></Item>
       <Item><Point:x>56</Point:x><Point:y>8</Point:y></Item>
       <Item><Point:x>56</Point:x><Point:y>52</Point:y></Item>
       <Item><Point:x>8</Point:x><Point:y>52</Point:y></Item>
      </Item>
      <Item Hash:key="SubpixelResolution">4</Item>
     </Item>
     <Item Hash:key="saendocardialContour">
      <Item Hash:key="Points">
       <Item><Point:x>16</Point:x><Point:y>12</Point:y></Item>
       <Item><Point:x>40</Point:x><Point:y>12</Point:y></Item>
       <Item><Point:x>40</Point:x><Point:y>36</Point:y></Item>
      </Item>
      <Item Hash:key="SubpixelResolution">4</Item>
     </Item>
     <Item Hash:key="sarvendocardialContour">
      <Item Hash:key="Points">
       <Item><Point:x>60</Point:x><Point:y>20</Point:y></Item>
       <Item><Point:x>76</Point:x><Point:y>20</Point:y></Item>
       <Item><Point:x>76</Point:x><Point:y>40</Point:y></Item>
      </Item>
      <Item Hash:key="SubpixelResolution">4</Item>
     </Item>
    </Item>
   </Item>
   <Item Hash:key="UID1">
    <Item Hash:key="Contours">
     <Item Hash:key="empty">
      <Item Hash:key="Points"/>
     </Item>
    </Item>
   </Item>
  </Item>
 </Item>
</Workspace>
"""


def test_cvi42_parser(tmp_path):
    xml = tmp_path / "ws.cvi42wsx"
    xml.write_text(CVI42_XML)
    got, ref = (mod.parse_workspace(str(xml)) for mod in (cvi42, jcvi42))
    assert sorted(got) == sorted(ref) == ["UID0"]
    for name, pts in ref["UID0"].items():
        np.testing.assert_array_equal(got["UID0"][name], pts)
    np.testing.assert_allclose(got["UID0"]["saendocardialContour"],
                               [[4, 3], [10, 3], [10, 9]])
    for mod, d in ((cvi42, "port"), (jcvi42, "jax")):
        (tmp_path / d).mkdir()
        mod.parseFile(str(xml), str(tmp_path / d))
    assert os.listdir(tmp_path / "port") == ["UID0.pickle"]
    with open(tmp_path / "port" / "UID0.pickle", "rb") as f:
        a = pickle.load(f)
    with open(tmp_path / "jax" / "UID0.pickle", "rb") as f:
        b = pickle.load(f)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterise_contours(seed):
    rng = np.random.RandomState(seed)
    contours = {k: rng.rand(rng.randint(3, 9), 2) * [20, 16]
                for k, _ in biobank.Biobank_Dataset._CONTOUR_ORDER
                if rng.rand() < 0.7}
    got = biobank.Biobank_Dataset.rasterise_contours(contours, 20, 16)
    ref = jbiobank.Biobank_Dataset.rasterise_contours(contours, 20, 16)
    assert got.shape == (64, 80)
    np.testing.assert_array_equal(got, ref)
    square = {"saendocardialContour": np.array([[2.0, 2.0], [8.0, 2.0],
                                                [8.0, 8.0], [2.0, 8.0]]),
              "saepicardialContour": np.array([[1.0, 1.0], [9.0, 1.0],
                                               [9.0, 9.0], [1.0, 9.0]])}
    lab = biobank.Biobank_Dataset.rasterise_contours(square, X=12, Y=12)
    assert (lab[20, 20], lab[5, 20], lab[0, 0]) == (1, 2, 0)


@pytest.mark.parametrize("syntax", [EXPLICIT, SOF3])
def test_convert_subject_with_cvi42(tmp_path, syntax):
    """SOP-UID file names, a cvi42 workspace annotating frame 0 of slice
    0: image, label and upsampled label NIfTIs byte-identical; the
    contour pickles cleaned up."""
    xml = tmp_path / "ws.cvi42wsx"
    xml.write_text(CVI42_XML.replace("UID0", "9.8.7.0.0"))

    def make(root, mods):
        w = mods["dicom"].dcmwrite_minimal
        for z in range(2):
            _write_series(w, f"{root}/CINE_segmented_SAX_b{z}", z, T=2,
                          names="uid", syntax=syntax)

    out = _convert_both(tmp_path, make, str(xml))
    assert sorted(os.listdir(out)) == ["label_sa.nii.gz",
                                       "label_up_sa.nii.gz", "sa.nii.gz"]
    lab = np.asarray(nifti.load(os.path.join(out, "label_sa.nii.gz")).dataobj)
    assert {1, 2, 3} <= set(np.unique(lab[..., 0, 0]))
    assert not lab[..., 1, :].any() and not lab[..., 0, 1].any()
    up = nifti.load(os.path.join(out, "label_up_sa.nii.gz"))
    assert up.dataobj.shape[:2] == (4 * lab.shape[0], 4 * lab.shape[1])


def test_read_dicom_images_fills_missing_and_unreadable(tmp_path, capsys):
    """A slice with fewer files than CardiacNumberOfImages and a frame
    whose pixel data is cut: the previous frame is copied, in both
    packages alike."""
    def make(root, mods):
        w = mods["dicom"].dcmwrite_minimal
        _write_series(w, f"{root}/CINE_segmented_SAX_b0", 0, T=4)
        d1 = f"{root}/CINE_segmented_SAX_b1"
        _write_series(w, d1, 1, T=4)
        os.remove(f"{d1}/img_01_03.dcm")
        # a frame whose pixel data is cut short
        p = f"{d1}/img_01_01.dcm"
        raw = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(raw[:-300])

    out = _convert_both(tmp_path, make)
    vol = np.asarray(nifti.load(os.path.join(out, "sa.nii.gz")).dataobj)
    np.testing.assert_array_equal(vol[:, :, 1, 1], vol[:, :, 1, 0])
    np.testing.assert_array_equal(vol[:, :, 1, 3], vol[:, :, 1, 2])
    assert "dicom file missing" in capsys.readouterr().out


def test_unpack_zip_and_base_image(tmp_path):
    import zipfile

    z = tmp_path / "a.zip"
    with zipfile.ZipFile(z, "w") as f:
        f.writestr("x/y.txt", "hello")
    for mod, d in ((download, "port"), (jdownload, "jax")):
        mod.unpack_zip(str(z), str(tmp_path / d))
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    vol = np.random.RandomState(0).rand(4, 5, 2, 3).astype(np.float32)
    aff = np.diag([-1.8, -1.8, 10.0, 1.0])
    biobank.BaseImage(vol, aff, 0.025).WriteToNifti(str(tmp_path / "a.nii.gz"))
    jbiobank.BaseImage(vol, aff, 0.025).WriteToNifti(str(tmp_path / "b.nii.gz"))
    assert (tmp_path / "a.nii.gz").read_bytes() == \
        (tmp_path / "b.nii.gz").read_bytes()
