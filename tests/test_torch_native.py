"""The port's native host ops (``ukbb_cardiac_tpu_torch/native``) against
the JAX package's and against the port's own Python decoders.

The same streams, made from seeded numpy inputs, go through the port's
C++ decoders and DICOM scanner, its Python decoders and ``_dcmread_pure``,
and the JAX package's: decoded pixels and attribute dicts must be equal,
encoded bytes identical, and a stream one side declines must be declined
the same way by the other.  The port builds ``hostops.cc`` into
``build/native/`` and raises if the compiler fails, where the JAX package
falls back to Python.
"""

import os
import stat
import struct

import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu import native as jnative
from ukbb_cardiac_tpu.data import dicom as jdicom
from ukbb_cardiac_tpu.data import jpegcodec as jjc
from ukbb_cardiac_tpu_torch import native
from ukbb_cardiac_tpu_torch.data import dicom
from ukbb_cardiac_tpu_torch.data import jpegcodec as jc

torch.set_num_threads(1)


def _cine_like(rng, rows, cols, maxv):
    """Smooth frame with a flat strip: the regular and the run coding
    paths (``tests/test_jpegcodec.py``)."""
    y, x = np.mgrid[0:rows, 0:cols]
    img = maxv * 0.6 * np.exp(-((x - cols / 2) ** 2 + (y - rows / 2) ** 2)
                              / (0.08 * rows * cols))
    img = img + rng.randn(rows, cols) * maxv * 0.01
    img[:3] = 0
    return np.clip(img, 0, maxv).astype(np.uint16)


def _image(name):
    """(image, precision) of each structured case of the JAX package's
    codec tests, from fixed seeds."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "smooth12":
        return _cine_like(rng, 40, 52, 4095), 12
    if name == "random8":
        return rng.randint(0, 256, (17, 23)).astype(np.uint16), 8
    if name == "random16":
        return rng.randint(0, 65536, (16, 16)).astype(np.uint16), 16
    if name == "flat":
        return np.full((9, 31), 77, np.uint16), 8
    if name == "zero":
        return np.zeros((5, 8), np.uint16), 12
    if name == "runs":
        img = np.full((20, 64), 500, np.uint16)
        for r in range(20):
            img[r, rng.randint(0, 64)] = rng.randint(0, 4096)
        return img, 12
    if name == "stripes":
        return np.tile(np.array([0, 4095], np.uint16), (16, 24)), 12
    if name == "extremes16":
        img = np.zeros((6, 6), np.uint16)
        img[::2, ::2] = 65535
        return img, 16
    if name == "alphabet7":
        return rng.randint(0, 128, (9, 13)).astype(np.uint16), 7
    if name == "row":
        return rng.randint(0, 256, (1, 64)).astype(np.uint16), 8
    if name == "column":
        return rng.randint(0, 1024, (64, 1)).astype(np.uint16), 10
    raise KeyError(name)


IMAGES = ["smooth12", "random8", "random16", "flat", "zero", "runs",
          "stripes", "extremes16", "alphabet7", "row", "column"]


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("codec", ["sof3", "jpegls"])
def test_jpeg_decoders_agree(codec, name):
    """Encoded bytes identical to the JAX package's; the port's C++ and
    Python decoders and the JAX package's Python decoder all give the
    image back."""
    img, P = _image(name)
    if codec == "sof3":
        blob = jc.encode_jpeg_lossless(img, P)
        assert blob == jjc.encode_jpeg_lossless(img, P)
        decoders = (lambda b: native.jpeg_sof3_decode(b, img.size),
                    jc.decode_jpeg_lossless, jjc.decode_jpeg_lossless)
    else:
        blob = jc.encode_jpegls(img, P)
        assert blob == jjc.encode_jpegls(img, P)
        decoders = (lambda b: native.jpegls_decode(b, img.size),
                    jc.decode_jpegls, jjc.decode_jpegls)
    for decode in decoders:
        got = decode(blob)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("sv", [1, 2, 3, 4, 5, 6, 7])
def test_sof3_each_predictor(sv):
    img, P = _cine_like(np.random.RandomState(sv), 12, 15, 1023), 10
    blob = jc.encode_jpeg_lossless(img, P, sv=sv)
    assert blob == jjc.encode_jpeg_lossless(img, P, sv=sv)
    for got in (native.jpeg_sof3_decode(blob, img.size),
                jc.decode_jpeg_lossless(blob), jjc.decode_jpeg_lossless(blob)):
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("near", [1, 2])
def test_jpegls_near_lossless(near):
    img, P = _image("smooth12")
    blob = jc.encode_jpegls(img, P, near=near)
    assert blob == jjc.encode_jpegls(img, P, near=near)
    got = native.jpegls_decode(blob, img.size)
    np.testing.assert_array_equal(got, jc.decode_jpegls(blob))
    np.testing.assert_array_equal(got, jjc.decode_jpegls(blob))
    assert 0 < np.abs(got.astype(int) - img.astype(int)).max() <= near


def test_native_output_capacity_retry():
    """A too-small pixel hint retries at the header's size."""
    img, P = _image("smooth12")
    blob = jc.encode_jpegls(img, P)
    np.testing.assert_array_equal(native.jpegls_decode(blob, 4), img)


def test_sof3_honors_table_selector():
    """Two Huffman tables, the scan selecting id 0: every decoder takes
    the selected one."""
    img = (np.arange(35, dtype=np.uint16) % 200).reshape(5, 7)
    data = jc.encode_jpeg_lossless(img, 8)
    bits = [0] * 16
    bits[0] = 1
    dht1 = bytes([0x01]) + bytes(bits) + bytes([0])
    seg = b"\xff\xc4" + (len(dht1) + 2).to_bytes(2, "big") + dht1
    sos = data.rfind(b"\xff\xda")
    patched = data[:sos] + seg + data[sos:]
    for got in (native.jpeg_sof3_decode(patched, img.size),
                jc.decode_jpeg_lossless(patched),
                jjc.decode_jpeg_lossless(patched)):
        np.testing.assert_array_equal(got, img)


def _outcome(decode, blob):
    """The decoded array, or the type of the exception a decoder raises."""
    try:
        return decode(blob)
    except Exception as err:  # the type is what is compared
        return type(err).__name__


def _same(a, b):
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return a.shape == b.shape and np.array_equal(a, b)


def _malformed(codec, seed):
    """Truncations of a valid stream at every offset past its header, and
    fuzzed entropy bytes after it."""
    img = (np.arange(48, dtype=np.uint16).reshape(6, 8) * 7) % 256
    blob = {"sof3": jc.encode_jpeg_lossless, "jpegls": jc.encode_jpegls}[
        codec](img, 8)
    sos = blob.rfind(b"\xff\xda")
    head = blob[:sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")]
    rng = np.random.RandomState(seed)
    blobs = [blob[:n] for n in range(len(blob))]
    blobs += [head + bytes(rng.randint(0, 256, rng.randint(1, 20))
                           .astype(np.uint8).tolist()) + b"\xff\xd9"
              for _ in range(60)]
    blobs.append(b"\xff\xd8\xff\xc0\x00\x04\x00\x00")
    blobs.append(b"not a jpeg")
    return img.size, blobs


@pytest.mark.parametrize("codec", ["sof3", "jpegls"])
def test_malformed_jpeg_streams(codec):
    """No crash on truncated or fuzzed streams.  The port's Python decoder
    and the JAX package's give the same array or raise the same exception
    type; so do the two packages' C++ decoders; the C++ decoder raises
    only JpegDecodeError, and the DICOM reader's composite (the C++
    decoder, then the Python one for what it declines) agrees between the
    packages."""
    n, blobs = _malformed(codec, seed=1 if codec == "sof3" else 0)
    if codec == "sof3":
        py, jpy = jc.decode_jpeg_lossless, jjc.decode_jpeg_lossless
        nat = lambda b: native.jpeg_sof3_decode(b, n)  # noqa: E731
        jnat = lambda b: jnative.jpeg_sof3_decode(b, n)  # noqa: E731
        syntax = dicom.JPEG_LOSSLESS_SV1
    else:
        py, jpy = jc.decode_jpegls, jjc.decode_jpegls
        nat = lambda b: native.jpegls_decode(b, n)  # noqa: E731
        jnat = lambda b: jnative.jpegls_decode(b, n)  # noqa: E731
        syntax = dicom.JPEG_LS_LOSSLESS
    img = dicom.DicomImage({"TransferSyntaxUID": syntax})
    jimg = jdicom.DicomImage({"TransferSyntaxUID": syntax})
    declined = 0
    for blob in blobs:
        a, b = _outcome(py, blob), _outcome(jpy, blob)
        assert _same(a, b), (blob, a, b)
        c = _outcome(nat, blob)
        if jnative.available():
            assert _same(c, _outcome(jnat, blob)), blob
        assert not isinstance(c, str) or c == "JpegDecodeError", c
        if not isinstance(c, str) and not isinstance(a, str):
            np.testing.assert_array_equal(c, a)
        declined += isinstance(c, str)
        assert _same(_outcome(lambda f: img._decode_frame(f, 6, 8, 16), blob),
                     _outcome(lambda f: jimg._decode_frame(f, 6, 8, 16),
                              blob))
    assert declined > len(blobs) // 2


@pytest.mark.parametrize("name", ["smooth12", "random8", "flat"])
def test_rle_matches_jax(name):
    img, _ = _image(name)
    blob = jc.encode_rle(img)
    assert blob == jjc.encode_rle(img)
    rows, cols = img.shape
    for got in (jc.decode_rle(blob, rows, cols, 2),
                jjc.decode_rle(blob, rows, cols, 2)):
        np.testing.assert_array_equal(got, img)
    for k in range(0, len(blob), 7):
        assert _same(_outcome(lambda b: jc.decode_rle(b, rows, cols, 2),
                              blob[:k]),
                     _outcome(lambda b: jjc.decode_rle(b, rows, cols, 2),
                              blob[:k]))


def _explicit_with_sq(path):
    """An explicit-VR file from the writer with an undefined-length SQ
    (a nested UI element) spliced in before the dataset body."""
    pixel = (np.arange(16 * 20) % 251).astype(np.int16).reshape(16, 20)
    attrs = {"Rows": 16, "Columns": 20, "BitsAllocated": 16,
             "PixelRepresentation": 1, "PixelSpacing": [1.8, 1.8],
             "ImagePositionPatient": [1.0, 2.0, 3.0],
             "ImageOrientationPatient": [1, 0, 0, 0, 1, 0],
             "TriggerTime": 123.5, "CardiacNumberOfImages": 50,
             "InstanceNumber": 7, "SeriesInstanceUID": "1.2.3.4",
             "SeriesDescription": "CINE_segmented_SAX_b1"}
    dicom.dcmwrite_minimal(path, attrs, pixel)
    raw = open(path, "rb").read()
    pos = raw.index(b"DICM") + 4
    while pos + 8 <= len(raw):
        group, = struct.unpack_from("<H", raw, pos)
        if group != 0x0002:
            break
        ln, = struct.unpack_from("<H", raw, pos + 6)
        pos += 8 + ln
    sq = (struct.pack("<HH", 0x0008, 0x1140) + b"SQ\x00\x00"
          + struct.pack("<I", 0xFFFFFFFF)
          + struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF)
          + struct.pack("<HH", 0x0008, 0x1155) + b"UI"
          + struct.pack("<H", 4) + b"9.9\x00"
          + struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
          + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return raw[:pos] + sq + raw[pos:], pixel


def _implicit_raw():
    body = bytearray()
    for group, elem, raw in ((0x0018, 0x1090, b"50"),
                             (0x0028, 0x0010, struct.pack("<H", 16)),
                             (0x0028, 0x0011, struct.pack("<H", 20))):
        body.extend(struct.pack("<HHI", group, elem, len(raw)) + raw)
    return bytes(body)


@pytest.mark.parametrize("kind", ["explicit", "explicit_sq", "implicit"])
def test_dicom_scan_matches_pure_python(tmp_path, kind):
    """The native scanner's path (``dcmread``) and ``_dcmread_pure`` give
    the same attribute dict, and the same as the JAX package's reader."""
    path = str(tmp_path / "x.dcm")
    if kind == "implicit":
        buf, pixel = _implicit_raw(), None
    else:
        buf, pixel = _explicit_with_sq(path)
        if kind == "explicit":
            buf = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(buf)
    assert native.dicom_scan(buf) is not None
    via_native = dicom.dcmread(path)
    assert via_native._attrs == dicom._dcmread_pure(buf)._attrs
    assert via_native._attrs == jdicom.dcmread(path)._attrs
    if pixel is not None:
        np.testing.assert_array_equal(via_native.pixel_array, pixel)
    else:
        assert int(via_native.CardiacNumberOfImages) == 50


def test_dicom_scan_truncated_never_crashes(tmp_path):
    """Every truncation of a stream with a nested long-VR element: rows
    or None, never a crash, and the same as the JAX package's scanner;
    ``dcmread`` then agrees with ``_dcmread_pure`` (or both raise the
    same)."""
    pixel = np.zeros((4, 4), dtype=np.int16)
    p = str(tmp_path / "t.dcm")
    dicom.dcmwrite_minimal(p, {"Rows": 4, "Columns": 4, "BitsAllocated": 16,
                               "PixelRepresentation": 1,
                               "SeriesInstanceUID": "1.2.3"}, pixel)
    raw = open(p, "rb").read()
    sq = (struct.pack("<HH", 0x0008, 0x1140) + b"SQ\x00\x00"
          + struct.pack("<I", 0xFFFFFFFF)
          + struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF)
          + struct.pack("<HH", 0x0008, 0x1155) + b"OB\x00\x00"
          + struct.pack("<I", 4) + b"abcd"
          + struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
          + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    full = raw[:len(raw) // 2] + sq + raw[len(raw) // 2:]
    for n in range(len(full) + 1):
        res = native.dicom_scan(full[:n])
        assert res is None or res.ndim == 2
        if jnative.available():
            ref = jnative.dicom_scan(full[:n])
            assert (res is None) == (ref is None)
            if res is not None:
                np.testing.assert_array_equal(res, ref)
        if n % 16 == 0:
            with open(p, "wb") as f:
                f.write(full[:n])
            a = _outcome(lambda b: dicom.dcmread(p)._attrs, None)
            b = _outcome(lambda b: dicom._dcmread_pure(full[:n])._attrs,
                         None)
            assert a == b


def test_dicom_scan_declines_when_table_overflows():
    el = struct.pack("<HHI", 0x0028, 0x0010, 2) + struct.pack("<H", 7)
    assert native.dicom_scan(el * 70) is None
    assert native.dicom_scan(el * 60).shape == (60, 4)


def test_scan_names_match_the_native_table():
    """``_SCAN_NAMES`` indexes the C++ table of wanted tags: the same
    order as the JAX package's (both scanners are the same source).  The
    port's file is the JAX package's with one section more, the aortic
    QC's pass over a stack of frames, taken out here, and without the
    up-leg packer, taken out of the JAX package's file here."""
    assert dicom._SCAN_NAMES == jdicom._SCAN_NAMES
    src = (native.SRC).read_text()
    rule = "// " + "-" * 75 + "\n"
    own = src.index(rule + "// Components of one label over a stack of "
                           "frames")
    src = src[:own] + src[src.index(rule + "// DICOM element scanner"):]
    with open(os.path.join(os.path.dirname(jnative.__file__),
                           "hostops.cc")) as f:
        ref = f.read()
    packer = ref.index("// Plane-split pack for the adaptive H2D transfer")
    ref = (ref[:packer] + ref[ref.index("// Unpack `bits`-wide fields"):]
           ).replace("// Bit-plane pack/unpack for the deploy engines' "
                     "transfer paths.", "// Bit-field unpack for the "
                     "deploy engines' label readback.")
    assert src[src.index("#include <cstdint>"):] == \
        ref[ref.index("#include <cstdint>"):]


def _failing_compiler(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "g++"
    fake.write_text("#!/bin/sh\necho 'g++: no compiler here' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")


def test_failed_build_raises_where_jax_falls_back(tmp_path, monkeypatch):
    """With a g++ that fails and no earlier build, the port raises with
    the compiler's output; the JAX package returns None from its native
    entry points and reads DICOMs through Python."""
    _failing_compiler(tmp_path, monkeypatch)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.dicom_scan(b"\x00" * 8)
    assert not list((tmp_path / "build").glob("*.so"))
    path = str(tmp_path / "x.dcm")
    dicom.dcmwrite_minimal(path, {"Rows": 2, "Columns": 2},
                           np.zeros((2, 2), np.uint16))
    with pytest.raises(RuntimeError):
        dicom.dcmread(path)
    # the JAX package: no library, so None and the pure-Python reader
    monkeypatch.setattr(jnative, "_LIB", str(tmp_path / "jax_hostops.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.get_lib() is None
    assert jnative.dicom_scan(b"\x00" * 8) is None
    assert int(jdicom.dcmread(path).Rows) == 2


def test_build_goes_to_build_dir_named_by_digest(tmp_path, monkeypatch):
    """A fresh build directory gets one library named by the digest of the
    source and flags; a second load reuses it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()
    (built,) = (tmp_path / "native").iterdir()
    assert built == native.lib_path()
    assert built.name.startswith("libhostops-") and built.suffix == ".so"
    mtime = built.stat().st_mtime_ns
    monkeypatch.setattr(native, "_lib", None)
    assert native.get_lib() is not lib
    assert built.stat().st_mtime_ns == mtime
    assert native.lib_path().parent == tmp_path / "native"
