"""Minimal DICOM reader (pure Python) for UK Biobank CMR series.

Counterpart of ``ukbb_cardiac_tpu/data/dicom.py``, copied: the port
imports nothing of the JAX package.  The native scanner and JPEG
decoders are the port's own build of ``native/hostops.cc``.

The reference uses pydicom (``data/biobank_utils.py``), with a SimpleITK
fallback for compressed transfer syntaxes (``:344-363``).  Neither is a
dependency here; UKB cardiac DICOMs are uncompressed little-endian, so a
direct parser covers the real data path.  Exposes the attribute subset
``Biobank_Dataset`` consumes: Rows, Columns, PixelSpacing,
SpacingBetweenSlices, SliceThickness, ImagePositionPatient,
ImageOrientationPatient, CardiacNumberOfImages, TriggerTime,
SeriesInstanceUID, SeriesDescription, InstanceNumber and ``pixel_array``.

Supported transfer syntaxes: implicit VR little endian (1.2.840.10008.1.2)
and explicit VR little endian (1.2.840.10008.1.2.1).  Compressed files
raise ``UnsupportedDicom`` — callers degrade per-frame like the reference.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"
# compressed transfer syntaxes decoded natively (the reference degrades
# through SimpleITK, biobank_utils.py:352-363)
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"   # SOF3, any predictor
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"   # SOF3, selection value 1
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
COMPRESSED_SYNTAXES = {JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1,
                       JPEG_LS_LOSSLESS, JPEG_LS_NEAR, RLE_LOSSLESS}

# tag -> attribute name (the subset biobank_utils touches)
_TAGS = {
    (0x0008, 0x0018): "SOPInstanceUID",
    (0x0008, 0x103E): "SeriesDescription",
    (0x0018, 0x0050): "SliceThickness",
    (0x0018, 0x0088): "SpacingBetweenSlices",
    (0x0018, 0x1060): "TriggerTime",
    (0x0018, 0x1090): "CardiacNumberOfImages",
    (0x0020, 0x000E): "SeriesInstanceUID",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x7FE0, 0x0010): "PixelData",
}

_INT_ATTRS = {"Rows", "Columns", "CardiacNumberOfImages", "InstanceNumber",
              "BitsAllocated", "PixelRepresentation", "SamplesPerPixel",
              "NumberOfFrames"}
# tags whose standard VR is binary US — only these may be decoded as
# 16-bit ints in implicit-VR files (IS tags like CardiacNumberOfImages are
# ASCII there; a 2-byte "50" must NOT be unpacked as uint16)
_US_ATTRS = {"Rows", "Columns", "BitsAllocated", "PixelRepresentation",
             "SamplesPerPixel"}
_FLOAT_ATTRS = {"SliceThickness", "SpacingBetweenSlices", "TriggerTime",
                "RescaleIntercept", "RescaleSlope"}
_FLOAT_LIST_ATTRS = {"PixelSpacing", "ImagePositionPatient",
                     "ImageOrientationPatient"}


class UnsupportedDicom(Exception):
    pass


class DicomImage:
    """Attribute-style access mirroring pydicom's Dataset surface."""

    def __init__(self, attrs: Dict[str, object]):
        self._attrs = attrs

    def __getattr__(self, name):
        try:
            return self._attrs[name]
        except KeyError:
            raise AttributeError(name)

    def __contains__(self, name):
        return name in self._attrs

    @property
    def pixel_array(self) -> np.ndarray:
        bits = int(self._attrs.get("BitsAllocated", 16))
        signed = int(self._attrs.get("PixelRepresentation", 0)) == 1
        if bits == 16:
            dtype = np.int16 if signed else np.uint16
        elif bits == 8:
            dtype = np.int8 if signed else np.uint8
        else:
            raise UnsupportedDicom(f"BitsAllocated={bits}")
        rows = int(self._attrs["Rows"])
        cols = int(self._attrs["Columns"])
        n_frames = int(self._attrs.get("NumberOfFrames", 1))
        frags = self._attrs.get("PixelDataFragments")
        if frags is not None:
            frames = [self._decode_frame(f, rows, cols, bits)
                      for f in _frames_from_fragments(
                          frags, n_frames,
                          self._attrs.get("BasicOffsetTable", []))]
            arr = np.stack(frames).astype(dtype)
            return arr if n_frames > 1 else arr[0]
        raw = self._attrs.get("PixelData")
        if raw is None:
            raise AttributeError("PixelData")
        arr = np.frombuffer(raw, dtype=dtype,
                            count=rows * cols * n_frames)
        if n_frames > 1:
            return arr.reshape(n_frames, rows, cols)
        return arr.reshape(rows, cols)

    def _decode_frame(self, frag: bytes, rows: int, cols: int,
                      bits: int) -> np.ndarray:
        from ukbb_cardiac_tpu_torch import native
        from ukbb_cardiac_tpu_torch.data import jpegcodec as jc

        syntax = self._attrs.get("TransferSyntaxUID")
        if syntax in (JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1,
                      JPEG_LS_LOSSLESS, JPEG_LS_NEAR):
            if syntax in (JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1):
                fast, slow = native.jpeg_sof3_decode, jc.decode_jpeg_lossless
            else:
                fast, slow = native.jpegls_decode, jc.decode_jpegls
            try:
                out = fast(frag, rows * cols)
            except jc.JpegDecodeError:
                # the C++ decoder declines some valid streams the Python
                # codec handles (and vice versa for malformed ones) —
                # always give the full decoder a chance before the caller
                # degrades the frame
                out = None
            return out if out is not None else slow(frag)
        if syntax == RLE_LOSSLESS:
            return jc.decode_rle(frag, rows, cols, bits // 8)
        raise UnsupportedDicom(f"transfer syntax {syntax}")


def _decode_value(name: str, vr: Optional[str], raw: bytes):
    if name == "PixelData":
        return raw
    if vr == "US" or (vr is None and name in _US_ATTRS and len(raw) == 2):
        return struct.unpack("<H", raw[:2])[0]
    if vr == "UL":
        return struct.unpack("<I", raw[:4])[0]
    text = raw.decode("latin-1").strip("\x00 ").strip()
    if name in _INT_ATTRS:
        try:
            return int(float(text))
        except ValueError:
            return 0
    if name in _FLOAT_ATTRS:
        try:
            return float(text)
        except ValueError:
            return 0.0
    if name in _FLOAT_LIST_ATTRS:
        return [float(v) for v in text.split("\\") if v]
    return text


_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}


def _frames_from_fragments(frags, n_frames: int, bot):
    """Group encapsulated fragments into per-frame byte strings (PS3.5
    A.4): one fragment per frame is the common case; a frame may span
    several fragments, resolved via the Basic Offset Table."""
    if n_frames == len(frags):
        return list(frags)
    if n_frames == 1:
        return [b"".join(frags)]
    if len(bot) == n_frames:
        # offsets are byte positions of each frame's first fragment,
        # counted from the start of the fragment stream (item headers
        # included)
        starts = []
        off = 0
        for i, f in enumerate(frags):
            starts.append(off)
            off += 8 + len(f)
        frames = []
        try:
            for j in range(n_frames):
                lo = starts.index(bot[j])
                hi = (starts.index(bot[j + 1]) if j + 1 < n_frames
                      else len(frags))
                frames.append(b"".join(frags[lo:hi]))
        except ValueError:
            raise UnsupportedDicom(
                f"Basic Offset Table entries {bot[:4]}... do not align "
                f"with the fragment starts {starts[:4]}...")
        return frames
    raise UnsupportedDicom(
        f"cannot map {len(frags)} pixel fragments onto {n_frames} frames "
        "without a Basic Offset Table")


def _parse_encapsulated(buf: bytes, pos: int, attrs: Dict[str, object]) -> int:
    """Parse encapsulated (compressed) PixelData items (PS3.5 A.4):
    the first item is the Basic Offset Table, the rest are fragments.
    Returns the position after the sequence delimiter."""
    n = len(buf)
    first = True
    frags = []
    bot: list = []
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            break
        if (group, elem) != (0xFFFE, 0xE000) or length == 0xFFFFFFFF:
            raise UnsupportedDicom("malformed encapsulated pixel data")
        if first:
            bot = [struct.unpack_from("<I", buf, pos + 4 * i)[0]
                   for i in range(length // 4)]
            first = False
        else:
            frags.append(bytes(buf[pos:pos + length]))
        pos += length
    attrs["PixelDataFragments"] = frags
    attrs["BasicOffsetTable"] = bot
    return pos


def _parse_dataset(buf: bytes, pos: int, explicit: bool,
                   attrs: Dict[str, object], stop_at: Optional[int] = None,
                   encapsulated_ok: bool = False):
    n = len(buf)
    end = n if stop_at is None else stop_at
    while pos + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if (group, elem) == (0xFFFE, 0xE00D) or (group, elem) == (0xFFFE, 0xE0DD):
            pos += 4
            continue
        vr = None
        if (group, elem) == (0xFFFE, 0xE000):  # item inside SQ
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            if length == 0xFFFFFFFF:
                pos = _skip_undefined(buf, pos, explicit)
            else:
                pos += length
            continue
        if explicit:
            vr = buf[pos:pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
            vr = vr.decode("ascii", "replace")
        else:
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4

        if length == 0xFFFFFFFF:
            if (group, elem) == (0x7FE0, 0x0010):
                if encapsulated_ok:
                    pos = _parse_encapsulated(buf, pos, attrs)
                    continue
                raise UnsupportedDicom(
                    "encapsulated (compressed) pixel data under an "
                    "uncompressed transfer syntax — malformed stream")
            pos = _skip_undefined(buf, pos, explicit)
            continue

        name = _TAGS.get((group, elem))
        if name is not None:
            attrs[name] = _decode_value(name, vr, buf[pos:pos + length])
        pos += length
    return pos


def _skip_undefined(buf: bytes, pos: int, explicit: bool) -> int:
    """Skip an undefined-length sequence by scanning nested delimiters."""
    depth = 1
    n = len(buf)
    while pos + 8 <= n and depth > 0:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if (group, elem) in ((0xFFFE, 0xE000), (0xFFFE, 0xE00D),
                             (0xFFFE, 0xE0DD)):
            # item / delimiter tags always use a 4-byte length, no VR
            length = struct.unpack_from("<I", buf, pos + 4)[0]
            pos += 8
            if (group, elem) == (0xFFFE, 0xE0DD):      # sequence delimiter
                depth -= 1
            elif (group, elem) == (0xFFFE, 0xE000) and length != 0xFFFFFFFF:
                pos += length                           # defined-length item
            continue
        # nested element inside a delimited item: honour the transfer syntax
        if explicit:
            vr = buf[pos + 4:pos + 6]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 8)[0]
                pos += 12
            else:
                length = struct.unpack_from("<H", buf, pos + 6)[0]
                pos += 8
        else:
            length = struct.unpack_from("<I", buf, pos + 4)[0]
            pos += 8
        if length == 0xFFFFFFFF:
            depth += 1
        else:
            pos += length
    return pos


# _TAGS in ascending (group, element) order — MUST match kDicomWanted in
# native/hostops.cc (asserted by tests/test_native.py)
_SCAN_NAMES = [_TAGS[k] for k in sorted(_TAGS)]


def dcmread(path: str) -> DicomImage:
    """Read a DICOM file — the ``pydicom.dcmread`` twin for our subset.

    Uses the native C++ element scanner (``native/hostops.cc:dicom_scan``)
    when available — the per-element walk dominates converting a UKB
    subject (thousands of files); value decoding stays here.  Falls back
    to the pure-Python parser on any stream the scanner declines."""
    with open(path, "rb") as f:
        buf = f.read()

    from ukbb_cardiac_tpu_torch import native
    rows = native.dicom_scan(buf)
    if rows is not None:
        attrs: Dict[str, object] = {}
        for idx, off, ln, vr_code in rows.tolist():
            name = _SCAN_NAMES[idx]
            vr = (None if vr_code == 0 else
                  bytes((vr_code & 0xFF, vr_code >> 8)).decode("ascii",
                                                               "replace"))
            attrs[name] = _decode_value(name, vr, buf[off:off + ln])
        return DicomImage(attrs)
    return _dcmread_pure(buf)


def _dcmread_pure(buf: bytes) -> DicomImage:
    attrs: Dict[str, object] = {}
    if buf[128:132] == b"DICM":
        # file meta group: always explicit VR LE; read until group != 0002
        pos = 132
        transfer = EXPLICIT_LE
        n = len(buf)
        while pos + 8 <= n:
            group, elem = struct.unpack_from("<HH", buf, pos)
            if group != 0x0002:
                break
            vr = buf[pos + 4:pos + 6]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 8)[0]
                hdr = 12
            else:
                length = struct.unpack_from("<H", buf, pos + 6)[0]
                hdr = 8
            if (group, elem) == (0x0002, 0x0010):
                transfer = buf[pos + hdr:pos + hdr + length].decode(
                    "ascii").strip("\x00 ")
            pos += hdr + length
        if transfer == IMPLICIT_LE:
            explicit = False
        elif transfer == EXPLICIT_LE or transfer in COMPRESSED_SYNTAXES:
            # encapsulated syntaxes always carry an explicit-VR-LE dataset
            explicit = True
        else:
            raise UnsupportedDicom(
                f"transfer syntax {transfer} — this reader supports "
                "implicit/explicit VR little endian, JPEG lossless "
                "(.4.57/.4.70), JPEG-LS (.4.80/.4.81) and RLE (1.2.5). "
                "Convert other files first, e.g. `gdcmconv --raw`.")
        if transfer in COMPRESSED_SYNTAXES:
            # needed by pixel_array to pick the decoder; omitted for
            # uncompressed files so the native-scanner fast path and this
            # one produce identical attribute sets
            attrs["TransferSyntaxUID"] = transfer
        _parse_dataset(buf, pos, explicit, attrs,
                       encapsulated_ok=transfer in COMPRESSED_SYNTAXES)
    else:
        # raw dataset without preamble: assume implicit VR LE
        _parse_dataset(buf, 0, False, attrs)
    return DicomImage(attrs)


_WRITE_VRS = {
    "SOPInstanceUID": "UI", "SeriesInstanceUID": "UI",
    "SeriesDescription": "LO", "SliceThickness": "DS",
    "SpacingBetweenSlices": "DS", "TriggerTime": "DS",
    "CardiacNumberOfImages": "IS", "InstanceNumber": "IS",
    "ImagePositionPatient": "DS", "ImageOrientationPatient": "DS",
    "NumberOfFrames": "IS", "Rows": "US", "Columns": "US",
    "PixelSpacing": "DS", "BitsAllocated": "US",
    "PixelRepresentation": "US", "SamplesPerPixel": "US",
    "RescaleIntercept": "DS", "RescaleSlope": "DS",
}
_NAME_TO_TAG = {v: k for k, v in _TAGS.items()}


def dcmwrite_minimal(path: str, attrs: Dict[str, object],
                     pixel: Optional[np.ndarray] = None,
                     transfer_syntax: str = EXPLICIT_LE) -> None:
    """Write a minimal explicit-VR-little-endian DICOM file.

    Used for synthetic fixtures and tests (the reference relies on real
    UKB DICOMs that cannot ship with the repo). ``pixel`` is a (rows,
    cols) int16/uint16 array.  With a compressed ``transfer_syntax`` the
    pixel data is encoded (data/jpegcodec.py) and written encapsulated
    (one fragment per frame, empty Basic Offset Table).
    """
    body = bytearray()

    def put(group, elem, vr, val: bytes):
        if len(val) % 2:
            # DICOM pads string VRs with space 0x20; only UI (and binary
            # VRs) pad with NUL
            val += (b"\x00" if vr in ("UI", "OB", "OW", "UN") else b"\x20")
        body.extend(struct.pack("<HH", group, elem))
        if vr in ("OB", "OW", "SQ", "UT", "UN", "OF"):
            body.extend(vr.encode() + b"\x00\x00")
            body.extend(struct.pack("<I", len(val)))
        else:
            body.extend(vr.encode())
            body.extend(struct.pack("<H", len(val)))
        body.extend(val)

    items = []
    for name, value in attrs.items():
        tag = _NAME_TO_TAG.get(name)
        if tag is None:
            continue
        vr = _WRITE_VRS[name]
        if vr == "US":
            raw = struct.pack("<H", int(value))
        elif isinstance(value, (list, tuple, np.ndarray)):
            raw = "\\".join(str(v) for v in value).encode()
        else:
            raw = str(value).encode()
        items.append((tag, vr, raw))
    for (group, elem), vr, raw in sorted(items):
        put(group, elem, vr, raw)
    if pixel is not None:
        if transfer_syntax == EXPLICIT_LE:
            put(0x7FE0, 0x0010, "OW", np.ascontiguousarray(pixel).tobytes())
        elif transfer_syntax in COMPRESSED_SYNTAXES:
            from ukbb_cardiac_tpu_torch.data import jpegcodec as jc

            pix = np.asarray(pixel)
            frames = pix[None] if pix.ndim == 2 else pix
            P = int(attrs.get("BitsAllocated", 16))

            def encode(frame):
                u = frame.astype(np.int64)
                if u.min() < 0:
                    raise ValueError("compressed writer takes unsigned "
                                     "sample values")
                if transfer_syntax in (JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1):
                    return jc.encode_jpeg_lossless(u, P, sv=1)
                if transfer_syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR):
                    return jc.encode_jpegls(u, P)
                return jc.encode_rle(frame)

            # encapsulated OB, undefined length (PS3.5 A.4)
            body.extend(struct.pack("<HH", 0x7FE0, 0x0010))
            body.extend(b"OB\x00\x00")
            body.extend(struct.pack("<I", 0xFFFFFFFF))
            body.extend(struct.pack("<HHI", 0xFFFE, 0xE000, 0))  # empty BOT
            for frame in frames:
                blob = encode(frame)
                if len(blob) % 2:
                    blob += b"\x00"
                body.extend(struct.pack("<HHI", 0xFFFE, 0xE000, len(blob)))
                body.extend(blob)
            body.extend(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
        else:
            raise UnsupportedDicom(f"cannot write syntax {transfer_syntax}")

    meta = bytearray()

    def put_meta(group, elem, vr, val: bytes):
        if len(val) % 2:
            val += b"\x00"
        meta.extend(struct.pack("<HH", group, elem))
        meta.extend(vr.encode())
        meta.extend(struct.pack("<H", len(val)))
        meta.extend(val)

    put_meta(0x0002, 0x0010, "UI", transfer_syntax.encode())

    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(bytes(meta))
        f.write(bytes(body))


def is_dicom_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(132)
        return head[128:132] == b"DICM"
    except OSError:
        return False
