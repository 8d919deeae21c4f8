"""The port's native host ops: ``native/hostops.cc``, bound with ctypes.

A copy of ``ukbb_cardiac_tpu/native/__init__.py`` without its up-leg
packer: the DICOM reader's
:func:`dicom_scan`, :func:`jpeg_sof3_decode` and :func:`jpegls_decode`;
the connected-component passes on 2D masks that ``ops/cc.py`` routes
through (:func:`largest_cc_2d`, :func:`count_significant_cc_2d`,
:func:`remove_small_cc_2d`), :func:`label_areas_per_frame`, and
:func:`count_significant_cc_frames`, the aortic QC's one pass over a
cine's frames; and :func:`unpack_bits`, the engines' label readback.
The library is built with ``g++ -O3 -shared -fPIC`` (not
``-march=native``: a library built on one host and loaded on another
CPU would fault at call time) at first use, into
``build/native/`` at the root of the checkout (listed in
``.gitignore``).  Its file name carries a digest of the source and
flags, so an edited source is rebuilt.  One thread builds under a lock;
the compiler writes a temporary file of its own, which replaces the
target atomically.  Nothing here runs at import time.

A build that fails raises, with the compiler's output: there is no
pure-Python fallback for a missing toolchain (the JAX package's
"unavailable" returns are not copied).  The numpy and scipy versions of
the CC passes and the unpack stay beside their callers as the plain
versions the tests hold these to.  A stream the native code
declines (``dicom_scan`` returns None; a JPEG decoder declines an image
larger than its working buffer) still goes to the Python decoder, as in
the JAX package: that is what the reference computes, not a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "hostops.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_serial = itertools.count()


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libhostops-{digest[:16]}.so"


def build() -> Path:
    """Compile ``hostops.cc`` unless a current build exists; returns the
    library's path.  Raises RuntimeError if the compiler is missing or
    fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique per call: threads share a pid
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{next(_serial)}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as err:
        raise RuntimeError(f"cannot build {SRC.name} with {CXX}: {err}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed for {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built if needed, with its C signatures
    declared.  Thread-safe: the cohort and the conversion reach first
    use from several threads."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            lib.largest_cc_2d.restype = i64
            lib.largest_cc_2d.argtypes = [i8p, i32, i32, i32, i8p]
            lib.count_significant_cc_2d.restype = i32
            lib.count_significant_cc_2d.argtypes = [i8p, i32, i32, i32, i64]
            lib.remove_small_cc_2d.restype = None
            lib.remove_small_cc_2d.argtypes = [i8p, i32, i32, i32, i64, i8p]
            lib.label_areas_per_frame.restype = None
            lib.label_areas_per_frame.argtypes = [i16p, i64, i32, i32, i64p]
            lib.count_significant_cc_frames.restype = None
            lib.count_significant_cc_frames.argtypes = [
                i16p, i32, i32, i32, i32, i32, i64,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"), i64p]
            lib.unpack_bits.restype = None
            lib.unpack_bits.argtypes = [i8p, i64, i32, i8p, i64]
            u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
            i32_ref = ctypes.POINTER(ctypes.c_int32)
            lib.dicom_scan.restype = ctypes.c_int64
            lib.dicom_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p,
                                       ctypes.c_int64]
            for fn in (lib.jpeg_sof3_decode, lib.jpegls_decode):
                fn.restype = ctypes.c_int32
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, u16p,
                               ctypes.c_int64, i32_ref, i32_ref]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here.  A query only: every op
    of this module still raises when the build fails."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _jpeg_decode(fn_name: str, data: bytes, expected_pixels):
    lib = get_lib()
    cap = int(expected_pixels) if expected_pixels else (1 << 22)
    out = np.empty(cap, dtype=np.uint16)
    rows = ctypes.c_int32(0)
    cols = ctypes.c_int32(0)
    rc = getattr(lib, fn_name)(data, np.int64(len(data)), out,
                               np.int64(cap), ctypes.byref(rows),
                               ctypes.byref(cols))
    if rc == -3 and expected_pixels:  # header dims exceed the caller's hint
        return _jpeg_decode(fn_name, data, None)
    if rc == -3:
        # larger than the default working buffer: the caller takes the
        # Python decoder
        return None
    if rc != 0:
        from ukbb_cardiac_tpu_torch.data.jpegcodec import JpegDecodeError
        kind = {-1: "malformed", -2: "unsupported"}.get(rc, f"error {rc}")
        raise JpegDecodeError(f"native {fn_name}: {kind} stream")
    return out[:rows.value * cols.value].reshape(rows.value, cols.value)


def jpeg_sof3_decode(data: bytes, expected_pixels=None):
    """Native JPEG lossless (SOF3) decode → (rows, cols) uint16, or None
    for an image larger than the working buffer (callers then take
    data/jpegcodec.py).  Raises JpegDecodeError on bad streams."""
    return _jpeg_decode("jpeg_sof3_decode", data, expected_pixels)


def jpegls_decode(data: bytes, expected_pixels=None):
    """Native JPEG-LS decode → (rows, cols) uint16, or None as
    :func:`jpeg_sof3_decode`."""
    return _jpeg_decode("jpegls_decode", data, expected_pixels)


def dicom_scan(buf: bytes):
    """Walk a DICOM byte stream natively; rows (tag_index, offset, length,
    vr_code) for the Biobank attribute subset.  Returns the (k, 4) int64
    array, or None if the stream needs the pure-Python path (unsupported
    transfer syntax / encapsulated pixels / malformed)."""
    lib = get_lib()
    out = np.empty((64, 4), dtype=np.int64)
    k = lib.dicom_scan(buf, np.int64(len(buf)), out.reshape(-1),
                       np.int64(out.shape[0]))
    if k < 0:
        return None
    return out[:k]


def _require_2d(binary) -> np.ndarray:
    b = np.ascontiguousarray(np.asarray(binary).astype(np.uint8))
    if b.ndim != 2:
        raise ValueError(f"native CC passes take 2D masks, got shape "
                         f"{b.shape} (ops/cc.py takes 3D masks to scipy)")
    return b


def largest_cc_2d(binary, connectivity: int = 1) -> np.ndarray:
    """Largest connected component of a 2D mask as a bool mask; of
    components of equal size, the first in raster order (scipy's
    ``argmax`` over its labels)."""
    lib = get_lib()
    b = _require_2d(binary)
    out = np.empty_like(b)
    # the pass is orientation-agnostic: (nx = columns, ny = rows)
    lib.largest_cc_2d(b, np.int32(b.shape[1]), np.int32(b.shape[0]),
                      np.int32(connectivity), out)
    return out.astype(bool)


def count_significant_cc_2d(binary, pixel_thres: int = 10,
                            connectivity: int = 2) -> int:
    """Number of components of a 2D mask larger than ``pixel_thres``."""
    lib = get_lib()
    b = _require_2d(binary)
    return int(lib.count_significant_cc_2d(
        b, np.int32(b.shape[1]), np.int32(b.shape[0]),
        np.int32(connectivity), np.int64(pixel_thres)))


def remove_small_cc_2d(binary, thres: int = 10,
                       connectivity: int = 1) -> np.ndarray:
    """uint8 mask of the components of a 2D mask with at least ``thres``
    pixels."""
    lib = get_lib()
    b = _require_2d(binary)
    out = np.empty_like(b)
    lib.remove_small_cc_2d(b, np.int32(b.shape[1]), np.int32(b.shape[0]),
                           np.int32(connectivity), np.int64(thres), out)
    return out


def label_areas_per_frame(volume, n_labels: int) -> np.ndarray:
    """Per-frame per-label voxel counts of an (X, Y, Z, T) label volume
    → (T, n_labels) int64."""
    lib = get_lib()
    volume = np.asarray(volume)
    if volume.min() < np.iinfo(np.int16).min or \
            volume.max() > np.iinfo(np.int16).max:
        raise ValueError("label values exceed int16 range")
    v = np.ascontiguousarray(
        np.transpose(volume, (3, 0, 1, 2)).astype(np.int16))
    T = v.shape[0]
    counts = np.empty((T, n_labels), dtype=np.int64)
    lib.label_areas_per_frame(v.reshape(-1), np.int64(v.size // T),
                              np.int32(T), np.int32(n_labels),
                              counts.reshape(-1))
    return counts


def count_significant_cc_frames(frames, label: int, pixel_thres: int = 10,
                                connectivity: int = 2):
    """Per-frame :func:`count_significant_cc_2d` of ``frames == label``
    over a (T, ny, nx) int16 stack, in one pass that compares the labels
    in place → ((T,) int32 counts, (T,) int64 areas of the label).  A
    C-contiguous stack is read without a copy."""
    frames = np.asarray(frames)
    if frames.ndim != 3 or frames.dtype != np.int16:
        raise ValueError(f"count_significant_cc_frames takes a (T, ny, nx) "
                         f"int16 stack, got {frames.dtype} {frames.shape}")
    if not np.iinfo(np.int16).min <= label <= np.iinfo(np.int16).max:
        raise ValueError(f"label {label} exceeds int16 range")
    frames = np.ascontiguousarray(frames)
    T, ny, nx = frames.shape
    counts = np.empty(T, dtype=np.int32)
    areas = np.empty(T, dtype=np.int64)
    get_lib().count_significant_cc_frames(
        frames.reshape(-1), np.int32(nx), np.int32(ny), np.int32(T),
        np.int32(label), np.int32(connectivity), np.int64(pixel_thres),
        counts, areas)
    return counts, areas


def _check_bits(bits: int) -> None:
    if bits not in (1, 2, 4):
        raise ValueError(f"bits must be 1, 2 or 4, got {bits}")


def unpack_bits(packed, bits: int, n: int) -> np.ndarray:
    """Unpack ``bits``-wide fields (low field first) from a uint8 byte
    array into ``n`` uint8 values, in one pass through a per-byte table:
    the host-side inverse of the engines' device pack
    (``infer/engine.py::pack_bits``)."""
    _check_bits(bits)
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    if n > packed.size * (8 // bits):
        raise ValueError(f"{packed.size} packed bytes hold at most "
                         f"{packed.size * (8 // bits)} values, asked for {n}")
    out = np.empty(n, dtype=np.uint8)
    get_lib().unpack_bits(packed, np.int64(packed.size), np.int32(bits),
                          out, np.int64(n))
    return out
