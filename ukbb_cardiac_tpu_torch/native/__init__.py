"""The port's native host ops: ``native/hostops.cc``, bound with ctypes.

A copy of ``ukbb_cardiac_tpu/native/__init__.py`` for the entry points
the DICOM reader uses: :func:`dicom_scan`, :func:`jpeg_sof3_decode` and
:func:`jpegls_decode`.  The library is built with ``g++ -O3 -shared
-fPIC`` (not ``-march=native``: a library built on one host and loaded
on another CPU would fault at call time) at first use, into
``build/native/`` at the root of the checkout (listed in
``.gitignore``).  Its file name carries a digest of the source and
flags, so an edited source is rebuilt.  One thread builds under a lock;
the compiler writes a temporary file of its own, which replaces the
target atomically.  Nothing here runs at import time.

A build that fails raises, with the compiler's output: there is no
pure-Python fallback for a missing toolchain.  A stream the native code
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
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
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
