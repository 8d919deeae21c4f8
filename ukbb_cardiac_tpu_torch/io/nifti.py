"""Pure-numpy NIfTI-1 reader/writer.

The reference pipeline uses nibabel for all image I/O (e.g.
``common/image_utils.py:252-339``, ``common/deploy_network.py:80-151``).
nibabel is not a dependency of this framework; NIfTI-1 is a simple fixed
348-byte header followed by Fortran-ordered voxel data, so we implement it
directly.  The public surface mirrors the small part of nibabel the
reference uses: ``load``, ``save``, and an image object exposing
``.affine``, ``.header`` (dict-like with ``dim``/``pixdim``), ``.dataobj``
and ``.get_fdata()``.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ukbb_cardiac_tpu_torch.utils.timing import span

_HDR_SIZE = 348
_MAGIC_SINGLE = b"n+1\x00"

# NIfTI-1 datatype codes <-> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class Nifti1Header:
    """Minimal dict-like NIfTI-1 header.

    Supports the fields the reference reads/writes: ``dim``, ``pixdim``
    (``deploy_network.py:137``, ``image_utils.py:256,277``).
    """

    def __init__(self, dim=None, pixdim=None, datatype=16):
        self.dim = np.ones(8, dtype=np.int16) if dim is None else np.asarray(dim, dtype=np.int16)
        self.pixdim = (
            np.ones(8, dtype=np.float32) if pixdim is None else np.asarray(pixdim, dtype=np.float32)
        )
        self.datatype = datatype
        self.scl_slope = 0.0
        self.scl_inter = 0.0

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        if key in ("dim", "pixdim"):
            getattr(self, key)[:] = value
        else:
            setattr(self, key, value)

    def copy(self):
        h = Nifti1Header(self.dim.copy(), self.pixdim.copy(), self.datatype)
        h.scl_slope, h.scl_inter = self.scl_slope, self.scl_inter
        return h


class Nifti1Image:
    """In-memory NIfTI image: voxel array + 4x4 RAS affine + header."""

    def __init__(self, dataobj, affine, header=None):
        self.dataobj = np.asanyarray(dataobj)
        self.affine = (
            np.eye(4, dtype=np.float64) if affine is None else np.asarray(affine, dtype=np.float64)
        )
        if header is None:
            header = Nifti1Header()
            ndim = self.dataobj.ndim
            header.dim[0] = ndim
            header.dim[1 : 1 + ndim] = self.dataobj.shape
        self.header = header

    @property
    def shape(self):
        return self.dataobj.shape

    def get_fdata(self):
        return np.asarray(self.dataobj, dtype=np.float64)

    # nibabel 2.x compat used throughout the reference (deploy_network.py:81)
    def get_data(self):
        return self.dataobj


def _parse_header(hdr: bytes):
    if len(hdr) < _HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    byteorder = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr_be = struct.unpack_from(">i", hdr, 0)[0]
        if sizeof_hdr_be == _HDR_SIZE:
            byteorder = ">"
        else:
            raise ValueError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    u = lambda fmt, off: struct.unpack_from(byteorder + fmt, hdr, off)
    dim = np.array(u("8h", 40), dtype=np.int16)
    datatype = u("h", 70)[0]
    pixdim = np.array(u("8f", 76), dtype=np.float32)
    vox_offset = u("f", 108)[0]
    scl_slope = u("f", 112)[0]
    scl_inter = u("f", 116)[0]
    qform_code = u("h", 252)[0]
    sform_code = u("h", 254)[0]
    quatern = u("3f", 256)
    qoffset = u("3f", 268)
    srow = np.array(u("12f", 280), dtype=np.float64).reshape(3, 4)
    magic = hdr[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError("bad NIfTI magic")

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :4] = srow
    elif qform_code > 0:
        affine = _qform_to_affine(quatern, qoffset, pixdim)
    else:
        # Fall back to scaling by pixdim, matching nibabel's base affine.
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    return {
        "byteorder": byteorder,
        "dim": dim,
        "datatype": datatype,
        "pixdim": pixdim,
        "vox_offset": int(round(vox_offset)) if vox_offset else 352,
        "scl_slope": scl_slope,
        "scl_inter": scl_inter,
        "affine": affine,
    }


def _qform_to_affine(quatern, qoffset, pixdim):
    b, c, d = (float(x) for x in quatern)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    Z = np.diag([pixdim[1], pixdim[2], pixdim[3] * qfac])
    affine = np.eye(4)
    affine[:3, :3] = R @ Z
    affine[:3, 3] = qoffset
    return affine


def _read_bytes_uncached(filename: str) -> bytes:
    if str(filename).endswith(".gz"):
        with gzip.open(filename, "rb") as f:
            return f.read()
    with open(filename, "rb") as f:
        return f.read()


# Decompressed-bytes LRU: the cohort pipeline reads the same subject
# files from several stages (image for deploy + volumes + strain; seg
# for volumes + QC + contours), and on this 1-core host the repeated
# zlib inflates were a top-5 profiled cost (~0.3 s/subject).  Safe to
# share: ``load`` hands out read-only ``frombuffer`` views, so callers
# cannot mutate the cached bytes; the (mtime_ns, size) key invalidates
# rewritten files (the deploy→phenotype chain rewrites seg files).
_BYTES_CACHE: dict = {}
_BYTES_CACHE_BUDGET = 512 * 1024 * 1024
_bytes_cache_size = 0


def _read_bytes(filename: str) -> bytes:
    global _bytes_cache_size
    try:
        st = os.stat(filename)
    except OSError:
        return _read_bytes_uncached(filename)
    key = (os.path.realpath(filename), st.st_mtime_ns, st.st_size)
    hit = _BYTES_CACHE.get(key)
    if hit is not None:
        # move-to-end for LRU order (dicts preserve insertion order)
        _BYTES_CACHE[key] = _BYTES_CACHE.pop(key)
        return hit
    raw = _read_bytes_uncached(filename)
    if len(raw) <= _BYTES_CACHE_BUDGET // 4:
        _BYTES_CACHE[key] = raw
        _bytes_cache_size += len(raw)
        while _bytes_cache_size > _BYTES_CACHE_BUDGET and _BYTES_CACHE:
            oldest = next(iter(_BYTES_CACHE))
            _bytes_cache_size -= len(_BYTES_CACHE.pop(oldest))
    return raw


def read_shape(filename: str) -> tuple:
    """Shape of a ``.nii`` / ``.nii.gz`` volume from its header ONLY.

    Reads just the first 352 bytes (streamed for gzip, so the voxel
    payload is never inflated) — used to size device-resident pools over
    a whole dataset without decoding every cine
    (``train/device_pool.py``)."""
    if str(filename).endswith(".gz"):
        with gzip.open(filename, "rb") as f:
            hdr = f.read(_HDR_SIZE)
    else:
        with open(filename, "rb") as f:
            hdr = f.read(_HDR_SIZE)
    meta = _parse_header(hdr)
    dim = meta["dim"]
    return tuple(int(x) for x in dim[1 : 1 + int(dim[0])])


@span("ukbb.io.nifti.load")
def load(filename: str) -> Nifti1Image:
    """Load a ``.nii`` / ``.nii.gz`` file."""
    raw = _read_bytes(filename)
    meta = _parse_header(raw[:_HDR_SIZE])
    dim = meta["dim"]
    ndim = int(dim[0])
    shape = tuple(int(x) for x in dim[1 : 1 + ndim])
    dtype = np.dtype(_DTYPES[meta["datatype"]]).newbyteorder(meta["byteorder"])
    count = int(np.prod(shape)) if shape else 1
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=meta["vox_offset"])
    # NIfTI voxel data is Fortran-ordered (x varies fastest).
    array = data.reshape(shape, order="F")
    slope, inter = meta["scl_slope"], meta["scl_inter"]
    # nibabel semantics: slope 0 / NaN / non-finite means "no scaling"
    if np.isfinite(slope) and (slope not in (0.0, 1.0)
                               or (slope == 1.0 and np.isfinite(inter)
                                   and inter != 0.0)):
        array = array * slope + inter
    header = Nifti1Header(dim=dim, pixdim=meta["pixdim"], datatype=meta["datatype"])
    header.scl_slope = meta["scl_slope"]
    header.scl_inter = meta["scl_inter"]
    return Nifti1Image(array, meta["affine"], header)


def _build_header_bytes(image: Nifti1Image) -> bytes:
    data = np.asanyarray(image.dataobj)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    dtype = data.dtype.newbyteorder("=")
    if data.dtype.byteorder not in ("=", "|") and data.dtype != dtype:
        # data loaded from a big-endian file: actually swap the bytes —
        # relabelling the dtype alone would write a little-endian header
        # over big-endian voxels (every value silently corrupted)
        data = data.astype(dtype)
    if np.dtype(dtype) not in _DTYPE_CODES:
        data = data.astype(np.float64 if data.dtype.kind == "f" else np.int32)
        dtype = data.dtype
    code = _DTYPE_CODES[np.dtype(dtype)]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = np.ones(8, dtype=np.int16)
    dim[0] = data.ndim
    dim[1 : 1 + data.ndim] = data.shape
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    pixdim = np.ones(8, dtype=np.float32)
    if image.header is not None:
        src = np.asarray(image.header.pixdim, dtype=np.float32)
        pixdim[: len(src)] = src
    # Keep spatial pixdims consistent with the affine column norms.
    norms = np.linalg.norm(image.affine[:3, :3], axis=0)
    for i in range(3):
        if norms[i] > 0:
            pixdim[i + 1] = norms[i]
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code: affine is authoritative
    struct.pack_into("<3f", hdr, 256, 0.0, 0.0, 0.0)
    struct.pack_into("<3f", hdr, 268, *image.affine[:3, 3].astype(np.float32))
    struct.pack_into("<12f", hdr, 280, *image.affine[:3, :4].astype(np.float32).ravel())
    hdr[344:348] = _MAGIC_SINGLE
    return bytes(hdr), data


@span("ukbb.io.nifti.save")
def save(image: Nifti1Image, filename: str) -> None:
    """Save to ``.nii`` / ``.nii.gz``."""
    hdr, data = _build_header_bytes(image)
    # Voxels go out in Fortran order.  Loaded images are F-contiguous
    # (``load`` reshapes with order="F"), and so are the deploy engines'
    # labels (``PendingSegmentation.result``), so ``data.T`` is a
    # C-contiguous zero-copy view that the buffer protocol can stream
    # directly; anything else pays one serialisation copy, under the
    # span ``ukbb.io.nifti.reorder``.  Writing header and
    # voxels as separate f.write calls (instead of one concatenated
    # payload) avoids a second full-size copy — on the 1-core cohort
    # host these copies were a measured share of the per-subject wall.
    if data.flags.f_contiguous:
        voxels = data.T if data.ndim > 1 else data
    elif data.flags.c_contiguous and data.ndim <= 1:
        voxels = data
    else:
        with span("ukbb.io.nifti.reorder"):
            voxels = data.tobytes(order="F")
    if str(filename).endswith(".gz"):
        # mtime=0 → deterministic output bytes for golden-file tests.
        # compresslevel=1, like nibabel's default: level 9 costs ~30 s on
        # a float64 seg cine (measured) vs 0.55 s at level 1 — NIfTI
        # writes dominated cohort throughput before this was set.
        with open(filename, "wb") as raw:
            with gzip.GzipFile(filename="", fileobj=raw, mode="wb", mtime=0,
                               compresslevel=1) as f:
                f.write(hdr)
                f.write(b"\x00" * 4)
                f.write(voxels)
    else:
        with open(filename, "wb") as f:
            f.write(hdr)
            f.write(b"\x00" * 4)
            f.write(voxels)
