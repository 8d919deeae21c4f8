"""Legacy-VTK polydata I/O (pure numpy).

The reference uses the `vtk` C++ wrapper to write myocardial contours,
landmarks and thickness maps as legacy ``.vtk`` polydata
(``common/cardiac_utils.py:462-536,645-750``).  vtk is not a dependency
here; the legacy format is a simple container, so we implement the
subset the pipeline uses: POINTS, LINES, POINT_DATA / CELL_DATA with
SCALARS and VECTORS arrays.

Files are written as "# vtk DataFile Version 4.0" — the version MIRTK
compatibility forced the reference to sed-patch into its outputs
(``cardiac_utils.py:1392``); we emit it natively.

Writes default to the legacy BINARY encoding (big-endian, double
precision — bit-exact round trip): the cohort pipeline writes ~100
polydata files per subject and ASCII ``str.format`` was its single
largest host cost on this 1-core host (~1.1 s/subject, profiled).
Binary writes the same arrays with ``tofile`` in ~1/50 the time.  This
copy keeps the binary encoding only, which is all the SA chain writes.

The port's copy of ``ukbb_cardiac_tpu/io/vtkio.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class PolyData:
    """Minimal polydata: 3D points, polyline cells, named data arrays."""

    points: np.ndarray  # (N, 3) float
    lines: List[np.ndarray] = field(default_factory=list)  # each an index array
    point_scalars: Dict[str, np.ndarray] = field(default_factory=dict)
    point_vectors: Dict[str, np.ndarray] = field(default_factory=dict)
    cell_scalars: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_cells(self) -> int:
        return len(self.lines)


def _cells_flat(pd: PolyData) -> np.ndarray:
    """Legacy connectivity stream: [len, id0, id1, ...] per cell."""
    if not pd.lines:
        return np.zeros((0,), np.int32)
    m = len(pd.lines[0])
    if all(len(l) == m for l in pd.lines):
        # uniform cells (the pipeline's contours are all segment pairs
        # or fixed-length polylines): one column_stack, no per-cell loop
        arr = np.asarray(pd.lines, dtype=np.int32).reshape(len(pd.lines), m)
        return np.column_stack(
            [np.full(len(pd.lines), m, np.int32), arr]).ravel()
    return np.concatenate(
        [np.concatenate(([len(l)], np.asarray(l, dtype=np.int64)))
         for l in pd.lines]).astype(np.int32)


def _save_binary(pd: PolyData, path: str, title: str) -> None:
    """Legacy BINARY polydata: section keywords in ASCII, array payloads
    as raw big-endian bytes (the VTK wire convention).  Points and
    vectors are written double-precision so the round trip is
    bit-exact (the strain tables are derived from re-loaded contour
    points; float32 would inject ~1e-7 relative noise)."""
    with open(path, "wb") as f:
        w = f.write
        w(b"# vtk DataFile Version 4.0\n")
        w(title.encode() + b"\n")
        w(b"BINARY\nDATASET POLYDATA\n")
        pts = np.ascontiguousarray(np.asarray(pd.points, dtype=">f8"))
        w(f"POINTS {pd.n_points} double\n".encode())
        w(pts.tobytes())
        w(b"\n")
        if pd.lines:
            flat = _cells_flat(pd)
            w(f"LINES {pd.n_cells} {flat.size}\n".encode())
            w(flat.astype(">i4").tobytes())
            w(b"\n")

        def scalar_block(name, data):
            data = np.asarray(data)
            if np.issubdtype(data.dtype, np.integer):
                typ, cast = "int", ">i4"
            else:
                typ, cast = "double", ">f8"
            w(f"SCALARS {name} {typ}\nLOOKUP_TABLE default\n".encode())
            w(data.astype(cast).tobytes())
            w(b"\n")

        if pd.point_scalars or pd.point_vectors:
            w(f"POINT_DATA {pd.n_points}\n".encode())
            for name, data in pd.point_scalars.items():
                scalar_block(name, data)
            for name, data in pd.point_vectors.items():
                w(f"VECTORS {name} double\n".encode())
                w(np.asarray(data, dtype=">f8").tobytes())
                w(b"\n")
        if pd.cell_scalars:
            w(f"CELL_DATA {pd.n_cells}\n".encode())
            for name, data in pd.cell_scalars.items():
                scalar_block(name, data)


def save_polydata(pd: PolyData, path: str,
                  title: str = "ukbb_cardiac_tpu") -> None:
    _save_binary(pd, path, title)


_VTK_DTYPES = {
    "bit": None, "char": np.int8, "unsigned_char": np.uint8,
    "short": np.int16, "unsigned_short": np.uint16,
    "int": np.int32, "unsigned_int": np.uint32,
    "long": np.int64, "unsigned_long": np.uint64,
    "float": np.float32, "double": np.float64,
}


class _BinaryCursor:
    """Scan a legacy-BINARY vtk byte stream: ASCII keyword lines
    interleaved with raw big-endian array payloads."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def line(self):
        while True:
            if self.pos >= len(self.buf):
                return None
            nl = self.buf.find(b"\n", self.pos)
            if nl < 0:
                ln, self.pos = self.buf[self.pos:], len(self.buf)
            else:
                ln, self.pos = self.buf[self.pos:nl], nl + 1
            ln = ln.strip()
            if ln:
                return ln.decode("ascii", "replace")

    def array(self, n, np_dtype):
        dt = np.dtype(np_dtype).newbyteorder(">")
        end = self.pos + n * dt.itemsize
        arr = np.frombuffer(self.buf[self.pos:end], dtype=dt)
        if arr.size != n:
            raise ValueError("unexpected EOF in binary vtk payload")
        self.pos = end
        return arr.astype(np_dtype)


def _load_binary(buf: bytes, path: str) -> PolyData:
    cur = _BinaryCursor(buf)
    pd = PolyData(points=np.zeros((0, 3)))
    section = None
    while True:
        ln = cur.line()
        if ln is None:
            break
        up = ln.upper()
        if up.startswith("#") or up == "BINARY" or up.startswith("DATASET"):
            continue
        parts = ln.split()
        key = parts[0].upper()
        if key == "POINTS":
            n = int(parts[1])
            dt = _VTK_DTYPES[parts[2].lower()]
            pd.points = cur.array(n * 3, dt).astype(float).reshape(n, 3)
        elif key in ("LINES", "POLYGONS"):
            n_cells, total = int(parts[1]), int(parts[2])
            vals = cur.array(total, np.int32)
            if n_cells and total % n_cells == 0:
                m = total // n_cells - 1
                grid = vals.reshape(n_cells, m + 1)
                if np.all(grid[:, 0] == m):
                    # uniform cells: one reshape instead of a per-cell loop
                    pd.lines.extend(grid[:, 1:].astype(int))
                    continue
            j = 0
            for _ in range(n_cells):
                m = int(vals[j])
                pd.lines.append(vals[j + 1:j + 1 + m].astype(int))
                j += 1 + m
        elif key == "POINT_DATA":
            section = ("point", int(parts[1]))
        elif key == "CELL_DATA":
            section = ("cell", int(parts[1]))
        elif key == "SCALARS":
            name, dt = parts[1], _VTK_DTYPES[parts[2].lower()]
            kind, n = section
            mark = cur.pos
            ln2 = cur.line()
            if ln2 is None or not ln2.upper().startswith("LOOKUP_TABLE"):
                cur.pos = mark
            arr = cur.array(n, dt)
            arr = (arr.astype(int) if np.issubdtype(np.dtype(dt), np.integer)
                   else arr.astype(float))
            if kind == "point":
                pd.point_scalars[name] = arr
            else:
                pd.cell_scalars[name] = arr
        elif key == "VECTORS":
            name, dt = parts[1], _VTK_DTYPES[parts[2].lower()]
            kind, n = section
            pd.point_vectors[name] = cur.array(
                n * 3, dt).astype(float).reshape(n, 3)
        elif key == "FIELD":
            n_arrays = int(parts[2])
            for _ in range(n_arrays):
                hdr = cur.line().split()
                n_comp, n_tuples = int(hdr[1]), int(hdr[2])
                cur.array(n_comp * n_tuples, _VTK_DTYPES[hdr[3].lower()])
    return pd


def load_polydata(path: str) -> PolyData:
    with open(path, "rb") as f:
        buf = f.read()
    # the encoding line is within the first three lines of any legacy file
    head = b"\n".join(buf.split(b"\n", 4)[:4]).upper()
    if b"BINARY" not in head:
        raise ValueError(f"{path}: only the binary encoding is read here")
    return _load_binary(buf, path)


def append_polydata(pds: List[PolyData]) -> PolyData:
    """Merge polydata blocks, offsetting cell indices — the
    ``vtkAppendPolyData`` equivalent (``cardiac_utils.py:969-984``)."""
    pds = [p for p in pds if p.n_points > 0]
    if not pds:
        return PolyData(points=np.zeros((0, 3)))
    points = np.concatenate([p.points for p in pds], axis=0)
    out = PolyData(points=points)
    offset = 0
    for p in pds:
        for l in p.lines:
            out.lines.append(np.asarray(l) + offset)
        offset += p.n_points
    for name in pds[0].point_scalars:
        if all(name in p.point_scalars for p in pds):
            out.point_scalars[name] = np.concatenate(
                [p.point_scalars[name] for p in pds])
    for name in pds[0].point_vectors:
        if all(name in p.point_vectors for p in pds):
            out.point_vectors[name] = np.concatenate(
                [p.point_vectors[name] for p in pds], axis=0)
    for name in pds[0].cell_scalars:
        if all(name in p.cell_scalars for p in pds):
            out.cell_scalars[name] = np.concatenate(
                [p.cell_scalars[name] for p in pds])
    return out
