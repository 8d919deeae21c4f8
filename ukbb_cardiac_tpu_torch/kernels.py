"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``), at first use, and
bound with ``ctypes``.  The library's file name carries a hash of the
source and flags, so an edited source is rebuilt and never mixed up with
an old build.  Nothing here runs at import time.

The cohort driver reaches first use from several threads at once: a lock
per kernel makes one of them build while the others wait, every compile
writes a temporary file of its own, and :func:`count_launches` updates
the wrappers' launch counters under a lock.  A launch sent into a
CUDA-graph capture does not run then: the capture's
:class:`LaunchRecord` keeps it, and each replay of the graph adds the
record to the counters (``reg/programs.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import itertools
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List

from ukbb_cardiac_tpu_torch.utils.timing import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> [(symbol, restype, argtypes)]
SIGNATURES = {
    "fused_head": [
        # bf16, n_level, N, X, Y, n_class; feats[5]; chans[5];
        # wbuf, tap_idx, tap_w, scratch, out, stream
        ("ukbb_fused_head", _I, [_I] * 6 + [_P] * 5 + [_I] * 5 + [_P] * 6),
        ("ukbb_cuda_error_string", ctypes.c_char_p, [_I]),
    ],
    "bspline_field": [
        # B, Cx, Cy, X, Y, spacing, the launch (rows, threads);
        # weight table, input, output, stream
        ("ukbb_bspline_field", _I, [_I] * 8 + [_P] * 4),
        # the same, with the band plan (ni, nj, rows, width) after spacing
        ("ukbb_bspline_field_adjoint", _I, [_I] * 10 + [_P] * 4),
        ("ukbb_cuda_error_string", ctypes.c_char_p, [_I]),
    ],
}


@dataclass
class Build:
    name: str
    path: Path
    seconds: float     # 0.0 when an existing build was reused
    ptxas: List[str]   # the compiler's register / spill / smem lines


_LIBS: Dict[str, ctypes.CDLL] = {}
# one re-entrant lock per kernel name (load holds it while it builds)
_BUILD_LOCKS = {name: threading.RLock() for name in SIGNATURES}
_TMP_SERIAL = itertools.count()
_COUNT_LOCK = threading.Lock()
# the record of the CUDA-graph capture underway (``reg/programs.py``
# captures one graph at a time in the process)
_RECORD: "LaunchRecord | None" = None


class LaunchRecord:
    """The kernel launches that a CUDA-graph capture recorded, by wrapper,
    counter and class.  A launch sent into a capture runs only when the
    graph replays, so it is recorded here instead of counted, and
    :meth:`replayed` adds the record to the wrappers' counters at each
    replay."""

    def __init__(self):
        self.counts: Dict[tuple, int] = {}

    def add(self, fn, n: int, attr: str = "launches",
            n_class: int | None = None) -> None:
        key = (fn, attr, n_class)
        self.counts[key] = self.counts.get(key, 0) + n

    def replayed(self) -> None:
        for (fn, attr, n_class), n in self.counts.items():
            count_launches(fn, n, attr, n_class)


@contextlib.contextmanager
def recording(record: LaunchRecord):
    """Record into ``record`` the launches sent into the capture that
    the caller runs inside this block."""
    global _RECORD
    with _COUNT_LOCK:
        _RECORD = record
    try:
        yield record
    finally:
        with _COUNT_LOCK:
            _RECORD = None


def _capturing() -> bool:
    """Whether the calling thread's current CUDA stream is being captured
    into a graph (a captured backward runs on the autograd engine's
    device thread, with the capture stream as its current stream)."""
    import torch

    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def count_launches(fn, n: int, attr: str = "launches",
                   n_class: int | None = None) -> None:
    """Add ``n`` to the wrapper ``fn``'s counter ``attr`` (and, with
    ``n_class``, to ``fn.launches_by_class[n_class]``) under a lock:
    ``+=`` on an attribute is a read-modify-write that loses counts when
    worker threads launch together.  A launch into a CUDA-graph capture
    goes to the capture's :class:`LaunchRecord` instead (none outside
    ``reg/programs.py``: then it is not counted)."""
    capturing = _capturing()
    with _COUNT_LOCK:
        if capturing:
            if _RECORD is not None:
                _RECORD.add(fn, n, attr, n_class)
            return
        setattr(fn, attr, getattr(fn, attr) + n)
        if n_class is not None:
            fn.launches_by_class[n_class] = (
                fn.launches_by_class.get(n_class, 0) + n)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _finish(started):
    proc, _, _, t0 = started
    log, _ = proc.communicate()
    return log, time.perf_counter() - t0


@span("ukbb.kernels.build")
def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Build]:
    """Compile every named kernel that has no current build, one ``nvcc``
    per source, all started together.  Raises with the compiler's output
    if one fails.  Holds each named kernel's lock (in a fixed order), so
    a concurrent caller waits for this build and then reuses it."""
    names = sorted(set(names))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started, done = {}, {}
    with contextlib.ExitStack() as held:
        for name in names:
            held.enter_context(_BUILD_LOCKS[name])
        for name in names:
            out = lib_path(name)
            if out.exists():
                done[name] = Build(name, out, 0.0, [])
                continue
            # unique per call: threads share a pid
            tmp = out.with_name(f"{out.name}.{os.getpid()}."
                                f"{next(_TMP_SERIAL)}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, out, tmp, time.perf_counter())
        # wait on every compiler at once, so each build's time is its own
        with ThreadPoolExecutor(max(len(started), 1)) as pool:
            logs = dict(zip(started, pool.map(_finish, started.values())))
        for name, (proc, out, tmp, t0) in started.items():
            log, seconds = logs[name]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            lines = [ln.strip() for ln in log.splitlines()
                     if re.search(r"registers|spill|Compiling entry", ln)]
            done[name] = Build(name, out, seconds, lines)
    return done


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with its C
    signatures declared."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCKS[name]:
        if name not in _LIBS:
            path = build([name])[name].path
            lib = ctypes.CDLL(str(path))
            for sym, restype, argtypes in SIGNATURES[name]:
                fn = getattr(lib, sym)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS[name]


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.ukbb_cuda_error_string(err).decode()
