"""Structured per-stage timing, the program's profiler spans and
optional device profiling.

Counterpart of ``ukbb_cardiac_tpu/utils/timing.py``: one structured
timer (named spans, aggregated stats, JSON export) in place of the
reference's scattered wall-clock prints, and an optional device trace,
here ``torch.profiler`` over the CPU and the card, written as a Chrome
trace JSON (viewable in ``chrome://tracing``, Perfetto or TensorBoard).

:func:`span` names a stretch of the program's host work on the
profiler's clock: while a profiler records (``device_trace``,
``torch.profiler.profile``, ``emit_nvtx``) it opens a
``torch.profiler.record_function`` range, which lands in the same trace
as the card's kernels (an NVTX range under ``emit_nvtx``); otherwise it
reads one flag and does nothing else.  Every name the port opens starts
with ``ukbb.``:

- ``ukbb.subject`` (one per cohort subject) and ``ukbb.stage.<key>``
  (the cohort's stages, each the stretch its ``stage_seconds[<key>]``
  times);
- ``ukbb.io.nifti.load``, ``ukbb.io.nifti.save``, ``ukbb.io.vtk``,
  ``ukbb.io.csv``: file reads and writes, decode and encode included;
  ``ukbb.io.nifti.reorder``, inside a save: the copy of voxels that are
  not Fortran-contiguous into the file's order;
- ``ukbb.engine.dispatch``, ``ukbb.engine.wait``: a cine's host prep,
  upload and queued programs, and the wait for its labels and their
  unpacking; ``ukbb.deploy.write``: the deploy's host work on the labels
  around its NIfTI writes (casts, the ES frame);
- ``ukbb.program.warmup``, ``.capture``, ``.replay``, ``.release``: a
  program key's first eager call, its capture, a replay with its
  copy-in and copy-out, and the release of dropped programs' pools
  (``reg/programs.py``);
- ``ukbb.reg.dispatch``: the strain stage's registration, field and
  sampling programs queued;
- ``ukbb.phenotype.<name>``: each phenotype stage's host work;
- ``ukbb.kernels.build``: compiling the CUDA kernels;
- ``ukbb.ckpt.load``: a segmentation bundle read and put on its device,
  its head or weight standardisation folded
  (``infer/deploy.py::load_segmentation_model``).

A span goes around a call into a captured program, never inside a
function that a program captures: such a function runs at its warm-up
and capture only, not at its replays.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

# whether a profiler records in the calling thread (torch.profiler
# records the thread that started it): one flag read, about 0.1 us,
# against about 9 us for a record_function that finds none
_recording = torch._C._autograd._profiler_enabled


class span:
    """``with span(name): ...`` or ``@span(name)``: a profiler range named
    ``name`` around the block or each call while a profiler records, and
    a flag read otherwise.  A ``span`` object used as a context manager
    serves one ``with`` at a time; as a decorator it serves any number
    of calls, from any thread (a thread that no profiler records reads
    the flag as off)."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _recording():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        opened, self._range = self._range, None
        if opened is not None:
            opened.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call


class StageTimer:
    """Hierarchical named wall-clock spans with aggregation.

    >>> timer = StageTimer()
    >>> with timer.span("segment"):
    ...     ...
    >>> timer.summary()["segment"]["total_s"]
    """

    def __init__(self):
        self._records = defaultdict(list)
        # a span stack per thread: the fleet drives subjects from a thread
        # pool, and one shared stack would interleave span names across
        # threads; the records are shared (under a lock) so summary()
        # sees every thread's
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block under ``name`` (nested in the calling thread's
        open spans), and open the profiler range ``name`` around it
        (:class:`span`)."""
        stack = self._stack
        full = "/".join(stack + [name])
        stack.append(name)
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            stack.pop()
            with self._lock:
                self._records[full].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._records[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        # a snapshot under the lock: worker threads may open new span
        # names while a reporter iterates
        with self._lock:
            records = {name: list(vals) for name, vals in self._records.items()}
        out = {}
        for name, vals in records.items():
            out[name] = {
                "count": len(vals),
                "total_s": sum(vals),
                "mean_s": sum(vals) / len(vals),
                "max_s": max(vals),
            }
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name}: n={s['count']} total={s['total_s']:.3f}s "
                         f"mean={s['mean_s']:.3f}s max={s['max_s']:.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Optional ``torch.profiler`` trace of the CPU and, where there is
    one, the card, written on exit as a Chrome trace JSON
    (``<host>_<pid>.<time>.pt.trace.json``) into ``log_dir``.

    No-op when ``log_dir`` is falsy, so callers can thread a flag
    through.  Best-effort, as the JAX package's: a profiler that cannot
    start warns and the body runs untraced.  The profiler stops on every
    exit, the body's exceptions included."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    try:
        prof.start()
    except Exception as e:  # tracing is best-effort: never fail the deploy
        print(f"Warning: device trace unavailable ({e}); continuing.")
        yield
        return
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the body's queued kernels, traced
        prof.stop()
