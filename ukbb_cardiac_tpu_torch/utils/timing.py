"""Structured per-stage timing and optional device profiling.

Counterpart of ``ukbb_cardiac_tpu/utils/timing.py``: one structured
timer (named spans, aggregated stats, JSON export) in place of the
reference's scattered wall-clock prints, and an optional device trace,
here ``torch.profiler`` over the CPU and the card, written as a Chrome
trace JSON (viewable in ``chrome://tracing``, Perfetto or TensorBoard).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


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
        stack = self._stack
        full = "/".join(stack + [name])
        stack.append(name)
        t0 = time.perf_counter()
        try:
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
    import torch
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
