"""The traced run: a ``torch.profiler`` window and its reduction.

From the profiler's raw events the run takes the device intervals
(kernels, copies and sets on the card), merges them into busy time, finds
the idle gaps between them and labels each gap with the benchmark's own
span (``bench:`` ranges the driver opens around calls into the program)
or, failing that, the torch operator the host was in.  Kernel device time
by name feeds the roofline readers.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from typing import Dict, Iterable, List, Tuple

import torch

SPAN_PREFIX = "bench:"


class Trace:
    """What a per-layer reader may take from the traced window."""

    def __init__(self, device: List[Tuple[int, int, str]],
                 host: List[Tuple[int, int, str]], window_ns: Tuple[int, int]):
        self.device = sorted(device)          # (start_ns, end_ns, name)
        self.host = host                      # (start_ns, end_ns, name)
        self.window_ns = window_ns
        self.busy = _merge((s, e) for s, e, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def kernel_seconds(self, names: Iterable[str]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds one
        of ``names``."""
        names = tuple(names)
        hits = [(s, e) for s, e, n in self.device
                if any(k in n for k in names)]
        return sum(e - s for s, e in hits) * 1e-9, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, int] = {}
        for s, e, name in self.device:
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps with no device work inside the window,
        each named by what the host was doing at its middle."""
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self._label((s + e) // 2), (e - s) * 1e-9] for s, e in gaps]

    def _label(self, t: int) -> str:
        spans = [(e - s, n) for s, e, n in self.host
                 if s <= t <= e and n.startswith(SPAN_PREFIX)]
        if spans:
            return min(spans)[1][len(SPAN_PREFIX):]
        ops = [(e - s, n) for s, e, n in self.host
               if s <= t <= e and not n.startswith(SPAN_PREFIX)]
        return "host: " + max(ops)[1] if ops else "host: python"


def _merge(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """Profile the window: ``with Tracer() as t: ...``; then ``t.trace``.
    The profiler stamps its events with the wall clock in nanoseconds, so
    the window's edges are read from the same clock."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        _sync()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        _sync()
        t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = _reduce(self._prof, (self._t0, t1))
        return False


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _reduce(prof, window) -> Trace:
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # a range opened on the host is mirrored on the device as an
            # annotation over its kernels: not work of its own
            if not ev.is_user_annotation() and \
                    not ev.name().startswith(SPAN_PREFIX):
                device.append((s, e, ev.name()))
        else:
            host.append((s, e, ev.name()))
    return Trace(device, host, window)


@contextlib.contextmanager
def spans(targets: Iterable[Tuple[str, str, str]]):
    """Open a ``bench:<label>`` range around each call of the functions
    named by (module, attribute, label) while the block runs; the module
    attributes are restored after.  The program is not edited: its
    modules look these names up when they call them."""
    saved = []
    try:
        for module_name, attr, label in targets:
            module = importlib.import_module(module_name)
            fn = getattr(module, attr)
            saved.append((module, attr, fn))
            setattr(module, attr, _wrapped(fn, SPAN_PREFIX + label))
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def _wrapped(fn, name):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call
