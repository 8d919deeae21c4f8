"""The registration path's device programs: CUDA graphs captured once per
shape and replayed.

The port's counterpart of the JAX package's cached jitted programs:
``reg/register.py::make_register_batch`` (``lru_cache``; each level's
``step_block``, a ``fori_loop`` over all of its Adam steps in one
dispatch, with ``synth_prev_levels``, ``normalise_pair`` and the pyramid
blurs), ``phenotype/strain.py::_field_programs`` (densify + invert +
compose + blend) and ``data/propagate_aortic.py::_dense_program``.

:func:`run` takes a function of tensors that returns a tuple of tensors,
and a tag that names what the function computes.  On CUDA tensors the
first call of a key -- the tag, the device and every input's shape and
dtype -- runs the function as it is (the warm-up: its result is the
call's, its kernels launch and count as they would eagerly), then
captures it into a ``torch.cuda.CUDAGraph`` over static copies of the
inputs.  Every later call of the key copies its inputs in, replays the
graph on the caller's current stream and clones the outputs out.  A
replay runs the captured kernels in the captured order, so its outputs
are bitwise the warm-up's when every kernel is deterministic.

On CPU tensors, and in a thread inside the module-private
:func:`_eager_route`, the function runs as it is: the CPU tests reach
the same code, and the card tests and ``chip_smoke.py`` compare the
graphs with the eager route.  On CUDA tensors a failed capture or replay
raises; nothing falls back to the eager route.

Threads (``run_cohort --workers N`` shares one card between threads):

- a capture runs with ``capture_error_mode="thread_local"``, so another
  thread's CUDA calls do not break it, and one at a time in the process
  (``torch.cuda.graph``'s rule), on a side stream of its own;
- each program holds a lock around copy-in, replay and copy-out, and its
  first capture happens under that lock; a replay on another stream
  waits for the last call's copy-out, since both use the same buffers.

Launches: while a graph replays, the kernel wrappers do not run.  A
capture records the launches it made (``kernels.LaunchRecord``; they
are not counted then, as nothing runs), and each replay adds the record
to the wrappers' counters.  The warm-up counts as an eager run.  So a
call counts the launches that executed on the card, the first call of a
key included.

Memory: each program keeps the static inputs and a private memory pool
for the graph (``reserved``: the growth of
``torch.cuda.memory_reserved`` over the capture).  At most
``MAX_PROGRAMS`` are kept, the least recently used dropped first, as the
JAX ``lru_cache(maxsize=64)`` does.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

import torch

from ukbb_cardiac_tpu_torch import kernels

MAX_PROGRAMS = 64

_PROGRAMS: "OrderedDict[tuple, Program]" = OrderedDict()
_CACHE_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[str, torch.cuda.Stream] = {}
_ROUTE = threading.local()


class Program:
    """One function captured as a CUDA graph over static buffers."""

    def __init__(self, key: tuple, fn: Callable[..., Tuple[torch.Tensor,
                                                          ...]]):
        self.key = key
        self.fn = fn
        self.lock = threading.Lock()
        self.graph = None
        self.static_in: List[torch.Tensor] = []
        self.static_out: Tuple[torch.Tensor, ...] = ()
        self.launches = kernels.LaunchRecord()
        self.done = None          # event after the last call's copy-out
        self.capture_s = 0.0      # host seconds of the capture
        self.reserved = 0         # bytes memory_reserved grew by
        self.replays = 0

    def __call__(self, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with self.lock, torch.cuda.device(inputs[0].device):
            if self.graph is None:
                out = self.fn(*inputs)
                self._capture(inputs)
                return out
            stream = torch.cuda.current_stream()
            stream.wait_event(self.done)
            for buf, x in zip(self.static_in, inputs):
                buf.copy_(x)
            self.graph.replay()
            out = tuple(o.clone() for o in self.static_out)
            self.done.record(stream)
            self.replays += 1
        self.launches.replayed()
        return out

    def _capture(self, inputs) -> None:
        dev = inputs[0].device
        static_in = [torch.empty_like(x) for x in inputs]
        graph = torch.cuda.CUDAGraph()
        record = kernels.LaunchRecord()
        with _CAPTURE_LOCK:
            side = _capture_stream(dev)
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            with torch.cuda.stream(side), kernels.recording(record):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.fn(*static_in)
                except BaseException:
                    # end the invalidated capture; the function's own
                    # error is the one to raise
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
            self.capture_s = time.perf_counter() - t0
            self.reserved = torch.cuda.memory_reserved(dev) - before
        self.static_in, self.static_out = static_in, tuple(out)
        self.launches = record
        self.done = torch.cuda.Event()
        self.graph = graph


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    key = str(dev)
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[key]


def run(tag: tuple, fn: Callable[..., Tuple[torch.Tensor, ...]],
        *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs)``, a tuple of tensors: on CUDA tensors through the
    program of (``tag``, device, the inputs' shapes and dtypes), captured
    at its first call and replayed after; as it is on CPU tensors and on
    the eager route.  ``tag`` names everything ``fn`` computes that the
    inputs' shapes do not fix.  Inputs are made contiguous first."""
    inputs = tuple(x.contiguous() for x in inputs)
    dev = inputs[0].device
    if dev.type != "cuda" or getattr(_ROUTE, "eager", False):
        return tuple(fn(*inputs))
    key = (tag, str(dev)) + tuple((tuple(x.shape), x.dtype) for x in inputs)
    with _CACHE_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _PROGRAMS[key] = Program(key, fn)
            while len(_PROGRAMS) > MAX_PROGRAMS:
                _PROGRAMS.popitem(last=False)
        else:
            _PROGRAMS.move_to_end(key)
    return prog(*inputs)


def programs() -> List[Program]:
    """The cached programs, least recently used first."""
    with _CACHE_LOCK:
        return list(_PROGRAMS.values())


def clear() -> None:
    """Drop every cached program (their graphs and memory pools go with
    the last reference)."""
    with _CACHE_LOCK:
        _PROGRAMS.clear()


@contextlib.contextmanager
def _eager_route():
    """Module-private: inside this block, :func:`run` in the calling
    thread runs every function as it is, on the card too, with no capture
    or replay -- the route the graphs are compared with."""
    before = getattr(_ROUTE, "eager", False)
    _ROUTE.eager = True
    try:
        yield
    finally:
        _ROUTE.eager = before
