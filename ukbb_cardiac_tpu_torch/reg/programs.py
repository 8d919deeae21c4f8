"""The port's device programs: CUDA graphs captured once per shape and
replayed.

The port's counterpart of the JAX package's cached jitted programs.  The
module-level cache (:func:`run`, at most ``MAX_PROGRAMS``, as the JAX
``lru_cache(maxsize=64)``) holds the data-independent ones:
``reg/register.py::make_register_batch`` (each level's ``step_block``, a
``fori_loop`` over all of its Adam steps in one dispatch, with
``synth_prev_levels``, ``normalise_pair`` and the pyramid blurs),
``phenotype/strain.py::_field_programs`` (densify + invert + compose +
blend), ``_sample_program`` and ``_warp_dice_program``, and
``data/propagate_aortic.py::_dense_program``.  A :class:`ProgramCache`
that an owner holds keeps the programs over that owner's weights, as the
JAX engines' ``self._compiled`` dicts do: each deploy engine has one
(``infer/engine.py``, ``infer/deploy_ao.py``), so an engine's graphs
read its own parameters, and an engine's programs never evict the
registration's.

:meth:`ProgramCache.run` takes a function of tensors that returns a
tuple of tensors, and a tag that names what the function computes.  On
CUDA tensors the
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

Inference mode: the static inputs are made outside
``torch.inference_mode``, so a program captured inside it (the engines'
methods run there) copies in from outside it too, and the other way
round.

Memory: each program keeps the static inputs and a private memory pool
for the graph (``reserved``: the growth of
``torch.cuda.memory_reserved`` over the capture).  A cache may bound its
programs by count and by the sum of their ``reserved``, the least
recently used dropped first (never the one just run).  The caching
allocator keeps a dropped graph's pool, and cannot free anything while
a capture is underway, so a pool would stay reserved until the cache is
emptied: a cache that drops programs (its bound, :meth:`ProgramCache.
clear`) empties it then, between captures.  An owner that lets its
cache go (an engine built for one run) clears it first.

Spans (``utils/timing.py``), each around a call into a program and never
inside the function it captures: ``ukbb.program.warmup`` (a key's first
eager call), ``ukbb.program.capture``, ``ukbb.program.replay`` (copy-in,
replay and copy-out) and ``ukbb.program.release`` (dropped programs'
pools returned to the card).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ukbb_cardiac_tpu_torch import kernels
from ukbb_cardiac_tpu_torch.utils.timing import span

MAX_PROGRAMS = 64
# an engine's programs, the least recently used dropped beyond: room for
# every program of one shape (the aortic engine's 4.71 GiB at (240, 196,
# 1, 100), chip_smoke.py phase 14, NVIDIA H100 80GB HBM3, 700.00 W)
ENGINE_BYTES = 8 * 2 ** 30

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

    def __call__(self, *inputs: torch.Tensor,
                 out: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, ...]:
        with self.lock, torch.cuda.device(inputs[0].device):
            if self.graph is None:
                with span("ukbb.program.warmup"):
                    result = _written(self.fn(*inputs), out)
                self._capture(inputs)
                return result
            with span("ukbb.program.replay"):
                stream = torch.cuda.current_stream()
                stream.wait_event(self.done)
                for buf, x in zip(self.static_in, inputs):
                    buf.copy_(x)
                self.graph.replay()
                if out is None:
                    result = tuple(o.clone() for o in self.static_out)
                else:
                    result = _written(self.static_out, out)
                self.done.record(stream)
            self.replays += 1
        self.launches.replayed()
        return result

    @span("ukbb.program.capture")
    def _capture(self, inputs) -> None:
        dev = inputs[0].device
        with torch.inference_mode(False):
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


def _written(result, out) -> Tuple[torch.Tensor, ...]:
    """``result`` as a tuple, or copied into the tensors ``out`` (and
    those returned)."""
    if out is None:
        return tuple(result)
    for o, r in zip(out, result):
        o.copy_(r)
    return tuple(out)


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    key = str(dev)
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[key]


class ProgramCache:
    """Programs keyed by (tag, device, every input's shape and dtype), the
    least recently used dropped first beyond ``max_programs`` programs or
    ``max_bytes`` of their ``reserved`` (None: no bound)."""

    def __init__(self, max_programs: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.max_programs = max_programs
        self.max_bytes = max_bytes
        self._programs: "OrderedDict[tuple, Program]" = OrderedDict()
        self._lock = threading.Lock()
        self.dropped = 0          # programs the bounds dropped

    def run(self, tag: tuple, fn: Callable[..., Tuple[torch.Tensor, ...]],
            *inputs: torch.Tensor,
            out: Optional[Sequence[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)``, a tuple of tensors: on CUDA tensors through
        the program of (``tag``, device, the inputs' shapes and dtypes),
        captured at its first call and replayed after; as it is on CPU
        tensors and on the eager route.  ``tag`` names everything ``fn``
        computes that the inputs' shapes do not fix (the first ``fn`` of
        a key is the one captured).  Inputs are made contiguous first.
        With ``out``, the outputs are written into those tensors, which
        are returned."""
        inputs = tuple(x.contiguous() for x in inputs)
        if not _graphed(inputs[0]):
            return _written(fn(*inputs), out)
        key = (tag, str(inputs[0].device)) + tuple(
            (tuple(x.shape), x.dtype) for x in inputs)
        with self._lock:
            prog = self._programs.get(key)
            new = prog is None
            if new:
                prog = self._programs[key] = Program(key, fn)
            else:
                self._programs.move_to_end(key)
        result = prog(*inputs, out=out)
        if new:
            self._bound(prog)
        return result

    def _bound(self, newest: Program) -> None:
        """Drop the least recently used programs (never ``newest``) while
        the cache is over a bound, then return their pools."""
        dropped = []
        with self._lock:
            def over():
                progs = self._programs.values()
                return ((self.max_programs is not None
                         and len(progs) > self.max_programs)
                        or (self.max_bytes is not None
                            and sum(p.reserved for p in progs)
                            > self.max_bytes))
            while len(self._programs) > 1 and over():
                key = next(iter(self._programs))
                if self._programs[key] is newest:
                    self._programs.move_to_end(key)
                    continue
                dropped.append(self._programs.pop(key))
            self.dropped += len(dropped)
        if dropped:
            _release(dropped)

    def programs(self) -> List[Program]:
        """The cached programs, least recently used first."""
        with self._lock:
            return list(self._programs.values())

    def nbytes(self) -> int:
        """The cached programs' ``reserved``, summed."""
        return sum(p.reserved for p in self.programs())

    def clear(self) -> None:
        """Drop every cached program and return their graphs' pools to the
        card."""
        with self._lock:
            dropped = list(self._programs.values())
            self._programs.clear()
        _release(dropped)


@span("ukbb.program.release")
def _release(dropped: List[Program]) -> None:
    """Let the programs of ``dropped`` go, then empty the allocator's cache
    so that their graphs' pools go back to the card and a later capture
    can have them; between captures (the allocator frees nothing while
    one is underway)."""
    devices = {p.static_in[0].device for p in dropped if p.graph is not None}
    dropped.clear()  # the last references: the graphs and pools go
    for device in devices:
        with _CAPTURE_LOCK, torch.cuda.device(device):
            torch.cuda.empty_cache()


def _graphed(x: torch.Tensor) -> bool:
    """Whether a program of ``x``'s device captures and replays here: on
    CUDA tensors, outside the eager route."""
    return x.device.type == "cuda" and not getattr(_ROUTE, "eager", False)


# the data-independent programs (registration, fields, strain sampling)
_SHARED = ProgramCache(MAX_PROGRAMS)


def run(tag: tuple, fn: Callable[..., Tuple[torch.Tensor, ...]],
        *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """:meth:`ProgramCache.run` on the module-level cache, which keeps at
    most ``MAX_PROGRAMS``."""
    return _SHARED.run(tag, fn, *inputs)


def programs() -> List[Program]:
    """The module-level cache's programs, least recently used first."""
    return _SHARED.programs()


def clear() -> None:
    """Drop every program of the module-level cache."""
    _SHARED.clear()


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
