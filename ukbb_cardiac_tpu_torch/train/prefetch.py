"""Background batch prefetching and the K-step chunk builders.

Counterpart of ``ukbb_cardiac_tpu/train/prefetch.py``.  The host-side
sampler (NIfTI reads, crop, rescale, host augmentation) runs in a worker
thread with a bounded queue, so batch preparation overlaps the device
steps (numpy, scipy and zlib release the GIL).  The chunk builders cut
the K-step chunks at the validation, checkpoint and progress boundaries
and stage the next chunk on the device while the current one runs;
:func:`run_chunks` is the trainers' timed step loop over those chunks.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch


class BatchPrefetcher:
    """Wraps a ``make_batch() -> batch`` callable into a prefetching
    iterator.  ``depth`` batches are kept ready ahead of the consumer."""

    def __init__(self, make_batch: Callable[[], object], depth: int = 2):
        self._make_batch = make_batch
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._make_batch()
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced in next()
            self._error = e

    def next(self):
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._queue.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._error is None:
                    raise RuntimeError("prefetch worker exited")

    def close(self):
        self._stop.set()
        try:  # drain so the worker unblocks
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def chunk_length(it: int, K: int, total: int, cadences: Sequence[int]) -> int:
    """Steps in the chunk starting after ``it`` completed iterations: at
    most K, cut so that every cadence boundary and the end of training
    land exactly on an iteration count."""
    k_now = min(K, total - it)
    for c in cadences:
        if c and c > 0:
            k_now = min(k_now, c - it % c)
    return k_now


def make_stage(device) -> Callable:
    """``stage(arrays) -> tensors``: a dict of numpy arrays to the device.

    On the card each array is copied into pinned host memory and sent with
    ``non_blocking=True`` on a side stream; the current stream waits on an
    event recorded after the copies, and the tensors are marked as used
    by it.  So the copy of chunk N+1 overlaps chunk N's steps, and no
    step reads a tensor before its copy ends."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda arrays: {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in arrays.items()}
    side = torch.cuda.Stream(device)

    def stage(arrays):
        main = torch.cuda.current_stream(device)
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in arrays.items()}
        with torch.cuda.stream(side):
            out = {k: v.to(device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        main.wait_event(done)
        for t in out.values():
            t.record_stream(main)
        return out

    return stage


def _rows(batch: dict, shard) -> dict:
    """This rank's rows of every array of a batch (``shard`` (rank,
    world); None keeps the batch whole)."""
    if shard is None:
        return batch
    from ukbb_cardiac_tpu_torch.train.distributed import take_rows

    return {k: take_rows(v, shard) for k, v in batch.items()}


def make_chunk_builder(prefetcher: BatchPrefetcher, K: int, total: int,
                       cadences: Sequence[int], stage: Callable,
                       shard=None):
    """Build the K-step input of a training loop.

    Returns ``build_input(it) -> (k_now, batches, seeds, release)``:
    ``k_now`` from :func:`chunk_length`; for ``k_now > 1`` the batches
    stacked on a new leading axis (``steps.make_multi_train_step``), else
    one batch (``steps.make_train_step``); ``seeds`` the per-step seeds
    ``it + 1 .. it + k_now`` (the JAX trainer's ``PRNGKey(it + 1 ..)``);
    ``release()`` is a no-op here (see :func:`make_pool_chunk_builder`).
    ``stage`` (:func:`make_stage`) sends the arrays to the device.
    ``shard`` (rank, world): a data-parallel rank stages only its rows of
    each batch, on its own device (the JAX trainer's ``stage_local``); a
    batch that does not divide raises ``ValueError``."""

    def build_input(it):
        k_now = chunk_length(it, K, total, cadences)
        seeds = list(range(it + 1, it + 1 + k_now))
        chunk = [_rows(prefetcher.next(), shard) for _ in range(k_now)]
        if k_now > 1:
            batches = stage({k: np.stack([b[k] for b in chunk])
                             for k in chunk[0]})
        else:
            batches = stage(chunk[0])
        return k_now, batches, seeds, lambda: None

    return build_input


def make_pool_chunk_builder(prefetcher: BatchPrefetcher, pool, K: int,
                            total: int, cadences: Sequence[int],
                            stage: Callable, shard=None):
    """Build the K-step input of a device-pool training loop
    (``train/device_pool.py``).

    Returns ``build_input(it) -> (k_now, (pool_img, pool_lab, batches),
    seeds, release)`` with :func:`make_chunk_builder`'s chunk lengths and
    seeds; ``batches`` are the (K, B) index tensors on the device (with
    ``shard``, this rank's rows).  The chunk's slot pins — every row's,
    the other ranks' too — hold until ``release()``, which the loop calls
    once the step that gathers from them has been enqueued: an upload
    into a released slot is then ordered after that gather."""

    def build_input(it):
        k_now = chunk_length(it, K, total, cadences)
        seeds = list(range(it + 1, it + 1 + k_now))
        chunk = [prefetcher.next() for _ in range(k_now)]
        pool_img, pool_lab = pool.snapshot()
        rows = [_rows(b, shard) for b in chunk]
        batches = stage({k: np.stack([b[k] for b in rows])
                         for k in rows[0]})

        def release():
            for b in chunk:
                for s in b["slot"]:
                    pool.unpin(int(s))

        return k_now, (pool_img, pool_lab, batches), seeds, release

    return build_input


def run_chunks(build_input, step: Callable, multi_step: Callable,
               pooled: bool, start: int, total: int,
               cadences: Sequence[int], device, side_work: Callable) -> dict:
    """The trainers' step loop: run the chunks that ``build_input`` (one
    of the builders above) stages, from iteration ``start`` to ``total``,
    and after each call ``side_work(iteration, loss, aux, t0, k_now)``
    (validation, progress, checkpoints; ``t0`` the chunk's start time).
    Pool chunks go to ``multi_step(pool_img, pool_lab, batches, seeds)``;
    other chunks to ``multi_step(batches, seeds)`` when ``k_now > 1``,
    else to ``step(batch, seed)``.

    Returns stats: iterations run, and from the end of the first call on
    (cuDNN's autotuning excluded) the step loop's seconds with the side
    work set aside, the seconds it waited for the next chunk, the steps
    it ran, and the calls and the host seconds spent in them (``dispatch_s``:
    on the card a program's copy-in and replay, or an eager call's issue
    time, until the device queue pushes back).  Before side work at a
    cadence boundary the card is synchronised, so the queued steps finish
    inside the loop's window, not in the side work's host sync.  A
    remainder chunk at a boundary has another K, so it is another
    program of the step's (``train/steps.py``)."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    stats = {"iterations": 0, "steady_iterations": 0, "steady_s": 0.0,
             "wait_s": 0.0, "steady_calls": 0, "dispatch_s": 0.0}
    t_aside = 0.0  # side-work seconds inside the window
    t_steady = None
    iteration = start
    # a resume at/past total must not sample a never-used batch
    pending = build_input(iteration) if iteration < total else None
    while iteration < total:
        t0 = time.time()
        k_now, batches, seeds, release = pending
        t_call = time.time()
        if pooled:
            losses_k, aux = multi_step(*batches, seeds)
        elif k_now > 1:
            losses_k, aux = multi_step(batches, seeds)
        else:
            loss, aux = step(batches, seeds[0])
            losses_k = loss[None]
        t_called = time.time()
        release()
        iteration += k_now
        stats["iterations"] += k_now
        if t_steady is None:
            sync()  # the first call (cuDNN autotuning) is not timed
            t_steady = time.time()
        else:
            stats["steady_iterations"] += k_now
            stats["steady_calls"] += 1
            stats["dispatch_s"] += t_called - t_call
        if iteration < total:
            t_wait = time.time()
            pending = build_input(iteration)
            if stats["steady_iterations"]:
                stats["wait_s"] += time.time() - t_wait
        side = (iteration == total
                or any(c and iteration % c == 0 for c in cadences))
        if side and stats["steady_iterations"]:
            sync()
        t_side = time.time()
        side_work(iteration, losses_k[-1], aux, t0, k_now)
        if stats["steady_iterations"]:
            t_aside += time.time() - t_side
    sync()
    if t_steady is not None:
        stats["steady_s"] = time.time() - t_steady - t_aside
    return stats
