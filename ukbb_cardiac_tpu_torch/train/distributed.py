"""Data-parallel training over ``torch.distributed``: one process per device.

This module has no counterpart in the JAX package.  There, a data-parallel
step is one GSPMD program over a ``jax.sharding.Mesh`` — params
replicated, the batch sharded on ``"data"`` — and one Python process
drives every chip.  PyTorch has no such compiler, so the port runs one
process (a *rank*) per device in a process group: NCCL between cards,
gloo on the CPU.  Every rank holds the whole model, draws the same global
batches and keeps its equal shard of each; the step all-reduces what the
JAX program reduces (``train/steps.py``, ``models/layers.py``).

- :func:`rank_devices`: rank r on ``cuda:r`` (``parallel/mesh.py::
  make_mesh`` names and checks the devices: more ranks than cards raises
  ``ValueError``), or N ranks on the CPU.
- :func:`run`: spawns the ranks (start method ``spawn``: a forked process
  cannot use CUDA), sets up the group through a ``file://`` rendezvous in
  a temporary directory (no TCP port to race for) with a timeout, so a
  hung rank fails instead of hanging; calls ``fn(rank, ...)`` in each,
  returns rank 0's result to the caller, re-raises a rank's exception in
  the caller, and destroys the group.  The ranks run with the caller's
  cuDNN and TF32 settings.
- :func:`run_in_turn`: several jobs in one group, one spawn.
- :func:`replica_steps`: K data-parallel steps of a model on given global
  batches, or the same steps in one process; what they leave (losses,
  aux, gradients, weights, BN statistics, Adam state) is the yardstick
  of a data-parallel setup against a single-process run.

``devices=`` / ``backend=`` let a one-card machine run several ranks on
one card (gloo accepts CUDA tensors and stages them through the host;
NCCL refuses two ranks on one card); they are keyword arguments of the
trainers, not CLI flags or config fields.
"""

from __future__ import annotations

import copy
import datetime
import os
import pickle
import shutil
import tempfile
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600  # a collective waiting longer fails its rank


class Rank(NamedTuple):
    """A rank's place: its index, the world size, its device and the
    process group (the process's default group)."""

    rank: int
    world: int
    device: torch.device
    group: object


def rank_devices(n: int, device: Optional[str] = None,
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device of each of ``n`` ranks: rank r on ``cuda:r``, or ``n``
    CPU ranks when ``device`` is ``"cpu"``; ``devices`` names them
    instead.  More ranks than cards raises ``ValueError``, as
    ``make_mesh`` does; without a card a CUDA rank raises."""
    from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh

    mesh = (make_mesh(list(devices)) if devices is not None
            else make_mesh(n, device=device))
    return [torch.device(d) for d in mesh.axis_devices("data")]


def _backend_flags() -> dict:
    return {"deterministic": torch.backends.cudnn.deterministic,
            "benchmark": torch.backends.cudnn.benchmark,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32}


def _set_backend_flags(flags: dict) -> None:
    torch.backends.cudnn.deterministic = flags["deterministic"]
    torch.backends.cudnn.benchmark = flags["benchmark"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]


def _entry(index: int, fn: Callable, devices: List[str], backend: str,
           work: str, timeout: float, flags: dict, threads: int) -> None:
    """One rank's process: join the group, run ``fn`` on the arguments
    the caller saved, save rank 0's result; on an exception save it for
    the caller and exit without the teardown (a peer may still wait in a
    collective)."""
    world = len(devices)
    device = torch.device(devices[index])
    _set_backend_flags(flags)
    torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(work, "rendezvous"),
            world_size=world, rank=index,
            timeout=datetime.timedelta(seconds=timeout))
        args, kwargs = torch.load(os.path.join(work, "args.pt"),
                                  weights_only=False)
        out = fn(Rank(index, world, device, dist.group.WORLD), *args,
                 **kwargs)
        if index == 0:
            torch.save(out, os.path.join(work, "result.pt"))
    except BaseException as exc:
        with open(os.path.join(work, f"error-{index}.pkl"), "wb") as f:
            try:
                pickle.dump(exc, f)
            except Exception:
                pickle.dump(RuntimeError(f"rank {index}: {exc!r}"), f)
        raise
    dist.destroy_process_group()


def _rank_error(work: str, first: Optional[int]):
    """The exception a rank saved: the first failed rank's, else the
    lowest rank's that saved one."""
    names = sorted(n for n in os.listdir(work) if n.startswith("error-"))
    if first is not None and f"error-{first}.pkl" in names:
        names.insert(0, f"error-{first}.pkl")
    for name in names:
        try:
            with open(os.path.join(work, name), "rb") as f:
                return pickle.load(f)
        except Exception:
            continue
    return None


def run(fn: Callable, args: tuple, devices: Sequence,
        backend: Optional[str] = None, timeout: float = TIMEOUT_S,
        kwargs: Optional[dict] = None):
    """Run ``fn(rank, *args, **kwargs)`` in one spawned process per device
    of ``devices`` (a :class:`Rank` each) and return rank 0's result.

    ``fn``, ``args`` and ``kwargs`` must pickle (``fn`` a module-level function of an
    importable module).  ``backend``: ``"nccl"`` for CUDA ranks and
    ``"gloo"`` for CPU ranks by default.  A rank's exception is raised
    here, the original type and message, from the spawn error that holds
    the rank's traceback; the other ranks are then stopped."""
    devices = [torch.device(d) for d in devices]
    backend = backend or ("nccl" if devices[0].type == "cuda" else "gloo")
    threads = max(1, torch.get_num_threads() // len(devices))
    work = tempfile.mkdtemp(prefix="ukbb_dp_")
    ctx = None
    try:
        # a file, not the spawn pipe: tensors in a pipe go through shared
        # memory handles one by one, seconds for a model's worth
        torch.save((args, kwargs or {}), os.path.join(work, "args.pt"))
        ctx = mp.start_processes(
            _entry, args=(fn, [str(d) for d in devices], backend, work,
                          timeout, _backend_flags(), threads),
            nprocs=len(devices), join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except (mp.ProcessRaisedException,
                mp.ProcessExitedException) as exc:
            err = _rank_error(work, getattr(exc, "error_index", None))
            if err is not None:
                raise err from exc
            raise
        return torch.load(os.path.join(work, "result.pt"),
                          weights_only=False)
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


def rank_stats(rank: Rank, stats: dict, started: float) -> dict:
    """``stats`` with what a rank adds: ``rank_start_time`` (the host
    clock when this rank began its work, after the spawn and the group's
    set-up) and, on a card, ``max_allocated_by_rank`` (every rank's peak
    device memory, bytes, all-reduced into a vector)."""
    stats = {**stats, "rank_start_time": started}
    if rank.device.type == "cuda":
        on = (rank.device if dist.get_backend(rank.group) == "nccl"
              else "cpu")
        peaks = torch.zeros(rank.world, dtype=torch.float64, device=on)
        peaks[rank.rank] = torch.cuda.max_memory_allocated(rank.device)
        dist.all_reduce(peaks, group=rank.group)
        stats["max_allocated_by_rank"] = [int(v) for v in peaks.tolist()]
    return stats


def run_in_turn(rank: Rank, calls: Sequence[tuple]) -> list:
    """Several rank functions in turn in one process group: ``calls``
    holds ``(fn, args, kwargs)`` triples, each called as ``fn(rank,
    *args, **kwargs)``; returns their results.  One spawn and one group
    set-up serve several jobs."""
    return [fn(rank, *args, **kwargs) for fn, args, kwargs in calls]


def take_rows(array, shard, axis: int = 0):
    """This rank's rows of ``array`` along ``axis``: ``shard`` (rank,
    world) of an even split.  A batch that does not divide raises
    ``ValueError``, where the JAX package's partitioner fails."""
    rank, world = shard
    n = array.shape[axis]
    if n % world:
        raise ValueError(f"a batch of {n} does not divide evenly over "
                         f"{world} data-parallel ranks ({n} % {world} != 0)")
    m = n // world
    index = (slice(None),) * axis + (slice(rank * m, (rank + 1) * m),)
    return array[index]


def replica_steps(rank: Optional[Rank], net: torch.nn.Module,
                  make_loss: Callable, batches: dict, seeds: Sequence[int],
                  make_optimizer: Optional[Callable] = None, lr=1e-3,
                  builder: str = "multi", pool=None, device=None,
                  channels_last: bool = False, calls: int = 1) -> dict:
    """K training steps of ``net`` from given global batches: data
    parallel in ``rank`` (each rank takes its rows), or with ``rank``
    None the single-process steps on ``device`` — the yardstick.

    ``net``: a module, left as it is (a copy trains); ``make_loss(net,
    group=...)`` builds the loss closure (``functools.partial`` of
    ``train.sa.make_fcn_loss`` / ``train.ao.make_ao_loss``);
    ``make_optimizer(net)`` the optimizer (default ``train.steps.Adam``
    at ``lr``);
    ``batches``: numpy arrays (K, B, ...), the global batch of each step;
    ``builder``: ``"single"`` (K calls of the one-step builder),
    ``"multi"`` (the K-step builder), ``"pool_slice"`` / ``"pool_window"``
    (``batches`` are index batches into ``pool`` = (image, label) numpy
    arrays, which every rank holds whole).  ``calls``: the K steps run
    that many times over (on the card the first call runs eagerly and
    captures, later ones replay), the seeds offset by K each time.

    Returns, on the CPU: ``losses`` (calls x K,), the last step's ``aux``,
    the route of the step (``step.route``), the
    last step's ``grads`` by parameter name (the averaged ones in a
    rank), the ``state`` dict and the optimizer's ``adam`` state dict."""
    from ukbb_cardiac_tpu_torch.train import device_pool
    from ukbb_cardiac_tpu_torch.train import steps as steps_lib

    group = rank.group if rank is not None else None
    device = torch.device(rank.device if rank is not None else
                          (device or "cpu"))
    net = copy.deepcopy(net).to(
        device, memory_format=(torch.channels_last if channels_last
                               else torch.preserve_format))
    optimizer = (make_optimizer(net) if make_optimizer is not None
                 else steps_lib.Adam(net.parameters(), lr=lr))
    loss_fn = make_loss(net, group=group)
    if rank is not None:
        batches = {k: take_rows(v, (rank.rank, rank.world), axis=1)
                   for k, v in batches.items()}
    batches = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batches.items()}
    seeds = list(seeds)
    if builder in ("pool_slice", "pool_window"):
        make = {("pool_slice", False): device_pool.make_pool_slice_multi_step,
                ("pool_window", False):
                    device_pool.make_pool_window_multi_step,
                ("pool_slice", True):
                    device_pool.make_pool_slice_multi_dp_step,
                ("pool_window", True):
                    device_pool.make_pool_window_multi_dp_step}[
            builder, group is not None]
        step = (make(loss_fn, optimizer, group) if group is not None
                else make(loss_fn, optimizer))
        img, lab = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in pool)

        def run(seeds):
            return step(img, lab, batches, seeds)
    elif builder == "multi":
        step = (steps_lib.make_multi_dp_train_step(loss_fn, optimizer, group)
                if group is not None
                else steps_lib.make_multi_train_step(loss_fn, optimizer))

        def run(seeds):
            return step(batches, seeds)
    elif builder == "single":
        step = (steps_lib.make_dp_train_step(loss_fn, optimizer, group)
                if group is not None
                else steps_lib.make_train_step(loss_fn, optimizer))

        def run(seeds):
            out = [step({k: v[i] for k, v in batches.items()}, s)
                   for i, s in enumerate(seeds)]
            return torch.stack([o[0] for o in out]), out[-1][1]
    else:
        raise ValueError(f"unknown builder {builder!r}")
    out = [run([s + c * len(seeds) for s in seeds]) for c in range(calls)]
    losses, aux = torch.cat([o[0] for o in out]), out[-1][1]

    def cpu(value):
        if isinstance(value, torch.Tensor):
            return value.detach().to("cpu", copy=True)
        if isinstance(value, dict):
            return {k: cpu(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(cpu(v) for v in value)
        return value

    result = {"losses": cpu(losses), "aux": cpu(aux), "route": step.route,
              "grads": {k: cpu(p.grad) for k, p in net.named_parameters()
                        if p.grad is not None},
              "state": cpu(net.state_dict()),
              "adam": cpu(optimizer.state_dict())}
    step.programs.clear()  # the step's own graphs go with it
    return result
