"""Train-step builders: one step, K steps per call, evaluation; the port's
Adam.

Counterpart of ``ukbb_cardiac_tpu/train/steps.py``.  The JAX step is a
pure function (``value_and_grad`` + optax + BN state threading) that
``jax.jit`` compiles, K of them under one ``lax.scan``.  Here the model
owns its parameters and BN buffers, ``loss_fn`` updates the moving
statistics in place during its forward, and :class:`Adam` applies
optax's update (``lr * m_hat / (sqrt(v_hat) + eps)``, eps 1e-8) with its
step count and learning rate on the device.

On the card each call -- one step or K -- is one program
(``reg/programs.py``): the first call of a key (the batch's shapes and
dtypes, K and the route) runs as it is and is then captured as a CUDA
graph, which every later call of the key replays.  Only the call's data
goes in (the batches or pool indices and the augmentation's draws); the
parameters, gradients, Adam state, BatchNorm buffers and the device pool
are read and written by address.  So the builders hold the gradients
(allocated once, zeroed in place before each backward) and the
optimizer holds its state tensors; nothing may replace them while the
programs live.  The programs belong to the caller's
:class:`~ukbb_cardiac_tpu_torch.reg.programs.ProgramCache` (``programs=``;
by default one of the builder's own, as ``step.programs``, bounded by
``TRAINER_BYTES``), which the trainers release at their end.  On CPU
tensors and on ``programs._eager_route()`` the same function runs op by op.

A step takes an integer ``seed`` where the JAX step takes a PRNG key.
A loss that draws random numbers exposes ``loss_fn.draw(seed, n,
device)`` (its draws for a batch of ``n`` rows: tensors, in dicts and
tuples; the trainers' losses draw the augmentation's parameters with
``ops.augment.sample_shard_params``) and ``loss_fn.apply(batch, draws)``:
the builders make every step's draws before the call, from the same
generator and seed the loss would use, and pass them in stacked on a
leading axis K, so a graph never bakes a seed in, the draws are bitwise
the loss's own, and K steps in one call equal K single steps bit for
bit.  A loss without ``draw`` must not depend on its seed.  Nothing
inside a call waits on the device: the losses stay on the device,
stacked, and the caller reads them once per call.

Data-parallel steps (``make_dp_train_step``, ``make_multi_dp_train_step``)
run in every rank of a ``torch.distributed`` process group
(``train/distributed.py``), each on its equal shard of the global batch.
The JAX package's DP step is one GSPMD program whose loss is the global
batch's mean; here each rank takes its shard's mean, all-reduces its
gradients once per step as one flat buffer (the shard's loss rides at its
end) and divides by the world size, which is the same gradient for equal
shards.  The loss closure makes the BatchNorm statistics and the aux
metrics global (``models/layers.py``, :func:`segmentation_aux`).  The
route is fixed when the step is built, from the group's backend: on an
NCCL group the collectives are captured with the rest of the call (the
eager first call makes the communicator); a gloo group stages CUDA
tensors through the host, which a graph cannot hold, so its steps run
uncaptured, op by op, by design (``step.route`` says which).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ukbb_cardiac_tpu_torch.reg import programs as programs_lib

# a trainer's programs, the least recently used dropped beyond: room for
# the widest trainer's step programs of two K (a remainder chunk at a
# cadence boundary is another K) beside its validation program.  Measured
# on the widest: the FCN production call (K = 10 x 128 slices at 192^2,
# bf16) 8.4 GiB, the UNet-LSTM reference step (10 windows of 9 frames at
# 256^2, f32) 9.3 GiB and its validation loss 4.9 GiB (chip_smoke.py
# phases 7 and 9, NVIDIA H100 80GB HBM3, 700.00 W).  Under
# ``programs.ENGINE_BYTES`` the FCN's step and validation programs
# evicted each other at every cadence.
TRAINER_BYTES = 32 * 2 ** 30


def group_shard(group) -> tuple:
    """(rank, world size) of this process in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class Adam(torch.optim.Optimizer):
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in
    optax's order of operations, as ``torch.optim.Adam`` keeps its
    state: ``state[p]`` holds ``step`` (float32), ``exp_avg`` and
    ``exp_avg_sq`` on ``p``'s device (``ckpt/convert.py`` maps them to
    optax's leaves).  The step count and the learning rate are device
    tensors, so an update reads nothing back from the card and a CUDA
    graph can capture it; the same code runs on the CPU.  Every
    parameter of a group takes the update, a zero gradient too, as
    optax's does (a parameter with no gradient at all is skipped)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, {"lr": lr})
        self._lr_tensors = {}

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device)
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    def _learning_rate(self, group: dict, step: torch.Tensor
                       ) -> torch.Tensor:
        """The group's learning rate for the update that ``step`` (after
        its increment) counts, a float32 device tensor."""
        key = (float(group["lr"]), str(step.device))
        if key not in self._lr_tensors:
            self._lr_tensors[key] = torch.full(
                (), key[0], dtype=torch.float32, device=step.device)
        return self._lr_tensors[key]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        b1, b2 = self.b1, self.b2
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._state(p) for p in params]
            steps = [st["step"] for st in states]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            grads = [p.grad for p in params]
            torch._foreach_add_(steps, 1.0)
            # the trainers step every parameter together: one count
            count = steps[0]
            # optax: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
            g1 = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, g1)
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            # bias corrections 1 - b**count as device divisors (a host
            # scalar divisor turns into a reciprocal multiply on the card)
            bc1 = 1 - torch.pow(b1, count)
            bc2 = 1 - torch.pow(b2, count)
            mu_hat = torch._foreach_div(mus, bc1)
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu_hat, den)
            torch._foreach_mul_(upd, -self._learning_rate(group, count))
            torch._foreach_add_(params, upd)
        return loss


class ScheduledAdam(Adam):
    """:class:`Adam` whose learning rate is ``lr * factor ** n`` with
    ``n`` the number of boundaries at or below the update's 0-based
    index (the optimizer's own step count, so it survives a resume) --
    ``optax.piecewise_constant_schedule``, computed on the device from
    the step tensor as optax computes it from its count."""

    def __init__(self, params, lr: float, boundaries: Sequence[int],
                 factor: float):
        super().__init__(params, lr=lr)
        self.base_lr = lr
        self.boundaries = sorted(boundaries)
        self.factor = factor

    def _learning_rate(self, group, step):
        lr = super()._learning_rate(group, step)
        for b in self.boundaries:
            # the update of 0-based index step - 1 is past boundary b
            lr = torch.where(step > b, lr * self.factor, lr)
        return lr


def adam_with_schedule(params, lr: float = 1e-3, reduce_after=(),
                       reduce_factor: float = 0.1) -> Adam:
    """:class:`Adam` with the reference's piecewise-constant decay
    (``train_network_ao.py:329-339``): the learning rate multiplies by
    ``reduce_factor`` after EACH boundary in ``reduce_after``."""
    if isinstance(reduce_after, int):
        reduce_after = [reduce_after] if reduce_after > 0 else []
    boundaries = [int(b) for b in reduce_after if int(b) > 0]
    if boundaries:
        return ScheduledAdam(params, lr, boundaries, reduce_factor)
    return Adam(params, lr=lr)


def _reduce_gradients(grads, loss: torch.Tensor, group) -> torch.Tensor:
    """All-reduce ``grads`` and the shard's loss as one flat buffer,
    divided by the world size: the global-batch mean of both (equal
    shards).  Returns the global loss; the gradients are written back in
    place."""
    world = dist.get_world_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    return flat[-1]


_BUILDERS = itertools.count()


class _Steps:
    """K optimizer steps of ``loss_fn`` per call, one program per key.

    ``gather(pool, batch) -> batch`` (with ``pool`` the tensors a pool
    step reads by address) turns each step's index batch into pixels
    inside the program."""

    def __init__(self, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                 group=None, programs=None, gather=None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.group = group
        self.gather = gather
        self.programs = (programs if programs is not None else
                         programs_lib.ProgramCache(max_bytes=TRAINER_BYTES))
        self.params = [p for g in optimizer.param_groups
                       for p in g["params"]]
        backend = dist.get_backend(group) if group is not None else None
        # gloo stages CUDA tensors through the host: never captured
        self.graphed = backend != "gloo"
        self.route = ("single" if group is None else f"{backend} group "
                      f"({'graphs' if self.graphed else 'uncaptured'})")
        self._tag = ("train", next(_BUILDERS))
        self._spec = None

    def _grads(self):
        """The parameters' gradients, allocated once (in each parameter's
        memory format) and kept: a program writes them by address."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def _one(self, batch, draws, seed, grads):
        torch._foreach_zero_(grads)
        if draws is None:
            loss, aux = self.loss_fn(batch, seed)
        else:
            loss, aux = self.loss_fn.apply(batch, draws)
        loss.backward()
        loss = loss.detach()
        if self.group is not None:
            loss = _reduce_gradients(grads, loss, self.group)
        self.optimizer.step()
        return loss, aux

    def __call__(self, batches: dict, seeds: Sequence[int], pool=()):
        """K = len(seeds) steps on ``batches`` (tensors with a leading
        axis K) -> (losses[K], the last step's aux)."""
        seeds = [int(s) for s in seeds]
        K = len(seeds)
        names = sorted(batches)
        xs = [batches[n] for n in names]
        draw = getattr(self.loss_fn, "draw", None)
        draw_spec = None
        if draw is not None:
            # every step's draws, stacked on a leading axis K: inputs
            rows, device = xs[0].shape[1], xs[0].device
            made = [pytree.tree_flatten(draw(s, rows, device))
                    for s in seeds]
            draw_spec = made[0][1]
            xs += [torch.stack(col) for col in zip(*(m[0] for m in made))]
        grads = self._grads()
        n_names = len(names)

        def fn(*inputs):
            losses, aux = [], None
            for k in range(K):
                batch = {n: v[k] for n, v in zip(names, inputs[:n_names])}
                if self.gather is not None:
                    batch = self.gather(pool, batch)
                step_draws = (pytree.tree_unflatten(
                    [d[k] for d in inputs[n_names:]], draw_spec)
                    if draw is not None else None)
                loss, aux = self._one(batch, step_draws, seeds[k], grads)
                losses.append(loss)
            leaves, self._spec = pytree.tree_flatten(aux)
            return (torch.stack(losses), *leaves)

        if self.graphed:
            tag = self._tag + (K, tuple(names),
                               tuple(t.data_ptr() for t in pool))
            out = self.programs.run(tag, fn, *xs)
        else:
            out = fn(*xs)
        return out[0], pytree.tree_unflatten(list(out[1:]), self._spec)


def _single(steps: _Steps):
    def step(batch, seed: int):
        losses, aux = steps({k: v[None] for k, v in batch.items()}, [seed])
        return losses[0], aux

    step.programs, step.route = steps.programs, steps.route
    return step


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    *, programs=None):
    """Single step.

    ``loss_fn(batch, seed) -> (loss, aux)`` runs the training forward
    (updating BN moving statistics).  Returns ``step(batch, seed) ->
    (loss, aux)`` with ``loss`` a detached device scalar; on the card a
    program of ``programs`` (a ``ProgramCache``; by default the step's
    own, ``step.programs``).  The graph route needs an optimizer whose
    update a graph captures (:class:`Adam`)."""
    return _single(_Steps(loss_fn, optimizer, programs=programs))


def make_multi_train_step(loss_fn: Callable,
                          optimizer: torch.optim.Optimizer, *,
                          programs=None):
    """K optimizer steps per call.

    ``batches``: a dict whose tensors carry a leading axis K (one slot per
    step); ``seeds``: K integers.  Returns ``step(batches, seeds) ->
    (losses[K], last_aux)``, the losses stacked on the device; on the
    card one program runs all K steps (the JAX ``lax.scan``).  The same
    arithmetic as K calls of :func:`make_train_step`."""
    return _Steps(loss_fn, optimizer, programs=programs)


def make_dp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       group, *, programs=None):
    """Data-parallel :func:`make_train_step` in one rank of ``group``.

    ``batch``: this rank's equal shard of the global batch; ``loss_fn``
    built for ``group`` (global BatchNorm statistics, augmentation and
    aux, as ``train.sa.make_fcn_loss(..., group=group)``).  After the
    backward the gradients are all-reduced once, as one flat buffer, and
    averaged; every rank then takes the same Adam update.  Returns
    ``step(batch, seed) -> (loss, aux)``, ``loss`` the global batch's
    mean, on the device.  With one rank the arithmetic is
    :func:`make_train_step`'s, bit for bit.  On an NCCL group the call is
    a program with its collectives captured; on a gloo group it runs
    uncaptured (``step.route``)."""
    return _single(_Steps(loss_fn, optimizer, group, programs))


def make_multi_dp_train_step(loss_fn: Callable,
                             optimizer: torch.optim.Optimizer, group, *,
                             programs=None):
    """K data-parallel steps per call: :func:`make_multi_train_step`'s
    batches (this rank's shard of each, on axis 1 of (K, B, ...)) through
    :func:`make_dp_train_step`."""
    return _Steps(loss_fn, optimizer, group, programs)


def segmentation_aux(pred: torch.Tensor, label: torch.Tensor, classes,
                     group=None) -> dict:
    """The trainers' aux metrics: ``accuracy`` and, for each ``(name,
    k)`` of ``classes``, the Dice of class k.  With a process group of
    more than one rank they are ratios of the global batch's counts, all
    reduced in one float64 vector before the ratios, as the JAX DP step's
    sums over its sharded batch."""
    with torch.no_grad():
        if group is None or dist.get_world_size(group) == 1:
            aux = {"accuracy": (pred == label).float().mean()}
            for name, k in classes:
                a, b = pred == k, label == k
                aux[name] = (2 * (a & b).sum() / torch.clamp(
                    a.sum() + b.sum(), min=1e-7))
            return aux
        # the pixel count as a device fill: no copy from the host
        counts = [(pred == label).sum(),
                  label.new_full((), label.numel(), dtype=torch.int64)]
        for _, k in classes:
            a, b = pred == k, label == k
            counts += [(a & b).sum(), a.sum() + b.sum()]
        c = torch.stack(counts).double()
        dist.all_reduce(c, group=group)
        aux = {"accuracy": (c[0] / c[1]).float()}
        for i, (name, _) in enumerate(classes):
            aux[name] = (2 * c[2 + 2 * i]
                         / torch.clamp(c[3 + 2 * i], min=1e-7)).float()
        return aux


def make_eval_step(metric_fn: Callable, *, programs=None):
    """Evaluation step: ``metric_fn(batch) -> outputs`` (tensors, in
    tuples and dicts) without gradients; on the card a program of
    ``programs`` (by default the step's own) per batch shape, the JAX
    package's jitted ``loss_fn_eval``."""
    cache = (programs if programs is not None else
             programs_lib.ProgramCache(max_bytes=TRAINER_BYTES))
    tag = ("eval", next(_BUILDERS))
    spec = []

    def eval_step(batch):
        names = sorted(batch)

        def fn(*xs):
            with torch.no_grad():
                out = metric_fn(dict(zip(names, xs)))
            leaves, s = pytree.tree_flatten(out)
            spec[:] = [s]
            return tuple(leaves)

        out = cache.run(tag + (tuple(names),), fn,
                        *(batch[n] for n in names))
        return pytree.tree_unflatten(list(out), spec[0])

    eval_step.programs = cache
    return eval_step
