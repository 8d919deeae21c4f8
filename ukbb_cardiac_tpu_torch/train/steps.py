"""Train-step builders: one step, K steps per call, evaluation.

Counterpart of ``ukbb_cardiac_tpu/train/steps.py``.  The JAX step is a
pure function (``value_and_grad`` + optax + BN state threading); here the
model owns its parameters and BN buffers, ``loss_fn`` updates the moving
statistics in place during its forward, and ``torch.optim.Adam`` applies
the update (its arithmetic is optax's: ``lr * m_hat / (sqrt(v_hat) +
eps)``, eps 1e-8).

A step takes an integer ``seed`` where the JAX step takes a PRNG key; the
loss function seeds its augmentation generator from it, so K steps in one
call equal K single steps bit for bit.  Nothing inside a step or a
K-step call waits on the device: the losses stay on the device, stacked,
and the caller reads them once per call.

Data-parallel steps (``make_dp_train_step``, ``make_multi_dp_train_step``)
run in every rank of a ``torch.distributed`` process group
(``train/distributed.py``), each on its equal shard of the global batch.
The JAX package's DP step is one GSPMD program whose loss is the global
batch's mean; here each rank takes its shard's mean, all-reduces its
gradients once per step as one flat buffer (the shard's loss rides at its
end) and divides by the world size, which is the same gradient for equal
shards.  The loss closure makes the BatchNorm statistics and the aux
metrics global (``models/layers.py``, :func:`segmentation_aux`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist


def group_shard(group) -> tuple:
    """(rank, world size) of this process in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _reduce_gradients(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                      group) -> torch.Tensor:
    """All-reduce the gradients of ``optimizer``'s parameters and the
    shard's loss as one flat buffer, divided by the world size: the
    global-batch mean of both (equal shards).  Returns the global loss;
    the gradients are written back in place."""
    world = dist.get_world_size(group)
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    return flat[-1]


def _make_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
               group=None):
    def step(batch, seed: int):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, seed)
        loss.backward()
        loss = loss.detach()
        if group is not None:
            loss = _reduce_gradients(optimizer, loss, group)
        optimizer.step()
        return loss, aux

    return step


def _make_multi_step(single: Callable):
    def multi_step(batches, seeds: Sequence[int]):
        losses, aux = [], None
        for k, seed in enumerate(seeds):
            loss, aux = single({n: v[k] for n, v in batches.items()}, seed)
            losses.append(loss)
        return torch.stack(losses), aux

    return multi_step


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer):
    """Single step.

    ``loss_fn(batch, seed) -> (loss, aux)`` runs the training forward
    (updating BN moving statistics).  Returns ``step(batch, seed) ->
    (loss, aux)`` with ``loss`` a detached device scalar."""
    return _make_step(loss_fn, optimizer)


def make_multi_train_step(loss_fn: Callable,
                          optimizer: torch.optim.Optimizer):
    """K optimizer steps per call.

    ``batches``: a dict whose tensors carry a leading axis K (one slot per
    step); ``seeds``: K integers.  Returns ``step(batches, seeds) ->
    (losses[K], last_aux)``, the losses stacked on the device.  The same
    arithmetic as K calls of :func:`make_train_step`."""
    return _make_multi_step(_make_step(loss_fn, optimizer))


def make_dp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       group):
    """Data-parallel :func:`make_train_step` in one rank of ``group``.

    ``batch``: this rank's equal shard of the global batch; ``loss_fn``
    built for ``group`` (global BatchNorm statistics, augmentation and
    aux, as ``train.sa.make_fcn_loss(..., group=group)``).  After the
    backward the gradients are all-reduced once, as one flat buffer, and
    averaged; every rank then takes the same Adam update.  Returns
    ``step(batch, seed) -> (loss, aux)``, ``loss`` the global batch's
    mean, on the device.  With one rank the arithmetic is
    :func:`make_train_step`'s, bit for bit."""
    return _make_step(loss_fn, optimizer, group)


def make_multi_dp_train_step(loss_fn: Callable,
                             optimizer: torch.optim.Optimizer, group):
    """K data-parallel steps per call: :func:`make_multi_train_step`'s
    batches (this rank's shard of each, on axis 1 of (K, B, ...)) through
    :func:`make_dp_train_step`."""
    return _make_multi_step(_make_step(loss_fn, optimizer, group))


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
        counts = [(pred == label).sum(),
                  torch.tensor(label.numel(), device=label.device)]
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


def make_eval_step(metric_fn: Callable):
    """Evaluation step: ``metric_fn(batch) -> aux`` without gradients."""

    def eval_step(batch):
        with torch.no_grad():
            return metric_fn(batch)

    return eval_step


class ScheduledAdam(torch.optim.Adam):
    """Adam whose learning rate is ``lr * factor ** n`` with ``n`` the
    number of boundaries at or below the update count (0-based, read
    from the optimizer's own state, so it survives a resume) —
    ``optax.piecewise_constant_schedule``."""

    def __init__(self, params, lr: float, boundaries: Sequence[int],
                 factor: float):
        super().__init__(params, lr=lr)
        self.base_lr = lr
        self.boundaries = sorted(boundaries)
        self.factor = factor

    def step(self, closure=None):
        first = self.param_groups[0]["params"][0]
        st = self.state.get(first, {})
        count = int(st["step"]) if st else 0
        lr = self.base_lr
        for b in self.boundaries:
            if count >= b:
                lr = lr * self.factor
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def adam_with_schedule(params, lr: float = 1e-3, reduce_after=(),
                       reduce_factor: float = 0.1) -> torch.optim.Adam:
    """Adam with the reference's piecewise-constant decay
    (``train_network_ao.py:329-339``): the learning rate multiplies by
    ``reduce_factor`` after EACH boundary in ``reduce_after``."""
    if isinstance(reduce_after, int):
        reduce_after = [reduce_after] if reduce_after > 0 else []
    boundaries = [int(b) for b in reduce_after if int(b) > 0]
    if boundaries:
        return ScheduledAdam(params, lr, boundaries, reduce_factor)
    return torch.optim.Adam(params, lr=lr)
