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

Data-parallel training over several cards (the JAX package's mesh steps)
is not ported: ``make_dp_train_step`` and ``make_multi_dp_train_step``
raise (ROADMAP A14).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer):
    """Single step.

    ``loss_fn(batch, seed) -> (loss, aux)`` runs the training forward
    (updating BN moving statistics).  Returns ``step(batch, seed) ->
    (loss, aux)`` with ``loss`` a detached device scalar."""

    def step(batch, seed: int):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, seed)
        loss.backward()
        optimizer.step()
        return loss.detach(), aux

    return step


def make_multi_train_step(loss_fn: Callable,
                          optimizer: torch.optim.Optimizer):
    """K optimizer steps per call.

    ``batches``: a dict whose tensors carry a leading axis K (one slot per
    step); ``seeds``: K integers.  Returns ``step(batches, seeds) ->
    (losses[K], last_aux)``, the losses stacked on the device.  The same
    arithmetic as K calls of :func:`make_train_step`."""
    single = make_train_step(loss_fn, optimizer)

    def multi_step(batches, seeds: Sequence[int]):
        losses, aux = [], None
        for k, seed in enumerate(seeds):
            loss, aux = single({n: v[k] for n, v in batches.items()}, seed)
            losses.append(loss)
        return torch.stack(losses), aux

    return multi_step


def make_dp_train_step(*args, **kwargs):
    raise NotImplementedError(
        "data-parallel training over several cards is not ported "
        "(ROADMAP A14)")


make_multi_dp_train_step = make_dp_train_step


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
