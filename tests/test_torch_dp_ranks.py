"""Rank functions for ``tests/test_torch_dp.py``.

The data-parallel tests spawn processes (``train/distributed.py``), and a
spawned process imports the module that holds its function.  This one
imports neither ``jax`` nor the JAX package, so the ranks stay free of
them; it holds no tests.
"""

import contextlib

import numpy as np
import torch

from ukbb_cardiac_tpu_torch.ops import augment
from ukbb_cardiac_tpu_torch.train import distributed


@contextlib.contextmanager
def injected(params):
    """Within the block the device augmenters draw ``params`` (numpy
    arrays of the global batch's parameters, :func:`augment.sample_params`
    keys) at every step instead of sampling: the JAX and torch generators
    never agree, so parity tests hand both packages the same draws."""
    if params is None:
        yield
        return
    sample = augment.sample_params

    def fixed(generator, n, shift, rotate, scale, intensity, device=None):
        assert n == len(params["rotate"]), (n, len(params["rotate"]))
        return {k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in params.items()}

    augment.sample_params = fixed
    try:
        yield
    finally:
        augment.sample_params = sample


def run_case(rank, case: dict) -> dict:
    """``distributed.replica_steps`` for one case (its ``inject`` entry
    the augmentation parameters, or None), in ``rank`` or, with ``rank``
    None, in this process."""
    case = dict(case)
    with injected(case.pop("inject", None)):
        return distributed.replica_steps(rank, **case)


def run_cases(rank, cases: list) -> list:
    """:func:`run_case` for each case in turn, one process group."""
    torch.set_num_threads(1)
    return [run_case(rank, c) for c in cases]


def fail_on(rank, bad: int):
    """Rank ``bad`` raises; the others wait in a collective it never
    joins."""
    import torch.distributed as dist

    if rank.rank == bad:
        raise KeyError(f"rank {bad} fails")
    dist.all_reduce(torch.ones(1), group=rank.group)
    return rank.rank
