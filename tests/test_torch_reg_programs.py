"""The registration's programs (``reg/programs.py``) on the CPU: the
cached factory, each level's program and the field program against the
JAX package, threads through one factory, and the launch bookkeeping of
graph replays.

On the CPU every program runs as its plain function (the card tests
replay the graphs, ``tests/test_torch_card.py``), so these hold the
restructured code that the graphs capture.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.phenotype import strain as jstrain
from ukbb_cardiac_tpu.reg import register as jr
from ukbb_cardiac_tpu_torch import kernels
from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh
from ukbb_cardiac_tpu_torch.phenotype import strain as tstrain
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.reg import register as tr

torch.set_num_threads(1)


def _blob_pairs(B, X=48, Y=48, seed=18):
    """B (target, source) pairs of a smooth blob moved by up to 3 px, with
    a little noise (the blobs of ``tests/test_torch_reg.py``)."""
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    rng = np.random.RandomState(seed)

    def frames(shifts):
        return np.stack([np.exp(-((gx - 24 - s) ** 2 + (gy - 22 - s / 2) ** 2)
                                / 72.0) for s in shifts])

    shifts = rng.uniform(0, 3, size=(2, B))
    return tuple((frames(s) + 0.01 * rng.randn(B, X, Y)).astype(np.float32)
                 for s in shifts)


def _tcfg(cfg):
    return tr.RegConfig(**dataclasses.asdict(cfg))


# --- the cached factory -----------------------------------------------------

def test_factory_is_cached_per_key(monkeypatch):
    """An equal (image_shape, cfg, mesh, device, axis) gives the same
    factory back, as the JAX ``lru_cache`` does; another cfg, shape,
    device or mesh a new one."""
    cfg = tr.RegConfig(spacing=8, levels=2, iters=3)
    reg = tr.make_register_batch((32, 32), cfg, device="cpu")
    assert reg is tr.make_register_batch([32, 32], tr.RegConfig(
        spacing=8, levels=2, iters=3), device=torch.device("cpu"))
    others = [tr.make_register_batch((32, 32), tr.RegConfig(
                  spacing=8, levels=2, iters=4), device="cpu"),
              tr.make_register_batch((32, 48), cfg, device="cpu"),
              tr.make_register_batch((32, 32), cfg,
                                     mesh=make_mesh(["cpu"] * 2))]
    # building a factory for the card touches no card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    others.append(tr.make_register_batch((32, 32), cfg, device="cuda"))
    assert len({id(r) for r in [reg] + others}) == 1 + len(others)
    assert tr.make_register_batch((32, 32), cfg,
                                  mesh=make_mesh(["cpu"] * 2)) is others[2]


def test_factory_checks_its_config_before_the_cache():
    with pytest.raises(ValueError, match="unknown metric"):
        tr.make_register_batch((16, 16), tr.RegConfig(metric="mi"),
                               device="cpu")


# --- the level programs against the JAX package ----------------------------

@pytest.mark.parametrize("metric, levels, iters, atol", [
    # the bound of tests/test_torch_reg.py's multi-step run, 1e-3 px: 2
    # levels x 30 SSD steps; the NMI config's 1 level, 5 steps (6.4e-5 px
    # measured: beyond some 10 steps Adam's sign sensitivity carries the
    # NMI runs of both packages apart, as tests/test_torch_propagate.py
    # sets out)
    ("ssd", 2, 30, 1e-3),
    ("nmi", 1, 5, 1e-3),
])
def test_level_programs_match_jax(metric, levels, iters, atol):
    tgt, src = _blob_pairs(4)
    cfg = jr.RegConfig(spacing=8, levels=levels, iters=iters, lr=0.5,
                       be_weight=1e-2 if metric == "ssd" else 1e-4,
                       metric=metric, n_bins=16)
    ref = jr.make_register_batch((48, 48), cfg)(tgt, src)
    got = tr.make_register_batch((48, 48), _tcfg(cfg), device="cpu")(
        tgt, src)
    assert len(got) == levels
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol,
                                   rtol=0)
    assert np.abs(np.asarray(ref[-1])).max() > 0.1   # the lattices moved


def test_threads_through_one_factory_get_their_own_result():
    """Two threads register different pairs through one cached factory
    at once: each gets bitwise what it gets alone."""
    cfg = tr.RegConfig(spacing=8, levels=2, iters=5)
    reg = tr.make_register_batch((48, 48), cfg, device="cpu")
    inputs = [_blob_pairs(3, seed=s) for s in (1, 2)]
    alone = [reg(*pair) for pair in inputs]
    got = [None, None]

    def worker(i):
        got[i] = reg(*inputs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for want, have in zip(alone, got):
        assert all(torch.equal(a, b) for a, b in zip(want, have))
    assert not torch.equal(alone[0][-1], alone[1][-1])


# --- the field program ------------------------------------------------------

@pytest.mark.parametrize("inverse_consistent", [True, False])
def test_field_program_is_densify_then_combine(inverse_consistent):
    """The field program equals ``combine_fields`` of ``total_field``
    bitwise, and the JAX ``_field_programs`` (dense, then combine) at the
    ``tests/test_torch_strain.py`` tolerance."""
    Z, T, X, Y = 2, 5, 24, 32
    cfg = jr.RegConfig(spacing=8, levels=2)
    B = Z * (T if inverse_consistent else 2 * (T - 1))
    rng = np.random.RandomState(5)
    controls = [(0.8 * rng.randn(B, *tr.bspline.lattice_shape(
        (X // f, Y // f), cfg.spacing), 2) * f).astype(np.float32)
        for f in (2, 1)]
    tcs = [torch.from_numpy(c) for c in controls]
    with torch.no_grad():
        got = tstrain._field_program(tcs, (X, Y), Z, T, _tcfg(cfg),
                                     inverse_consistent)
        parts = tstrain.combine_fields(
            tr.total_field(tcs, (X, Y), _tcfg(cfg)), Z, T,
            inverse_consistent)
    assert torch.equal(got, parts)
    dense, combine = jstrain._field_programs(Z, T, X, Y, cfg,
                                             inverse_consistent)
    ref = np.asarray(combine(dense(*[jnp.asarray(c) for c in controls])))
    assert got.shape == ref.shape == (Z, T, X, Y, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert np.abs(ref).max() > 0.5


def test_programs_run_plain_on_the_cpu():
    """On CPU tensors a program is its function, and nothing is cached."""
    programs.clear()
    x = torch.arange(6.0).reshape(2, 3).t()      # not contiguous
    seen = []

    def fn(a):
        seen.append(a.is_contiguous())
        return (a * 2,)

    (out,) = programs.run(("double",), fn, x)
    assert torch.equal(out, x * 2) and seen == [True]
    assert programs.programs() == []
    with programs._eager_route():
        assert programs._ROUTE.eager
    assert not programs._ROUTE.eager


# --- the launch bookkeeping of graph replays --------------------------------

def _wrapper():
    def fn():
        pass

    fn.launches = 0
    fn.adjoint_launches = 0
    fn.launches_by_class = {}
    return fn


def test_launch_record_adds_its_counts_per_replay():
    fwd, head = _wrapper(), _wrapper()
    record = kernels.LaunchRecord()
    for _ in range(93):
        record.add(fwd, 1)
    for _ in range(90):
        record.add(fwd, 1, "adjoint_launches")
    record.add(head, 5, n_class=4)
    assert (fwd.launches, fwd.adjoint_launches, head.launches) == (0, 0, 0)
    for replays in (1, 2, 3):
        record.replayed()
        assert (fwd.launches, fwd.adjoint_launches) == (93 * replays,
                                                        90 * replays)
        assert head.launches == 5 * replays
        assert head.launches_by_class == {4: 5 * replays}


def test_launches_into_a_capture_are_recorded_not_counted(monkeypatch):
    """While the calling thread's stream is being captured, a wrapper's
    count goes to the capture's record (or nowhere, outside a program's
    capture); outside a capture it is counted."""
    fn = _wrapper()
    monkeypatch.setattr(kernels, "_capturing", lambda: True)
    kernels.count_launches(fn, 1)
    with kernels.recording(kernels.LaunchRecord()) as record:
        kernels.count_launches(fn, 1)
        kernels.count_launches(fn, 2, "adjoint_launches")
    assert (fn.launches, fn.adjoint_launches) == (0, 0)
    assert record.counts == {(fn, "launches", None): 1,
                             (fn, "adjoint_launches", None): 2}
    assert kernels._RECORD is None
    monkeypatch.setattr(kernels, "_capturing", lambda: False)
    kernels.count_launches(fn, 1)
    record.replayed()
    assert (fn.launches, fn.adjoint_launches) == (2, 2)
