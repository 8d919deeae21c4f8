"""The port's device meshes (``parallel/mesh.py``) and the paths that split
work over them, against the JAX package on its 8 virtual CPU devices and
against the port's own unsharded run, on ``make_mesh(["cpu"] * 8)``.

Every mesh path is embarrassingly parallel (subjects, slices and
registration pairs are independent), so labels must be byte-identical to
the unsharded port and to the JAX package's mesh, and the registration's
lattices and the cohort's strain rows equal to the unsharded port's; the
lattices and rows are held to the JAX package's within the bounds of
``tests/test_torch_reg.py`` and ``tests/test_torch_cohort.py``.  Widths
are those of ``tests/test_parallel.py``.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_cohort import (STRAIN_GLOBAL_ATOL, STRAIN_SEGMENT_ATOL,
                               _cohort)
from ukbb_cardiac_tpu.infer import deploy_ao as jdeploy_ao
from ukbb_cardiac_tpu.infer import engine as jengine
from ukbb_cardiac_tpu.models import convlstm as jconvlstm
from ukbb_cardiac_tpu.models import fcn as jfcn
from ukbb_cardiac_tpu.models import unet as junet
from ukbb_cardiac_tpu.parallel import cohort as jcohort
from ukbb_cardiac_tpu.parallel import mesh as jmesh
from ukbb_cardiac_tpu.reg import RegConfig as JCfg
from ukbb_cardiac_tpu.reg import make_register_batch as jregister
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.infer import deploy_ao as tdeploy_ao
from ukbb_cardiac_tpu_torch.infer import engine as tengine
from ukbb_cardiac_tpu_torch.models.wrappers import UNetLSTM
from ukbb_cardiac_tpu_torch.parallel import cohort as tcohort
from ukbb_cardiac_tpu_torch.parallel import mesh as tmesh
from ukbb_cardiac_tpu_torch.reg import register as treg

torch.set_num_threads(1)

# tests/test_torch_reg.py's port-vs-JAX bound on registration lattices, px
LATTICE_ATOL = 1e-3
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def fcn_engines():
    """The tiny FCN of tests/test_parallel.py in both packages."""
    cfg = jfcn.FCNConfig(n_class=4, n_level=3, n_filter=(2, 4, 4),
                         n_block=(1, 1, 1), same_dim=2, fc=4)
    params, state, names = jfcn.init_fcn(jax.random.PRNGKey(0), cfg)
    jeng = jengine.InferenceEngine(
        jengine.SegmentationModel.from_fcn(params, state, names, cfg),
        chunk=16)
    teng = tengine.InferenceEngine(tengine.SegmentationModel.from_fcn(
        convert.fcn_from_jax(params, state, names, cfg), "cpu"), chunk=16)
    return jeng, teng


@pytest.fixture(scope="module")
def ao_engines():
    """The tiny U-Net + bidirectional ConvLSTM of tests/test_parallel.py."""
    cfg = junet.UNetConfig(n_class=3, n_level=2, n_filter=(4, 4),
                           n_block=(1, 1))
    params, state, names = junet.init_unet(jax.random.PRNGKey(0), cfg)
    params.update(jconvlstm.init_biconv_lstm(jax.random.PRNGKey(1),
                                             cfg.n_filter[0], 4, cfg.n_class))
    jeng = jdeploy_ao.AorticEngine("unet_lstm", cfg, names, params, state,
                                   bidirectional=True)
    net = UNetLSTM(convert.unet_from_jax(params, state, names, cfg),
                   convert.convlstm_from_jax(params, True))
    return jeng, tdeploy_ao.AorticEngine("unet_lstm", net, "cpu")


# --- the mesh itself ---------------------------------------------------------

def test_make_mesh_shapes_match_jax(eight_devices):
    assert (tmesh.make_mesh(CPU8).shape == jmesh.make_mesh(8).shape
            == {"data": 8})
    two_d = tmesh.make_mesh(CPU8, axes=("data", "space"), shape=(4, 2))
    assert two_d.shape == jmesh.make_mesh(8, axes=("data", "space"),
                                          shape=(4, 2)).shape
    assert two_d.axis_devices("space") == [torch.device("cpu")] * 2
    replicas = tmesh.make_mesh(3, device="cpu")
    assert replicas.shape == {"data": 3}
    assert replicas.devices.tolist() == [torch.device("cpu")] * 3
    # hashable and compared by devices, as JAX's meshes
    assert replicas == tmesh.make_mesh(["cpu"] * 3)
    assert len({replicas, tmesh.make_mesh(["cpu"] * 3)}) == 1


def test_make_mesh_errors(monkeypatch):
    # a CUDA mesh without a card raises; it never becomes a CPU mesh
    for ask in ((2,), (None,), (["cuda:0"],)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh(*ask)
    with pytest.raises(ValueError, match="at least one"):
        tmesh.make_mesh(0, device="cpu")
    # more cards than the machine has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="machine has 1"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="machine has 1"):
        tmesh.make_mesh(["cuda:0", "cuda:1"])
    assert tmesh.make_mesh(1).devices.tolist() == [torch.device("cuda", 0)]


@pytest.mark.parametrize("b, n", [(8, 8), (6, 8), (1, 8), (9, 4), (5, 1)])
def test_pad_batch_to_devices_matches_jax(b, n):
    x = np.random.RandomState(b).rand(b, 3, 2).astype(np.float32)
    got, valid = tmesh.pad_batch_to_devices(x, n)
    want, jvalid = jmesh.pad_batch_to_devices(x, n)
    assert valid == jvalid == b
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s, n", [(8, 8), (3, 8), (1, 8), (9, 8), (5, 2)])
def test_pad_stack_to_multiple_matches_jax(s, n):
    x = (np.random.RandomState(s).rand(s, 4, 4) * 100).astype(np.int16)
    got, count = tengine.pad_stack_to_multiple(x, n)
    want, jcount = jengine.pad_stack_to_multiple(x, n)
    assert count == jcount == s and got.shape[0] % n == 0
    np.testing.assert_array_equal(got, want)


def test_pad_stack_to_multiple_refuses_an_empty_stack():
    empty = np.zeros((0, 4, 4), np.int16)
    for fn in (tengine.pad_stack_to_multiple, jengine.pad_stack_to_multiple):
        with pytest.raises(ValueError, match="empty"):
            fn(empty, 8)


def _jax_blocks(arr):
    """The per-device blocks of a sharded JAX array, in device order."""
    return [np.asarray(s.data) for s in sorted(arr.addressable_shards,
                                                key=lambda s: s.device.id)]


def test_shard_batch_matches_jax(eight_devices):
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    got = tmesh.shard_batch(x, tmesh.make_mesh(CPU8))
    want = _jax_blocks(jmesh.shard_batch(x, jmesh.make_mesh(8)))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.device == torch.device("cpu")
        np.testing.assert_array_equal(g.numpy(), w)
    # a dict of arrays, as JAX's pytree
    tree = tmesh.shard_batch({"a": x, "b": x[:, 0]}, tmesh.make_mesh(CPU8))
    np.testing.assert_array_equal(tree["b"][3].numpy(), x[3:4, 0])
    with pytest.raises(ValueError):
        tmesh.shard_batch(x[:6], tmesh.make_mesh(CPU8))
    with pytest.raises(ValueError):
        jmesh.shard_batch(x[:6], jmesh.make_mesh(8))


@pytest.mark.parametrize("kind", ["batch", "spatial", "replicated"])
def test_sharding_descriptors_place_blocks_as_jax(eight_devices, kind):
    """On a (4, 2) data x space mesh each descriptor puts the same block
    on each device as the JAX package's ``NamedSharding``."""
    x = np.arange(8 * 6 * 2, dtype=np.float32).reshape(8, 6, 2)
    axes, shape = ("data", "space"), (4, 2)
    tm = tmesh.make_mesh(CPU8, axes=axes, shape=shape)
    jm = jmesh.make_mesh(8, axes=axes, shape=shape)
    tsh, jsh = {"batch": (tmesh.batch_sharding(tm),
                          jmesh.batch_sharding(jm)),
                "spatial": (tmesh.spatial_sharding(tm),
                            jmesh.spatial_sharding(jm)),
                "replicated": (tmesh.replicated(tm),
                               jmesh.replicated(jm))}[kind]
    got = tmesh.shard_batch(x, tsh)
    want = _jax_blocks(jax.device_put(x, jsh))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("devices", [["cpu"] * 4,
                                     ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]])
def test_map_shards_keeps_order_and_raises_a_shards_error(devices):
    """One device runs its shards in turn; two distinct ones a thread
    each: the results come back in shard order, and a failing shard's
    exception reaches the caller."""
    devices = [torch.device(d) for d in devices]
    seen = []

    def square(shard, device):
        seen.append((shard, str(device)))
        return shard * shard

    assert tmesh.map_shards(square, [1, 2, 3, 4], devices) == [1, 4, 9, 16]
    for dev in {str(d) for d in devices}:
        mine = [sh for sh, d in seen if d == dev]
        assert mine == sorted(mine)

    def fail(shard, device):
        if shard == 3:
            raise ZeroDivisionError(f"shard {shard}")
        return shard

    with pytest.raises(ZeroDivisionError, match="shard 3"):
        tmesh.map_shards(fail, [1, 2, 3, 4], devices)


# --- the sharded deploys ------------------------------------------------------

def test_sharded_forward_matches_run_slices_and_jax(eight_devices,
                                                   fcn_engines):
    jeng, teng = fcn_engines
    slices = np.random.RandomState(0).rand(16, 32, 32, 1).astype(np.float32)
    got = teng.make_sharded_forward(tmesh.make_mesh(CPU8))(slices)
    jmesh8 = jmesh.make_mesh(8)
    with jmesh8:
        want = np.asarray(jeng.make_sharded_forward(jmesh8)(
            jeng._params, jeng._state, jnp.asarray(slices)))
    assert got.dtype == np.uint8 and got.shape == (16, 32, 32)
    np.testing.assert_array_equal(got, teng.run_slices(slices[..., 0]))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divide"):
        teng.make_sharded_forward(tmesh.make_mesh(CPU8))(slices[:6])


@pytest.mark.parametrize("n_subjects", [8, 3])
def test_segment_subjects_sharded_matches_fused_and_jax(eight_devices,
                                                        fcn_engines,
                                                        n_subjects):
    """8 subjects one per replica, and 3 (fewer than the axis: the stack
    pads by cycling)."""
    jeng, teng = fcn_engines
    rng = np.random.RandomState(n_subjects)
    cines = (rng.rand(n_subjects, 32, 36, 2, 3) * 1000).astype(np.int16)
    got = teng.segment_subjects_sharded(cines, tmesh.make_mesh(CPU8))
    want = jeng.segment_subjects_sharded(cines, jmesh.make_mesh(8))
    assert got.shape == cines.shape and got.dtype == np.uint8
    for i in range(n_subjects):
        np.testing.assert_array_equal(got[i],
                                      teng.segment_sequence_fused(cines[i]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_subjects", [8, 3])
def test_aortic_fleet_matches_segment_cine_and_jax(eight_devices, ao_engines,
                                                   n_subjects):
    jeng, teng = ao_engines
    rng = np.random.RandomState(5 + n_subjects)
    cines = (rng.rand(n_subjects, 24, 24, 1, 3) * 1000).astype(np.int16)
    got = teng.segment_subjects_sharded(cines, tmesh.make_mesh(CPU8),
                                        pad_to=32)
    want = jeng.segment_subjects_sharded(cines, jmesh.make_mesh(8), pad_to=32)
    assert got.shape == cines.shape
    for i in range(n_subjects):
        np.testing.assert_array_equal(got[i],
                                      teng.segment_cine(cines[i], pad_to=32))
    np.testing.assert_array_equal(got, want)


# --- the sharded registration and the cohort over it ---------------------------

def _ring_pairs(n=6, X=32, Y=32):
    """tests/test_parallel.py's rings: 6 pairs, not divisible by 8."""
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    d = np.sqrt((gx - X / 2) ** 2 + (gy - Y / 2) ** 2)
    tgt = [np.exp(-0.5 * ((d - 9 - 0.3 * i) / 2.5) ** 2) for i in range(n)]
    src = [np.exp(-0.5 * ((d - 11 - 0.3 * i) / 2.5) ** 2) for i in range(n)]
    return np.stack(tgt).astype(np.float32), np.stack(src).astype(np.float32)


@pytest.mark.parametrize("n_pairs", [6, 3])
def test_register_batch_on_a_mesh(eight_devices, n_pairs):
    """Equal to the port's unsharded run, bit for bit, and within the
    port-vs-JAX lattice bound of JAX's sharded run."""
    tgt, src = _ring_pairs(n_pairs)
    cfg = JCfg(levels=2, iters=20, spacing=6)
    tcfg = treg.RegConfig(levels=2, iters=20, spacing=6)
    got = treg.make_register_batch((32, 32), tcfg,
                                   mesh=tmesh.make_mesh(CPU8))(tgt, src)
    single = treg.make_register_batch((32, 32), tcfg, device="cpu")(tgt, src)
    want = jregister((32, 32), cfg, mesh=jmesh.make_mesh(8))(tgt, src)
    assert len(got) == len(single) == len(want) == 2
    for g, s, w in zip(got, single, want):
        assert g.shape == s.shape == w.shape and g.shape[0] == n_pairs
        assert torch.equal(g, s)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=LATTICE_ATOL, rtol=0)
    assert max(float(s.abs().max()) for s in single) > 0.5  # it did move


def test_register_batch_on_a_mesh_refuses_an_empty_batch():
    reg = treg.make_register_batch((16, 16), treg.RegConfig(),
                                   mesh=tmesh.make_mesh(CPU8))
    with pytest.raises(ValueError, match="empty"):
        reg(np.zeros((0, 16, 16), np.float32), np.zeros((0, 16, 16),
                                                        np.float32))


def _strain_table(csv_dir):
    return pd.read_csv(os.path.join(csv_dir, "table_strain_sax.csv"),
                       index_col=0).sort_index()


def test_run_cohort_sa_on_a_mesh(eight_devices, tmp_path):
    """Two subjects (truth segs present, so the deploy skips): the strain
    rows on ``["cpu"] * 8`` equal the unsharded port run's, and fall
    within the SA strain bounds of the JAX cohort on its 8-device mesh."""
    ref = _cohort(str(tmp_path / "jax"), 2)
    for tag in ("flat", "mesh"):
        shutil.copytree(ref, str(tmp_path / tag))
    jcohort.run_cohort_sa(ref, None, workers=1, mesh=jmesh.make_mesh(8),
                          output_dir=str(tmp_path / "jax_csv"),
                          verbose=False)
    tcohort.run_cohort_sa(str(tmp_path / "flat"), None, device="cpu",
                          output_dir=str(tmp_path / "flat_csv"),
                          verbose=False)
    res = tcohort.run_cohort_sa(str(tmp_path / "mesh"), None,
                                mesh=tmesh.make_mesh(CPU8),
                                output_dir=str(tmp_path / "mesh_csv"),
                                verbose=False)
    assert sorted(res.fleet.succeeded) == ["subj00", "subj01"]
    got, flat, want = (_strain_table(str(tmp_path / f"{t}_csv"))
                       for t in ("mesh", "flat", "jax"))
    assert got.shape == want.shape == (2, 34)
    np.testing.assert_array_equal(got.values, flat.values)
    diff = np.abs(got.values - want.values)
    assert np.nanmax(diff) <= STRAIN_SEGMENT_ATOL, np.nanmax(diff)
    glob = [want.columns.get_loc(c) for c in ("Ecc_Global (%)",
                                              "Err_Global (%)")]
    assert diff[:, glob].max() <= STRAIN_GLOBAL_ATOL, diff[:, glob]
