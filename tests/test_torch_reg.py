"""The port's registration (``reg/{losses,register,parcfg}.py``,
``ops/resample.py``) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both.  The JAX
package runs its gather path here (its ``'auto'`` warp backend is the
gather off a TPU), which is what the port computes for every backend.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ukbb_cardiac_tpu.ops.resample import sample_2d as jsample
from ukbb_cardiac_tpu.reg import losses as jl
from ukbb_cardiac_tpu.reg import register as jr
from ukbb_cardiac_tpu.reg.parcfg import load_par_cfg as jload
from ukbb_cardiac_tpu_torch.ops.resample import sample_2d as tsample
from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh
from ukbb_cardiac_tpu_torch.reg import losses as tl
from ukbb_cardiac_tpu_torch.reg import register as tr
from ukbb_cardiac_tpu_torch.reg.parcfg import load_par_cfg as tload

torch.set_num_threads(1)

T = torch.from_numpy
# float32 elementwise work and sums over at most a few thousand terms,
# taken in another order by XLA than by PyTorch
ATOL = 1e-5


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_regconfig_fields_match_jax():
    """The config crosses between the packages as its fields: same names,
    same defaults, same presets."""
    assert ([(f.name, f.default) for f in dataclasses.fields(tr.RegConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jr.RegConfig)])
    for preset in ("cine_2d_motion", "aortic_motion"):
        jcfg = getattr(jr.RegConfig, preset)()
        assert tr.RegConfig(**dataclasses.asdict(jcfg)) == getattr(
            tr.RegConfig, preset)()


@pytest.mark.parametrize("sigma", [0.0, 0.4, 1.0, 3.0])
def test_gaussian_blur_matches_jax(sigma):
    x = _img((3, 37, 41))
    ref = np.stack([np.asarray(jr.gaussian_blur(jnp.asarray(a), sigma))
                    for a in x])
    np.testing.assert_allclose(tr.gaussian_blur(T(x), sigma).numpy(), ref,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_ssd_matches_jax(masked):
    a, b = _img((4, 20, 24), 1), _img((4, 20, 24), 2)
    m = (_img((4, 20, 24), 3) > 0.3).astype(np.float32) if masked else None
    ref = [float(jl.ssd(jnp.asarray(a[i]), jnp.asarray(b[i]),
                        None if m is None else jnp.asarray(m[i])))
           for i in range(4)]
    got = tl.ssd(T(a), T(b), None if m is None else T(m)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_bending_energy_and_nmi_match_jax():
    f = np.random.RandomState(4).randn(3, 22, 26, 2).astype(np.float32)
    ref = [float(jl.bending_energy(jnp.asarray(fi))) for fi in f]
    np.testing.assert_allclose(tl.bending_energy(T(f)).numpy(), ref,
                               rtol=1e-5, atol=0)
    a, b = _img((3, 30, 30), 5), _img((3, 30, 30), 6)
    b[1] = a[1]
    ref = [float(jl.nmi(jnp.asarray(a[i]), jnp.asarray(b[i]), 16))
           for i in range(3)]
    np.testing.assert_allclose(tl.nmi(T(a), T(b), 16).numpy(), ref,
                               rtol=1e-5, atol=0)


def _coords(shape, seed):
    """Sampling coordinates that lie inside, on integers, and outside."""
    rng = np.random.RandomState(seed)
    X, Y = shape
    cx = rng.uniform(-2.5, X + 1.5, size=(17, 13)).astype(np.float32)
    cy = rng.uniform(-2.5, Y + 1.5, size=(17, 13)).astype(np.float32)
    cx[:4] = np.round(cx[:4])                    # exact integers ...
    cy[:4] = np.round(cy[:4])
    cx[4, :4] = [-1.0, -0.5, X - 1.0, X - 0.5]   # ... and the edges
    cy[4, :4] = [Y - 1.0, -1.0, -0.25, Y]
    return cx, cy


def test_sample_2d_matches_map_coordinates():
    img = _img((12, 15), 7) * 10
    cx, cy = _coords(img.shape, 8)
    ref = np.asarray(jsample(jnp.asarray(img), jnp.asarray(cx),
                             jnp.asarray(cy), order=1))
    got = tsample(T(img), T(cx), T(cy)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # batched over a leading axis, each image at its own coordinates
    imgs = np.stack([img, img[::-1].copy()])
    got2 = tsample(T(imgs), T(np.stack([cx, cy])), T(np.stack([cy, cx]))
                   ).numpy()
    np.testing.assert_allclose(got2[0], ref, atol=1e-6, rtol=0)
    ref2 = np.asarray(jsample(jnp.asarray(imgs[1]), jnp.asarray(cy),
                              jnp.asarray(cx), order=1))
    np.testing.assert_allclose(got2[1], ref2, atol=1e-6, rtol=0)
    # warp_image is the same sampling at grid + displacement
    disp = np.stack([cx[:12, :13] - np.arange(12)[:, None],
                     cy[:12, :13] - np.arange(13)[None, :]], -1)
    np.testing.assert_allclose(
        tr.warp_image(T(img[:, :13].copy()), T(disp.astype(np.float32))
                      ).numpy(),
        np.asarray(jr.warp_image(jnp.asarray(img[:, :13]),
                                 jnp.asarray(disp.astype(np.float32)))),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("where", ["inside", "integer", "outside"])
def test_warp_and_its_coordinate_gradient_match_jax(where):
    """The constant-source warp and its one-sided coordinate gradient;
    at zero displacement every coordinate is an integer, where the
    gradient is the forward difference."""
    B, X, Y = 2, 14, 17
    src = _img((B, X, Y), 9)
    rng = np.random.RandomState(10)
    disp = {"inside": rng.uniform(-3, 3, (B, X, Y, 2)),
            "integer": rng.randint(-2, 3, (B, X, Y, 2)),
            "outside": rng.uniform(-20, 20, (B, X, Y, 2))}[where].astype(
                np.float32)
    if where == "integer":
        disp[0] = 0.0
    G = rng.randn(B, X, Y).astype(np.float32)

    def jloss(d):
        return jnp.sum(jr._warp_batch(jnp.asarray(src), d, "gather") * G)

    ref_out = np.asarray(jr._warp_batch(jnp.asarray(src), jnp.asarray(disp),
                                        "gather"))
    ref_grad = np.asarray(jax.grad(jloss)(jnp.asarray(disp)))
    d = T(disp).requires_grad_(True)
    out = tr._warp_batch(T(src), d)
    (out * T(G)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(d.grad.numpy(), ref_grad, atol=1e-6, rtol=0)


def _smooth_fields(n, X, Y, amp, seed):
    rng = np.random.RandomState(seed)
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    out = np.zeros((n, X, Y, 2), np.float32)
    for i in range(n):
        for k in range(2):
            a, b, p = rng.uniform(0.05, 0.2, 3)
            out[i, ..., k] = amp * np.sin(a * gx + b * gy + 6 * p)
    return out


def test_compose_fields_matches_jax():
    d1 = _smooth_fields(3, 20, 24, 2.0, 11)
    d2 = _smooth_fields(3, 20, 24, 4.0, 12)  # pulls some points outside
    ref = np.stack([np.asarray(jr.compose_fields(jnp.asarray(a),
                                                 jnp.asarray(b), "gather"))
                    for a, b in zip(d1, d2)])
    got = tr.compose_fields(T(d1), T(d2)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_invert_field_batch_matches_jax():
    d = _smooth_fields(4, 24, 20, 1.5, 13)
    ref = np.asarray(jr.invert_field_batch(jnp.asarray(d), backend="gather"))
    got = tr.invert_field_batch(T(d)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_compose_chain_matches_jax_per_chain():
    pairs = _smooth_fields(2 * 5, 18, 22, 1.0, 14).reshape(2, 5, 18, 22, 2)
    got = tr.compose_chain(T(pairs)).numpy()
    assert got.shape == (2, 6, 18, 22, 2)
    for z in range(2):
        ref = np.asarray(jr.compose_chain(jnp.asarray(pairs[z]),
                                          backend="gather"))
        np.testing.assert_allclose(got[z], ref, atol=ATOL, rtol=0)


def test_total_field_transform_points_average_match_jax():
    cfg = jr.RegConfig(spacing=6, levels=2)
    rng = np.random.RandomState(15)
    controls = [rng.randn(9, 9, 2).astype(np.float32),
                rng.randn(7, 8, 2).astype(np.float32)]
    tcfg = tr.RegConfig(**dataclasses.asdict(cfg))
    ref = np.asarray(jr.total_field([jnp.asarray(c) for c in controls],
                                    (30, 34), cfg))
    got = tr.total_field([T(c) for c in controls], (30, 34), tcfg).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    pts = rng.uniform(0, 30, (11, 2)).astype(np.float32)
    ref = np.asarray(jr.transform_points([jnp.asarray(c) for c in controls],
                                         jnp.asarray(pts), cfg))
    got = tr.transform_points([T(c) for c in controls], T(pts), tcfg).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    f, w = _smooth_fields(3, 8, 9, 1.0, 16), np.array([0.2, 0.5, 0.3],
                                                      np.float32)
    np.testing.assert_allclose(
        tr.average_fields(T(f), T(w)).numpy(),
        np.asarray(jr.average_fields(jnp.asarray(f), jnp.asarray(w))),
        atol=1e-6, rtol=0)


def test_adam_matches_optax():
    """The written-out Adam against ``optax.adam`` over a few steps."""
    rng = np.random.RandomState(17)
    p = rng.randn(3, 5, 5, 2).astype(np.float32)
    grads = [rng.randn(*p.shape).astype(np.float32) * 10 ** -k
             for k in range(6)]
    opt = optax.adam(0.5)
    jp, state = jnp.asarray(p), opt.init(jnp.asarray(p))
    tp = T(p)
    adam = tr._Adam(tp, 0.5, len(grads))
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp = adam.step(tp, T(g))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)


def _blob_pairs(X=48, Y=48):
    """Smooth moving blobs with a little noise: 4 (target, source) pairs."""
    gx, gy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    rng = np.random.RandomState(18)

    def frames(shifts):
        return np.stack([np.exp(-((gx - 24 - s) ** 2 + (gy - 22 - s / 2) ** 2)
                                / 72.0) for s in shifts]).astype(np.float32)

    tgt = frames([0, 1.5, 3.0, 1.0]) + 0.01 * rng.randn(4, X, Y)
    src = frames([1.5, 3.0, 1.0, 0.0]) + 0.01 * rng.randn(4, X, Y)
    return tgt.astype(np.float32), src.astype(np.float32)


def _register_both(cfg, shape, tgt, src):
    ref = [np.asarray(c) for c in jr.make_register_batch(shape, cfg)(tgt,
                                                                      src)]
    got = tr.make_register_batch(shape, tr.RegConfig(**dataclasses.asdict(
        cfg)), device="cpu")(tgt, src)
    return ref, got


@pytest.mark.parametrize("padding_value", [None, 0.05])
def test_register_batch_after_one_adam_step(padding_value):
    """One step per level from zero lattices: Adam's first step is about
    lr * sign(gradient), so only a gradient whose sign differs could move
    a control by more than float noise; 1e-4 px (the level-0 lattice is
    scaled by its factor 2) leaves no room for one.  Odd sizes exercise
    the edge padding."""
    tgt, src = _blob_pairs(45, 47)
    cfg = jr.RegConfig(spacing=8, levels=2, iters=1, lr=0.5, be_weight=1e-2,
                       padding_value=padding_value)
    ref, got = _register_both(cfg, (45, 47), tgt, src)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=0)


def test_register_batch_full_small_run():
    """48^2, 2 levels x 30 steps on smooth blobs.  Adam normalises each
    gradient by its own size, so float noise in a near-zero gradient can
    move a control by up to lr per step; on this smooth input the lattices
    agreed to 7e-5 px and the dense fields to 2.3e-5 px (measured), held
    here at 1e-3 px."""
    tgt, src = _blob_pairs()
    cfg = jr.RegConfig(spacing=8, levels=2, iters=30, lr=0.5, be_weight=1e-2)
    ref, got = _register_both(cfg, (48, 48), tgt, src)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-3, rtol=0)
    fj = np.asarray(jax.vmap(lambda *cs: jr.total_field(cs, (48, 48), cfg))(
        *[jnp.asarray(r) for r in ref]))
    ft = tr.total_field(got, (48, 48), tr.RegConfig(**dataclasses.asdict(
        cfg))).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-3, rtol=0)
    assert np.abs(fj).max() > 1.0   # the run did move


def test_register_batch_refuses_what_is_not_ported():
    empty = np.zeros((0, 16, 16), np.float32)
    with pytest.raises(ValueError, match="empty"):
        tr.make_register_batch((16, 16), tr.RegConfig(),
                               mesh=make_mesh(["cpu"] * 2))(empty, empty)
    with pytest.raises(ValueError):
        tr.make_register_batch((16, 16), tr.RegConfig(warp_backend="tpu"),
                               device="cpu")
    reg = tr.make_register_batch((16, 16), tr.RegConfig(), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        reg(np.zeros((0, 16, 16), np.float32), np.zeros((0, 16, 16),
                                                        np.float32))


def test_register_batch_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.make_register_batch((16, 16), tr.RegConfig())


def test_load_par_cfg_matches_jax(tmp_path):
    path = tmp_path / "ffd_cine_2d_motion.cfg"
    path.write_text(
        "Transformation model = FFD\n"
        "Energy function = SSD(I1, I2 o T) + 1e-1 BE\n"
        "No. of resolution levels = 3\n"
        "Control point spacing = 10\n"
        "Padding value = -1\n"
        "Epsilon = 0.0001\n"
        "Resolution level = 1\n"
        "Blurring = 2\n")
    jcfg, jign = jload(str(path), base=jr.RegConfig.cine_2d_motion())
    tcfg, tign = tload(str(path), base=tr.RegConfig.cine_2d_motion())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tign == jign
