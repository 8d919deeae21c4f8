"""The port's fused FCN head (``models/fused_head.py``) against the JAX
package's Pallas head, and the CUDA kernel's host-side layout.

The Pallas kernel runs under its interpreter on the CPU, as
``tests/test_pallas.py`` runs it.  The CUDA kernel cannot run here: its
fragment-ordered 3xTF32 weight packing, tile walk and bilinear tap tables
are checked on the CPU by a numpy model of the kernel's tensor-core
fragments, and the kernel itself against the plain version by
``tests/test_torch_card.py`` and ``chip_smoke.py`` on a card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.models import fcn as jfcn
from ukbb_cardiac_tpu.models import pallas_head as jph
from ukbb_cardiac_tpu_torch.ckpt.convert import fcn_from_jax
from ukbb_cardiac_tpu_torch.ckpt.store import load_model
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.models import fused_head as tfh
from ukbb_cardiac_tpu_torch.models import layers as tL

torch.set_num_threads(1)

PALLAS_ATOL = 2e-5   # the Pallas head's own bound against apply_fcn
BUNDLE = os.path.join(os.path.dirname(__file__), "fixtures", "bench_weights",
                      "FCN_sa.npz")
FULL = jfcn.FCNConfig(n_class=4, n_level=5, n_filter=(16, 32, 64, 128, 256),
                      n_block=(2, 2, 3, 3, 3), same_dim=32, fc=64)


def _weights(source):
    if source == "FCN_sa":
        _, cfg, names, params, state = load_model(BUNDLE)
        return jfcn.FCNConfig(**cfg.__dict__), params, state, names
    params, state, names = jfcn.init_fcn(jax.random.PRNGKey(0), FULL)
    return (FULL, jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state), names)


def _port(cfg, params, state, names):
    return fcn_from_jax(params, state, names, tfcn.FCNConfig(**cfg.__dict__))


@pytest.mark.parametrize("source", ["init", "FCN_sa"])
def test_plain_matches_pallas_interpret(source):
    cfg, params, state, names = _weights(source)
    x = np.random.RandomState(0).rand(2, 96, 112, 1).astype(np.float32)
    ref = np.asarray(jph.apply_fcn_pallas(params, state, names, cfg,
                                          jnp.asarray(x),
                                          compute_dtype=jnp.float32))
    net = _port(cfg, params, state, names)
    with torch.no_grad():
        got = tfh.apply_fcn_fused(net, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 4, 96, 112)
    np.testing.assert_allclose(got, ref, atol=PALLAS_ATOL, rtol=0)


def test_fold_conv_bn_matches_jax():
    rng = np.random.RandomState(1)
    k = rng.randn(1, 1, 8, 6).astype(np.float32) * 0.3
    bn_p = {"gamma": rng.rand(6).astype(np.float32) + 0.5,
            "beta": rng.randn(6).astype(np.float32)}
    bn_s = {"moving_mean": rng.randn(6).astype(np.float32),
            "moving_variance": rng.rand(6).astype(np.float32) + 0.1}
    W_ref, b_ref = jph.fold_conv_bn(jnp.asarray(k), bn_p, bn_s)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    W, b = tfh.fold_conv_bn(t(k.transpose(3, 2, 0, 1)), t(bn_p["gamma"]),
                            t(bn_p["beta"]), t(bn_s["moving_mean"]),
                            t(bn_s["moving_variance"]))
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-6,
                               atol=1e-7)


def _feats(N=2, X=32, Y=48, dtype=torch.float32):
    net = _port(*_weights("init"))
    x = torch.from_numpy(
        np.random.RandomState(2).rand(N, X, Y, 1).astype(np.float32))
    with torch.no_grad():
        feats = net.encode(tfcn.nchw(x, dtype))
    return net, feats


def test_wrapper_takes_plain_version_on_cpu():
    net, feats = _feats()
    head = tfh.fold_head(net)
    before = tfh.fused_head.launches
    with torch.no_grad():
        got = tfh.fused_head(feats, head)
        ref = tfh.fused_head_plain(feats, head)
    assert tfh.fused_head.launches == before
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    net, feats = _feats()
    head = tfh.fold_head(net)
    with pytest.raises(ValueError):
        tfh.fused_head(feats[:-1], head)
    with pytest.raises(TypeError):
        tfh.fused_head([f.double() for f in feats], head)
    with pytest.raises(ValueError):
        tfh.fused_head([feats[0].transpose(2, 3).contiguous().transpose(2, 3)]
                       + feats[1:], head)
    with pytest.raises(ValueError):
        tfh.fused_head([feats[0][:, :, :16]] + feats[1:], head)


@pytest.mark.parametrize("n", [12, 13, 26, 52, 104])
def test_tap_tables_rebuild_upsample_matrices(n):
    """The kernel's (index, weight) pairs are exactly the non-zeros of
    ``_upsample_matrix``, level by level."""
    head = tfh.fold_head(_port(*_weights("init")))
    X, Y = 16 * 8, n * 16
    idx, wts = head.taps(X, Y, "cpu")
    idx, wts = idx.numpy(), wts.numpy()
    for l in range(1, head.n_level):
        t = (l - 1) * (X + Y)
        for off, n_out in ((t, X), (t + X, Y)):
            A = np.zeros((n_out, n_out >> l), np.float32)
            for r in range(n_out):
                i0, i1 = idx[off + r]
                A[r, i0] += wts[off + r, 0]
                A[r, i1] += wts[off + r, 1]
            np.testing.assert_array_equal(A, tL._upsample_matrix(n_out >> l,
                                                                 2 ** l))


# m16n8k8 TF32 fragment layouts (lane = 4g + t), as csrc/fused_head.cu
# states them: the (row, column) each register of a lane holds.
_G, _T = np.arange(32) // 4, np.arange(32) % 4
A_ROW, A_COL = np.stack([_G, _G + 8, _G, _G + 8], 1), np.stack(
    [_T, _T, _T + 4, _T + 4], 1)
C_ROW, C_COL = np.stack([_G, _G, _G + 8, _G + 8], 1), np.stack(
    [2 * _T, 2 * _T + 1, 2 * _T, 2 * _T + 1], 1)
B_ROW, B_COL = np.stack([_T, _T + 4], 1), np.stack([_G, _G], 1)


def _to_mat(frag, rows, cols, shape):
    out = np.zeros(frag.shape[:-2] + shape, np.float64)
    out[..., rows, cols] = frag
    return out


def _mma(d, a, b):
    """One mma.sync m16n8k8 on fragments: d (M, 32, 4) += a (M, 32, 4)
    . b (32, 2), products exact, the sum rounded to float32."""
    D = _to_mat(d, C_ROW, C_COL, (16, 8)) + _to_mat(
        a, A_ROW, A_COL, (16, 8)) @ _to_mat(b, B_ROW, B_COL, (8, 8))
    return D.astype(np.float32)[..., C_ROW, C_COL]


def _mma3(de, ahi, alo, frag, mode):
    """The kernel's mma3 on its two accumulators de = (d, e): d += hi . hi,
    e += lo . hi + hi . lo.  frag is the lane's float4 (32, 4) {hi b0,
    hi b1, lo b0, lo b1}; ``alo`` None when the kernel skips it (bf16
    features).  Mode "1xtf32" keeps only hi . hi: the single-TF32
    product."""
    d, e = de
    d = _mma(d, ahi, frag[:, :2])
    if mode == "1xtf32":
        return d, e
    if alo is not None:
        e = _mma(e, alo, frag[:, :2])
    return d, _mma(e, ahi, frag[:, 2:])


def _acc(*shape):
    z = np.zeros(shape + (32, 4), np.float32)
    return z, z.copy()


def _fold(de):
    return de[0] + de[1]


def _c_to_a(c, bias8):
    """bias + ReLU on a C fragment -> split A fragment, a = c[0, 2, 1, 3]."""
    v = np.maximum(c + bias8[C_COL], 0).astype(np.float32)[..., [0, 2, 1, 3]]
    return tfh.split_tf32(v)


def _tile_to_a(F, kb, bf16):
    """A fragment of k-block kb from staged tiles F (M, C, 16): channel
    8kb + column, pixel row; channels past C read as zero."""
    C = F.shape[1]
    ch = kb * 8 + A_COL
    v = np.where(ch < C, F[:, np.minimum(ch, C - 1), A_ROW], 0).astype(
        np.float32)
    hi, lo = tfh.split_tf32(v)
    return hi, (None if bf16 else lo)


def _staged_blocks(f, tile):
    """Walk an image batch f (N, C, P) in tiles of ``tile`` pixels per
    image, the last one ragged and staged as zeros past the plane, cut
    into 16-pixel warp blocks.  Returns the blocks (M, C, 16), each
    block's image and first pixel."""
    N, C, P = f.shape
    tiles = -(-P // tile)
    padded = np.zeros((N, C, tiles * tile), f.dtype)
    padded[:, :, :P] = f
    blocks = padded.reshape(N, C, -1, 16).transpose(0, 2, 1, 3)
    n = np.repeat(np.arange(N), blocks.shape[1])
    p = np.tile(np.arange(blocks.shape[1]) * 16, N)
    return blocks.reshape(-1, C, 16), n, p


def _kernel_model(feats, head, mode="3xtf32"):
    """numpy model of csrc/fused_head.cu: reads the weights only from the
    packed buffer at the offsets the C entry point computes and in
    fragment order, runs every product as the kernel's mma on fragments
    (3xTF32, or single TF32 for mode "1xtf32"), walks the pixels in the
    kernel's tiles with a ragged last tile, keeps the coarse levels' fc1
    partial sums in a channels-last scratch and adds the bilinear taps
    from the tables in the accumulator fragments' layout."""
    SD, FC, NCP = tfh.KERNEL_SAME_DIM, tfh.KERNEL_FC, tfh.KERNEL_CLASS_PAD
    bf16 = feats[0].dtype == torch.bfloat16
    f = [t.float().numpy() for t in feats]
    N, C0, X, Y = f[0].shape
    wbuf = head.packed("cpu").numpy()
    idx, wts = (t.numpy() for t in head.taps(X, Y, "cpu"))
    pos = 0

    def frags(K, Nc):  # (K/8, Nc/8, 32, 4) fragments at the cursor
        nonlocal pos
        Kp = -(-K // 8) * 8
        out = wbuf[pos:pos + 2 * Kp * Nc].reshape(Kp // 8, Nc // 8, 32, 4)
        pos += 2 * Kp * Nc
        return out

    def vec(n):
        nonlocal pos
        pos += n
        return wbuf[pos - n:pos]

    fW0, fW1, fW2, fWo = frags(C0, SD), frags(SD, FC), frags(FC, FC), frags(
        FC, NCP)
    b0, b1, b2, bo = vec(SD), vec(FC), vec(FC), vec(NCP)

    def project(F, fWsd, bsd, fW1l):
        """projection over staged channels, then the fc1 slice: (M, 8, 32, 4)"""
        h = [_acc(F.shape[0]) for _ in range(SD // 8)]
        for kb in range(fWsd.shape[0]):
            hi, lo = _tile_to_a(F, kb, bf16)
            for nb in range(SD // 8):
                h[nb] = _mma3(h[nb], hi, lo, fWsd[kb, nb], mode)
        acc = [_acc(F.shape[0]) for _ in range(FC // 8)]
        for kb in range(SD // 8):
            hi, lo = _c_to_a(_fold(h[kb]), bsd[8 * kb:8 * kb + 8])
            for nb in range(FC // 8):
                acc[nb] = _mma3(acc[nb], hi, lo, fW1l[kb, nb], mode)
        return np.stack([_fold(a) for a in acc], axis=1)

    scratch = {}
    for l in range(1, len(f)):
        C, Xl, Yl = f[l].shape[1:]
        fWsd, fW1l = frags(C, SD), frags(SD, FC)
        bsd = vec(SD)
        F, n, p = _staged_blocks(f[l].reshape(N, C, -1),
                                 tfh.KERNEL_COARSE_TILE)
        q = project(F, fWsd, bsd, fW1l)
        S = np.zeros((N, Xl * Yl, FC), np.float32)
        P = p[:, None, None] + C_ROW                       # (M, 32, 4)
        ch = np.arange(FC // 8)[:, None, None] * 8 + C_COL  # (8, 32, 4)
        ok = P < Xl * Yl
        for nb in range(FC // 8):
            S[np.broadcast_to(n[:, None, None], P.shape)[ok], P[ok],
              np.broadcast_to(ch[nb], P.shape)[ok]] = q[:, nb][ok]
        scratch[l] = S
    assert pos == wbuf.size

    F, n, p = _staged_blocks(f[0].reshape(N, C0, -1), tfh.KERNEL_TILE)
    acc = project(F, fW0, b0, fW1)
    P = np.minimum(p[:, None, None] + C_ROW, X * Y - 1)
    xs, ys = P // Y, P % Y
    ch = np.arange(FC // 8)[None, :, None, None] * 8 + C_COL
    nn = n[:, None, None, None]
    for l in range(1, len(f)):
        Yl = Y >> l
        t = (l - 1) * (X + Y)
        ix, wx, iy, wy = idx[t + xs], wts[t + xs], idx[t + X + ys], wts[
            t + X + ys]
        for a in (0, 1):
            for c in (0, 1):
                wt = (wx[..., a] * wy[..., c])[:, None]
                tap = (ix[..., a] * Yl + iy[..., c])[:, None]
                acc = (acc + wt * scratch[l][nn, tap, ch]).astype(np.float32)
    zhl = [_c_to_a(acc[:, kb], b1[8 * kb:8 * kb + 8]) for kb in range(FC // 8)]
    o = _acc(acc.shape[0])
    for nb in range(FC // 8):
        z = _acc(acc.shape[0])
        for kb in range(FC // 8):
            z = _mma3(z, *zhl[kb], fW2[kb, nb], mode)
        hi, lo = _c_to_a(_fold(z), b2[8 * nb:8 * nb + 8])
        o = _mma3(o, hi, lo, fWo[nb, 0], mode)
    o = _fold(o) + bo[C_COL]
    out = np.zeros((N, NCP, X * Y), np.float32)
    P = p[:, None, None] + C_ROW
    ok = P < X * Y
    out[np.broadcast_to(n[:, None, None], P.shape)[ok],
        np.broadcast_to(C_COL, P.shape)[ok], P[ok]] = o[ok]
    return out[:, :head.n_class].reshape(N, head.n_class, X, Y)


def _sa_feats(dtype, N=2, X=32, Y=48):
    """FCN_sa features of seeded random slices, and the folded head."""
    net = _port(*_weights("FCN_sa"))
    x = torch.from_numpy(
        np.random.RandomState(2).rand(N, X, Y, 1).astype(np.float32))
    with torch.no_grad():
        return net.encode(tfcn.nchw(x, dtype)), tfh.fold_head(net)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_layout_model_matches_plain(dtype):
    feats, head = _sa_feats(dtype)
    with torch.no_grad():
        ref = tfh.fused_head_plain(feats, head).numpy()
    np.testing.assert_allclose(_kernel_model(feats, head), ref, atol=1e-5,
                               rtol=0)


def _random_head(n_level, n_class, seed):
    """Folded head weights at the kernel's widths, seeded, no BN."""
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32))
    chans = (16, 32, 64, 128, 256)[:n_level]
    SD, FC = tfh.KERNEL_SAME_DIM, tfh.KERNEL_FC
    return tfh.HeadWeights(
        [t(c, SD) for c in chans], [t(1, SD)[0] for _ in chans],
        t(n_level * SD, FC), t(1, FC)[0], t(FC, FC), t(1, FC)[0],
        t(FC, n_class), t(1, n_class)[0])


@pytest.mark.parametrize("n_level,shape,n_class", [
    (3, (36, 44), 2),     # 1584 pixels: 12 tiles of 128 and one of 48
    (2, (18, 26), 4),     # 468: a ragged 16-pixel block of 4 pixels
    (1, (13, 7), 8),      # 91 pixels, plane not a multiple of 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_model_ragged_last_tile(n_level, shape, n_class, dtype):
    head = _random_head(n_level, n_class, seed=n_level)
    rng = np.random.RandomState(7)
    X, Y = shape
    feats = [torch.from_numpy(rng.rand(2, head.Wsd[l].shape[0], X >> l,
                                       Y >> l).astype(np.float32)).to(dtype)
             for l in range(n_level)]
    with torch.no_grad():
        ref = tfh.fused_head_plain(feats, head).numpy()
    got = _kernel_model(feats, head)
    assert got.shape == (2, n_class, X, Y)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["1xtf32", "3xtf32"])
def test_tf32_split_is_needed_for_the_kernel_bound(mode):
    """Single TF32 misses the kernel's 1e-4 bound against the plain
    version on FCN_sa features; the 3xTF32 split meets it."""
    feats, head = _sa_feats(torch.float32)
    with torch.no_grad():
        ref = tfh.fused_head_plain(feats, head).numpy()
    err = np.abs(_kernel_model(feats, head, mode) - ref).max()
    assert (err > 1e-4) if mode == "1xtf32" else (err <= 1e-5), err


@pytest.mark.parametrize("which", ["Wsd", "W1", "W2", "Wout"])
def test_packed_fragments_rebuild_weights(which):
    """hi + lo of every fragment entry rebuilds the folded weight within
    2^-21 relative, and hi, lo are TF32 values (13 low bits zero)."""
    _, head = _sa_feats(torch.float32)
    sd = head.same_dim
    mats = {"Wsd": [(w, False) for w in head.Wsd],
            "W1": [(head.W1[l * sd:(l + 1) * sd], True)
                   for l in range(head.n_level)],
            "W2": [(head.W2, True)],
            "Wout": [(torch.cat([head.Wout, torch.zeros(
                head.Wout.shape[0], 8 - head.n_class)], 1), True)]}[which]
    for W, chained in mats:
        W = W.numpy()
        fr = tfh.weight_fragments(W, chained)
        assert not (fr.view(np.uint32) & 0x1FFF).any()
        Kp = fr.shape[0] * 8
        back = np.zeros((Kp, W.shape[1]), np.float64)
        order = (tfh.CHAIN_ORDER if chained else np.arange(8))
        for kb in range(fr.shape[0]):
            for nb in range(fr.shape[1]):
                for i in (0, 1):
                    rows = kb * 8 + order[B_ROW[:, i]]
                    back[rows, nb * 8 + B_COL[:, i]] = (
                        fr[kb, nb, :, i].astype(np.float64)
                        + fr[kb, nb, :, i + 2])
        Wp = np.zeros_like(back)
        Wp[:W.shape[0]] = W
        assert np.all(np.abs(back - Wp) <= 2.0 ** -21 * np.abs(Wp))
