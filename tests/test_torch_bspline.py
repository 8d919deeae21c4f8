"""The port's B-spline FFD synthesis (``reg/bspline.py``,
``reg/bspline_field.py``) against the JAX package's, and the CUDA
kernel's host-side layout.

The Pallas kernel runs under its interpreter on the CPU, as
``tests/test_pallas.py`` runs it.  The CUDA kernel cannot run here: its
weight table, indexing and the adjoint's band plan are checked by a numpy
model of the kernel's loops, and the kernel itself against the plain version by
``tests/test_torch_card.py`` and ``chip_smoke.py`` on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.reg import bspline as jb
from ukbb_cardiac_tpu.reg.pallas_bspline import pallas_dense_field
from ukbb_cardiac_tpu_torch.reg import bspline as tb
from ukbb_cardiac_tpu_torch.reg.bspline_field import (ADJOINT_THREADS,
                                                      adjoint_plan,
                                                      bspline_field,
                                                      field_plan)

torch.set_num_threads(1)

# The Pallas kernel's own bound against the conv synthesis
# (tests/test_pallas.py); the plain version differs from both only in the
# order of at most 16 float32 products per value.
SYNTH_ATOL = 2e-5
# The adjoint sums up to (4s)^2 float32 products per control; a float64
# check put one float32 summation order 9e-6 from exact at s = 40, 96^2.
ADJOINT_ATOL = 1e-4

SHAPES = [((96, 96), 8), ((192, 208), 10), ((100, 120), 20)]
LATTICE = {"covering": 0, "shorter": -2, "longer": 3}


def _lattice(shape, spacing, delta, batch=2, seed=0):
    Cx, Cy = jb.lattice_shape(shape, spacing)
    return np.random.RandomState(seed).randn(
        batch, Cx + delta, Cy + delta, 2).astype(np.float32)


@pytest.mark.parametrize("lattice", list(LATTICE))
@pytest.mark.parametrize("shape,spacing", SHAPES)
def test_plain_matches_conv_and_pallas(shape, spacing, lattice):
    c = _lattice(shape, spacing, LATTICE[lattice])
    got = tb.bspline_dense_field_plain(torch.from_numpy(c), shape,
                                       spacing).numpy()
    for i in range(c.shape[0]):
        conv = np.asarray(jb.bspline_dense_field(jnp.asarray(c[i]), shape,
                                                 spacing))
        pallas = np.asarray(pallas_dense_field(jnp.asarray(c[i]), shape,
                                               spacing, tile=80,
                                               interpret=True))
        np.testing.assert_allclose(got[i], conv, atol=SYNTH_ATOL, rtol=0)
        np.testing.assert_allclose(got[i], pallas, atol=SYNTH_ATOL, rtol=0)


def _jax_grad(c, G, shape, spacing):
    return np.stack([np.asarray(jax.grad(
        lambda cc, g=g: jnp.sum(jb.bspline_dense_field(cc, shape, spacing)
                                * g))(jnp.asarray(ci)))
        for ci, g in zip(c, G)])


@pytest.mark.parametrize("lattice", list(LATTICE))
@pytest.mark.parametrize("shape,spacing", SHAPES + [((96, 96), 40)])
def test_adjoint_matches_jax_grad(shape, spacing, lattice):
    c = _lattice(shape, spacing, LATTICE[lattice], seed=1)
    G = np.random.RandomState(2).randn(c.shape[0], *shape, 2).astype(
        np.float32)
    ref = _jax_grad(c, G, shape, spacing)
    plain = tb.bspline_adjoint_plain(torch.from_numpy(G), c.shape[1:3],
                                     spacing).numpy()
    ct = torch.from_numpy(c).requires_grad_(True)
    (bspline_field(ct, shape, spacing) * torch.from_numpy(G)).sum().backward()
    np.testing.assert_allclose(plain, ref, atol=ADJOINT_ATOL, rtol=0)
    np.testing.assert_allclose(ct.grad.numpy(), ref, atol=ADJOINT_ATOL,
                               rtol=0)


def test_public_function_keeps_jax_layouts():
    """(Cx, Cy, 2) → (X, Y, 2) and (…, Cx, Cy, 2) → (…, X, Y, 2)."""
    c = _lattice((40, 44), 6, 0, batch=6)
    one = tb.bspline_dense_field(torch.from_numpy(c[0]), (40, 44), 6)
    ref = np.asarray(jb.bspline_dense_field(jnp.asarray(c[0]), (40, 44), 6))
    assert one.shape == (40, 44, 2)
    np.testing.assert_allclose(one.numpy(), ref, atol=SYNTH_ATOL, rtol=0)
    many = tb.bspline_dense_field(
        torch.from_numpy(c.reshape(2, 3, *c.shape[1:])), (40, 44), 6)
    assert many.shape == (2, 3, 40, 44, 2)
    np.testing.assert_array_equal(many[0, 0].numpy(), one.numpy())


@pytest.mark.parametrize("spacing", [1, 5, 8, 10, 20, 40])
@pytest.mark.parametrize("extra", [-3, 0, 2])
def test_weight_table_rebuilds_basis_matrix(spacing, extra):
    """The kernel's (s, 4) residue table, indexed as the kernel indexes it
    (control ⌊x/s⌋ + a, zero past the lattice), rebuilds basis_matrix
    bit for bit, also for lattices shorter or longer than the covering
    one."""
    dim = 97
    n = max(1, jb.lattice_shape((dim, dim), spacing)[0] + extra)
    B = tb.basis_matrix(dim, spacing, n)
    table = tb.residue_weights(spacing)
    M = np.zeros_like(B)
    for x in range(dim):
        for a in range(4):
            i = x // spacing + a
            if i < n:
                M[x, i] = table[x % spacing, a]
    np.testing.assert_array_equal(M, B)
    if extra == 0:
        np.testing.assert_array_equal(B, jb.basis_matrix(dim, spacing))


def _field_in_order(c, shape, s):
    """The forward's order of operations as the first design of
    field_kernel had it (a thread per column y and run of s rows: the 4
    control rows q + a reduced over their 4 columns, stopping at the
    lattice's edge, then 4 products per pixel)."""
    w = tb.residue_weights(s)
    B, Cx, Cy, _ = c.shape
    X, Y = shape
    field = np.zeros((B, X, Y, 2), np.float32)
    for y in range(Y):
        qy = y // s
        for q in range(-(-X // s)):
            row = np.zeros((4, B, 2), np.float32)
            for a in range(4):
                if q + a >= Cx:
                    continue
                for k in range(4):
                    if qy + k >= Cy:
                        break
                    row[a] += w[y % s, k] * c[:, q + a, qy + k]
            for r in range(min(s, X - q * s)):
                field[:, q * s + r, y] = sum(w[r, a] * row[a]
                                             for a in range(4))
    return field


def _kernel_model(c, shape, s):
    """numpy model of csrc/bspline_field.cu: field_kernel's block for a
    pair and band of field_plan's rows (whole runs of s rows); each item,
    a pair of columns (y, y + 1) and the band's rows of one run q, loads
    the control rows q .. q + 3 at columns y/s .. y/s + 4 (zero beyond the
    lattice), reduces them over 4 columns for y and for y + 1 (one column
    further at a seam), and writes s rows of values straight to the
    output, 16 bytes where the pair is aligned.  Checks that every value
    is written once."""
    w = tb.residue_weights(s)
    B, Cx, Cy, _ = c.shape
    X, Y = shape
    rows, threads = field_plan(shape, s)
    assert rows % s == 0 or rows == X
    assert threads % 32 == 0 and threads <= 256
    P = (Y + 1) // 2
    out = np.zeros((B, X * Y, 2), np.float32)
    written = np.zeros(X * Y, np.int64)
    zero = np.zeros((B, 2), np.float32)

    def ctl(i, j):
        return c[:, i, j] if i < Cx and j < Cy else zero

    for x0 in range(0, X, rows):
        x1 = min(X, x0 + rows)
        q0 = x0 // s
        for it in range(P * ((x1 - 1) // s - q0 + 1)):
            j, y = it // P, 2 * (it % P)
            q, qy, qy1 = q0 + j, y // s, (y + 1) // s
            held = {}
            for col, wy, k0 in ((y, w[y % s], 0),
                                (y + 1, w[(y + 1) % s], qy1 - qy)):
                red = []
                for a in range(4):
                    acc = 0
                    for k in range(4):
                        acc = acc + wy[k] * ctl(q + a, qy + k0 + k)
                    red.append(acc)
                held[col] = red
            for x in range(max(x0, q * s), min(x1, q * s + s)):
                for col in (y, y + 1)[:2 if y + 1 < Y else 1]:
                    out[:, x * Y + col] = sum(w[x - q * s, a] * held[col][a]
                                              for a in range(4))
                    written[x * Y + col] += 1
    np.testing.assert_array_equal(written, 1)
    return out.reshape(B, X, Y, 2)


def _adjoint_model(G, lattice, s):
    """adjoint_kernel's loops: for each band of the plan and each slice of
    up to ADJOINT_THREADS of its columns, the support rows staged in
    chunks; pass 1 walks the rows in ascending x, row x = q*s + r adding
    w[r][a] G[x] into a window of 4 sums for controls q + a and storing
    control q's when its run of s rows ends; pass 2 sums the columns of
    each control column's support.  Also returns how often each cotangent
    pixel was staged."""
    w = tb.residue_weights(s)
    B, X, Y, _ = G.shape
    Cx, Cy = lattice
    ni, nj, rows, width = adjoint_plan(tuple(lattice), (X, Y), s)
    out = np.zeros((B, Cx, Cy, 2), np.float32)
    staged = np.zeros((X, Y), np.int64)
    for j0 in range(0, Cy, nj):
        j1 = min(Cy, j0 + nj)
        ya = max(0, (j0 - 3) * s)
        W = max(0, min(Y, j1 * s) - ya)
        assert W <= width
        for i0 in range(0, Cx, ni):
            i1 = min(Cx, i0 + ni)
            xa, xb = max(0, (i0 - 3) * s), min(X, i1 * s)
            part = np.zeros((B, i1 - i0, W, 2), np.float32)
            for ys in range(ya, ya + W, ADJOINT_THREADS):
                ws = min(ADJOINT_THREADS, ya + W - ys)
                win = np.zeros((4, B, ws, 2), np.float32)
                q, r = xa // s, 0

                def store(i, v):
                    if i0 <= i < i1:
                        part[:, i - i0, ys - ya:ys - ya + ws] = v

                for x0 in range(xa, xb, rows):
                    x1 = min(xb, x0 + rows)
                    stage = G[:, x0:x1, ys:ys + ws]
                    staged[x0:x1, ys:ys + ws] += 1
                    for x in range(x0, x1):
                        win += w[r][:, None, None, None] * stage[:, x - x0]
                        r += 1
                        if r == s:
                            store(q, win[0])
                            win = np.concatenate([win[1:], win[:1] * 0])
                            q, r = q + 1, 0
                for k in range(4):
                    store(q + k, win[k])
            for il in range(i1 - i0):
                for j in range(j0, j1):
                    acc = np.zeros((B, 2), np.float32)
                    for a in (3, 2, 1, 0):
                        y0 = (j - a) * s
                        for r in range(max(0, -y0), min(s, Y - y0)):
                            acc += w[r, a] * part[:, il, y0 + r - ya]
                    out[:, i0 + il, j] = acc
    return out, staged


def _adjoint_in_order(G, lattice, s):
    """Each control's sum over its support rows in ascending x, as the
    plain loop of the earlier one-block-per-control-row kernel wrote it,
    then pass 2: the order the window keeps."""
    w = tb.residue_weights(s)
    B, X, Y, _ = G.shape
    Cx, Cy = lattice
    out = np.zeros((B, Cx, Cy, 2), np.float32)
    for i in range(Cx):
        part = np.zeros((B, Y, 2), np.float32)
        for x in range(max(0, (i - 3) * s), min(X, (i + 1) * s)):
            part += w[x % s, i - x // s] * G[:, x]
        for j in range(Cy):
            acc = np.zeros((B, 2), np.float32)
            for a in (3, 2, 1, 0):
                y0 = (j - a) * s
                for r in range(max(0, -y0), min(s, Y - y0)):
                    acc += w[r, a] * part[:, y0 + r]
            out[:, i, j] = acc
    return out


@pytest.mark.parametrize("shape,spacing,delta", [
    ((23, 31), 5, 0), ((30, 26), 4, -2), ((24, 24), 10, 2),
    ((24, 24), 10, 0), ((48, 48), 10, 0), ((96, 96), 10, 0),
    ((96, 96), 40, None),              # the coarse-lattice densify, 6 x 6
    ((100, 57), 10, 0),                # the aortic propagation's crop
    ((16, 700), 10, 0),                # wide: more items than threads
    ((192, 192), 10, 0),               # one band, rows in 10 chunks
    ((96, 1024), 10, 0),               # 3 bands of control rows
    ((40, 1536), 10, 0),               # bands of controls, column slices
])
def test_kernel_model_matches_plain(shape, spacing, delta):
    if delta is None:
        c = np.random.RandomState(3).randn(1, 6, 6, 2).astype(np.float32)
    else:
        c = _lattice(shape, spacing, delta, batch=1 if max(shape) > 96
                     else 2, seed=3)
    G = np.random.RandomState(4).randn(c.shape[0], *shape, 2).astype(
        np.float32)
    if shape[0] * shape[1] <= 12000:
        got = _kernel_model(c, shape, spacing)
        np.testing.assert_allclose(
            got, tb.bspline_dense_field_plain(torch.from_numpy(c), shape,
                                              spacing).numpy(),
            atol=SYNTH_ATOL, rtol=0)
        # the same operands in the same order as the first design
        np.testing.assert_array_equal(got, _field_in_order(c, shape,
                                                           spacing))
    got, staged = _adjoint_model(G, c.shape[1:3], spacing)
    np.testing.assert_allclose(
        got, tb.bspline_adjoint_plain(torch.from_numpy(G), c.shape[1:3],
                                      spacing).numpy(), atol=ADJOINT_ATOL,
        rtol=0)
    if max(shape) <= 96:   # the window keeps each control's order of sums
        np.testing.assert_array_equal(
            got, _adjoint_in_order(G, c.shape[1:3], spacing))
    ni, nj = adjoint_plan(c.shape[1:3], shape, spacing)[:2]
    if (ni, nj) == tuple(c.shape[1:3]):
        assert staged.max() == 1   # one band: each pixel read once
    else:
        assert staged.max() > 1    # bands share the rows between them


@pytest.mark.parametrize("shape,spacing,plan", [
    ((96, 96), 10, (20, 96)),      # SA strain, finest level
    ((128, 128), 10, (20, 128)),   # LA strain
    ((100, 57), 10, (20, 64)),     # propagation
    ((96, 96), 40, (40, 64)),      # a densify: one run
    ((23, 31), 5, (20, 64)),       # odd rows: 8-byte stores
    ((12, 1000), 10, (12, 256)),   # wider than the threads
])
def test_field_plan(shape, spacing, plan):
    assert field_plan(shape, spacing) == plan


def test_wrapper_takes_plain_version_on_cpu():
    c = torch.from_numpy(_lattice((32, 40), 8, 0)).requires_grad_(True)
    before = (bspline_field.launches, bspline_field.adjoint_launches)
    out = bspline_field(c, (32, 40), 8)
    out.sum().backward()
    assert (bspline_field.launches, bspline_field.adjoint_launches) == before
    torch.testing.assert_close(
        out, tb.bspline_dense_field_plain(c.detach(), (32, 40), 8),
        atol=0, rtol=0)
    torch.testing.assert_close(
        c.grad, tb.bspline_adjoint_plain(torch.ones(2, 32, 40, 2),
                                         c.shape[1:3], 8), atol=0, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    c = torch.from_numpy(_lattice((32, 40), 8, 0))
    with pytest.raises(TypeError):
        bspline_field(c.double(), (32, 40), 8)
    with pytest.raises(ValueError, match="contiguous"):
        bspline_field(c.transpose(1, 2), (32, 40), 8)
    with pytest.raises(ValueError):
        bspline_field(c[0], (32, 40), 8)
    with pytest.raises(ValueError):
        bspline_field(c.to("meta"), (32, 40), 8)
    with pytest.raises(ValueError):
        bspline_field(c, (32, 40), 0)


def test_cubic_bspline_and_point_disp_match_jax():
    t = np.linspace(-2.5, 2.5, 101).astype(np.float32)
    np.testing.assert_allclose(tb.cubic_bspline(torch.from_numpy(t)).numpy(),
                               np.asarray(jb.cubic_bspline(jnp.asarray(t))),
                               atol=1e-7, rtol=0)
    c = _lattice((32, 32), 8, 0, batch=1)[0]
    pts = np.array([[0.0, 0.0], [5.0, 9.0], [31.0, 31.0], [16.3, 4.7],
                    [-3.0, 40.0]], np.float32)
    ref = np.asarray(jb.bspline_point_disp(jnp.asarray(c), jnp.asarray(pts),
                                           8))
    got = tb.bspline_point_disp(torch.from_numpy(c), torch.from_numpy(pts),
                                8).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_fit_lattice_to_field_matches_jax():
    field = np.random.RandomState(5).randn(24, 28, 2).astype(np.float32)
    ref = jb.fit_lattice_to_field(jnp.asarray(field), 6)
    got = tb.fit_lattice_to_field(torch.from_numpy(field), 6)
    # the lattice itself comes from two pseudo-inverses of near-singular
    # bases (entries ~200 for a unit field, relative noise ~5e-5); its
    # least-squares field, what a caller uses, is well conditioned
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(
        tb.bspline_dense_field(got, (24, 28), 6).numpy(),
        np.asarray(jb.bspline_dense_field(ref, (24, 28), 6)), atol=1e-4,
        rtol=0)
