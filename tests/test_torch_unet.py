"""The port's aortic networks against the JAX package's, on the CPU: the
TF-SAME transposed and 3D convolutions, 5D BatchNorm, the U-Net and the
temporal U-Net, the ConvLSTM cell and its uni- and bidirectional scans,
the bundle loaders, and the trained ``UNet-LSTM_ao`` bundle on a small
cine padded to the deploy's 256 x 256 grid.

Every input comes from a numpy seed and goes through both packages.
Tolerances: conv layers 1e-5; U-Net logits and features 2e-4 (the FCN's
bound); the ConvLSTM 1e-5 on tiny configs.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.ckpt import store as jstore
from ukbb_cardiac_tpu.models import convlstm as jconvlstm
from ukbb_cardiac_tpu.models import layers as jL
from ukbb_cardiac_tpu.models import unet as junet
from ukbb_cardiac_tpu.models import wrappers as jwrappers
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.ckpt.store import load_model, load_model_with_extra
from ukbb_cardiac_tpu_torch.models import convlstm as tconvlstm
from ukbb_cardiac_tpu_torch.models import layers as tL
from ukbb_cardiac_tpu_torch.models import unet as tunet
from ukbb_cardiac_tpu_torch.models import wrappers as twrappers

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(__file__), "fixtures", "bench_weights")
AO_BUNDLE = os.path.join(WEIGHTS, "UNet-LSTM_ao.npz")
LAYER_ATOL = 1e-5
UNET_ATOL = 2e-4
LSTM_ATOL = 1e-5
TINY = junet.UNetConfig(n_class=3, n_level=3, n_filter=(4, 8, 8),
                        n_block=(1, 2, 1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _oihw(k):
    k = np.asarray(k, np.float32)
    return _t(k.transpose((k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))))


# --- layers -----------------------------------------------------------------

@pytest.mark.parametrize("hw, k, cin, cout", [((6, 7), 3, 3, 5),
                                              ((8, 8), 3, 4, 2),
                                              ((5, 4), 2, 2, 3),
                                              ((4, 6), 4, 3, 3)])
def test_conv2d_transpose_matches_jax(hw, k, cin, cout):
    rng = np.random.RandomState(k + cin)
    x = rng.randn(2, *hw, cin).astype(np.float32)
    w = rng.randn(k, k, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = np.asarray(jL.conv2d_transpose(jnp.asarray(x), jnp.asarray(w),
                                          stride=2, bias=jnp.asarray(b)))
    got = tL.conv2d_transpose(_t(x).permute(0, 3, 1, 2), _oihw(w), 2,
                              bias=_t(b)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], cout)
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL, rtol=0)


def test_conv2d_transpose_is_the_input_dilated_conv():
    """The same function as the JAX package's form: zero-stuffed input,
    then a correlation with the stored kernel and the SAME-transpose
    padding."""
    rng = np.random.RandomState(1)
    x = _t(rng.randn(1, 3, 5, 6))
    w = _t(rng.randn(4, 3, 3, 3))                     # OIHW, correlation
    dil = torch.zeros(1, 3, 9, 11)
    dil[:, :, ::2, ::2] = x
    lo, hi = tL._same_transpose_padding(3, 2)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(dil, (lo, hi, lo, hi)), w)
    got = tL.conv2d_transpose(x, w, 2)
    assert got.shape == want.shape == (1, 4, 10, 12)
    torch.testing.assert_close(got, want, atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("strides", [(1, 1, 1), (1, 2, 2), (2, 2, 2)])
def test_conv3d_matches_jax(strides):
    rng = np.random.RandomState(sum(strides))
    x = rng.randn(2, 5, 7, 6, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 3, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want = np.asarray(jL.conv3d(jnp.asarray(x), jnp.asarray(w), strides,
                                bias=jnp.asarray(b)))
    got = tL.conv3d(_t(x).permute(0, 4, 1, 2, 3), _oihw(w), strides,
                    bias=_t(b)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("strides", [(1, 2, 2), (2, 2, 2)])
def test_conv3d_transpose_matches_jax(strides):
    rng = np.random.RandomState(7)
    x = rng.randn(1, 4, 5, 3, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 3, 2).astype(np.float32)
    want = np.asarray(jL.conv3d_transpose(jnp.asarray(x), jnp.asarray(w),
                                          strides))
    got = tL.conv3d_transpose(_t(x).permute(0, 4, 1, 2, 3), _oihw(w),
                              strides).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (1, 4 * strides[0], 10, 6, 2)
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("dims", [2, 3])
def test_batch_norm_matches_jax(dims):
    rng = np.random.RandomState(dims)
    shape = (2, 5, 6, 4) if dims == 2 else (2, 3, 5, 6, 4)
    x = rng.randn(*shape).astype(np.float32)
    p = {"gamma": rng.rand(4).astype(np.float32) + 0.5,
         "beta": rng.randn(4).astype(np.float32)}
    s = {"moving_mean": rng.randn(4).astype(np.float32),
         "moving_variance": rng.rand(4).astype(np.float32) + 0.1}
    want, _ = jL.batch_norm(jnp.asarray(x), p, s, train=False)
    xt = _t(x).movedim(-1, 1)
    got = tL.batch_norm(xt, _t(p["gamma"]), _t(p["beta"]),
                        _t(s["moving_mean"]), _t(s["moving_variance"]))
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)


# --- U-Nets -----------------------------------------------------------------

def _randomise_bn(params, state, seed):
    """Give every BatchNorm non-trivial statistics (init leaves them at
    0/1), so the parity tests exercise them."""
    rng = np.random.RandomState(seed)

    def walk(p, s):
        for k in p:
            if k.startswith("batch_normalization"):
                n = p[k]["gamma"].shape[0]
                p[k] = {"gamma": rng.rand(n).astype(np.float32) + 0.5,
                        "beta": 0.1 * rng.randn(n).astype(np.float32)}
                s[k] = {"moving_mean": 0.1 * rng.randn(n).astype(np.float32),
                        "moving_variance":
                            rng.rand(n).astype(np.float32) + 0.5}
            elif isinstance(p[k], dict) and "kernel" not in p[k]:
                walk(p[k], s.setdefault(k, {}))
    walk(params, state)
    return params, state


@functools.lru_cache(maxsize=None)
def _jit_init(conv3d):
    """``init_unet`` as one compiled program (not one per random draw),
    and its layer names."""
    names = {}

    def init(key):
        p, s, names["n"] = junet.init_unet(key, TINY, conv3d_=conv3d)
        return p, s

    init = jax.jit(init)
    init.lower(jax.random.PRNGKey(0))
    return init, names["n"]


def _tiny_unet(conv3d, seed=0):
    init, n = _jit_init(conv3d)
    p, s = init(jax.random.PRNGKey(seed))
    p, s = _randomise_bn(jax.tree_util.tree_map(np.asarray, p),
                         jax.tree_util.tree_map(np.asarray, s), seed)
    return p, s, n


def test_unet_matches_jax():
    p, s, n = _tiny_unet(False)
    x = np.random.RandomState(0).randn(3, 16, 24, 1).astype(np.float32)
    want_l, want_f, _ = junet.apply_unet(p, s, n, TINY, jnp.asarray(x))
    model = convert.unet_from_jax(p, s, n, TINY)
    with torch.no_grad():
        got_l, got_f = tunet.apply_unet(model, _t(x))
    assert got_l.dtype == torch.float32 and got_l.shape == (3, 16, 24, 3)
    assert got_f.shape == (3, 16, 24, 4)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=UNET_ATOL, rtol=0)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=UNET_ATOL, rtol=0)


def test_temporal_unet_matches_jax():
    p, s, n = _tiny_unet(True, seed=1)
    x = np.random.RandomState(1).randn(2, 3, 8, 16, 1).astype(np.float32)
    want_l, want_f, _ = junet.apply_temporal_unet(p, s, n, TINY,
                                                  jnp.asarray(x))
    model = convert.unet_from_jax(p, s, n, TINY, temporal=True)
    with torch.no_grad():
        got_l, got_f = tunet.apply_temporal_unet(model, _t(x))
    assert got_l.shape == (2, 3, 8, 16, 3)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=UNET_ATOL, rtol=0)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=UNET_ATOL, rtol=0)


def test_unet_bf16_keeps_the_jax_dtypes():
    p, s, n = _tiny_unet(False)
    x = np.random.RandomState(2).randn(2, 16, 16, 1).astype(np.float32)
    want_l, want_f, _ = junet.apply_unet(p, s, n, TINY, jnp.asarray(x),
                                         compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got_l, got_f = tunet.apply_unet(convert.unet_from_jax(p, s, n, TINY),
                                        _t(x), torch.bfloat16)
    assert got_l.dtype == torch.float32 and got_f.dtype == torch.bfloat16
    assert want_f.dtype == jnp.bfloat16
    # bf16 keeps ~3 digits: a loose bound on the logits
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=5e-2,
                               rtol=0)


# --- ConvLSTM ---------------------------------------------------------------

def _cell_params(rng, cin, hidden):
    return {"kernel": (0.3 * rng.randn(3, 3, cin + hidden, 4 * hidden))
            .astype(np.float32),
            "biases": (0.1 * rng.randn(4 * hidden)).astype(np.float32)}


def test_convlstm_cell_matches_jax():
    rng = np.random.RandomState(3)
    p = _cell_params(rng, 3, 4)
    x, c, h = (rng.randn(2, 6, 5, k).astype(np.float32) for k in (3, 4, 4))
    want_c, want_h = jconvlstm.convlstm_cell(p, *map(jnp.asarray, (x, c, h)))
    cell = tconvlstm.ConvLSTMCell(3, 4)
    cell.load_state_dict({"weight": _oihw(p["kernel"]),
                          "bias": _t(p["biases"])})
    nchw = [_t(a).permute(0, 3, 1, 2) for a in (x, c, h)]
    with torch.no_grad():
        got_c, got_h = cell(*nchw)
    np.testing.assert_allclose(got_c.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_c), atol=LSTM_ATOL, rtol=0)
    np.testing.assert_allclose(got_h.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_h), atol=LSTM_ATOL, rtol=0)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_convlstm_scans_match_jax(bidirectional):
    rng = np.random.RandomState(4)
    cin, hidden, n_class = 3, 4, 3
    init = (jconvlstm.init_biconv_lstm if bidirectional
            else jconvlstm.init_conv_lstm)
    params = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(5), cin, hidden, n_class))
    feats = rng.randn(2, 5, 8, 6, cin).astype(np.float32)
    apply_j = (jconvlstm.apply_biconv_lstm if bidirectional
               else jconvlstm.apply_conv_lstm)
    want = np.asarray(apply_j(params, jnp.asarray(feats)))
    model = convert.convlstm_from_jax(params, bidirectional)
    apply_t = (tconvlstm.apply_biconv_lstm if bidirectional
               else tconvlstm.apply_conv_lstm)
    with torch.no_grad():
        got = apply_t(model, _t(feats)).numpy()
    assert got.shape == want.shape == (2, 5, 8, 6, n_class)
    np.testing.assert_allclose(got, want, atol=LSTM_ATOL, rtol=0)


def test_backward_scan_aligns_states_to_frames():
    """The backward scan's state at index t has seen frames T-1 .. t: its
    last frame changes every output, its first frame only index 0."""
    torch.manual_seed(0)
    cell = tconvlstm.ConvLSTMCell(2, 3)
    with torch.no_grad():
        cell.weight.normal_()
        feats = torch.randn(1, 4, 2, 5, 5)
        base = tconvlstm.scan_cell(cell, feats, reverse=True)
        first = feats.clone()
        first[:, 0] += 1.0
        moved = tconvlstm.scan_cell(cell, first, reverse=True)
    assert torch.equal(moved[:, 1:], base[:, 1:])
    assert not torch.equal(moved[:, 0], base[:, 0])


# --- bundles ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["unet", "temporal_unet", "unet_lstm"])
def test_bundle_kinds_load_into_the_ports_modules(tmp_path, kind):
    """Bundles the JAX package writes, of each U-Net kind, load into the
    port's modules and compute the JAX function."""
    p, s, n = _tiny_unet(kind == "temporal_unet", seed=2)
    extra = {}
    if kind == "unet_lstm":
        p.update(jax.tree_util.tree_map(np.asarray, jconvlstm.init_conv_lstm(
            jax.random.PRNGKey(3), TINY.n_filter[0], 2, TINY.n_class)))
        extra = {"bidirectional": False}
    path = str(tmp_path / f"{kind}.npz")
    jstore.save_model(path, kind, TINY, n, p, s, extra)
    got_kind, cfg, names, params, state, got_extra = \
        load_model_with_extra(path)
    assert (got_kind, got_extra) == (kind, extra)
    assert cfg == tunet.UNetConfig(n_class=3, n_level=3, n_filter=(4, 8, 8),
                                   n_block=(1, 2, 1))
    assert load_model(path)[:3] == (got_kind, cfg, names)
    model = convert.unet_from_jax(params, state, names, cfg,
                                  temporal=kind == "temporal_unet")
    rng = np.random.RandomState(5)
    with torch.no_grad():
        if kind == "temporal_unet":
            x = rng.randn(1, 2, 8, 8, 1).astype(np.float32)
            got = tunet.apply_temporal_unet(model, _t(x))[0]
            want = junet.apply_temporal_unet(p, s, n, TINY, x)[0]
        elif kind == "unet":
            x = rng.randn(2, 8, 8, 1).astype(np.float32)
            got = tunet.apply_unet(model, _t(x))[0]
            want = junet.apply_unet(p, s, n, TINY, x)[0]
        else:
            x = rng.randn(1, 3, 8, 8, 1).astype(np.float32)
            feats = twrappers.unet_lstm_features(model, _t(x))
            lstm = convert.convlstm_from_jax(params, False)
            assert isinstance(lstm, tconvlstm.ConvLSTM)
            got = tconvlstm.apply_conv_lstm(lstm, feats)
            jf, _ = jwrappers.unet_lstm_features(p, s, n, TINY, x)
            want = jconvlstm.apply_conv_lstm(p, jf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=UNET_ATOL,
                               rtol=0)


@pytest.fixture(scope="module")
def ao_bundle():
    return jstore.load_model(AO_BUNDLE), load_model_with_extra(AO_BUNDLE)


def test_trained_unet_lstm_matches_jax_on_a_padded_cine(ao_bundle):
    """``UNet-LSTM_ao`` (widths 16-256, 5 levels, bidirectional ConvLSTM
    with 16 hidden channels) on a 96 x 96 x 4-frame phantom cine, z-scored
    and padded to 256 x 256 as the deploy does: features and U-Net logits
    within 2e-4, the LSTM head's logits within 2e-4, labels equal."""
    from phantom import ao_phantom
    from ukbb_cardiac_tpu.ops import normalise_intensity

    (kind, cfg, names, params, state, extra), port = ao_bundle
    assert kind == "unet_lstm" and extra["bidirectional"]
    image, _ = ao_phantom(96, 96, 4, rng=np.random.RandomState(6))
    image = np.pad(normalise_intensity(image), ((80, 80), (80, 80), (0, 0),
                                                (0, 0)))
    seq = np.transpose(image, (2, 3, 0, 1))[..., None].astype(np.float32)
    jf, _ = jwrappers.unet_lstm_features(params, state, names, cfg,
                                         jnp.asarray(seq))
    want = np.asarray(jconvlstm.apply_biconv_lstm(params, jf))
    _, pcfg, pnames, pparams, pstate, _ = port
    unet = convert.unet_from_jax(pparams, pstate, pnames, pcfg)
    lstm = convert.convlstm_from_jax(pparams, True)
    with torch.no_grad():
        tf = twrappers.unet_lstm_features(unet, _t(seq))
        got = tconvlstm.apply_biconv_lstm(lstm, tf).numpy()
        net = twrappers.UNetLSTM(unet, lstm)
        direct = net(_t(seq).permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)
    assert tf.shape == (1, 4, 256, 256, 16)
    assert got.shape == (1, 4, 256, 256, 3)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=UNET_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=UNET_ATOL, rtol=0)
    torch.testing.assert_close(direct, torch.from_numpy(got), atol=0, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
