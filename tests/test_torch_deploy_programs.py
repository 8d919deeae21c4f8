"""The deploy engines' programs (``infer/engine.py``,
``infer/deploy_ao.py``) and the strain's sampling programs
(``phenotype/strain.py``) on the CPU, against the JAX package.

On the CPU every program runs as its plain function (the card tests
replay the graphs, ``tests/test_torch_card.py``), so these hold the
functions that the graphs capture: the slice engine's prep, chunk
forward and pack against the JAX engine's ``_cine_fns`` / ``_fn``
(labels identical; packed bytes in its bit layout, the voxels in the
NIfTI file's order, and read back Fortran-contiguous), the aortic
engine's full-sequence program and dispatch against ``_lstm_full`` /
``_subject_fn`` (``seg_ao`` identical, logits and probabilities within
1e-5), and the strain's
point sampling and warp-Dice against ``_sample_program`` /
``_warp_dice_program``.  The cache tests run the engines with every
program "replayed" by its function (a fake of ``Program.__call__``), to
count the programs each key makes.

Tiny networks from seeded JAX initialisers (their BatchNorm statistics
and biases drawn from seeded numpy) and the trained LA bundles (2, 3 and
6 classes) on their phantoms; cines from seeded numpy.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom import la_phantom, seg4_la_phantom
from test_torch_la import BUNDLES, WEIGHTS
from ukbb_cardiac_tpu.infer import deploy_ao as jdeploy_ao
from ukbb_cardiac_tpu.infer.deploy import \
    load_segmentation_model as jax_load
from ukbb_cardiac_tpu.infer import engine as jengine
from ukbb_cardiac_tpu.models import convlstm as jconvlstm
from ukbb_cardiac_tpu.models import fcn as jfcn
from ukbb_cardiac_tpu.models import unet as junet
from ukbb_cardiac_tpu.phenotype import strain as jstrain
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.infer import deploy_ao as tdeploy_ao
from ukbb_cardiac_tpu_torch.infer import engine as tengine
from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
from ukbb_cardiac_tpu_torch.models.wrappers import UNetLSTM
from ukbb_cardiac_tpu_torch.phenotype import strain as tstrain
from ukbb_cardiac_tpu_torch.reg import programs

torch.set_num_threads(1)

# the full-sequence model against the JAX package's: float32 convolutions
# and 2 x T ConvLSTM steps summed in another order
SEQ_ATOL = 1e-5
# the chunk forward's softmax probabilities (the mesh and aortic tests'
# bound for the slice engine's probabilities)
PROB_ATOL = 2e-5
CHUNK = 8


def _randomised(tree, rng):
    """``tree`` with its BatchNorm scales, shifts and statistics and its
    biases drawn from ``rng`` (an initialiser leaves them 1 and 0, and a
    tiny net's labels then tie)."""
    def draw(name, a):
        if name in ("gamma", "moving_variance"):
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if name in ("beta", "moving_mean", "bias"):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    return {layer: {k: draw(k, a) for k, a in leaves.items()}
            for layer, leaves in tree.items()}


def _fcn_engines(n_class, seed=0, chunk=CHUNK):
    """A tiny FCN (3 levels) of ``n_class`` classes in both packages."""
    cfg = jfcn.FCNConfig(n_class=n_class, n_level=3, n_filter=(2, 4, 4),
                         n_block=(1, 1, 1), same_dim=2, fc=4)
    params, state, names = jfcn.init_fcn(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)
    params, state = _randomised(params, rng), _randomised(state, rng)
    jeng = jengine.InferenceEngine(
        jengine.SegmentationModel.from_fcn(params, state, names, cfg),
        chunk=chunk)
    teng = tengine.InferenceEngine(tengine.SegmentationModel.from_fcn(
        convert.fcn_from_jax(params, state, names, cfg), "cpu"), chunk=chunk)
    return jeng, teng


@pytest.fixture(scope="module")
def fcn3():
    return _fcn_engines(3)


@pytest.fixture(scope="module")
def ao_engines():
    """A tiny U-Net + bidirectional ConvLSTM in both packages."""
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


def _cine(shape=(36, 44, 3, 5), seed=1, dtype=np.int16):
    """A cine whose Z*T (15) is not a multiple of the chunk (8): two
    chunks, the last padded up."""
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 2000).astype(dtype)


def _packed_in(labels, bits, order):
    """``labels`` packed ``bits`` to a field, low field first (the JAX
    engine's bit layout), in numpy, the voxels taken in ``order``: "C"
    as the JAX engine packs them, "F" (x fastest, the NIfTI file's
    order) as the port's engines do."""
    per = 8 // bits
    flat = labels.ravel(order=order).astype(np.uint8)
    flat = np.concatenate([flat, np.zeros(-flat.size % per, np.uint8)])
    shifts = np.arange(per, dtype=np.uint8) * bits
    return np.bitwise_or.reduce(flat.reshape(-1, per) << shifts, axis=1)


def _same_packing(jp, tp, labels):
    """The two engines' packed bytes hold ``labels`` in one bit layout,
    the JAX engine's in C order and the port's in the file's order."""
    np.testing.assert_array_equal(np.asarray(jp._packed),
                                  _packed_in(labels, jp._bits, "C"))
    np.testing.assert_array_equal(tp._packed.numpy(),
                                  _packed_in(labels, tp._bits, "F"))


def _same_dispatch(jeng, teng, cine, rescale="percentile"):
    """Labels of both engines' dispatch identical, the port's
    Fortran-contiguous; packed bytes in one layout."""
    jp = jeng.segment_sequence_dispatch(cine, rescale=rescale)
    tp = teng.segment_sequence_dispatch(cine, rescale)
    got, want = tp.result(), jp.result()
    assert got.shape == want.shape == cine.shape and got.dtype == np.uint8
    assert got.flags.f_contiguous
    np.testing.assert_array_equal(got, want)
    _same_packing(jp, tp, want)
    return got


# --- the slice engine's programs ---------------------------------------------

@pytest.mark.parametrize("rescale,dtype", [("percentile", np.int16),
                                           ("zscore", np.int16),
                                           ("none", np.float32)])
def test_dispatch_programs_match_jax(fcn3, rescale, dtype):
    """prep (rescale, pad, chunks) -> chunk forward per chunk -> pack,
    on a cine of two chunks, the last padded: labels identical to the JAX
    engine's, packed in its bit layout, from the cine in C order and in
    Fortran order (as a NIfTI cine arrives; its upload copies nothing)."""
    jeng, teng = _fcn_engines(3)
    cine = _cine(dtype=dtype)
    if rescale == "none":
        cine = cine / np.float32(2000)
    labels = _same_dispatch(jeng, teng, cine, rescale)
    assert len(np.unique(labels)) > 1
    np.testing.assert_array_equal(
        _same_dispatch(jeng, teng, np.asfortranarray(cine), rescale), labels)


@pytest.mark.parametrize("n_class", [3, 6])
def test_dispatch_reads_back_in_file_order(n_class):
    """A cine of 23,865 voxels, a multiple neither of the four 2-bit nor
    of the two 4-bit fields a byte holds, so the packed tail is part
    full: ``result()`` is an F-contiguous (X, Y, Z, T) array equal to the
    JAX engine's labels, its buffer the NIfTI file's voxel stream."""
    jeng, teng = _fcn_engines(n_class)
    cine = _cine(shape=(37, 43, 3, 5), seed=n_class)
    labels = _same_dispatch(jeng, teng, cine)
    bits = tengine.label_bits(teng.model.n_class)
    assert bits == (2 if n_class <= 4 else 4)
    assert labels.size % (8 // bits) != 0
    assert labels.T.flags.c_contiguous
    assert labels.T.tobytes() == labels.tobytes(order="F")
    assert len(np.unique(labels)) > 1


@pytest.mark.parametrize("bundle", ["la_2ch", "la_4ch", "seg4"])
def test_dispatch_programs_match_jax_by_class_count(bundle):
    """The trained LA bundles (2, 3 and 6 classes: 2-bit and 4-bit fields)
    on their phantoms, 5 frames in chunks of 4 (the last padded): labels
    identical to the JAX engine's, packed in its bit layout, near the
    truth."""
    path = os.path.join(WEIGHTS, BUNDLES[bundle])
    jeng = jengine.InferenceEngine(jax_load(path), chunk=4)
    teng = tengine.InferenceEngine(load_segmentation_model(path, "cpu"),
                                   chunk=4)
    rng = np.random.RandomState(len(bundle))
    image, truth = (seg4_la_phantom(96, 96, 5, rng=rng) if bundle == "seg4"
                    else la_phantom(96, 96, 5, n_class=len(bundle) - 3,
                                    rng=rng))
    labels = _same_dispatch(jeng, teng, image.astype(np.int16))
    n_class = int(truth.max()) + 1
    assert tengine.label_bits(teng.model.n_class) == (
        2 if n_class <= 4 else 4)
    assert np.mean(labels == truth) > 0.95


@pytest.mark.parametrize("want_prob", [False, True])
def test_chunk_forward_matches_jax_fn(fcn3, want_prob):
    """The chunk-forward program's function against the JAX engine's
    ``_fn`` on one padded chunk: labels identical, probabilities within
    PROB_ATOL."""
    jeng, teng = fcn3
    block = np.random.RandomState(2).rand(CHUNK, 48, 48, 1).astype(
        np.float32)
    out = jeng._fn(block.shape, want_prob)(jeng._params, jeng._state,
                                           jnp.asarray(block))
    got = tengine._chunk_forward(teng.model, want_prob,
                                 torch.from_numpy(block))
    want_pred = out[1] if want_prob else out
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_pred))
    assert got[0].dtype == torch.uint8
    if want_prob:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(out[0]),
                                   atol=PROB_ATOL, rtol=0)


def test_run_slices_pads_the_last_chunk_as_jax(fcn3):
    """``run_slices`` of 13 slices (chunks of 8, the last padded) and the
    sequence / volume paths: labels identical to the JAX engine's,
    probabilities within PROB_ATOL."""
    jeng, teng = fcn3
    image = np.random.RandomState(3).rand(30, 34, 13).astype(np.float32)
    slices = np.transpose(image, (2, 0, 1))
    pred, prob = teng.run_slices(slices, want_prob=True)
    jpred, jprob = jeng.run_slices(slices, want_prob=True)
    assert pred.shape == (13, 30, 34) and prob.shape == (13, 30, 34, 3)
    np.testing.assert_array_equal(pred, jpred)
    np.testing.assert_allclose(prob, jprob, atol=PROB_ATOL, rtol=0)
    np.testing.assert_array_equal(teng.segment_volume(image),
                                  np.transpose(jpred, (1, 2, 0)))


def test_prep_and_pack_functions(fcn3):
    """The prep function's slices are the cine rescaled, transposed frame
    major, centred-padded and zero-padded to whole chunks; the pack
    function crops and packs them back in the cine's NIfTI voxel order
    ((X, Y, Z, T) Fortran order, x fastest)."""
    _, teng = fcn3
    cine = _cine()
    X, Y, Z, T = cine.shape
    pads = tengine.pad_to_multiple(X, Y, 16)
    up = torch.from_numpy(np.ascontiguousarray(cine.T))
    (slices,) = tengine._prep_cine("none", pads, 1, up)
    assert slices.shape == (T * Z + 1, 48, 48, 1)
    x_pre, _, y_pre, _ = pads
    want = np.transpose(cine, (3, 2, 0, 1)).reshape(T * Z, X, Y)
    window = (slice(0, T * Z), slice(x_pre, x_pre + X),
              slice(y_pre, y_pre + Y), 0)
    np.testing.assert_array_equal(slices[window].numpy(), want)
    slices[window] = 0
    assert not slices.any()                 # the padding is zeros
    labels = torch.from_numpy((np.arange(slices[..., 0].numel()) % 3)
                              .astype(np.uint8).reshape(slices.shape[:3]))
    (packed,) = tengine._pack_cine((X, Y, Z, T), pads, 2, labels)
    seg = labels[:T * Z, x_pre:x_pre + X, y_pre:y_pre + Y].numpy()
    seg = np.transpose(seg.reshape(T, Z, X, Y), (2, 3, 1, 0))
    np.testing.assert_array_equal(
        tengine.unpack_bits(packed.numpy(), 2, seg.size).reshape(
            seg.shape, order="F"), seg)


# --- the aortic engine's programs --------------------------------------------

def test_full_sequence_program_matches_jax_lstm_full(ao_engines):
    """The full-sequence program's function (U-Net over every frame, the
    bidirectional ConvLSTM's scan, softmax) against the JAX engine's
    ``_lstm_full``: ConvLSTM logits and probabilities within SEQ_ATOL."""
    jeng, teng = ao_engines
    seq = np.random.RandomState(4).randn(2, 5, 32, 32).astype(np.float32)
    want = np.asarray(jeng._lstm_full(None)(jeng._params, jeng._state,
                                            jnp.asarray(seq[..., None])))
    with torch.inference_mode():
        (got,) = tdeploy_ao._sequence_prob("unet_lstm", teng.net,
                                           torch.float32,
                                           torch.from_numpy(seq))
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want,
                               atol=SEQ_ATOL, rtol=0)
    cfg, names = jeng.cfg, jeng.names
    _, feats, _ = junet.apply_unet(jeng._params, jeng._state, names, cfg,
                                   jnp.asarray(seq.reshape(10, 32, 32, 1)),
                                   train=False)
    want_logits = np.asarray(jconvlstm.apply_biconv_lstm(
        jeng._params, feats.reshape(2, 5, 32, 32, -1)))
    with torch.inference_mode():
        logits = teng.net(torch.from_numpy(seq)[:, :, None])
    np.testing.assert_allclose(logits.permute(0, 1, 3, 4, 2).numpy(),
                               want_logits, atol=SEQ_ATOL, rtol=0)
    np.testing.assert_allclose(teng._full_prob(torch.from_numpy(seq)),
                               got, atol=0, rtol=0)


@pytest.mark.parametrize("z_score", [True, False])
def test_subject_programs_match_jax_subject_fn(ao_engines, z_score):
    """The dispatch's programs (normalise + pad, full sequence, argmax +
    crop + pack) against the JAX engine's ``_subject_fn`` at a 32^2 grid:
    labels identical, packed in one bit layout (the port's in the file's
    voxel order); ``pred_sequence`` of the padded cine through the same
    full-sequence program."""
    jeng, teng = ao_engines
    rng = np.random.RandomState(5)
    cine = (rng.rand(30, 27, 1, 6) * 1500).astype(np.int16)
    jp = jeng.segment_cine_dispatch(cine, z_score=z_score, pad_to=32)
    tp = teng.segment_cine_dispatch(cine, z_score=z_score, pad_to=32)
    got, want = tp.result(), jp.result()
    assert got.flags.f_contiguous
    np.testing.assert_array_equal(got, want)
    _same_packing(jp, tp, want)
    assert len(np.unique(got)) > 1
    padded = rng.randn(32, 32, 1, 6).astype(np.float32)
    np.testing.assert_array_equal(teng.pred_sequence(padded),
                                  jeng.pred_sequence(padded))


def test_aortic_dispatch_reads_back_in_file_order(ao_engines):
    """An aortic cine of 5,481 voxels (a part-full packed tail):
    ``result()`` is an F-contiguous (X, Y, Z, T) array equal to the JAX
    engine's labels, packed in the file's voxel order."""
    jeng, teng = ao_engines
    cine = (np.random.RandomState(6).rand(29, 27, 1, 7) * 1500).astype(
        np.int16)
    jp = jeng.segment_cine_dispatch(cine, z_score=True, pad_to=32)
    tp = teng.segment_cine_dispatch(cine, z_score=True, pad_to=32)
    got, want = tp.result(), jp.result()
    assert got.shape == cine.shape and got.dtype == np.uint8
    assert got.flags.f_contiguous and got.size % 4 != 0
    np.testing.assert_array_equal(got, want)
    _same_packing(jp, tp, want)
    assert len(np.unique(got)) > 1


# --- the strain's sampling programs ------------------------------------------

def _fields(shape, scale, seed):
    rng = np.random.RandomState(seed)
    return (scale * rng.randn(*shape, 2)).astype(np.float32)


def test_sampling_programs_match_jax_across_valid_regions():
    """``sample_points`` at a bucketed point count and ``warp_dice`` at two
    valid regions (one program for both: the region is an input) against
    the JAX programs."""
    Zsel, T, X, Y = 2, 4, 32, 32
    N = tstrain.bucket_points(70)
    assert N == jstrain._PTS_BUCKET == 128
    fields = _fields((Zsel, T, X, Y), 2.0, 6)
    pts = np.zeros((Zsel, N, 2), np.float32)
    pts[:, :70] = np.random.RandomState(7).uniform(0, 31, (Zsel, 70, 2))
    got = tstrain.sample_points(torch.from_numpy(fields),
                                torch.from_numpy(pts)).numpy()
    want = np.asarray(jstrain._sample_program(Zsel, T, X, Y, N)(
        jnp.asarray(fields), jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    seg = np.zeros((Zsel, T, X, Y), np.int32)
    seg[:, :, 6:24, 5:22] = 2
    seg[:, :, 9:19, 8:18] = 1
    program = jstrain._warp_dice_program(T, X, Y)
    for xv, yv in ((30, 29), (27, 31)):
        got = tstrain.warp_dice(torch.from_numpy(seg),
                                torch.from_numpy(fields), xv, yv).numpy()
        want = np.asarray(program(jnp.asarray(seg), jnp.asarray(fields),
                                  xv, yv))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# --- the caches --------------------------------------------------------------

@pytest.fixture
def fake_replays(monkeypatch):
    """Every program call goes through its cache, and a "replay" runs the
    program's own (first) function: counts programs and replays on the
    CPU."""
    monkeypatch.setattr(programs, "_graphed", lambda x: not getattr(
        programs._ROUTE, "eager", False))

    def replay(self, *inputs, out=None):
        result = self.fn(*inputs)
        if self.replays == 0:
            # a "pool" of the outputs' bytes, for the caches' bounds
            self.reserved = sum(r.nbytes for r in result)
        self.replays += 1
        return programs._written(result, out)

    monkeypatch.setattr(programs.Program, "__call__", replay)


def _tags(engine):
    return sorted(p.key[0][0] for p in engine.programs())


def test_engine_programs_one_per_key(fake_replays):
    """Cines whose Z/T differ but pad to one chunk plane share the chunk
    forward; prep and pack are per cine shape; a second call of a shape
    makes no program.  Labels are the plain route's."""
    _, teng = _fcn_engines(3)
    a, b = _cine((36, 44, 3, 5)), _cine((40, 40, 2, 8), seed=2)
    want = [teng.segment_sequence_dispatch(c).result() for c in (a, b)]
    assert _tags(teng) == ["chunk-forward", "pack", "pack", "prep", "prep"]
    fwd = [p for p in teng.programs() if p.key[0][0] == "chunk-forward"]
    assert fwd[0].key[2] == ((CHUNK, 48, 48, 1), torch.float32)
    assert fwd[0].replays == 4                      # 2 chunks per cine
    for c, w in zip((a, b), want):
        np.testing.assert_array_equal(
            teng.segment_sequence_dispatch(c).result(), w)
    assert len(teng.programs()) == 5 and fwd[0].replays == 8
    with programs._eager_route():
        np.testing.assert_array_equal(
            teng.segment_sequence_dispatch(a).result(), want[0])
    assert fwd[0].replays == 8
    teng.run_slices(np.zeros((5, 40, 40), np.float32), want_prob=True)
    assert ("chunk-forward", True) in [p.key[0] for p in teng.programs()]


def test_engines_and_replicas_own_their_programs(fake_replays):
    """Two engines with different weights on one shape each hold their own
    programs and give their own labels; a replica on another device holds
    its own, and on the engine's device is the engine."""
    engines = [_fcn_engines(3, seed=s)[1] for s in (10, 11)]
    cine = _cine()
    labels = [e.segment_sequence_dispatch(cine).result() for e in engines]
    assert not np.array_equal(labels[0], labels[1])
    for e, want in zip(engines, labels):
        np.testing.assert_array_equal(
            e.segment_sequence_dispatch(cine).result(), want)
    ids = [{id(p) for p in e.programs()} for e in engines]
    assert len(ids[0]) == len(ids[1]) == 3 and not ids[0] & ids[1]
    eng = engines[0]
    assert eng.replica("cpu") is eng
    rep = eng.replica(torch.device("cpu", 1))
    assert rep is not eng and rep is eng.replica(torch.device("cpu", 1))
    assert rep._programs is not eng._programs and rep.programs() == []


def test_aortic_engine_programs(fake_replays, ao_engines):
    """The aortic dispatch's three programs; ``pred_sequence`` of the
    padded shape reuses the full-sequence program; a replica elsewhere
    owns its own cache."""
    _, teng = ao_engines
    teng._programs.clear()
    cine = (np.random.RandomState(8).rand(30, 27, 1, 6) * 900).astype(
        np.int16)
    want = teng.segment_cine_dispatch(cine, pad_to=32).result()
    assert _tags(teng) == ["full-prob", "subject-pack", "subject-prep"]
    np.testing.assert_array_equal(
        teng.segment_cine_dispatch(cine, pad_to=32).result(), want)
    teng.pred_sequence(np.zeros((32, 32, 1, 6), np.float32))
    full = [p for p in teng.programs() if p.key[0][0] == "full-prob"]
    assert len(full) == 1 and full[0].replays == 3
    rep = teng.replica(torch.device("cpu", 1))
    assert rep is not teng and rep._programs is not teng._programs
    assert teng.replica("cpu") is teng


def test_program_cache_bounds(fake_replays):
    """A bounded cache drops its least recently used programs, never the
    one just run: beyond ``max_programs`` programs, and beyond
    ``max_bytes`` of their ``reserved``, even when the newest alone is
    over; a dropped key makes a new program."""
    def fn(x):
        return (x + 1,)

    xs = [torch.zeros(n) for n in (10, 20, 30, 40)]   # 40-160 bytes
    cache = programs.ProgramCache(max_programs=2)
    for x in xs[:3]:
        cache.run(("f",), fn, x)
    assert [p.key[2][0] for p in cache.programs()] == [(20,), (30,)]
    cache.run(("f",), fn, xs[1])                      # used: now the MRU
    cache.run(("f",), fn, xs[3])
    assert [p.key[2][0] for p in cache.programs()] == [(20,), (40,)]
    assert cache.dropped == 2
    cache = programs.ProgramCache(max_bytes=200)
    for x in xs[:3]:
        cache.run(("f",), fn, x)
    assert cache.nbytes() == 120 + 80 and cache.dropped == 1
    cache.run(("f",), fn, xs[3])
    assert cache.nbytes() == 160 and cache.dropped == 3
    small = programs.ProgramCache(max_bytes=100)
    small.run(("f",), fn, xs[3])                      # over on its own
    assert small.nbytes() == 160
    (first,) = small.programs()
    small.run(("f",), fn, xs[3])
    assert small.programs() == [first] and first.replays == 2
    small.clear()
    assert small.programs() == [] and small.nbytes() == 0


def test_program_cache_writes_into_out(fake_replays):
    """With ``out`` a program's outputs are written into the given tensors
    and those come back, on the plain route and through a program."""
    x = torch.arange(6.0)
    for graphed in (False, True):
        cache = programs.ProgramCache()
        dst = (torch.empty(6), torch.empty(6))
        with (contextlib.nullcontext() if graphed
              else programs._eager_route()):
            for _ in range(2):
                got = cache.run(("f",), lambda v: (v * 2, v + 1), x, out=dst)
                assert got[0] is dst[0] and got[1] is dst[1]
                assert torch.equal(dst[0], x * 2)
                assert torch.equal(dst[1], x + 1)
        assert len(cache.programs()) == int(graphed)


def test_engine_programs_bounded_and_released(fake_replays):
    """An engine whose programs are bounded below the sum of four cine
    shapes' keeps its cache under the bound (beside one program over it
    alone), gives the unbounded engine's labels for every shape, again
    after its programs were dropped, and ``release_programs`` empties its
    cache and its replicas'."""
    _, free = _fcn_engines(3)
    shapes = [(36, 44, 3, 5), (36, 44, 4, 5), (40, 40, 2, 8), (50, 44, 3, 5)]
    cines = [_cine(s, seed=i) for i, s in enumerate(shapes)]
    want = [free.segment_sequence_dispatch(c).result() for c in cines]
    bound = free._programs.nbytes() // 2
    eng = tengine.InferenceEngine(free.model, CHUNK)
    assert eng._programs.max_bytes == programs.ENGINE_BYTES
    eng._programs.max_bytes = bound
    for _ in range(2):
        for c, w in zip(cines, want):
            np.testing.assert_array_equal(
                eng.segment_sequence_dispatch(c).result(), w)
            assert (eng._programs.nbytes() <= bound
                    or len(eng.programs()) == 1)
    assert eng._programs.dropped > 0
    rep = eng.replica(torch.device("cpu", 1))
    rep.segment_sequence_dispatch(cines[0]).result()
    assert rep.programs() and eng.programs()
    eng.release_programs()
    assert eng.programs() == [] and rep.programs() == []
    np.testing.assert_array_equal(
        eng.segment_sequence_dispatch(cines[0]).result(), want[0])


def test_strain_programs_keyed_by_shape(fake_replays):
    """One sampling program per (Zsel, T, X, Y, N) and one warp-Dice
    program per (Zsel, T, X, Y), whatever the valid region, in the
    module-level cache."""
    programs.clear()
    fields = torch.from_numpy(_fields((1, 3, 16, 16), 1.0, 9))
    seg = torch.zeros((1, 3, 16, 16), dtype=torch.int32)
    seg[..., 4:12, 4:12] = 1
    for n in (128, 128, 256):
        tstrain.sample_points(fields, torch.zeros((1, n, 2)))
    for xv in (14, 15, 16):
        tstrain.warp_dice(seg, fields, xv, 16)
    tags = sorted((p.key[0][0], p.replays) for p in programs.programs())
    assert tags == [("sample-points", 1), ("sample-points", 2),
                    ("warp-dice", 3)]
    programs.clear()
