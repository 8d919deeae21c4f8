"""The deploy engines' raw up-leg (``infer/engine.py::upload_cine`` and
``dispatch_cine``) on the CPU, against the JAX package's engines.

Twelve arrays cover the host dtypes a cine arrives in (int16 of 8, 10
and 12 bits, smooth and noisy; uint16; negative and wider than 12 bits;
float32, uint8, int8; a cine of one voxel column), each in C order and
in Fortran order, as a NIfTI cine arrives.  Bounds: the upload is the
cine's contiguous (T, Z, Y, X) transpose in the dtype the engines ship,
and for a Fortran-ordered cine of a shipped dtype the cine's own buffer
(no host copy); the SA engine's dispatch (a tiny FCN) and the aortic
engine's (a tiny UNet-LSTM) give labels byte-identical to the JAX
engines' on the same weights, Fortran-contiguous, or refuse a dtype
where the JAX engine refuses it.
"""

import numpy as np
import pytest
import torch

from test_torch_api import _tiny_ao_engines
from test_torch_deploy_programs import _fcn_engines
from ukbb_cardiac_tpu_torch.infer.engine import _HOST_DTYPES, upload_cine

torch.set_num_threads(1)


def _quiet(dtype, shape=(32, 36, 4, 24), seed=1, step=40):
    """A cine that changes slowly along time, 12 bits."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4000, size=shape[:-1] + (1,)).astype(np.int32)
    walk = rng.randint(-step, step + 1, size=shape).astype(np.int32)
    walk[..., 0] = 0
    return np.clip(base + np.cumsum(walk, axis=-1), 0, 4095).astype(dtype)


def _arrays():
    rng = np.random.RandomState(0)
    out = {f"plane{m}": rng.randint(0, m + 1, size=(13, 17, 3, 5)).astype(
        np.int16) for m in (255, 1023, 4095)}
    out["delta_i16"] = _quiet(np.int16)
    out["delta_u16"] = _quiet(np.uint16)
    out["noisy"] = np.clip(500 + 80 * rng.randn(24, 24, 2, 20), 0,
                           1023).astype(np.int16)
    out["negative"] = out["plane1023"].copy()
    out["negative"][0, 0, 0, 0] = -1
    out["wide"] = out["plane1023"].copy()
    out["wide"][0, 0, 0, 0] = 5000
    out["float"] = out["plane1023"].astype(np.float32)
    out["uint8"] = (out["plane1023"] % 200).astype(np.uint8)
    out["int8"] = (out["plane1023"] % 100).astype(np.int8)
    out["odd_tail"] = rng.randint(0, 1024, size=(7, 3, 1, 1)).astype(
        np.int16)
    return out


ARRAYS = _arrays()
ORDERS = ("C", "F")


def _in_order(name, order):
    return np.asarray(ARRAYS[name], order=order)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_upload_cine_is_the_raw_transpose(name, order):
    """The engines' layout, (T, Z, Y, X) contiguous, in the cine's dtype
    or float32 (uint16 and wider); a Fortran-ordered cine of a shipped
    dtype goes up from its own buffer."""
    cine = _in_order(name, order)
    got = upload_cine(cine, torch.device("cpu"))
    shipped = cine.dtype if cine.dtype in _HOST_DTYPES else np.float32
    assert got.dtype == torch.from_numpy(np.zeros(1, shipped)).dtype
    assert got.is_contiguous() and tuple(got.shape) == cine.shape[::-1]
    np.testing.assert_array_equal(got.numpy(), cine.T.astype(shipped))
    if order == "F" and shipped == cine.dtype:
        assert got.data_ptr() == cine.ctypes.data
    if name == "delta_u16":
        assert got.dtype == torch.float32


# --- both engines against the JAX engines, every dtype -----------------------

@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, dispatch-to-labels) of each engine, and
    the JAX labels of each (array, engine), computed once for both
    memory orders."""
    jsa, tsa = _fcn_engines(3)
    jao, tao = _tiny_ao_engines()

    def ao_run(eng, cine):
        pad_to = -(-max(cine.shape[:2]) // 8) * 8
        return eng.segment_cine(cine, pad_to=pad_to)

    return {"sa": (jsa, tsa,
                   lambda e, c: e.segment_sequence_dispatch(c).result()),
            "ao": (jao, tao, ao_run)}, {}


def _jax_labels(engines, name, kind):
    """The JAX engine's labels of ``ARRAYS[name]``, or the exception it
    raises, computed once."""
    table, cache = engines
    if (name, kind) not in cache:
        jeng, _, run = table[kind]
        try:
            cache[name, kind] = np.asarray(run(jeng, ARRAYS[name]))
        except Exception as e:  # the port must refuse it too
            cache[name, kind] = e
    return cache[name, kind]


@pytest.mark.parametrize("kind", ["sa", "ao"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_engine_dispatch_matches_jax_for_every_cine_dtype(engines, name,
                                                          order, kind):
    want = _jax_labels(engines, name, kind)
    _, teng, run = engines[0][kind]
    cine = _in_order(name, order)
    if isinstance(want, Exception):
        with pytest.raises(Exception):
            run(teng, cine)
        return
    got = run(teng, cine)
    assert got.dtype == np.uint8 and got.shape == cine.shape
    assert got.flags.f_contiguous
    np.testing.assert_array_equal(got, want)
