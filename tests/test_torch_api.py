"""The rest of the JAX package's public API in the port: the small
functions (``deploy_subject_sequence``, ``pad_to_factor``,
``get_trusted_mask``, ``pad_image_to_multiple``, ``native.available``,
the engines' readback) against the JAX ones, every name the JAX
subpackages' ``__init__`` export (or its torch counterpart) re-exported
by the port's, and the port's console scripts.

Masks are drawn by hypothesis (a fixed, derandomised sequence)."""

import importlib
import inspect
import os
import shutil
import tomllib
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from phantom import write_subject
from ukbb_cardiac_tpu import native as jnative
from ukbb_cardiac_tpu.infer import deploy as jdeploy
from ukbb_cardiac_tpu.infer import deploy_ao as jdeploy_ao
from ukbb_cardiac_tpu.infer import engine as jengine
from ukbb_cardiac_tpu.models import convlstm as jconvlstm
from ukbb_cardiac_tpu.models import unet as junet
from ukbb_cardiac_tpu.ops import cc as jcc
from ukbb_cardiac_tpu.ops import crop as jcrop
from ukbb_cardiac_tpu_torch import native
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.infer import deploy as tdeploy
from ukbb_cardiac_tpu_torch.infer import deploy_ao as tdeploy_ao
from ukbb_cardiac_tpu_torch.infer import engine as tengine
from ukbb_cardiac_tpu_torch.models.wrappers import UNetLSTM
from ukbb_cardiac_tpu_torch.ops import cc as tcc
from ukbb_cardiac_tpu_torch.ops import crop as tcrop

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BUNDLE = os.path.join(os.path.dirname(__file__), "fixtures", "bench_weights",
                      "FCN_sa.npz")
HYP = settings(max_examples=80, deadline=None, derandomize=True)


# --- the small functions -------------------------------------------------------

def test_deploy_subject_sequence_matches_jax(tmp_path):
    """One subject through both packages' ``deploy_subject_sequence``:
    the same returns and byte-identical seg NIfTIs; a second call skips
    (the seg exists) in both."""
    ref, port = tmp_path / "jax" / "1000000", tmp_path / "port" / "1000000"
    write_subject(str(ref), X=80, Y=96, Z=3, T=4,
                  rng=np.random.RandomState(7))
    shutil.copytree(ref, port)
    jeng = jengine.InferenceEngine(jdeploy.load_segmentation_model(BUNDLE))
    teng = tengine.InferenceEngine(tdeploy.load_segmentation_model(BUNDLE,
                                                                   "cpu"))
    assert jdeploy.deploy_subject_sequence(jeng, str(ref), "sa") > 0
    assert tdeploy.deploy_subject_sequence(teng, str(port), "sa") > 0
    for name in ("seg_sa.nii.gz", "seg_sa_ED.nii.gz", "seg_sa_ES.nii.gz",
                 "sa_ED.nii.gz", "sa_ES.nii.gz"):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    assert jdeploy.deploy_subject_sequence(jeng, str(ref), "sa") is None
    assert tdeploy.deploy_subject_sequence(teng, str(port), "sa") is None


label_maps = arrays(np.int16, st.tuples(st.integers(1, 24),
                                        st.integers(1, 24)),
                    elements=st.integers(0, 3))


@HYP
@given(label_maps, st.integers(1, 6))
def test_get_trusted_mask_matches_jax(label_map, radius):
    got = tcc.get_trusted_mask(label_map, radius)
    want = jcc.get_trusted_mask(label_map, radius)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape, multiple", [
    ((17, 30), 16), ((32, 48, 3), 16), ((5, 7, 2, 4), 8), ((64, 64), 16),
    ((1, 1, 1), 4)])
def test_pad_image_to_multiple_matches_jax(shape, multiple):
    image = np.random.RandomState(len(shape)).rand(*shape).astype(np.float32)
    got, pads = tcrop.pad_image_to_multiple(image, multiple)
    want, jpads = jcrop.pad_image_to_multiple(image, multiple)
    assert tuple(pads) == tuple(jpads)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("X, Y, factor", [
    (192, 208, 16), (17, 30, 16), (96, 96, 16), (5, 9, 4), (1, 1, 8)])
def test_pad_to_factor_matches_jax(X, Y, factor):
    assert (tengine.pad_to_factor(X, Y, factor)
            == jengine.pad_to_factor(X, Y, factor))


def test_native_available_matches_jax(monkeypatch):
    assert native.available() is jnative.available() is True

    def broken():
        raise RuntimeError("g++ failed")

    # a query only: a failed build reads as unavailable, and the ops raise
    monkeypatch.setattr(native, "get_lib", broken)
    assert native.available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.unpack_bits(np.zeros(1, np.uint8), 2, 4)


def _tiny_ao_engines():
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


def test_engine_readback_matches_jax_in_one_wait_span():
    """One cine through each engine of each package: the labels are the
    JAX engine's, and the readback is one ``ukbb.engine.wait`` span (the
    JAX package's ``d2h_seconds``, the wall blocked in the readback),
    inside the dispatch-to-labels call, under the profiler."""
    rng = np.random.RandomState(3)
    sa = (rng.rand(40, 52, 3, 10) * 900).astype(np.int16)
    ao = (rng.rand(24, 24, 1, 10) * 900).astype(np.int16)
    jsa = jengine.InferenceEngine(jdeploy.load_segmentation_model(BUNDLE))
    tsa = tengine.InferenceEngine(tdeploy.load_segmentation_model(BUNDLE,
                                                                  "cpu"))
    jao, tao = _tiny_ao_engines()
    for jeng, teng, run in (
            (jsa, tsa, lambda e: e.segment_sequence_dispatch(sa).result()),
            (jao, tao, lambda e: e.segment_cine(ao, pad_to=32))):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            labels = run(teng)
        np.testing.assert_array_equal(labels, run(jeng))
        assert labels.flags.f_contiguous and len(np.unique(labels)) > 1
        waits = [e for e in prof.events() if e.name == "ukbb.engine.wait"]
        assert len(waits) == 1 and waits[0].time_range.elapsed_us() >= 0


# --- the re-exports ------------------------------------------------------------

SUBPACKAGES = ("infer", "ops", "models", "phenotype", "ckpt", "parallel")
# JAX names whose counterpart in the port has another name
COUNTERPART = {
    "normalise_intensity_jax": "normalise_intensity_torch",
    "rescale_intensity_jax": "rescale_intensity_torch",
    "data_augmenter_jax": "data_augmenter_torch",
    "aortic_batch_augmenter_jax": "aortic_batch_augmenter_torch",
}
# not ported, on purpose: the port's __init__ docstring names each
NOT_PORTED = {"aortic_data_augmenter_jax", "init_fcn", "init_resnet",
              "init_unet", "init_conv_lstm", "init_biconv_lstm",
              "apply_resnet"}


def _jax_exports():
    """(subpackage, name) for every public name a JAX subpackage's
    ``__init__`` binds: its imports, not its submodules (apart from
    those it imports as names, ``models.losses`` / ``wrappers``)."""
    out = []
    for sub in SUBPACKAGES:
        pkg = importlib.import_module(f"ukbb_cardiac_tpu.{sub}")
        src = inspect.getsource(pkg)
        for name, value in sorted(vars(pkg).items()):
            if name.startswith("_") or name == "annotations":
                continue
            if isinstance(value, types.ModuleType) and \
                    f"import {name}" not in src and f", {name}" not in src:
                continue
            out.append((sub, name))
    return out


@pytest.mark.parametrize("sub, name", _jax_exports(),
                         ids=lambda v: str(v))
def test_subpackage_reexports(sub, name):
    port = importlib.import_module(f"ukbb_cardiac_tpu_torch.{sub}")
    if name in NOT_PORTED:
        assert name in port.__doc__, (sub, name)
        return
    value = getattr(port, COUNTERPART.get(name, name))
    assert callable(value) or isinstance(value, types.ModuleType)
    if not isinstance(value, types.ModuleType):
        assert value.__module__.startswith(f"ukbb_cardiac_tpu_torch.{sub}.")


def test_reexports_cover_the_jax_packages():
    assert len(_jax_exports()) > 80
    from ukbb_cardiac_tpu_torch.infer import InferenceEngine
    from ukbb_cardiac_tpu_torch.parallel import make_mesh
    assert InferenceEngine is tengine.InferenceEngine
    assert make_mesh(["cpu"] * 2).shape == {"data": 2}


def test_console_scripts_name_every_port_cli():
    """A ``ukbb-torch-*`` script for each CLI of the port, beside the JAX
    scripts, each naming a ``main``; and the ``torch`` extra."""
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]
    scripts = project["scripts"]
    ported = {target.split(":")[0].rsplit(".", 1)[1]
              for name, target in scripts.items()
              if name.startswith("ukbb-torch-")}
    clis = {p.stem for p in (ROOT / "ukbb_cardiac_tpu_torch" / "cli").glob(
        "*.py") if not p.stem.startswith("_")}
    assert ported == clis
    for name, target in scripts.items():
        module, fn = target.split(":")
        assert name.startswith("ukbb-torch-") == module.startswith(
            "ukbb_cardiac_tpu_torch.")
        if name.startswith("ukbb-torch-"):
            assert callable(getattr(importlib.import_module(module), fn))
            assert name.replace("ukbb-torch-", "ukbb-") in scripts
    assert project["optional-dependencies"]["torch"] == ["torch"]
