"""The port's native host ops beyond ingestion: the connected-component
passes that ``ops/cc.py`` routes 2D masks through, the per-frame label
counts, and the unpack of the engines' label readback — against the JAX
package's native library and against the plain scipy / numpy versions
kept beside them.

Integer outputs, so the bound is equality: masks, counts and unpacked
labels identical.  Masks are drawn by hypothesis (a fixed, derandomized
set), with ties between equal largest components, empty masks and both
connectivities among them.  Also: the port's build reads
``hostops.cc`` from its own package directory, which ``pyproject.toml``
ships, and ``utils/cache`` moves the build directories.
"""

import os
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from ukbb_cardiac_tpu import native as jnative
from ukbb_cardiac_tpu_torch import kernels, native
from ukbb_cardiac_tpu_torch.infer import engine
from ukbb_cardiac_tpu_torch.ops import cc
from ukbb_cardiac_tpu_torch.utils.cache import enable_compilation_cache

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HYP = settings(max_examples=80, deadline=None, derandomize=True)
masks = arrays(np.uint8, st.tuples(st.integers(1, 20), st.integers(1, 20)),
               elements=st.integers(0, 1))


@HYP
@given(masks)
def test_largest_cc_matches_jax_native_and_scipy(mask):
    got = cc.get_largest_cc(mask)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, cc.get_largest_cc_scipy(mask))
    np.testing.assert_array_equal(got, jnative.largest_cc_2d(mask, 1))


@HYP
@given(masks, st.integers(0, 6), st.sampled_from([1, 2]))
def test_count_and_remove_small_cc_match(mask, thres, connectivity):
    got = cc.count_significant_cc(mask, thres, connectivity)
    assert got == cc.count_significant_cc_scipy(mask, thres, connectivity)
    assert got == jnative.count_significant_cc_2d(mask, thres, connectivity)
    labels = mask * np.uint8(3)        # the input's values are kept
    kept = cc.remove_small_cc(labels, thres)
    np.testing.assert_array_equal(kept, cc.remove_small_cc_scipy(labels,
                                                                 thres))
    np.testing.assert_array_equal(
        native.remove_small_cc_2d(mask, thres, connectivity),
        jnative.remove_small_cc_2d(mask, thres, connectivity))


def _squares(*corners, size=3, shape=(12, 12)):
    m = np.zeros(shape, np.uint8)
    for x, y in corners:
        m[x:x + size, y:y + size] = 1
    return m


@pytest.mark.parametrize("mask", [
    _squares((0, 0), (6, 6)),                     # a tie: the first wins
    _squares((6, 6), (0, 7), (8, 0)),             # a three-way tie
    np.zeros((5, 7), np.uint8),                   # empty
    np.eye(6, dtype=np.uint8),                    # diagonal: 8-connected only
    np.ones((1, 9), np.uint8),
], ids=["tie", "tie3", "empty", "diagonal", "row"])
def test_cc_edge_cases(mask):
    want = cc.get_largest_cc_scipy(mask)
    np.testing.assert_array_equal(cc.get_largest_cc(mask), want)
    np.testing.assert_array_equal(jnative.largest_cc_2d(mask, 1), want)
    for conn in (1, 2):
        for thres in (0, 1, 3):
            assert (cc.count_significant_cc(mask, thres, conn)
                    == cc.count_significant_cc_scipy(mask, thres, conn))


def test_diagonal_is_one_component_at_8_connectivity():
    eye = np.eye(6, dtype=np.uint8)
    assert cc.count_significant_cc(eye, 0, 2) == 1
    assert cc.count_significant_cc(eye, 0, 1) == 6


def test_3d_masks_stay_on_scipy():
    m = np.random.RandomState(0).rand(9, 8, 5) > 0.6
    np.testing.assert_array_equal(cc.get_largest_cc(m),
                                  cc.get_largest_cc_scipy(m))
    assert (cc.count_significant_cc(m, 2, 3)
            == cc.count_significant_cc_scipy(m, 2, 3))
    with pytest.raises(ValueError, match="2D"):
        native.largest_cc_2d(m)


def test_label_areas_per_frame():
    vol = np.random.RandomState(1).randint(0, 5, (10, 9, 3, 4))
    got = native.label_areas_per_frame(vol, 4)
    np.testing.assert_array_equal(got, jnative.label_areas_per_frame(vol, 4))
    want = np.stack([[np.sum(vol[..., t] == v) for v in range(4)]
                     for t in range(4)])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="int16"):
        native.label_areas_per_frame(vol + 40000, 4)


@HYP
@given(st.sampled_from([1, 2, 4]), st.integers(0, 200), st.integers(0, 9))
def test_unpack_bits_matches_numpy_and_jax(bits, n, seed):
    packed = np.random.RandomState(seed).randint(
        0, 256, -(-n * bits // 8) + seed % 2).astype(np.uint8)
    got = native.unpack_bits(packed, bits, n)
    np.testing.assert_array_equal(got, engine.unpack_bits(packed, bits, n))
    np.testing.assert_array_equal(got, jnative.unpack_bits(packed, bits, n))
    with pytest.raises(ValueError):
        native.unpack_bits(packed, 3, n)


def test_native_source_is_the_packages_own(monkeypatch, tmp_path):
    """The build compiles ``hostops.cc`` beside ``native/__init__.py``,
    which the package data ships; ``enable_compilation_cache`` moves
    both build directories, and a later build lands there."""
    pkg_dir = Path(native.__file__).resolve().parent
    assert native.SRC == pkg_dir / "hostops.cc" and native.SRC.exists()
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert data["ukbb_cardiac_tpu_torch.native"] == ["hostops.cc"]
    assert data["ukbb_cardiac_tpu_torch.assoc"] == [
        "data/*.csv", "data/*.tsv", "data/*.txt"]

    commands = []

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kwargs):
        commands.append(cmd)
        Path(cmd[-1]).write_bytes(b"")
        return Done()

    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    assert enable_compilation_cache() is True
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert kernels.BUILD_DIR == ROOT / "build" / "kernels"
    assert enable_compilation_cache(str(tmp_path)) is True
    assert native.BUILD_DIR == kernels.BUILD_DIR == tmp_path
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    out = native.build()
    assert out.parent == tmp_path and out.exists()
    assert commands and commands[0][-3] == str(pkg_dir / "hostops.cc")
    assert os.path.basename(out).startswith("libhostops-")
