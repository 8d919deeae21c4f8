"""The traffic generator: the same seed gives the same inputs, another
seed other inputs, every seed the same shapes."""

import os

import numpy as np

from benchmark.harness import phantoms
from benchmark.harness.cohort import Cohort
from benchmark.reference.port.io import nifti
from conftest import small_cell


def _inputs(cell, seed, tmp):
    c = Cohort(cell.traffic, seed, str(tmp))
    c.write_inputs()
    return c, [np.asarray(nifti.load(c.input_path(p)).dataobj)
               for p in range(len(c.phantoms))]


def test_equal_seeds_equal_inputs_other_seeds_other(tmp_path):
    for name in ("fcn_sa.cohort_sa", "unet_lstm_ao.cohort_ao"):
        cell = small_cell(name)
        big = 2 ** 31 + 12345
        c1, a = _inputs(cell, big, tmp_path / name / "a")
        c2, b = _inputs(cell, big, tmp_path / name / "b")
        c3, c = _inputs(cell, big + 1, tmp_path / name / "c")
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert c1.order == c2.order
        assert not any(np.array_equal(x, y) for x, y in zip(a, c))
        assert [x.shape for x in a] == [x.shape for x in c]
        assert sorted(c1.order) == sorted(c3.order)


def _disk(X, Y, cx, cy, r):
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    return ((xx - cx) ** 2 + (yy - cy) ** 2) <= r * r


def test_sa_phantom_geometry_is_the_frame_by_frame_one():
    X, Y, Z, T, r_lv, wall, amp = 100, 120, 2, 12, 20.0, 7.0, 0.3
    _, seg = phantoms.sax_phantom(X, Y, Z, T, r_lv, wall, amp, 0.05,
                                  np.random.default_rng(0))
    cx, cy = X // 2, Y // 2
    scale = 1.0 - amp * np.sin(np.pi * np.arange(T) / float(T)) ** 2
    for t in range(T):
        r = r_lv * scale[t]
        R = r + wall
        lv = _disk(X, Y, cx, cy, r)
        epi = _disk(X, Y, cx, cy, R)
        rv = _disk(X, Y, cx - (R + 4), cy, r * 0.9 + 3) & ~epi
        sl = np.zeros((X, Y), np.int16)
        sl[rv], sl[epi & ~lv], sl[lv] = 3, 2, 1
        for z in range(Z):
            assert np.array_equal(seg[:, :, z, t], sl)


def test_pressures_and_sample_follow_the_seed(tmp_path):
    cell = small_cell("unet_lstm_ao.cohort_ao")
    a = Cohort(cell.traffic, 5, str(tmp_path / "a"))
    b = Cohort(cell.traffic, 5, str(tmp_path / "b"))
    assert np.array_equal(a.pressures, b.pressures)
    assert all(30.0 <= p <= 70.0 for p in a.pressures)
    assert os.path.isdir(a.inputs)
