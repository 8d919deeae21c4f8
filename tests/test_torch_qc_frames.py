"""The aortic QC's one native pass over a cine's frames
(``native.count_significant_cc_frames`` over the stack that
``ops/cc.py::single_slice_frames`` lays out): its counts against
``count_significant_cc_scipy`` frame by frame, and its areas against
numpy's, over random label cines, fragments at the size threshold,
diagonal contacts under both connectivities, non-square frames, one
frame, C- and Fortran-ordered cines.  Imports no JAX: the port's own
plain version is the yardstick.
"""

import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu_torch.native import count_significant_cc_frames
from ukbb_cardiac_tpu_torch.ops.cc import (count_significant_cc_scipy,
                                           single_slice_frames)

torch.set_num_threads(1)


def _want(cine, label, pixel_thres, connectivity):
    return [count_significant_cc_scipy(cine[:, :, :, t] == label,
                                       pixel_thres, connectivity)
            for t in range(cine.shape[3])]


def _check(cine, pixel_thres, connectivity, labels=range(4)):
    frames = single_slice_frames(cine)
    for label in labels:
        got, areas = count_significant_cc_frames(frames, label,
                                                 pixel_thres, connectivity)
        assert got.dtype == np.int32 and got.shape == (cine.shape[3],)
        assert got.tolist() == _want(cine, label, pixel_thres,
                                     connectivity), label
        assert areas.dtype == np.int64
        assert areas.tolist() == np.sum(cine == label,
                                        axis=(0, 1, 2)).tolist(), label


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("shape", [(24, 24, 1, 6), (31, 17, 1, 5),
                                   (17, 40, 1, 1)])
@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_random_cines_match_scipy(order, shape, density, connectivity):
    rng = np.random.RandomState(sum(shape) + connectivity)
    if density == "dense":
        cine = rng.randint(0, 4, shape)
    else:  # mostly background: small scattered fragments
        cine = np.where(rng.rand(*shape) < 0.15, rng.randint(1, 4, shape), 0)
    cine = np.asarray(cine, np.int16, order=order)
    for pixel_thres in (0, 3, 10):
        _check(cine, pixel_thres, connectivity)


@pytest.mark.parametrize("pixel_thres", [5, 10])
@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_fragment_at_the_threshold(pixel_thres, extra, connectivity):
    """A fragment of exactly ``pixel_thres`` pixels does not count; one
    of ``pixel_thres + 1`` does.  The fragment is an L over two rows, so
    its runs are joined across rows."""
    n = pixel_thres + extra
    cine = np.zeros((20, 30, 1, 3), np.int16, order="F")
    cine[2:14, 2:14, 0, :] = 1                      # one large component
    cine[16, 18:18 + n - 1, 0, 1] = 1               # the L's bar
    cine[17, 18, 0, 1] = 1                          # and its foot
    got, areas = count_significant_cc_frames(single_slice_frames(cine), 1,
                                             pixel_thres, connectivity)
    assert got.tolist() == [1, 1 + extra, 1]
    assert areas.tolist() == [144, 144 + n, 144]
    _check(cine, pixel_thres, connectivity, labels=[0, 1])


@pytest.mark.parametrize("connectivity", [1, 2])
def test_diagonal_contacts(connectivity):
    """Blocks that touch only at a corner, both ways and in a chain:
    8-connectivity joins them, 4-connectivity does not."""
    cine = np.zeros((16, 16, 1, 2), np.int16, order="F")
    cine[1:5, 1:5, 0, 0] = 2
    cine[5:9, 5:9, 0, 0] = 2                        # down and right
    cine[9:13, 1:5, 0, 0] = 2                       # down and left
    cine[1:5, 9:13, 0, 1] = 2
    cine[5:9, 5:9, 0, 1] = 2                        # down and left
    cine[9:13, 9:13, 0, 1] = 2                      # down and right
    got, _ = count_significant_cc_frames(single_slice_frames(cine), 2, 10,
                                         connectivity)
    assert got.tolist() == ([3, 3] if connectivity == 1 else [1, 1])
    _check(cine, 10, connectivity, labels=[0, 2])


@pytest.mark.parametrize("order", ["C", "F"])
def test_frames_of_a_cine_are_read_in_place_when_fortran(order):
    cine = np.asarray(np.random.RandomState(1).randint(0, 3, (9, 7, 1, 4)),
                      np.int16, order=order)
    frames = single_slice_frames(cine)
    assert frames.shape == (4, 7, 9)
    assert frames.flags.c_contiguous == (order == "F")
    assert np.shares_memory(frames, cine)
    for t in range(4):
        np.testing.assert_array_equal(frames[t], cine[:, :, 0, t].T)


@pytest.mark.parametrize("bad", [np.zeros((3, 4, 5), np.uint8),
                                 np.zeros((3, 4, 5), np.int32),
                                 np.zeros((4, 5), np.int16)])
def test_native_pass_takes_int16_stacks_only(bad):
    with pytest.raises(ValueError, match="int16"):
        count_significant_cc_frames(bad, 1)


def test_native_pass_refuses_a_label_beyond_int16():
    with pytest.raises(ValueError, match="int16 range"):
        count_significant_cc_frames(np.zeros((2, 3, 4), np.int16), 1 << 16)
