"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository.  They run on the CPU at small sizes; a test
that needs the card is marked ``cuda`` and skips inside the test."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips inside the test without one")


# Small cells for the CPU: the real configurations and traffic at phantom
# sizes a test run can hold (noisier, so that a lower precision flips
# labels), and a registration of 2 levels x 10 steps.  The limits are
# set from CPU readings at the seed the tests use (PyTorch 2.13): the
# program against the reference read 0 on every number; its bfloat16 path
# read 4.6e-4 (SA labels), 0.17 pp (mean strain gap) and 5.4e-5 (aortic
# labels); the stage rows are exact on both paths.
CPU_LIMITS = {
    "fcn_sa.cohort_sa": {"label_mismatch": 1e-5, "volume_stage_rel": 0.0,
                         "strain_mean_pp": 0.02},
    "unet_lstm_ao.cohort_ao": {"label_mismatch": 1e-5, "area_stage_rel": 0.0},
}


def small_cell(name: str):
    from benchmark.harness import spec
    cell = spec.cell(spec.load_spec(ROOT), name, ROOT)
    cell.workload = dict(cell.workload, limits=CPU_LIMITS[name])
    if name == "fcn_sa.cohort_sa":
        cell.traffic = dict(cell.traffic,
                            shapes=[[96, 96, 8, 6], [96, 112, 8, 6]],
                            per_shape=1,
                            geometry={"r_lv": 15.0, "wall": 6.0, "amp": 0.3,
                                      "noise": 0.15})
        cell.config = copy.deepcopy(cell.config)
        cell.config["registration"].update(levels=2, iters=10)
    else:
        cell.traffic = dict(cell.traffic, shapes=[[96, 96, 1, 10]],
                            per_shape=3, sample=2,
                            geometry=dict(cell.traffic["geometry"],
                                          r_aa=18.0, r_da=12.0, noise=0.15))
    return cell


@pytest.fixture
def cpu_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)
