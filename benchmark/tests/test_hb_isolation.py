"""A run loads neither JAX nor the JAX package, and the reference loads
nothing of the program.  Each check imports in a fresh interpreter and
compares top-level module names whole."""

import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

from benchmark.harness.guard import forbidden_loaded


def _loaded(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _modules(pattern: str) -> list:
    return sorted(os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
                  for p in glob.glob(os.path.join(ROOT, pattern),
                                     recursive=True)
                  if "__pycache__" not in p)


def test_the_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["ukbb_cardiac_tpu_torch.io", "jaxtyping",
                             "numpy"]) == []
    assert forbidden_loaded(["jax.numpy", "ukbb_cardiac_tpu.io",
                             "flax"]) == ["flax", "jax.numpy",
                                          "ukbb_cardiac_tpu.io"]


def test_run_drivers_metrics_and_counts_load_no_jax():
    mods = _modules("benchmark/drivers/*.py") + _modules(
        "benchmark/counts/*.py") + _modules("benchmark/harness/*.py")
    code = "import runpy, importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in mods)
    code += ("runpy.run_path('benchmark/run.py', run_name='not_main')\n"
             "from benchmark.harness import spec\n"
             "for m in spec.load_spec()['end_to_end'] + "
             "spec.load_spec()['per_layer']:\n"
             "    spec.reader(m['name'])\n"
             "import ukbb_cardiac_tpu_torch.parallel.cohort\n"
             "import ukbb_cardiac_tpu_torch.infer.deploy_ao\n")
    assert forbidden_loaded(_loaded(code)) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("benchmark/reference/**/*.py")
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in mods)
    loaded = _loaded(code)
    assert forbidden_loaded(loaded) == []
    assert [m for m in loaded
            if m.split(".")[0] == "ukbb_cardiac_tpu_torch"] == []


def test_no_card_no_result(tmp_path):
    """Without a card the run exits with another code than 0 and prints
    nothing on standard output (it never falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present; the run would measure")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "unet_lstm_ao.cohort_ao", "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
