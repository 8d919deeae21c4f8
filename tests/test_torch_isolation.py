"""The port stands alone: no module of ``ukbb_cardiac_tpu_torch``, and not
``chip_smoke.py``, imports ``jax`` or the JAX package, nor ``tensorflow``
or ``matplotlib`` when it is imported (the checkpoint converter and the
Manhattan plot import them when called); and its entry points refuse to
run without a card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from ukbb_cardiac_tpu_torch import resolve_device

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    def banned(name):
        return (name == "jax" or name.startswith("jax.")
                or name == "ukbb_cardiac_tpu"
                or name.startswith("ukbb_cardiac_tpu."))

    for name in [m for m in sys.modules if banned(m)]:
        del sys.modules[name]

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if banned(name):
                raise ImportError("port imported " + name)
            return None

    sys.meta_path.insert(0, Block())
    import ukbb_cardiac_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    leaked = sorted(m for m in sys.modules if banned(m))
    assert not leaked, leaked
    lazy = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("tensorflow", "matplotlib"))
    assert not lazy, lazy
    print(" ".join(names))
""")

# the strain slice's modules, which the walk above must reach
SLICE_MODULES = {
    "ukbb_cardiac_tpu_torch.reg.bspline",
    "ukbb_cardiac_tpu_torch.reg.bspline_field",
    "ukbb_cardiac_tpu_torch.reg.register",
    "ukbb_cardiac_tpu_torch.phenotype.strain",
    "ukbb_cardiac_tpu_torch.phenotype.wall_thickness",
    "ukbb_cardiac_tpu_torch.cli.eval_strain_sax",
    "ukbb_cardiac_tpu_torch.cli.eval_wall_thickness",
    # the cohort slice's
    "ukbb_cardiac_tpu_torch.parallel",
    "ukbb_cardiac_tpu_torch.parallel.fleet",
    "ukbb_cardiac_tpu_torch.parallel.cohort",
    "ukbb_cardiac_tpu_torch.phenotype.atrium",
    "ukbb_cardiac_tpu_torch.phenotype.strain_la",
    "ukbb_cardiac_tpu_torch.cli.run_cohort",
    "ukbb_cardiac_tpu_torch.cli.eval_atrial_volume",
    "ukbb_cardiac_tpu_torch.cli.eval_strain_lax",
    # the aortic slice's
    "ukbb_cardiac_tpu_torch.models.unet",
    "ukbb_cardiac_tpu_torch.models.convlstm",
    "ukbb_cardiac_tpu_torch.models.wrappers",
    "ukbb_cardiac_tpu_torch.infer.deploy_ao",
    "ukbb_cardiac_tpu_torch.phenotype.aorta",
    "ukbb_cardiac_tpu_torch.cli.deploy_network_ao",
    "ukbb_cardiac_tpu_torch.cli.eval_aortic_area",
    # the training slice's
    "ukbb_cardiac_tpu_torch.models.losses",
    "ukbb_cardiac_tpu_torch.ops.augment",
    "ukbb_cardiac_tpu_torch.ops.metrics",
    "ukbb_cardiac_tpu_torch.ops.resample",
    "ukbb_cardiac_tpu_torch.train",
    "ukbb_cardiac_tpu_torch.train.steps",
    "ukbb_cardiac_tpu_torch.train.prefetch",
    "ukbb_cardiac_tpu_torch.train.device_pool",
    "ukbb_cardiac_tpu_torch.train.sa",
    "ukbb_cardiac_tpu_torch.cli.train_network",
    # the aortic trainer's and the propagation's
    "ukbb_cardiac_tpu_torch.ops.sequence",
    "ukbb_cardiac_tpu_torch.data",
    "ukbb_cardiac_tpu_torch.data.propagate_aortic",
    "ukbb_cardiac_tpu_torch.cli.propagate_aortic_annotation",
    "ukbb_cardiac_tpu_torch.train.ao",
    "ukbb_cardiac_tpu_torch.cli.train_network_ao",
    # the ingestion slice's
    "ukbb_cardiac_tpu_torch.native",
    "ukbb_cardiac_tpu_torch.data.dicom",
    "ukbb_cardiac_tpu_torch.data.jpegcodec",
    "ukbb_cardiac_tpu_torch.data.biobank",
    "ukbb_cardiac_tpu_torch.data.cvi42",
    "ukbb_cardiac_tpu_torch.data.prepare",
    "ukbb_cardiac_tpu_torch.data.download",
    "ukbb_cardiac_tpu_torch.cli.convert_data",
    "ukbb_cardiac_tpu_torch.cli.prepare_data",
    "ukbb_cardiac_tpu_torch.cli.download_data",
    # the ninth slice's
    "ukbb_cardiac_tpu_torch.assoc",
    "ukbb_cardiac_tpu_torch.assoc.fdr",
    "ukbb_cardiac_tpu_torch.assoc.phewas",
    "ukbb_cardiac_tpu_torch.cli.perform_phenome_wide_association",
    "ukbb_cardiac_tpu_torch.ckpt.tf_reader",
    "ukbb_cardiac_tpu_torch.ckpt.fingerprint",
    "ukbb_cardiac_tpu_torch.cli.verify_checkpoint",
    "ukbb_cardiac_tpu_torch.cli.demo_pipeline",
    "ukbb_cardiac_tpu_torch.utils",
    "ukbb_cardiac_tpu_torch.utils.timing",
    "ukbb_cardiac_tpu_torch.utils.cache",
    # the mesh slice's
    "ukbb_cardiac_tpu_torch.parallel.mesh",
    # data-parallel training's
    "ukbb_cardiac_tpu_torch.train.distributed",
}


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 77
    assert SLICE_MODULES <= walked, SLICE_MODULES - walked


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_resolve_device_cpu_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("cli,argv", [
    ("propagate_aortic_annotation", ["--data_dir", "{d}"]),
    ("train_network_ao", ["--dataset_dir", "{d}"]),
    ("train_network_ao", ["--dataset_dir", "{d}", "--model", "UNet-LSTM",
                          "--model_path", "{d}/unet.npz"]),
    ("train_network", ["--dataset_dir", "{d}"]),
    ("demo_pipeline", ["--data_dir", "{d}", "--model_dir", "{d}",
                       "--csv_dir", "{d}/1"]),
    ("verify_checkpoint", ["--model_path", "{d}/m.npz"]),
])
def test_cli_refuses_without_a_card(cli, argv, tmp_path, monkeypatch):
    """Without --device cpu the CLIs raise when no card is present, before
    they read or write anything."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"ukbb_cardiac_tpu_torch.cli.{cli}")
    (tmp_path / "1").mkdir()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([a.format(d=tmp_path) for a in argv])
    assert sorted(os.listdir(tmp_path)) == ["1"]
