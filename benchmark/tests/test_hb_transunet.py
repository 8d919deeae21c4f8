"""The TransUNet deploy cell: the FLOP count against a sum by hand, the
new readers on traces that lack what they read, every cell's readers on
a run of a program older than them, and whole runs on the CPU at small
sizes (the program against the plain reference; a broken answer and the
bfloat16 path fail)."""

import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.counts.transunet_flops import (attention_bound, parts,
                                              transunet_forward_flops)
from benchmark.harness import runner, spec
from benchmark.harness.cohort import Pass
from benchmark.harness.trace import Trace
from conftest import ROOT

NEW = ("mfu.deploy", "attention_roofline.deploy", "idle_share.deploy")


def _net():
    return spec.cell(spec.load_spec(ROOT), "transunet_sa.deploy_sa",
                     ROOT).config["network"]


def test_transunet_flops_equal_a_sum_by_hand():
    """Multiply-adds of one 224^2 slice at published widths, term by
    term (conv: output pixels x taps x in x out)."""
    r50 = (112 * 112 * 49 * 3 * 64                              # stem
           # block1 at 55^2: unit1 with its projection, then two units
           + 3025 * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
           + 2 * 3025 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
           # block2: the 3x3/2 to 28^2 on unit1
           + 3025 * 256 * 128 + 784 * (9 * 128 * 128 + 128 * 512
                                       + 256 * 512)
           + 3 * 784 * (512 * 128 + 9 * 128 * 128 + 128 * 512)
           # block3: to 14^2
           + 784 * 512 * 256 + 196 * (9 * 256 * 256 + 256 * 1024
                                      + 512 * 1024)
           + 8 * 196 * (1024 * 256 + 9 * 256 * 256 + 256 * 1024))
    embed = 196 * 1024 * 768
    attn = 12 * 2 * 196 * 196 * 768
    encoder = 12 * (4 * 196 * 768 * 768 + 2 * 196 * 768 * 3072) + attn
    decoder = (196 * 9 * 768 * 512
               + 784 * 9 * (1024 * 256 + 256 * 256)
               + 3136 * 9 * (512 * 128 + 128 * 128)
               + 12544 * 9 * (192 * 64 + 64 * 64)
               + 50176 * 9 * (64 * 16 + 16 * 16)
               + 50176 * 9 * 16 * 4)
    assert r50 == 3_905_716_224 and decoder == 7_774_470_144
    net = _net()
    assert parts(net) == {"r50": r50, "embedding": embed, "encoder": encoder,
                          "attention": attn, "decoder": decoder}
    assert transunet_forward_flops(net) == 2 * (r50 + embed + encoder
                                                + decoder)
    assert transunet_forward_flops(net) == pytest.approx(58.38e9, rel=1e-4)
    seconds, by = attention_bound(net)
    assert by == "operations"
    assert seconds == pytest.approx(2 * attn / 67e12)


def _pass(shape, **outputs):
    return Pass(k=0, name="3000000", phantom=0, ok=True, error=None,
                stages={"segment": 1.0, "strain": 0.5, "aortic": 0.5,
                        "deploy": 1.0}, t_end=1.0,
                outputs=dict(outputs, shape=tuple(shape)))


def _parent_kind_run(cell, trace):
    """A run record of the cell's kind, with the outputs its driver
    records, and ``trace``."""
    shape = cell.traffic["shapes"][0]
    extra = {"cohort_sa": {"volumes": {}, "strain_image": (128, 128)},
             "cohort_ao": {"areas": None}}.get(cell.traffic["driver"], {})
    passes = [_pass(shape, **extra), _pass(shape, **extra)]
    return SimpleNamespace(record={"passes": passes, "window_s": 2.0,
                                   "attempted": 2, "failed": 0},
                           config=cell.config, traffic=cell.traffic,
                           setup_s=1.0, peak_reserved_bytes=2 ** 30,
                           trace=trace)


def _parent_trace():
    """A trace with the kernels and spans a program older than this
    cell's metrics gives: convolution kernels, the head's and the
    B-spline's, the engine's and the I/O spans; no attention kernel and
    no ``ukbb.ckpt.load``."""
    dev = [(10, 20, "sm80_xmma_fprop_implicit_gemm_f32f32"),
           (25, 30, "head_kernel"), (30, 32, "coarse_kernel"),
           (40, 45, "field_kernel"), (45, 50, "adjoint_kernel"),
           (60, 70, "elementwise_kernel")]
    host = [(0, 95, "ukbb.subject"), (0, 50, "ukbb.stage.segment"),
            (5, 9, "ukbb.io.nifti.load"), (32, 40, "ukbb.program.replay"),
            (50, 60, "ukbb.phenotype.strain.tables"),
            (0, 100, "bench:subject")]
    return Trace(dev, host, (0, 100))


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_spec(ROOT)["workloads"]])
@pytest.mark.parametrize("trace", ["parent", "empty", "none"])
def test_every_reader_gives_a_number_or_none_on_a_parent_run(name, trace):
    """For every cell, every metric it reports reads a number or None,
    and never raises, on a record and trace of the parent's kind (no
    new span, no new kernel); the result line then leaves the metric
    out."""
    cell = spec.cell(spec.load_spec(ROOT), name, ROOT)
    tr = {"parent": _parent_trace(), "empty": Trace([], [], (0, 100)),
          "none": None}[trace]
    run = _parent_kind_run(cell, tr)
    for m in cell.end_to_end + cell.per_layer:
        value = spec.reader(m["name"]).read(run)
        assert value is None or np.isfinite(float(value)), m["name"]


def test_new_readers_read_none_without_what_they_read():
    deploy = spec.cell(spec.load_spec(ROOT), "transunet_sa.deploy_sa", ROOT)
    run = _parent_kind_run(deploy, _parent_trace())
    # no attention kernel in the trace
    assert spec.reader("attention_roofline.deploy").read(run) is None
    for name in NEW:
        assert spec.reader(name).read(
            _parent_kind_run(deploy, None)) is None, name
        assert spec.reader(name).read(_parent_kind_run(
            deploy, Trace([], [], (0, 0)))) is None, name
    # a configuration of another model: the TransUNet readers read none
    sa = spec.cell(spec.load_spec(ROOT), "fcn_sa.cohort_sa", ROOT)
    for name in ("mfu.deploy", "attention_roofline.deploy"):
        assert spec.reader(name).read(_parent_kind_run(
            sa, _parent_trace())) is None


def test_new_readers_on_a_trace_that_has_their_kernels():
    deploy = spec.cell(spec.load_spec(ROOT), "transunet_sa.deploy_sa", ROOT)
    dev = [(0, 50_000_000, "fmha_cutlassF_f32_aligned_64x64_rf_sm80"),
           (60_000_000, 80_000_000, "sm80_xmma_gemm_f32f32")]
    run = _parent_kind_run(deploy, Trace(dev, [], (0, 100_000_000)))
    # two (192, 208, 10, 50) cines: 500 slices each, run as 512
    bound = attention_bound(deploy.config["network"])[0]
    assert spec.reader("attention_roofline.deploy").read(run) == \
        pytest.approx(100 * 1024 * bound / 0.05)
    flops = 1000 * transunet_forward_flops(deploy.config["network"])
    assert spec.reader("mfu.deploy").read(run) == pytest.approx(
        100 * flops / (0.1 * 67e12))
    assert spec.reader("idle_share.deploy").read(run) == pytest.approx(30.0)


# --- whole runs on the CPU ------------------------------------------------

SMALL_NET = {"img_size": 64, "hidden_size": 64, "num_heads": 4,
             "mlp_dim": 128, "num_layers": 2, "resnet_units": [1, 1, 1]}
# limits of the small CPU cell, from CPU readings at the seed below: the
# program against the reference read label_mismatch 0 and prob_max_abs
# below 1e-6; the bfloat16 path reads far above both
CPU_LIMITS = {"label_mismatch": 1e-5, "prob_max_abs": 1e-4,
              "label_majority_share": 0.9}


def _small_deploy_cell():
    cell = spec.cell(spec.load_spec(ROOT), "transunet_sa.deploy_sa", ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.config["network"].update(SMALL_NET)
    cell.config["chunk"] = 16
    cell.traffic = dict(cell.traffic, shapes=[[48, 56, 3, 6], [40, 40, 2, 6]],
                        per_shape=1, geometry={"r_lv": 7.0, "wall": 3.0,
                                               "amp": 0.3, "noise": 0.05})
    cell.workload = dict(cell.workload, limits=CPU_LIMITS)
    return cell


def _run(cell, seed=2 ** 31 + 11, **kw):
    return runner.run_cell(cell, seed, 1.0, False, device="cpu", **kw)


def _failing(result):
    return {k for k, c in result["compared"].items()
            if not (isinstance(c["value"], float)
                    and c["value"] <= c["limit"])}


def test_deploy_cell_agrees_with_the_reference(cpu_threads):
    result = _run(_small_deploy_cell())
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"subjects_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert result["compared"]["prob_max_abs"]["value"] < 1e-5


def test_deploy_cell_bfloat16_path_fails(cpu_threads):
    result = _run(_small_deploy_cell(), low_precision=True)
    assert {"label_mismatch", "prob_max_abs"} <= _failing(result)


def test_deploy_cell_answer_altered_fails(monkeypatch, cpu_threads):
    from ukbb_cardiac_tpu_torch.infer import engine
    pack = engine._pack_cine

    @functools.wraps(pack)
    def bad(shape, pads, bits, preds, *rest):
        # a block at the grid's centre: the grid's edges are padding
        preds = preds.clone()
        preds[..., 28:36, 28:36] = (preds[..., 28:36, 28:36] + 1) % 4
        return pack(shape, pads, bits, preds, *rest)

    monkeypatch.setattr(engine, "_pack_cine", bad)
    assert "label_mismatch" in _failing(_run(_small_deploy_cell()))
