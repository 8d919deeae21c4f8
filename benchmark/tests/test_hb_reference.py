"""A whole run on the CPU at a small size, with the harness's look for a
card skipped: the program and the plain reference agree, and the run
comes out as not correct when the program runs its own bfloat16 path or
when its timed path is broken underneath (an answer altered where it is
produced: labels, the volume row, the area row; half of a batch left
out: the registration's pairs, the aortic frames)."""

import functools

import pytest
import torch

from benchmark.harness import runner
from conftest import small_cell

CELLS = ("fcn_sa.cohort_sa", "unet_lstm_ao.cohort_ao")


def _run(name, seed=2 ** 31 + 3, **kw):
    return runner.run_cell(small_cell(name), seed, 1.0, False, device="cpu",
                           **kw)


def _failing(result):
    return {k for k, c in result["compared"].items()
            if not (isinstance(c["value"], float)
                    and c["value"] <= c["limit"])}


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name, cpu_threads):
    result = _run(name)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"subjects_per_s", "peak_mem_gib",
                                      "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_programs_bfloat16_path_fails(name, cpu_threads):
    result = _run(name, low_precision=True)
    assert not result["correct"]
    assert "label_mismatch" in _failing(result)


def _flip_labels(pack):
    """The engine's pack with a block of labels changed first."""
    @functools.wraps(pack)
    def bad(shape, pads, bits, preds, *rest):
        preds = preds.clone()
        preds[..., :8, :8] = (preds[..., :8, :8] + 1) % 3
        return pack(shape, pads, bits, preds, *rest)
    return bad


def test_sa_answer_altered_fails(monkeypatch, cpu_threads):
    from ukbb_cardiac_tpu_torch.infer import engine
    monkeypatch.setattr(engine, "_pack_cine", _flip_labels(engine._pack_cine))
    assert "label_mismatch" in _failing(_run("fcn_sa.cohort_sa"))


def test_sa_half_the_registration_batch_left_out_fails(monkeypatch,
                                                       cpu_threads):
    from ukbb_cardiac_tpu_torch.phenotype import strain
    make = strain.make_register_batch

    def half(*args, **kwargs):
        register = make(*args, **kwargs)

        def run(targets, sources):
            n = targets.shape[0] // 2
            done = register(targets[:n], sources[:n])
            return tuple(torch.cat([c, torch.zeros_like(c)])[:targets.shape[0]]
                         for c in done)
        return run

    monkeypatch.setattr(strain, "make_register_batch", half)
    assert "strain_mean_pp" in _failing(_run("fcn_sa.cohort_sa"))


def test_ao_answer_altered_fails(monkeypatch, cpu_threads):
    from ukbb_cardiac_tpu_torch.infer import deploy_ao
    pack = deploy_ao._subject_pack

    def bad(shape, pads, bits, prob):
        prob = prob.clone()             # (Z, T, n_class, X', Y')
        x, y = prob.shape[3] // 2, prob.shape[4] // 2
        prob[:, :, 1, x - 4:x + 4, y - 4:y + 4] = 2.0
        return pack(shape, pads, bits, prob)

    monkeypatch.setattr(deploy_ao, "_subject_pack", bad)
    assert "label_mismatch" in _failing(_run("unet_lstm_ao.cohort_ao"))


def test_ao_half_the_frames_left_out_fails(monkeypatch, cpu_threads):
    from ukbb_cardiac_tpu_torch.infer import deploy_ao
    full = deploy_ao._sequence_prob

    def half(kind, net, dtype, seq):
        T = seq.shape[1]
        (prob,) = full(kind, net, dtype, seq[:, :T // 2])
        return (torch.cat([prob, prob[:, -1:].expand(
            -1, T - T // 2, -1, -1, -1)], dim=1),)

    monkeypatch.setattr(deploy_ao, "_sequence_prob", half)
    assert "label_mismatch" in _failing(_run("unet_lstm_ao.cohort_ao"))


def test_sa_volume_row_altered_fails(monkeypatch, cpu_threads):
    from ukbb_cardiac_tpu_torch.phenotype import ventricle
    measure = ventricle.ventricular_volume_measures_from_seg

    def bad(seg, header):
        row = measure(seg, header)
        row["LVEDV"] *= 1.01
        return row

    monkeypatch.setattr(ventricle, "ventricular_volume_measures_from_seg",
                        bad)
    assert "volume_stage_rel" in _failing(_run("fcn_sa.cohort_sa"))


def test_ao_area_row_altered_fails(monkeypatch, cpu_threads):
    from ukbb_cardiac_tpu_torch.phenotype import aorta
    measure = aorta.aortic_area_measures

    def bad(data_dir, pp):
        val = measure(data_dir, pp)
        val["DAo"]["min area"] *= 1.01
        return val

    monkeypatch.setattr(aorta, "aortic_area_measures", bad)
    assert "area_stage_rel" in _failing(_run("unet_lstm_ao.cohort_ao"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_on_the_card(name, tmp_path):
    """The control (``benchmark/control.py``: the reference with TF32 on,
    in the program's place) at the cell's own sizes and limits, on two
    of its shapes (SA) or phantoms (aortic).  The full runs and their
    readings are in PERF.md."""
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card")
    from benchmark.control import control_numbers
    from benchmark.harness import spec
    from conftest import ROOT
    cell = spec.cell(spec.load_spec(ROOT), name, ROOT)
    if name == "fcn_sa.cohort_sa":
        cell.traffic = dict(cell.traffic, shapes=cell.traffic["shapes"][:2],
                            per_shape=1)
    else:
        cell.traffic = dict(cell.traffic, per_shape=2, sample=2)
    got = control_numbers(cell, 11, "cuda", str(tmp_path))
    limits = cell.workload["limits"]
    assert any(not got[k] <= lim for k, lim in limits.items())
