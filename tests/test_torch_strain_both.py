"""The both-directions SA strain scheme (``inverse_consistent=False``),
``reg.invert_field`` and ``reg.make_register_pair`` against the JAX
package's, on the CPU.

Both directions: per slice the T-1 forward pairs and the T-1 backward
pairs (fr+1) % T → fr are registered (2(T-1) a slice, against T in the
default scheme), the backward chain composed, not inverted, and blended.
The pair layout and the field blending are exact copies (equal arrays;
combine within 1e-5 px, float32 in another summation order).  Strain
tables come out of Adam-optimised registrations, so they are held by
bounds set from the JAX package's own drift for this scheme under
1e-7-of-range input noise, measured on this phantom (96x96x8x6, the
config of ``tests/test_torch_strain.py``) over 12 noise seeds: per AHA
segment 0.28-2.58 percentage points, Global 0.018-0.104, warp-Dice
0.0024-0.0047.  The bounds are the larger of twice that drift and the
default scheme's (2.0 / 0.5): 5.2 pp per segment, 0.5 Global; warp-Dice
stays within 0.005.  Measured port vs JAX: 0.37 / 0.041 / 0.0032.  The
measurement is this file run as a script:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_strain_both.py \
        drift 12

and ``... full`` runs both schemes in both packages on ``chip_smoke.py``'s
full-size main-path subject.
"""

import dataclasses
from pathlib import Path as _Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ukbb_cardiac_tpu.io import nifti
from ukbb_cardiac_tpu.phenotype import strain as jstrain
from ukbb_cardiac_tpu.reg import RegConfig as JCfg
from ukbb_cardiac_tpu.reg import register as jr
from ukbb_cardiac_tpu_torch.phenotype import strain as tstrain
from ukbb_cardiac_tpu_torch.reg import register as tr

from phantom import write_subject
from test_torch_reg import _blob_pairs, _smooth_fields
from test_torch_strain import _fields, _write_ed

torch.set_num_threads(1)

CFG = JCfg(spacing=8, levels=2, iters=30, lr=0.5, be_weight=1e-2)
STRAIN_SEGMENT_ATOL = 5.2     # 2 x the JAX package's 2.58 pp drift
STRAIN_GLOBAL_ATOL = 0.5      # the default scheme's (2 x drift is 0.21)
DICE_ATOL = 0.005


def _tcfg(cfg):
    return tr.RegConfig(**dataclasses.asdict(cfg))


def test_invert_field_matches_jax():
    """Smooth fields of ``test_torch_reg.py``'s batched-inverse test
    (amplitude 1.5 px): the fixed-point inverse within 1e-5 px of the JAX
    package's, that test's bound (float32 bilinear sums in another order,
    ten iterations), and within 1e-6 px of the port's batched inverse of
    the same field."""
    for field in _smooth_fields(4, 24, 20, 1.5, 13):
        ref = np.asarray(jr.invert_field(jnp.asarray(field)))
        got = tr.invert_field(torch.from_numpy(field))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    batch = tr.invert_field_batch(torch.from_numpy(field)[None])[0]
    np.testing.assert_allclose(got.numpy(), batch.numpy(), atol=1e-6, rtol=0)
    # away from the zero-padded border, the field after its inverse is
    # near the identity
    resid = tr.compose_fields(torch.from_numpy(field), got)[3:-3, 3:-3]
    assert float(resid.abs().max()) < 0.05
    assert float(tr.invert_field(torch.from_numpy(field), iters=0).abs()
                 .max()) == 0.0


def test_make_register_pair_matches_jax():
    """B = 1 of the batched registration, on one blob pair (the bounds of
    ``test_torch_reg.py::test_register_batch_full_small_run``: 1e-3 px)."""
    tgt, src = _blob_pairs()
    ref = jr.make_register_pair((48, 48), CFG)(tgt[1], src[1])
    got = tr.make_register_pair((48, 48), _tcfg(CFG), device="cpu")(
        torch.from_numpy(tgt[1]), torch.from_numpy(src[1]))
    assert len(got) == CFG.levels
    for r, g in zip(ref, got):
        assert g.shape == np.asarray(r).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3,
                                   rtol=0)
    batch = tr.make_register_batch((48, 48), _tcfg(CFG), device="cpu")(
        tgt[1:2], src[1:2])
    for g, b in zip(got, batch):
        assert torch.equal(g, b[0])
    assert np.abs(tr.total_field(got, (48, 48), _tcfg(CFG)).numpy()).max() > 0.5


@pytest.mark.parametrize("inverse_consistent", [True, False])
def test_pair_layout_matches_jax(inverse_consistent):
    """The (targets, sources) that JAX's ``track_multi_slice_fields``
    hands its registration equal the port's ``pair_frames``: B = Z * T in
    the default scheme, Z * 2(T-1) in both directions."""
    Z, T, X, Y = 3, 6, 8, 9
    frames = np.random.RandomState(0).rand(Z, T, X, Y).astype(np.float32)
    seen = {}

    def capture(targets, sources):
        seen["t"], seen["s"] = np.asarray(targets), np.asarray(sources)
        raise StopIteration

    with pytest.raises(StopIteration):
        jstrain.track_multi_slice_fields(
            frames, CFG, register_batch=capture,
            inverse_consistent=inverse_consistent)
    targets, sources = tstrain.pair_frames(frames, inverse_consistent)
    assert targets.shape[0] == Z * (T if inverse_consistent else 2 * (T - 1))
    np.testing.assert_array_equal(targets, seen["t"])
    np.testing.assert_array_equal(sources, seen["s"])


def test_combine_fields_both_directions_matches_jax():
    Z, T, X, Y = 2, 5, 20, 24
    fields = _fields((Z * 2 * (T - 1), X, Y), 1.5, 3)
    _, combine = jstrain._field_programs(Z, T, X, Y, CFG, False)
    ref = np.asarray(combine(jnp.asarray(fields)))
    got = tstrain.combine_fields(torch.from_numpy(fields), Z, T,
                                 inverse_consistent=False).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert not got[:, 0].any()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    subj = tmp_path_factory.mktemp("both") / "1000001"
    write_subject(str(subj), seqs=("sa",), X=96, Y=96, Z=8, T=6,
                  with_seg=True)
    _write_ed(subj)
    root = tmp_path_factory.mktemp("both_runs")
    out = {}
    for tag, fn, cfg, kw in (
            ("jax", jstrain.cine_2d_sa_motion_and_strain_analysis, CFG, {}),
            ("port", tstrain.cine_2d_sa_motion_and_strain_analysis,
             _tcfg(CFG), {"device": "cpu"})):
        motion = root / tag
        motion.mkdir()
        stem = root / f"{tag}_strain"
        df = fn(str(subj), str(motion), str(stem), cfg, eval_dice=True,
                inverse_consistent=False, **kw)
        out[tag] = {"dice": df.values, "stem": stem}
    return out


@pytest.mark.parametrize("kind", ["radial", "circum"])
def test_both_directions_strain_within_bound(runs, kind):
    ref = pd.read_csv(f"{runs['jax']['stem']}_{kind}.csv", index_col=0)
    got = pd.read_csv(f"{runs['port']['stem']}_{kind}.csv", index_col=0)
    assert list(got.index) == list(ref.index)
    np.testing.assert_array_equal(got.columns, ref.columns)
    diff = np.abs(got.values - ref.values)
    assert np.array_equal(np.isnan(got.values), np.isnan(ref.values))
    assert np.nanmax(diff) <= STRAIN_SEGMENT_ATOL, np.nanmax(diff)
    assert diff[-1].max() <= STRAIN_GLOBAL_ATOL, diff[-1]


def test_both_directions_warp_dice_within_bound(runs):
    np.testing.assert_allclose(runs["port"]["dice"], runs["jax"]["dice"],
                               atol=DICE_ATOL, rtol=0)
    assert runs["port"]["dice"].min() > 0.5


# --- the measurements behind the bounds above ------------------------------

def _strain_globals(stem):
    tabs = {k: pd.read_csv(f"{stem}_{k}.csv", index_col=0)
            for k in ("radial", "circum")}
    return tabs, tabs["circum"].loc["Global"].min(), \
        tabs["radial"].loc["Global"].max()


def measure_jax_drift(root, n_seeds):
    """The JAX package's both-directions strain on this file's phantom,
    clean and with 1e-7-of-range Gaussian noise on the cine (seeds 1 ..
    n_seeds): per seed the largest per-segment and Global differences
    and the warp-Dice difference; then the port's against the clean
    run."""
    import os
    import shutil

    subj = os.path.join(root, "1000001")
    write_subject(subj, seqs=("sa",), X=96, Y=96, Z=8, T=6, with_seg=True)
    _write_ed(_Path(subj))

    def run(tag, d, fn, cfg, **kw):
        motion = os.path.join(root, tag)
        os.makedirs(motion)
        df = fn(d, motion, os.path.join(root, f"{tag}_strain"), cfg,
                eval_dice=True, inverse_consistent=False, **kw)
        return _strain_globals(os.path.join(root, f"{tag}_strain"))[0], \
            df.values

    def diff(a, b):
        return (max(np.nanmax(np.abs(a[0][k].values - b[0][k].values))
                    for k in a[0]),
                max(np.abs(a[0][k].loc["Global"].values
                           - b[0][k].loc["Global"].values).max()
                    for k in a[0]),
                float(np.abs(a[1] - b[1]).max()))

    ref = run("jax", subj, jstrain.cine_2d_sa_motion_and_strain_analysis,
              CFG)
    sa = nifti.load(os.path.join(subj, "sa.nii.gz"))
    data = np.asanyarray(sa.dataobj).astype(np.float32)
    scale = 1e-7 * float(data.max() - data.min())
    for seed in range(1, n_seeds + 1):
        d = os.path.join(root, f"noisy{seed}")
        shutil.copytree(subj, d)
        noise = np.random.RandomState(seed).randn(*data.shape)
        nifti.save(nifti.Nifti1Image(
            data + (noise * scale).astype(np.float32), sa.affine,
            sa.header), os.path.join(d, "sa.nii.gz"))
        got = run(f"noisy{seed}_run", d,
                  jstrain.cine_2d_sa_motion_and_strain_analysis, CFG)
        print(f"JAX drift, seed {seed}: per segment %.4f pp, Global %.4f "
              "pp, warp-Dice %.4f" % diff(ref, got), flush=True)
    port = run("port", subj, tstrain.cine_2d_sa_motion_and_strain_analysis,
               _tcfg(CFG), device="cpu")
    print("port against JAX: per segment %.4f pp, Global %.4f pp, "
          "warp-Dice %.4f" % diff(ref, port))


def measure_full_size(root):
    """``chip_smoke.py``'s first main-path subject ((192, 208, 10, 50),
    deployed by the port on the CPU): Global Ecc (min) and Err (max) of
    both schemes in both packages, on the CPU."""
    import os

    import chip_smoke
    from ukbb_cardiac_tpu_torch.infer.deploy import deploy_dataset
    from ukbb_cardiac_tpu_torch.io import nifti as tnifti

    chip_smoke.N_SUBJECTS = 1
    chip_smoke.write_subjects(root, tnifti)
    deploy_dataset(chip_smoke.BUNDLE, root, device="cpu")
    subj = os.path.join(root, "1000000")
    for tag, fn, cfg, kw in (
            ("JAX", jstrain.cine_2d_sa_motion_and_strain_analysis,
             JCfg.cine_2d_motion(), {}),
            ("port", tstrain.cine_2d_sa_motion_and_strain_analysis,
             tr.RegConfig.cine_2d_motion(), {"device": "cpu"})):
        for ic in (True, False):
            stem = os.path.join(root, f"{tag}_{ic}")
            os.makedirs(stem + "_motion")
            df = fn(subj, stem + "_motion", stem, cfg, eval_dice=True,
                    inverse_consistent=ic, **kw)
            _, ecc, err = _strain_globals(stem)
            print(f"{tag}, inverse_consistent={ic}: Global Ecc {ecc:.4f} %, "
                  f"Err {err:.4f} %, warp-Dice LV/Myo "
                  f"{df.values.mean(axis=0).round(4).tolist()}", flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_strain_both.py
    #     drift 12 | full
    import sys
    import tempfile

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        if sys.argv[1] == "drift":
            measure_jax_drift(tmp, int(sys.argv[2]))
        else:
            measure_full_size(tmp)
