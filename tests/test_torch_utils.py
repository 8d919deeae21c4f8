"""``utils/timing.py`` (``StageTimer``, ``device_trace``) and
``ckpt/fingerprint.py`` against the JAX package's.

``StageTimer`` keeps a span stack per thread and shared records: driven
from several threads its span names never interleave, and its summary
has the JAX timer's names and counts for the same spans.  ``device_trace``
is ``torch.profiler`` here: on the CPU it writes one Chrome trace JSON
naming the ops run inside it, does nothing without a directory, warns and
runs the body untraced when the profiler cannot start, and stops the
profiler when the body raises.  Fingerprint JSONs are byte-identical to
the JAX package's, and the committed goldens diff clean against the
port's.
"""

import glob
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch import profiler as torch_profiler

from ukbb_cardiac_tpu.ckpt import fingerprint as jfp
from ukbb_cardiac_tpu.utils.timing import StageTimer as JaxStageTimer
from ukbb_cardiac_tpu_torch.ckpt import fingerprint as tfp
from ukbb_cardiac_tpu_torch.cli import verify_checkpoint as vc
from ukbb_cardiac_tpu_torch.utils.timing import StageTimer, device_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "bench_weights")
BUNDLES = ("FCN_sa", "FCN_la_2ch", "FCN_la_4ch", "FCN_la_4ch_seg4",
           "UNet-LSTM_ao")


def _drive(timer, n_threads=8, n_iter=20):
    barrier = threading.Barrier(n_threads)

    def work(k):
        barrier.wait(timeout=30)
        for _ in range(n_iter):
            with timer.span(f"subject{k % 2}"):
                with timer.span("segment"):
                    pass
                with timer.span("strain"):
                    timer.record("probe", 0.001)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)


def test_stage_timer_threads_match_jax():
    ours, theirs = StageTimer(), JaxStageTimer()
    _drive(ours)
    _drive(theirs)
    got, want = ours.summary(), theirs.summary()
    assert sorted(got) == sorted(want) == sorted([
        "subject0", "subject1", "subject0/segment", "subject1/segment",
        "subject0/strain", "subject1/strain", "probe"])
    for name in want:
        assert got[name]["count"] == want[name]["count"]
    assert got["subject0/segment"]["count"] == 4 * 20
    assert got["probe"]["count"] == 8 * 20
    assert got["probe"]["total_s"] == pytest.approx(0.16)


def test_stage_timer_dump_and_report(tmp_path):
    timer = StageTimer()
    timer.record("read", 0.5)
    timer.record("read", 1.5)
    path = str(tmp_path / "t.json")
    timer.dump(path)
    assert json.load(open(path)) == {"read": {
        "count": 2, "total_s": 2.0, "mean_s": 1.0, "max_s": 1.5}}
    assert timer.report() == ("read: n=2 total=2.000s mean=1.000s "
                              "max=1.500s")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with device_trace(log_dir):
        torch.mm(x, x)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "aten::mm" in names
    with device_trace(""):        # no directory: nothing traced
        torch.mm(x, x)
    assert len(os.listdir(log_dir)) == 1


def test_device_trace_stops_on_error_and_warns(tmp_path, capsys,
                                               monkeypatch):
    log_dir = str(tmp_path / "err")
    with pytest.raises(RuntimeError, match="body"):
        with device_trace(log_dir):
            torch.ones(3).sum()
            raise RuntimeError("body")
    assert len(glob.glob(os.path.join(log_dir, "*.json"))) == 1
    # the profiler is off again: a new one starts
    with device_trace(str(tmp_path / "again")):
        pass

    class Broken:
        def __init__(self, **kwargs):
            pass

        def start(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch_profiler, "profile", Broken)
    ran = []
    with device_trace(str(tmp_path / "broken")):
        ran.append(1)
    assert ran == [1]
    assert "device trace unavailable (no profiler here)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("name", BUNDLES)
def test_fingerprints_equal_jax_and_goldens(tmp_path, name):
    bundle = os.path.join(WEIGHTS, f"{name}.npz")
    ours, theirs = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    tfp.write_fingerprint(bundle, ours)
    jfp.write_fingerprint(bundle, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    golden = os.path.join(WEIGHTS, "fingerprints", f"{name}.json")
    assert vc.main(["--fingerprint_diff", golden, ours]) == 0


def test_fingerprint_diff_names_the_changed_tensor(tmp_path, capsys):
    bundle = os.path.join(WEIGHTS, "FCN_la_2ch.npz")
    with np.load(bundle) as z:
        arrays = {k: z[k] for k in z.files}
    key = "params/conv2d/kernel"
    arrays[key] = arrays[key] + np.float32(1)
    changed = str(tmp_path / "changed.npz")
    np.savez(changed, **arrays)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    tfp.write_fingerprint(bundle, a)
    tfp.write_fingerprint(changed, b)
    assert vc.main(["--fingerprint_diff", a, b]) == 1
    d = json.loads(capsys.readouterr().out)
    assert d == {"missing": [], "extra": [], "changed": [key]}
    assert tfp.diff_fingerprints(tfp.fingerprint_bundle(bundle),
                                 jfp.fingerprint_bundle(changed)) == d


def test_resolve_prefix_forms(tmp_path):
    (tmp_path / "m.ckpt-5.meta").write_bytes(b"")
    (tmp_path / "m.ckpt-9.index").write_bytes(b"")
    (tmp_path / "m.ckpt-9.meta").write_bytes(b"")
    assert vc.resolve_prefix("x.npz") == "x.npz"
    assert vc.resolve_prefix(str(tmp_path)) == str(tmp_path / "m.ckpt-9")
    assert vc.resolve_prefix(str(tmp_path / "m.ckpt-5")) == str(
        tmp_path / "m.ckpt-5")
    with pytest.raises(FileNotFoundError):
        vc.resolve_prefix(str(tmp_path / "none"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no .meta"):
        vc.resolve_prefix(str(tmp_path / "empty"))
