"""The reduction of a traced window: busy time is the union of device
intervals, idle gaps are what is left, each named by the innermost
benchmark span over its middle, annotations are no work."""

from benchmark.harness.trace import Trace


def test_busy_idle_and_labels():
    dev = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "head_kernel")]
    host = [(0, 100, "bench:subject"), (30, 50, "bench:strain.queue"),
            (60, 100, "aten::copy_")]
    t = Trace(dev, host, (0, 100))
    assert t.busy == [(10, 30), (50, 60)]
    assert abs(t.busy_s - 30e-9) < 1e-18
    gaps = t.idle_gaps()
    assert [g[0] for g in gaps] == ["subject", "strain.queue", "subject"]
    assert [round(g[1] * 1e9) for g in gaps] == [40, 20, 10]
    assert t.kernel_seconds(["head_kernel"]) == (10e-9, 1)
    assert t.top_ops(1)[0][0] == "k2"
