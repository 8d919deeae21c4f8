"""The segmentation networks' forward FLOPs over the traced window's
cines (``counts/cohort_work.py``, from widths and shapes) over the
window's seconds times the card's float32 peak."""
UNIT, SOURCE, BETTER = "%", "device_trace", "higher"
LAYER, MOVES = "model", "subjects_per_s"


def read(run):
    from benchmark.counts import peaks
    from benchmark.counts.cohort_work import forward_flops
    if run.trace is None or not run.record.get("passes"):
        return None
    flops = sum(forward_flops(run.config, p.outputs["shape"])
                for p in run.record["passes"] if p.ok)
    return 100.0 * flops / (run.trace.window_s * peaks()["float32_flops"])
