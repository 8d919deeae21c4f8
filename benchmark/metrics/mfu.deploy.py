"""TransUNet's forward FLOPs over the traced window's slices
(``counts/transunet_flops.py``, from widths and the fixed grid; each
completed subject's T x Z slices, not the chunks' pad slices) over the
window's seconds times the card's float32 peak."""
UNIT, SOURCE, BETTER = "%", "device_trace", "higher"
LAYER, MOVES = "model", "subjects_per_s"


def read(run):
    from benchmark.counts import peaks
    from benchmark.counts.transunet_flops import transunet_forward_flops
    if run.trace is None or run.config.get("model") != "transunet" \
            or not run.record.get("passes") or run.trace.window_s <= 0:
        return None
    slices = sum(p.outputs["shape"][2] * p.outputs["shape"][3]
                 for p in run.record["passes"] if p.ok)
    flops = slices * transunet_forward_flops(run.config["network"])
    return 100.0 * flops / (run.trace.window_s * peaks()["float32_flops"])
