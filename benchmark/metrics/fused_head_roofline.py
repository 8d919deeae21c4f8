"""The FCN head's least time for the window's slices
(``counts/head_bound.py``, one count per cine) over the device time of
the kernels that compute it (``csrc/fused_head.cu``)."""
UNIT, SOURCE, BETTER = "%", "device_trace", "higher"
LAYER, MOVES = "kernel fused_head", "subjects_per_s"
KERNELS = ("coarse_kernel", "head_kernel")


def read(run):
    from benchmark.counts.cohort_work import head_seconds
    if run.trace is None or run.config.get("model") != "fcn":
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    bound = sum(head_seconds(run.config, p.outputs["shape"])
                for p in run.record["passes"] if p.ok)
    return 100.0 * bound / seconds
