"""The B-spline synthesis and adjoint's least time for every call the
window's registrations make (``counts/bspline_bounds.py``, from each
level's pairs, lattice and image) over the device time of the kernels
that compute them (``csrc/bspline_field.cu``)."""
UNIT, SOURCE, BETTER = "%", "device_trace", "higher"
LAYER, MOVES = "kernel bspline_field", "subjects_per_s"
KERNELS = ("field_kernel", "adjoint_kernel")


def read(run):
    from benchmark.counts.cohort_work import bspline_seconds
    if run.trace is None or "registration" not in run.config:
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    bound = sum(bspline_seconds(run.config, p.outputs["shape"][3],
                                p.outputs["strain_image"])
                for p in run.record["passes"]
                if p.ok and p.outputs.get("strain_image"))
    return 100.0 * bound / seconds
