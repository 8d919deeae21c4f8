"""The ViT attention's least time for the window's slices
(``counts/transunet_flops.py::attention_bound``: Q K^T and the
probabilities times V of 12 layers x 12 heads over the float32 peak,
against Q, K, V and O over the memory rate), over the device time of the
fused attention kernels that ``F.scaled_dot_product_attention`` runs.
Each cine's slices are counted as the engine runs them: padded up to
whole chunks."""
UNIT, SOURCE, BETTER = "%", "device_trace", "higher"
LAYER, MOVES = "kernel attention", "subjects_per_s"
KERNELS = ("fmha_cutlassF",)


def _run_slices(n: int, chunk: int) -> int:
    """``n`` slices padded up to whole chunks of ``chunk`` (or, for fewer,
    of the next multiple of 8), as ``infer/engine.py`` runs them."""
    c = min(chunk, -(-n // 8) * 8)
    return -(-n // c) * c


def read(run):
    from benchmark.counts.transunet_flops import attention_bound
    if run.trace is None or run.config.get("model") != "transunet":
        return None
    seconds, _ = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    slices = sum(_run_slices(p.outputs["shape"][2] * p.outputs["shape"][3],
                             run.config["chunk"])
                 for p in run.record["passes"] if p.ok)
    return 100.0 * slices * attention_bound(run.config["network"])[0] \
        / seconds
