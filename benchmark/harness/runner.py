"""One run of one cell: set-up, the window (traced or not), the peak
memory, the comparison with the reference, the metrics, the result line.

``run.py`` calls :func:`run_cell` after it has found the card; the tests
call it on the CPU with small files of their own."""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Optional

import torch

from benchmark.harness import spec as spec_mod
from benchmark.harness import trace as trace_mod


def process_age() -> float:
    """Seconds since this process started (``/proc``; the kernel's clock
    ticks), or since the harness was imported where ``/proc`` has none."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", low_precision: bool = False,
             workdir: Optional[str] = None, log=sys.stderr) -> dict:
    """Run ``cell`` (:func:`spec.cell`) once.  Returns the result line as
    a dict; its ``compared`` holds each number that decided ``correct``
    beside its limit."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="bench-")
    ctx = SimpleNamespace(seed=int(seed), config=cell.config,
                          traffic=cell.traffic, workload=cell.workload,
                          device=device, workdir=workdir,
                          low_precision=low_precision)
    on_card = device != "cpu"
    driver = cell.driver
    try:
        with contextlib.redirect_stdout(log):
            state = driver.setup(ctx)
            if on_card:
                torch.cuda.synchronize()
            setup_s = process_age()
            tracer = None
            with contextlib.ExitStack() as stack:
                if trace:
                    stack.enter_context(trace_mod.spans(driver.SPANS))
                    tracer = stack.enter_context(trace_mod.Tracer())
                record = driver.window(state, seconds)
                if on_card:
                    torch.cuda.synchronize()
            peak = (max(torch.cuda.max_memory_reserved(d)
                        for d in range(torch.cuda.device_count()))
                    if on_card else 0)
            driver.release(state)
            t0 = time.perf_counter()
            got = driver.check(state, record)
            print(f"reference and comparison: "
                  f"{time.perf_counter() - t0:.3f} s", file=log)
        compared = compared_numbers(cell.workload["limits"], record, got,
                                    log)
        run = SimpleNamespace(record=record, config=cell.config,
                              traffic=cell.traffic, setup_s=setup_s,
                              peak_reserved_bytes=peak,
                              trace=tracer.trace if tracer else None)
        wanted = cell.per_layer if trace else cell.end_to_end
        metrics = {}
        for m in wanted:
            if m["source"] == "device_trace" and not on_card:
                continue  # a CPU run gives no device figure
            value = spec_mod.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        correct = all(_within(v, lim) for _, v, lim in compared)
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": (torch.cuda.get_device_name(0) if on_card
                        else "cpu"),
               "count": cell.entry["chips"],
               "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": record["attempted"],
                  "failed": record["failed"], "metrics": metrics,
                  "device": dev}
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
            result["breakdown"] = {"device_ops": run.trace.top_ops(),
                                   "idle_gaps": run.trace.idle_gaps()}
        _log_run(log, cell, record, run, setup_s)
        result["compared"] = {name: {"value": _num(v), "limit": lim}
                              for name, v, lim in compared}
        return result
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def compared_numbers(limits: dict, record: dict, got: dict, log) -> list:
    """(name, value, limit) of each number the workload file gives a
    limit, after the subjects or steps that failed (limit 0); the other
    numbers are printed for the record."""
    for name, value in got.items():
        if name not in limits:
            print(f"not compared {name}: {value}", file=log)
    return [("failed", float(record["failed"]), 0.0)] + [
        (name, got[name], limit) for name, limit in limits.items()]


def _within(value: float, limit: float) -> bool:
    return not math.isnan(value) and value <= limit


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def _log_run(log, cell, record, run, setup_s) -> None:
    print(f"cell {cell.name}: set-up {setup_s:.3f} s, "
          f"{record['attempted']} subjects in {record['window_s']:.3f} s, "
          f"{record['failed']} failed, programs captured in the window: "
          f"{record.get('programs_added', 'n/a')} new, "
          f"{record.get('programs_captured', 'n/a')} in all", file=log)
    passes = record.get("passes", ())
    for ps in passes:
        if not ps.ok:
            print(f"subject {ps.name} failed:\n{ps.error}", file=log)
    if passes:
        ends = [0.0] + [ps.t_end for ps in passes]
        took = sorted(b - a for a, b in zip(ends, ends[1:]))
        print("subject seconds: min {:.3f} median {:.3f} max {:.3f}".format(
            took[0], took[len(took) // 2], took[-1]), file=log)
        stages = sorted({k for ps in passes for k in ps.stages})
        print("stage seconds, median: " + ", ".join(
            "{} {:.3f}".format(k, sorted(ps.stages.get(k, 0.0)
                                         for ps in passes)[len(passes) // 2])
            for k in stages), file=log)
    for key in record.get("new_programs", ()):
        print(f"captured in the window: {key}", file=log)
    if run.trace is not None:
        print(f"trace: window {run.trace.window_s:.6f} s, busy "
              f"{run.trace.busy_s:.6f} s", file=log)
        for m in cell.per_layer:
            kernels = getattr(spec_mod.reader(m["name"]), "KERNELS", None)
            if kernels:
                s, n = run.trace.kernel_seconds(kernels)
                print(f"{m['name']}: {n} launches of {', '.join(kernels)} "
                      f"in {s:.6f} s", file=log)
        for name, s in run.trace.top_ops(20):
            _, n = run.trace.kernel_seconds([name])
            print(f"  {s:.6f} s  {n:6d} x  {name}", file=log)
