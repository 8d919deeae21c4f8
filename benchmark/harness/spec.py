"""Find a cell's files by the names in ``BENCHMARK.json``.

- ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic
  and the limits of the comparison that decides ``correct``;
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters and the
  name of the driver that runs it (``benchmark/drivers/<driver>.py``);
- the configuration's file as ``BENCHMARK.json`` names it;
- ``benchmark/metrics/<metric>.py``: one reader per metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType, SimpleNamespace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(spec: dict, name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell ``name``: its entry, workload file, configuration, traffic
    and driver module, and the end-to-end and per-layer metrics it
    reports."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic",
                                 entry["traffic"] + ".json"))
    workload = _json(os.path.join(HERE, "workloads", name + ".json"))
    driver = importlib.import_module("benchmark.drivers."
                                     + traffic["driver"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return SimpleNamespace(
        name=name, entry=entry, config=config, traffic=traffic,
        workload=workload, driver=driver,
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def reader(metric: str) -> ModuleType:
    """The reader module of ``metric`` (``benchmark/metrics/<name>.py``)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
