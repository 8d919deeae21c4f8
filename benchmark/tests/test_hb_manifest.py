"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it finds its files."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
HERE = os.path.join(ROOT, "benchmark")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(ROOT, p))
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    for word in spec["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x cells runs, each allowed
    # run_seconds + 60, each cell 2 x 90 more, 1200 spare
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries(spec):
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                                for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    all_names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                       "per_layer") for x in spec[key]]
    assert len(all_names) == len(set(all_names))


def test_every_config_is_used_and_every_cell_reports(spec):
    cells = {w["name"] for w in spec["workloads"]}
    assert {c["name"] for c in spec["configs"]} == {
        w["config"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for cell in cells:
        assert sum(reports(m, cell) for m in spec["end_to_end"]) >= 2
        assert any(reports(m, cell) for m in spec["per_layer"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell)


def test_every_name_finds_its_files(spec):
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"]
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
        assert os.path.exists(os.path.join(ROOT, cfg["reference"]))
        assert os.path.exists(os.path.join(ROOT, cfg["bundle"]))
    for w in spec["workloads"]:
        with open(os.path.join(HERE, "workloads", w["name"] + ".json")) as f:
            wl = json.load(f)
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["why"] == w["why"] and wl["limits"]
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(HERE, "drivers",
                                           traffic["driver"] + ".py"))


def test_metric_readers_declare_what_the_manifest_says(spec):
    from benchmark.harness.spec import reader
    for m in spec["end_to_end"] + spec["per_layer"]:
        r = reader(m["name"])
        assert (r.UNIT, r.SOURCE, r.BETTER) == (m["unit"], m["source"],
                                                m["better"])
        assert (r.LAYER, r.MOVES) == (m.get("layer"), m.get("moves"))


def test_every_file_under_paths_is_named_from_name_characters(spec):
    for p in spec["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
