"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness: the configuration, traffic and limits files of each
cell and the reader of each per-layer metric."""

from __future__ import annotations

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gsbench import run as harness  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_and_entry_keys():
    assert set(BENCH) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for section, keys in KEYS.items():
        for entry in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (section, entry)


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        sect = [n for s, n in names if s == section]
        assert len(sect) == len(set(sect)), section
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_command_and_paths():
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p) and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= BENCH["run_seconds"] <= 51


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


def test_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = harness._json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics_refer_to_cells_that_report_them():
    cells = {w["name"] for w in BENCH["workloads"]}
    reports = {}
    for cell in cells:
        spec = harness.cell_spec(BENCH, cell)
        reports[cell] = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reports[cell] and len(reports[cell]) >= 2
        assert spec["per_layer"], cell
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
        for cell in m["workloads"]:
            assert m["moves"] in reports[cell], (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_name_is_a_file(cell):
    spec = harness.cell_spec(BENCH, cell)
    drivers = os.path.join(ROOT, "gsbench", "drivers")
    assert os.path.exists(os.path.join(drivers, spec["traffic"]["driver"] + ".py"))
    assert spec["traffic"]["why"]
    for m in spec["per_layer"]:
        reader = harness._load(os.path.join(ROOT, "gsbench", "metrics", m["name"] + ".py"),
                               "reader")
        assert reader.read({}) is None  # nothing to read: no number
    assert set(spec["limits"]) and all(v > 0 for v in spec["limits"].values())
