"""The readers of the program's spans and counters (``gsbench/spans.py`` and
the ``span_*`` and ``bin_keep_share.render`` metrics) on a synthetic traced
context and report: their values and units, None in another cell's kind and
where the program has no ``observability.report``, and each listed only for
its own cell."""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gaustudio_torch.utils import observability  # noqa: E402
from gsbench import run as harness  # noqa: E402
from gsbench import trace  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
METRICS = {m["name"]: m for m in BENCH["per_layer"]}
CELL = {"train": "3dgs-m360.train", "render": "3dgs-m360.render", "mesh": "2dgs-dtu.mesh"}
STEPS = {"train": 12, "render": 25, "mesh": 1}

REPORT = {"spans": {"gs.features": {"calls": 12, "parent": "gs.render", "device_ms": 60.0},
                    "gs.preprocess": {"calls": 12, "parent": "gs.render", "device_ms": 120.0},
                    "gs.bin": {"calls": 12, "parent": "gs.render", "device_ms": 24.0},
                    "gs.composite": {"calls": 12, "parent": "gs.render", "device_ms": 12.0},
                    "gs.loss": {"calls": 12, "parent": "gs.step", "device_ms": 66.0},
                    "gs.backward": {"calls": 12, "parent": "gs.step", "device_ms": 480.0},
                    "gs.adam": {"calls": 12, "parent": "gs.step", "device_ms": 114.0},
                    "gs.step": {"calls": 12, "parent": None, "device_ms": None}},
          "counters": {"gs.entries": 750, "gs.rect_tiles": 1000, "gs.pixels": 4096}}
MS = 1_000_000  # ns
HOST = [(0, 3 * MS, "gs.loader_wait"), (10 * MS, 19 * MS, "gs.loader_wait"),
        (0, 500 * MS, "gs.mesh.views"), (600 * MS, 840 * MS, "gs.mesh.march"),
        (840 * MS, 990 * MS, "gs.mesh.dedup"), (400 * MS, 420 * MS, "gs.mesh.writer_wait"),
        (480 * MS, 485 * MS, "gs.mesh.writer_wait"), (0, 900 * MS, "gs.step")]

# metric -> (its cell's kind, its value on REPORT and HOST)
WANT = {
    "span_device_ms.train.features": ("train", 60.0 / 12),
    "span_device_ms.train.preprocess": ("train", 120.0 / 12),
    "span_device_ms.train.bin": ("train", 24.0 / 12),
    "span_device_ms.train.composite": ("train", 12.0 / 12),
    "span_device_ms.train.loss": ("train", 66.0 / 12),
    "span_device_ms.train.backward": ("train", 480.0 / 12),
    "span_device_ms.train.adam": ("train", 114.0 / 12),
    "span_host_ms.train.loader_wait": ("train", 12.0 / 12),
    "span_device_ms.render.features": ("render", 60.0 / 25),
    "span_device_ms.render.preprocess": ("render", 120.0 / 25),
    "span_device_ms.render.bin": ("render", 24.0 / 25),
    "span_device_ms.render.composite": ("render", 12.0 / 25),
    "bin_keep_share.render": ("render", 75.0),
    "span_host_s.mesh.views": ("mesh", 0.5),
    "span_host_s.mesh.march": ("mesh", 0.24),
    "span_host_s.mesh.dedup": ("mesh", 0.15),
    "span_host_s.mesh.writer_wait": ("mesh", 0.025),
}
UNIT = {"span_device_ms": "ms", "span_host_ms": "ms", "span_host_s": "s", "bin_keep_share": "%"}


def reader(name: str):
    return harness._load(os.path.join(ROOT, "gsbench", "metrics", name + ".py"), "reader")


def ctx(kind: str) -> dict:
    return {"kind": kind, "steps": STEPS[kind],
            "profile": {"spans": {"host": HOST, "device": []}}}


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(observability, "report", lambda: REPORT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value_and_unit(name, program):
    kind, value = WANT[name]
    assert reader(name).read(ctx(kind)) == pytest.approx(value, rel=1e-12)
    assert METRICS[name]["unit"] == UNIT[name.split(".")[0]]
    assert METRICS[name]["better"] == ("higher" if name == "bin_keep_share.render" else "lower")
    assert METRICS[name]["source"] == ("host_clock" if name.startswith("span_host")
                                       else "device_trace")


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_silent_elsewhere(name, program, monkeypatch):
    kind = WANT[name][0]
    for other in STEPS:
        if other != kind:
            assert reader(name).read(ctx(other)) is None, other
    assert reader(name).read({}) is None
    monkeypatch.delattr(observability, "report")  # a program before the spans
    assert reader(name).read(ctx(kind)) is None


def test_readers_are_silent_on_an_empty_window(monkeypatch):
    monkeypatch.setattr(observability, "report", lambda: {"spans": {}, "counters": {}})
    empty = {"kind": None, "steps": 1, "profile": {"spans": {"host": [], "device": []}}}
    for name, (kind, _) in WANT.items():
        assert reader(name).read(dict(empty, kind=kind)) is None, name


def test_cell_spec_lists_each_metric_for_its_cell_only():
    for cell in CELL.values():
        listed = {m["name"] for m in harness.cell_spec(BENCH, cell)["per_layer"]}
        assert listed & set(WANT) == {n for n, (k, _) in WANT.items() if CELL[k] == cell}


class _CpuWindow(trace.Window):
    """``trace.Window`` over the CPU alone: the profiler records the host's
    events, so the program's spans are live; no device, no busy time."""

    def __init__(self, host=True):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU])
        self.wall_s = 0.0

    def __enter__(self):
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False


def _tiny(spec: dict) -> tuple:
    """A cell's configuration and traffic cut to a CPU test's size."""
    cfg, traffic = copy.deepcopy(spec["config"]), copy.deepcopy(spec["traffic"])
    cfg.update(width=48, height=32, gaussians=600)
    if cfg["model"] == "3dgs":
        cfg["views"] = 40
    else:
        cfg["views"] = 7
        cfg["cameras"]["per_arc"] = [2, 2, 1, 1, 1]
    traffic.update({k: v for k, v in {"warmup_steps": 1, "rate_steps": 1, "stride": 1,
                                      "max_dim": 48, "wall_extractions": 1, "traced_steps": 2,
                                      "traced_frames": 2}.items() if k in traffic})
    return cfg, traffic


@pytest.mark.parametrize("kind", sorted(CELL))
def test_traced_run_feeds_the_span_readers(kind, monkeypatch):
    """A traced run of the cell's driver at a tiny size on the CPU, under a
    real (host-only) profiler: the host readings and counters come from the
    program's own spans; the device readings need CUDA events, so on the
    CPU they read None."""
    monkeypatch.setattr(trace, "Window", _CpuWindow)
    spec = harness.cell_spec(BENCH, CELL[kind])
    cfg, traffic = _tiny(spec)
    driver = harness._load(os.path.join(ROOT, "gsbench", "drivers", traffic["driver"] + ".py"),
                           "gsbench_driver_" + traffic["driver"])
    run = driver.Run(cfg, traffic, 2**31 + 17, torch.device("cpu"))
    run.setup()
    if kind == "train":  # the driver's stage breakdown times with CUDA events
        monkeypatch.setattr(run, "_stage_ms", lambda batch, settings: {})
    if kind == "mesh":
        monkeypatch.setattr(run, "_stages", lambda: {})
    ctx = run.traced()
    run.release()
    for name, (k, _) in WANT.items():
        if k != kind:
            continue
        value = reader(name).read(ctx)
        if name.startswith("span_device_ms"):
            assert value is None, name
        elif name == "bin_keep_share.render":
            assert 0 < value <= 100, value
        else:
            assert value is not None and value > 0, name
