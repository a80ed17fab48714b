"""The ``scaffold-m360.train`` cell end to end on the CPU at a tiny size: the
driver's set-up, window and comparison through the program's plain paths
within the cell's limits; a fault planted in the reference (the view
distance dropped from the heads' input) failing them; a traced window
feeding the cell's readers.

    python -m pytest gsbench/tests -q
"""

from __future__ import annotations

import copy
import gc
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gsbench import calibrate_scaffold, trace  # noqa: E402
from gsbench import run as harness  # noqa: E402
from gsbench.tests.test_gsbench_spans import _CpuWindow  # noqa: E402

BENCH = harness._json(os.path.join(ROOT, "BENCHMARK.json"))
CELL = "scaffold-m360.train"
SEED = 2**31 + 11  # above 32 signed bits, as a run's seed may be


def _driver():
    return harness._load(os.path.join(ROOT, "gsbench", "drivers", "train_scaffold.py"),
                         "gsbench_driver_train_scaffold")


def _tiny():
    spec = harness.cell_spec(BENCH, CELL)
    cfg, traffic = copy.deepcopy(spec["config"]), copy.deepcopy(spec["traffic"])
    k = 4
    cfg.update(width=48, height=48, views=24, anchors=300, n_offsets=k,
               heads={"opacity": k, "cov": 7 * k, "color": 3 * k})
    cfg["scene"].update(object_share=0.8, ground_share=0.2, object_sigma=0.05,
                        ground_sigma=0.1)
    traffic.update(warmup_steps=1, rate_steps=1, traced_steps=2)
    return spec, cfg, traffic


@pytest.fixture(scope="module")
def driven():
    spec, cfg, traffic = _tiny()
    run = _driver().Run(cfg, traffic, SEED, torch.device("cpu"))
    info = run.setup()
    measured = run.window(0.1)
    run.release()
    gc.collect()
    return run, spec, info, measured, run.reference()


def test_cell_is_correct_at_tiny_size(driven):
    run, spec, info, measured, ref = driven
    assert info["anchors"] == 300 and info["rows"] == 1200 and 0 < info["live_share"] < 1
    assert run.attempted >= 1 and measured["train_ms_per_it"] > 0
    numbers = run.compare(ref)
    assert set(numbers) == set(spec["limits"])
    assert harness.judge(numbers, spec["limits"]), numbers


def test_view_distance_left_out_fails(driven):
    run, spec, _, _, ref = driven
    keep = run.prog
    try:
        with calibrate_scaffold.no_distance():
            run.adopt(run.reference())
        assert not harness.judge(run.compare(ref), spec["limits"])
    finally:
        run.prog = keep


def test_traced_window_feeds_the_readers(monkeypatch):
    spec, cfg, traffic = _tiny()
    run = _driver().Run(cfg, traffic, SEED, torch.device("cpu"))
    run.setup()
    monkeypatch.setattr(trace, "Window", _CpuWindow)
    ctx = run.traced()
    ctx["profile"]["busy_s"] = 0.0  # no device
    values = {}
    for m in spec["per_layer"]:
        values[m["name"]] = harness._load(os.path.join(ROOT, "gsbench", "metrics",
                                                       m["name"] + ".py"), "reader").read(ctx)
    # CUDA events time the device spans: none on the CPU
    assert all(values[n] is None for n in values if n.startswith("span_device_ms."))
    assert 0 < values["live_row_share.scaffold"] < 100
    assert values["device_idle_share.scaffold"] == 100.0
    assert 0 < values["scaffold_step_mfu"] < 100
