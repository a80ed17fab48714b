"""Every cell of BENCHMARK.json end to end on the CPU at a tiny size: the
driver's set-up, window and comparison through the program's plain paths,
the comparison passing its limits; the bfloat16 control and each fault a
cell can have failing them.

    python -m pytest gsbench/tests -q
"""

from __future__ import annotations

import copy
import gc
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gsbench import run as harness  # noqa: E402
from gsbench.calibrate import half_image_loss  # noqa: E402

BENCH = harness._json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 11  # above 32 signed bits, as the driver's seeds are


def tiny(spec: dict) -> tuple:
    """(config, traffic) of a cell cut to a CPU test's size: the cell's
    files with the image, view and Gaussian counts made small."""
    cfg, traffic = copy.deepcopy(spec["config"]), copy.deepcopy(spec["traffic"])
    if cfg["model"] == "3dgs":
        cfg.update(width=64, height=48, views=40, gaussians=4000)
    else:
        cfg.update(width=64, height=48, views=7, gaussians=3000)
        cfg["cameras"]["per_arc"] = [2, 2, 1, 1, 1]
    if traffic["driver"] == "train":
        traffic.update(warmup_steps=1, rate_steps=1)
    if traffic["driver"] == "mesh":
        traffic.update(stride=1, max_dim=48)
    return cfg, traffic


def driven(cell: str):
    """A run of ``cell`` at the tiny size through set-up and a short window,
    its program state freed: (run, spec)."""
    spec = harness.cell_spec(BENCH, cell)
    cfg, traffic = tiny(spec)
    driver = harness._load(os.path.join(ROOT, "gsbench", "drivers", traffic["driver"] + ".py"),
                           "gsbench_driver_" + traffic["driver"])
    run = driver.Run(cfg, traffic, SEED, torch.device("cpu"))
    run.setup()
    from gsbench import trace

    profiler, trace.Window = trace.Window, _Window  # the mesh window profiles the device
    try:
        measured = run.window(0.1)
    finally:
        trace.Window = profiler
    assert run.attempted >= 1
    assert all(v > 0 for v in measured.values())
    run.release()
    gc.collect()
    return run, spec


@pytest.fixture(scope="module")
def runs():
    return {}


def get(runs, cell):
    if cell not in runs:
        run, spec = driven(cell)
        runs[cell] = (run, spec, run.reference())
    return runs[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_at_tiny_size(runs, cell):
    run, spec, ref = get(runs, cell)
    numbers = run.compare(ref)
    assert set(numbers) == set(spec["limits"])
    assert harness.judge(numbers, spec["limits"]), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(runs, cell):
    """The reference with its rasterizer in bfloat16, in the program's place."""
    run, spec, ref = get(runs, cell)
    control = copy.copy(run)
    control.adopt(run.reference(torch.bfloat16))
    numbers = control.compare(ref)
    assert not harness.judge(numbers, spec["limits"]), numbers


def test_train_step_left_unchanged_fails(runs, monkeypatch):
    """The trainer's step returns its state unchanged: the update gap is 1."""
    from gaustudio_torch.pipelines import train as T

    monkeypatch.setattr(T, "optimise", lambda state, *a, **k: state._replace(step=state.step + 1))
    run, spec = driven("3dgs-m360.train")
    numbers = run.compare(run.reference())
    assert numbers["update"] == pytest.approx(1.0)
    assert not harness.judge(numbers, spec["limits"])


def test_train_half_batch_fails(monkeypatch):
    """The program's loss takes the mean over half the image (its top rows)."""
    from gaustudio_torch.ops import ssim

    full = ssim.rgb_loss

    def half(pred, gt, lam=0.2):
        h = gt.shape[-2] // 2
        return full(pred[..., :h, :], gt[..., :h, :], lam)

    monkeypatch.setattr(ssim, "rgb_loss", half)
    run, spec = driven("3dgs-m360.train")
    numbers = run.compare(run.reference())
    assert not harness.judge(numbers, spec["limits"]), numbers


def test_render_wrong_frame_fails(monkeypatch):
    """gs-render's frame altered where it is produced: the previous view's
    pixels for each view."""
    from gaustudio_torch.scripts import render as gs_render

    real, last = gs_render.frame_pixels, {}

    def stale(out):
        frame = real(out)
        prev = last.get("frame", torch.zeros_like(frame))
        last["frame"] = frame
        return prev

    monkeypatch.setattr(gs_render, "frame_pixels", stale)
    run, spec = driven("3dgs-m360.render")
    numbers = run.compare(run.reference())
    assert not harness.judge(numbers, spec["limits"]), numbers


def test_mesh_view_left_out_fails(monkeypatch):
    """The fusion skips a view: one depth map never integrated."""
    from gaustudio_torch.ops import tsdf

    real, seen = tsdf.integrate, []

    def skip_first(volume, depth, *a, **k):
        seen.append(1)
        return volume if len(seen) % 7 == 1 else real(volume, depth, *a, **k)

    monkeypatch.setattr(tsdf, "integrate", skip_first)
    run, spec = driven("2dgs-dtu.mesh")
    numbers = run.compare(run.reference())
    assert not harness.judge(numbers, spec["limits"]), numbers


def test_half_image_loss_crops_rows():
    calls = []
    half_image_loss(lambda out, gt, cfg: calls.append((out["c"].shape, gt.shape)))(
        {"c": torch.zeros(10, 4, 3)}, torch.zeros(10, 4, 3), {})
    assert calls == [((5, 4, 3), (5, 4, 3))]


class _Window:
    """Stands in for ``trace.Window`` on the CPU: one second of device time
    for each compositor kernel, half of a one-second window busy."""

    def __init__(self, host=True):
        pass

    def busy_s(self):
        return 0.5

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def reduce(self):
        from gsbench.counts import k3, k4

        return {"kernels_s": {k.KERNEL: 1.0 for k in (k3, k4)}, "busy_s": 0.5,
                "window_s": 1.0, "device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_window_feeds_every_reader(cell, monkeypatch):
    """A traced run at the tiny size, the profiler stood in for: each of the
    cell's per-layer readers finds its number in the driver's context."""
    from gsbench import trace

    monkeypatch.setattr(trace, "Window", _Window)
    spec = harness.cell_spec(BENCH, cell)
    cfg, traffic = tiny(spec)
    traffic.update({k: 2 for k in ("traced_steps", "traced_frames", "wall_extractions") if k in traffic})
    driver = harness._load(os.path.join(ROOT, "gsbench", "drivers", traffic["driver"] + ".py"),
                           "gsbench_driver_" + traffic["driver"])
    run = driver.Run(cfg, traffic, SEED, torch.device("cpu"))
    run.setup()
    if traffic["driver"] == "train":  # CUDA events: the card's alone
        monkeypatch.setattr(run, "_stage_ms", lambda batch, settings: dict.fromkeys(
            ("forward", "loss", "backward", "adam"), 1.0))
    ctx = run.traced()
    run.release()
    ctx["run"] = run
    assert {"kind", "model", "profile", "steps", "params", "views"} <= set(ctx)
    for m in spec["per_layer"]:
        value = harness._load(os.path.join(ROOT, "gsbench", "metrics", m["name"] + ".py"),
                              "gsbench_metric").read(ctx)
        assert value is not None and value > 0, m["name"]
        if m["unit"] == "%":
            assert value <= 100, (m["name"], value)


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device, tmp_path):
    """One short run of each cell through the command, on the card."""
    import subprocess

    for cell in CELLS:
        out = subprocess.run([sys.executable, os.path.join(ROOT, "gsbench", "run.py"),
                              "--workload", cell, "--seed", str(SEED), "--seconds", "2",
                              "--trace", "0"], capture_output=True, text=True, timeout=600,
                             cwd=ROOT, env={**os.environ, "TMPDIR": str(tmp_path)})
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], result["compared"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
