"""The frozen counts in gsbench/counts give chip_smoke.py's values: the
operation constants, the bound, the pairs walked and K3's and K4's bounds on
a tiny scene's work as the program's plain paths bin and composite it; the
census counts with the benchmark's own rasterizer, at least the work the
program walks; the stage counts behind train_step_mfu add up stage by
stage."""

from __future__ import annotations

import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gsbench import generate  # noqa: E402
from gsbench import run as harness  # noqa: E402
from gsbench.counts import census, k3, k4, peaks, step  # noqa: E402
from gsbench.trace import _union, kernel_name  # noqa: E402


def test_constants_are_chip_smokes():
    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert peaks.F32_OPS_PER_S == chip_smoke.F32_OPS_PER_S
    for mod, name in ((k3, "render_tiles"), (k4, "render_tiles_backward")):
        assert mod.OPS_PER_PAIR == chip_smoke.OPS[name]
        assert mod.KERNEL == name + "_kernel"
    assert step.K1_PER_CANDIDATE == chip_smoke.OPS["duplicate_with_keys"]
    assert (step.PAIR_FWD, step.PAIR_BWD) == (k3.OPS_PER_PAIR, k4.OPS_PER_PAIR)
    for nbytes, ops in ((1e9, 1e6), (1e3, 1e12), (0, 0)):
        assert peaks.bound_ms(nbytes, ops) == chip_smoke.bound_ms(nbytes, ops)


def _view(model):
    cfg = harness._json(os.path.join(ROOT, "gsbench", "configs",
                                      "2dgs-dtu.json" if model == "2dgs" else "3dgs-m360.json"))
    cfg.update(width=72, height=40, views=4, gaussians=3000)
    if model == "2dgs":
        cfg["cameras"]["per_arc"] = [1, 1, 1, 1, 0]
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.ops.rasterize import RasterizeSettings
    from gaustudio_torch.pipelines.train import CameraBatch

    params = generate.scene(cfg, 5, torch.device("cpu"))
    cam_dict = generate.cameras(cfg)[1]
    cam = JSON_to_camera(cam_dict, device="cpu")
    st = RasterizeSettings(image_height=cam.image_height, image_width=cam.image_width,
                           tanfovx=math.tan(cam.FoVx / 2), tanfovy=math.tan(cam.FoVy / 2),
                           bg=torch.zeros(3))
    batch = CameraBatch(cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
                        torch.zeros(3, cam.image_height, cam.image_width))
    return params, cam_dict, batch, st


def _pre(model, params, batch, st):
    from gaustudio_torch.ops import gaussian
    from gaustudio_torch.ops import rasterize_surfel as rs
    from gaustudio_torch.pipelines.train import _features

    rot = params["rot"] / params["rot"].norm(dim=-1, keepdim=True)
    kw = dict(shs=_features(params), sh_degree=3, scales=torch.exp(params["scale"]),
              rotations=rot)
    op = torch.sigmoid(params["opacity"][:, 0])
    W, H = st.image_width, st.image_height
    if model == "2dgs":
        return rs.preprocess_surfel(params["xyz"], op, batch.viewmatrix, batch.projmatrix,
                                    batch.campos, W, H, **kw)
    return gaussian.preprocess(params["xyz"], op, batch.viewmatrix, batch.projmatrix,
                               batch.campos, W, H, st.tanfovx, st.tanfovy, **kw)


def _program_work(model, params, batch, st):
    """The view's work as the program's plain paths bin (with K1's cull
    for 3DGS) and composite it: the inputs of chip_smoke.py's bounds."""
    from gaustudio_torch.ops import binning, composite, composite_surfel
    from gaustudio_torch.ops import rasterize_surfel as rs

    pre = _pre(model, params, batch, st)
    W, H = st.image_width, st.image_height
    gx, gy = (W + 15) // 16, (H + 15) // 16
    if model == "2dgs":
        b = binning.bin_gaussians(rs.binning_input(pre), gx, gy, cull=False)
        out = composite_surfel.render_surfel_tiles(
            b.ranges, b.point_list, pre.M, pre.Dk, pre.mean2d, pre.opacities, pre.colors,
            pre.normal_view, gx, gy, W, H)
    else:
        b = binning.bin_gaussians(pre, gx, gy)
        out = composite.render_tiles(b.ranges, b.point_list, pre.means2d, pre.conic,
                                     pre.opacities, pre.colors, pre.depths, gx, gy, W, H)
    fwd, bwd = census.pairs_walked(b.ranges, out.final_T, out.n_contrib, W, H)
    assert (fwd, bwd) == chip_smoke.pairs_walked(b.ranges, out.final_T, out.n_contrib, W, H)
    return pre, {"gaussians": int(params["xyz"].shape[0]), "entries": int(b.num_rendered),
                 "tiles": gx * gy, "pixels": W * H, "fwd_pairs": fwd, "bwd_pairs": bwd}


def test_vanilla_bounds_and_pairs_are_chip_smokes():
    params, _, batch, st = _view("3dgs")
    pre, w = _program_work("3dgs", params, batch, st)
    want = chip_smoke.vanilla_bounds(pre, st.image_width, st.image_height)
    assert k3.bound(w) == pytest.approx(want["render_tiles"], rel=1e-12)
    assert k4.bound(w) == pytest.approx(want["render_tiles_backward"], rel=1e-12)
    assert w["fwd_pairs"] > 0 and w["bwd_pairs"] > 0 and w["entries"] > 0


@pytest.mark.parametrize("model", ["3dgs", "2dgs"])
def test_census_counts_at_least_what_the_program_walks(model):
    """The census's entries are the published rasterizer's (no tile cull),
    so it counts at least the entries and pairs the program walks, and its
    pixels that stop apply the same entries."""
    params, cam, batch, st = _view(model)
    _, prog = _program_work(model, params, batch, st)
    w = census.view_work(model, params, cam, 1, torch.device("cpu"))
    assert w["pixels"] == prog["pixels"] and w["tiles"] == prog["tiles"]
    assert w["entries"] == w["rect_tiles"] >= prog["entries"] > 0
    assert 0 < w["in_frustum"] <= w["gaussians"] == prog["gaussians"]
    assert w["fwd_pairs"] >= prog["fwd_pairs"] and w["bwd_pairs"] >= prog["bwd_pairs"] > 0
    assert w["params"] == sum(p.numel() for p in params.values())


def test_census_work_follows_the_views_in_order():
    params, cam, _, _ = _view("3dgs")
    other = dict(cam, id=cam["id"] + 1, position=[-x for x in cam["position"]])
    calls = []
    ctx = {"model": "3dgs", "views": [(cam, 1), (other, 1), (cam, 1)],
           "params": lambda: calls.append(1) or params}
    work = census.work(ctx)
    assert len(work) == 3 and work[0] is work[2] and work[0] != work[1]
    assert census.work(ctx) is work and calls == [1]
    assert census.work({"model": "3dgs", "views": []}) is None


def test_stage_counts_add_up():
    w = {"gaussians": 100, "in_frustum": 80, "rect_tiles": 300, "entries": 250, "tiles": 12,
         "pixels": 3072, "fwd_pairs": 9000, "bwd_pairs": 4000, "params": 5900}
    s = step.stages(w)
    assert set(s) == {"preprocess", "binning", "compositor", "loss", "statistics", "adam"}
    assert all(v > 0 for v in s.values())
    assert step.step_ops(w) == sum(s.values())
    assert s["compositor"] == step.PAIR_FWD * 9000 + step.PAIR_BWD * 4000
    assert s["adam"] == step.ADAM_PER_PARAM * 5900


def test_roofline_share_reads_nothing_without_its_kernel():
    assert peaks.roofline_share({}, k3) is None
    ctx = {"_work": [{"tiles": 1, "entries": 1, "gaussians": 1, "pixels": 1, "fwd_pairs": 1}],
           "profile": {"kernels_s": {}}}
    assert peaks.roofline_share(ctx, k3) is None
    ctx["profile"]["kernels_s"][k3.KERNEL] = 1e-3
    assert 0 < peaks.roofline_share(ctx, k3) < 100
    ctx["_work"] = None
    assert peaks.roofline_share(ctx, k3) is None


def test_trace_union_and_names():
    total, gaps = _union([(0, 10), (5, 12), (20, 25), (30, 31)])
    assert total == 12 + 5 + 1 and gaps == [(12, 20), (25, 30)]
    assert kernel_name("void render_tiles_kernel(int, float const*)") == "render_tiles_kernel"
    assert kernel_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_busy_is_the_union_of_the_device_events():
    """``Window.busy_s`` unions the device's intervals and ignores the host's."""
    import torch

    from gsbench import trace

    class Ev:
        def __init__(self, start, dur, dev):
            self.s, self.d, self.dev = start, dur, dev

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

        def device_type(self):
            return self.dev

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [Ev(20, 5, cuda), Ev(0, 10, cuda), Ev(5, 7, cuda), Ev(0, 100, cpu)]
    win = trace.Window(host=False)
    win._prof = type("P", (), {"profiler": type("A", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: events)})})})
    assert win.busy_s() == (12 + 5) / 1e9
