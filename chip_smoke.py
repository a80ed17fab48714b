#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gaustudio_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card: its name and power limit (nvidia-smi); TF32 off;
2. build: the CUDA kernels of gaustudio_torch/csrc, compiled with nvcc at
   first use (build seconds and ptxas register counts);
3. kernels: each kernel (K1 duplicate_with_keys, K2 identify_tile_ranges,
   K3 render_tiles, K4 render_tiles_backward) against its plain PyTorch
   version on the card, on a mini_scene view and on one 1920x1080 view of a
   300k-Gaussian, SH-degree-3 model, with the tolerances stated below; then
   each kernel's time against its plain version's at the 1080p shapes, and
   the time of the torch-op stages (activations + preprocess, the sort);
4. render path on the fixture: gs-render on tests/fixtures/mini_scene, and
   the renderer's PSNR against GOLDEN.json (within 0.15 dB);
5. render path at full width: gs-render of the 300k model from three
   1920x1080 cameras, with the launch counts of that run, the lit-fraction
   guard, and rasterize() timed warm against the plain path;
6. training path on the fixture: gs-train for 1000 iterations from the
   fixture's sparse points (densification at 600-1000), with the launch
   counts of that run, and the PSNR of the exported model against that of
   the initial point cloud (at least 3 dB better);
6b. training with the kernels against training with the plain versions:
   100 steps from the fixture's model, one camera sequence, final PSNR
   within 0.1 dB;
7. training at full width: 30 steps and one densify at 1920x1080 / 300k /
   SH 3 and at 512x512 / 100k, with ms per iteration and a breakdown.

Each path (phases 4, 5 and 6) is driven with every launch count set to 0
just before it and read just after; a kernel of the path that was not
launched fails the run. The report's ``launches`` sums the counts of the
render path (phase 5) and the training path (phase 6). The last two lines
are {"kernels": [...]} and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device. Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_scene")
GOLDEN_PSNR_TOL = 0.15
FULL_W, FULL_H, FULL_N, FULL_VIEWS = 1920, 1080, 300_000, 3
SMALL_W, SMALL_H, SMALL_N = 512, 512, 100_000  # the second training shape
FIXTURE_TRAIN_ITERS = 1000
# K1 and K2 are integer results and must agree exactly. K3 walks each pixel
# in the same order as its plain version and rounds its decisions the same way
# (csrc/common.cuh), while its blend may use fused multiply-adds: its float
# outputs agree to rounding, abs 1e-5 + rel 1e-5, and its int outputs exactly.
K3_ATOL = K3_RTOL = 1e-5
# K4 adds each warp's sums with atomicAdd, in an order that changes from run
# to run: each gradient, scaled by the plain version's max |value|, agrees
# within the tolerance of tests/test_pallas_bwd.py.
K4_RTOL, K4_ATOL = 2e-3, 2e-5

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "duplicate_with_keys": ("gaustudio_torch/csrc/binning.cu",
                            "gaustudio_tpu/ops/binning_fast.py:230"),
    "identify_tile_ranges": ("gaustudio_torch/csrc/binning.cu",
                             "gaustudio_tpu/ops/binning_fast.py:472"),
    "render_tiles": ("gaustudio_torch/csrc/composite.cu",
                     "gaustudio_tpu/ops/rasterize_pallas.py:136"),
    "render_tiles_backward": ("gaustudio_torch/csrc/composite_bwd.cu",
                              "gaustudio_tpu/ops/rasterize_pallas_bwd.py:80 (B4), "
                              "gaustudio_tpu/ops/rasterize_pallas_bwd.py:451 (B5), "
                              "gaustudio_tpu/ops/binning_fast.py:394 (B6)"),
}
FORWARD = ("duplicate_with_keys", "identify_tile_ranges", "render_tiles")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok, msg) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[torch.cuda.current_device()].strip()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- scenes -------------------------------------------------------------


def write_full_scene(out_dir: str, seed: int = 0, n: int = FULL_N, W: int = FULL_W,
                     H: int = FULL_H, name: str = "full") -> tuple[str, str]:
    """An n-point SH-degree-3 vanilla PLY and a cameras.json of three WxH
    views. Geometry, opacity and base colour come from bench.make_scene; the
    higher SH bands are seeded noise."""
    from bench import make_scene
    from gaustudio_torch.models.vanilla import VanillaPointCloud
    from gaustudio_torch.ops.sh import RGB2SH

    xyz, scales, quats, opac, colors = make_scene(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    f_rest = (rng.normal(size=(n, 45)) * 0.05).astype(np.float32)
    pcd = VanillaPointCloud.from_jax_params({
        "xyz": xyz, "opacity": np.log(opac / (1.0 - opac))[:, None],
        "f_dc": RGB2SH(colors), "f_rest": f_rest, "scale": np.log(scales), "rot": quats,
    })
    ply = os.path.join(out_dir, f"{name}_scene.ply")
    pcd.export(ply)

    tanfov = 0.85  # bench.py's camera
    focal = W / (2.0 * tanfov)
    cams = []
    for i in range(FULL_VIEWS):
        ang = 0.02 * (i - 1)
        c, s = math.cos(ang), math.sin(ang)
        cams.append({
            "id": i, "img_name": f"view_{i:02d}", "width": W, "height": H,
            "position": [0.05 * (i - 1), 0.0, 0.0],
            "rotation": [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
            "fx": focal, "fy": focal,
        })
    cams_path = os.path.join(out_dir, f"{name}_cameras.json")
    with open(cams_path, "w") as f:
        json.dump(cams, f)
    return ply, cams_path


def load_model(ply: str, sh: int, device):
    from gaustudio_torch import models

    pcd = models.make({"name": "vanilla_pcd"}, device=device)
    pcd.load(ply)
    pcd.active_sh_degree = sh
    return pcd


def load_cameras(path: str):
    from gaustudio_torch.datasets.utils import JSON_to_camera

    with open(path) as f:
        return [JSON_to_camera(cj) for cj in json.load(f)]


def view_preprocess(renderer, cam, pcd):
    """The Preprocessed of one view, exactly as rasterize() computes it."""
    from gaustudio_torch.ops import gaussian

    xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
    st = renderer.make_settings(cam, pcd, xyz.device)
    return gaussian.preprocess(
        xyz, opacity.reshape(-1), st.viewmatrix, st.projmatrix, st.campos,
        st.image_width, st.image_height, st.tanfovx, st.tanfovy, shs=shs,
        sh_degree=pcd.active_sh_degree, scales=scales, rotations=rotations)


# --- phase 3: kernels against their plain versions ----------------------


def compare_kernels(pre, W: int, H: int) -> dict:
    """Each kernel against its plain version on the same inputs; returns
    {kernel: max abs error} and raises on a disagreement."""
    from gaustudio_torch.ops import binning, composite

    gx, gy = (W + 15) // 16, (H + 15) // 16
    keys, gids = binning.duplicate_with_keys(pre, gx)
    keys_p, gids_p = binning.duplicate_with_keys_plain(pre, gx)
    check(keys.shape == keys_p.shape, f"K1 entry count {keys.shape[0]} != plain {keys_p.shape[0]}")
    k1_err = max(int((keys - keys_p).abs().max()), int((gids - gids_p).abs().max())) \
        if keys.numel() else 0

    sorted_keys, order = torch.sort(keys, stable=True)
    ranges = binning.identify_tile_ranges(sorted_keys, gx * gy)
    ranges_p = binning.identify_tile_ranges_plain(sorted_keys, gx * gy)
    k2_err = int((ranges - ranges_p).abs().max())
    counts = ranges[:, 1] - ranges[:, 0]

    point_list = gids[order]
    args = (ranges_p, point_list, pre.means2d, pre.conic, pre.opacities, pre.colors,
            pre.depths, gx, gy, W, H)
    out = composite.render_tiles(*args)
    out_p = composite.render_tiles_plain(*args)
    torch.cuda.synchronize()
    k3_err, int_mismatch = 0.0, 0
    for name, a, b in zip(out._fields, out, out_p):
        if a.dtype == torch.int32:
            int_mismatch += int((a != b).sum())
        else:
            check(torch.isfinite(a).all(), f"K3 {name}: non-finite values")
            k3_err = max(k3_err, float((a - b).abs().max()))
            torch.testing.assert_close(a, b, atol=K3_ATOL, rtol=K3_RTOL, msg=f"K3 {name}")
    say("kernels", f"{W}x{H}: {keys.shape[0]} entries, {gx * gy} tiles (max {int(counts.max())} "
        f"per tile); K1 max|err| {k1_err}, K2 max|err| {k2_err} (max per-tile count diff "
        f"{int(((ranges[:, 1] - ranges[:, 0]) - (ranges_p[:, 1] - ranges_p[:, 0])).abs().max())}),"
        f" K3 max|err| {k3_err:.3e} (tol {K3_ATOL:g} + {K3_RTOL:g}*|x|), K3 int mismatches "
        f"{int_mismatch}")
    check(k1_err == 0, "K1 disagrees with its plain version")
    check(k2_err == 0, "K2 disagrees with its plain version")
    check(int_mismatch == 0, "K3 median id / n_contrib disagree with the plain version")
    return {"duplicate_with_keys": k1_err, "identify_tile_ranges": k2_err, "render_tiles": k3_err}


def compare_backward(pre, W: int, H: int, seed: int):
    """K4 against its plain version on the binning and forward of the kernels,
    with seeded random cotangents on colour, depth, final T and median depth
    and a nonzero bg. Returns (max abs error, the arguments)."""
    from gaustudio_torch.ops import binning, composite

    gx, gy = (W + 15) // 16, (H + 15) // 16
    device = pre.depths.device
    b = binning.bin_gaussians(pre, gx, gy)
    fwd = composite.render_tiles(b.ranges, b.point_list, pre.means2d, pre.conic, pre.opacities,
                                 pre.colors, pre.depths, gx, gy, W, H)
    gen = torch.Generator(device=device).manual_seed(seed)
    cts = [torch.randn(shape, generator=gen, device=device)
           for shape in ((3, H, W), (H, W), (H, W), (H, W))]
    bg = torch.tensor([0.2, 0.4, 0.1], device=device)
    args = (b.ranges, b.point_list, pre.means2d, pre.conic, pre.opacities, pre.colors,
            pre.depths, bg, fwd.final_T, fwd.n_contrib, *cts, gx, gy, W, H)
    got = composite.render_tiles_backward(*args)
    want = composite.render_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    abs_err, scaled = 0.0, {}
    for name, a, ref in zip(got._fields, got, want):
        check(torch.isfinite(a).all(), f"K4 d_{name}: non-finite values")
        scale = float(ref.abs().max()) + 1e-6
        abs_err = max(abs_err, float((a - ref).abs().max()))
        scaled[name] = float((a - ref).abs().max()) / scale
        torch.testing.assert_close(a / scale, ref / scale, rtol=K4_RTOL, atol=K4_ATOL,
                                   msg=f"K4 d_{name} (scaled by {scale:.4g})")
    say("kernels", f"{W}x{H}: K4 max|err| {abs_err:.3e}; scaled by the plain max|value| "
        + ", ".join(f"d_{k} {v:.3e}" for k, v in scaled.items())
        + f" (tol rtol {K4_RTOL:g}, atol {K4_ATOL:g} on scaled values)")
    return abs_err, args


def time_kernels(pre, W: int, H: int, card: str, preprocess) -> dict:
    """{kernel: (ms, plain_ms)} at the shapes of one view; also prints the
    time of the stages of rasterize() that are torch ops (``preprocess`` is
    the call that made ``pre``)."""
    from gaustudio_torch.ops import binning, composite

    with torch.inference_mode():
        preprocess_ms = cuda_ms(preprocess, 20)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    keys, gids = binning.duplicate_with_keys(pre, gx)
    sorted_keys, order = torch.sort(keys, stable=True)
    ranges = binning.identify_tile_ranges(sorted_keys, gx * gy)
    args = (ranges, gids[order], pre.means2d, pre.conic, pre.opacities, pre.colors,
            pre.depths, gx, gy, W, H)
    times = {
        "duplicate_with_keys": (
            cuda_ms(lambda: binning.duplicate_with_keys(pre, gx), 20),
            cuda_ms(lambda: binning.duplicate_with_keys_plain(pre, gx), 5)),
        "identify_tile_ranges": (
            cuda_ms(lambda: binning.identify_tile_ranges(sorted_keys, gx * gy), 20),
            cuda_ms(lambda: binning.identify_tile_ranges_plain(sorted_keys, gx * gy), 5)),
        "render_tiles": (
            cuda_ms(lambda: composite.render_tiles(*args), 20),
            cuda_ms(lambda: composite.render_tiles_plain(*args), 3)),
    }
    sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), 20)
    for name, (ms, plain_ms) in times.items():
        say("time", f"{name} {W}x{H}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms | {card}")
    say("time", f"torch.sort of {keys.shape[0]} keys: {sort_ms:.4f} ms | {card}")
    say("time", f"activations + preprocess {W}x{H}: {preprocess_ms:.4f} ms | {card}")
    return times


# --- phases 4 and 5: the main path ----------------------------------------


def _wrappers() -> dict:
    from gaustudio_torch.ops import binning, composite

    return {"duplicate_with_keys": binning.duplicate_with_keys,
            "identify_tile_ranges": binning.identify_tile_ranges,
            "render_tiles": composite.render_tiles,
            "render_tiles_backward": composite.render_tiles_backward}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> float:
    mse = torch.mean((pred - gt) ** 2)
    return float(-10.0 * torch.log10(torch.clamp_min(mse, 1e-12)))


def main_path_fixture(out_dir: str, device) -> None:
    from gaustudio_torch import renderers
    from gaustudio_torch.scripts import render as gs_render
    from gaustudio_torch.utils.image import load_image

    with open(os.path.join(FIXTURE, "GOLDEN.json")) as f:
        golden = json.load(f)
    reset_counts()
    images = gs_render.main([
        "-m", os.path.join(FIXTURE, "gaussians.ply"), "-s", os.path.join(FIXTURE, "cameras.json"),
        "--sh", "0", "--device", "cuda", "-o", os.path.join(out_dir, "mini_scene")])
    counts = read_counts()
    cams = load_cameras(os.path.join(FIXTURE, "cameras.json"))
    check(len(os.listdir(images)) == len(cams), "gs-render wrote the wrong number of images")
    say("fixture", f"gs-render wrote {len(cams)} PNGs; launches {json.dumps(counts)}")
    check(all(counts[k] > 0 for k in FORWARD), f"a kernel was not launched: {counts}")

    pcd = load_model(os.path.join(FIXTURE, "gaussians.ply"), 0, device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    got = []
    for cam in cams:
        out = renderer.render(cam, pcd)
        gt, _ = load_image(os.path.join(FIXTURE, "images", cam.image_name))
        got.append(psnr(out["render"].permute(1, 2, 0), torch.from_numpy(gt).to(device)))
    mean = float(np.mean(got))
    say("fixture", f"PSNR mean {mean:.4f} vs GOLDEN {golden['psnr_mean']} "
        f"(tol {GOLDEN_PSNR_TOL}); per view {[round(p, 3) for p in got]}")
    check(abs(mean - golden["psnr_mean"]) <= GOLDEN_PSNR_TOL, "PSNR off the golden")


def main_path_full(out_dir: str, ply: str, cams_path: str, device, card: str) -> dict:
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import rasterize as rast
    from gaustudio_torch.scripts import render as gs_render
    from gaustudio_torch.utils.image import read_png

    reset_counts()
    t0 = time.perf_counter()
    images = gs_render.main(["-m", ply, "-s", cams_path, "--sh", "3", "--device", "cuda",
                             "-o", os.path.join(out_dir, "full")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    say("full", f"gs-render {FULL_VIEWS} views of {FULL_W}x{FULL_H}, {FULL_N} Gaussians: "
        f"{wall:.2f} s wall (load, render, PNG); launches {json.dumps(counts)}")
    check(all(counts[k] > 0 for k in FORWARD), f"a kernel was not launched: {counts}")
    pngs = sorted(os.listdir(images))
    check(len(pngs) == FULL_VIEWS, pngs)
    img = read_png(os.path.join(images, pngs[0]))
    check(img.shape == (FULL_H, FULL_W, 3), img.shape)

    pcd = load_model(ply, 3, device)
    cam = load_cameras(cams_path)[1]
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    out = renderer.render(cam, pcd)
    rgb = out["render"]
    check(rgb.shape == (3, FULL_H, FULL_W) and torch.isfinite(rgb).all(),
          f"render {tuple(rgb.shape)} is not a finite [3, {FULL_H}, {FULL_W}] image")
    lit = float((rgb.sum(0) > 0).float().mean())
    say("full", f"lit fraction {lit:.4f} (guard > 0.9), mean {float(rgb.mean()):.4f}, "
        f"{out['num_rendered']} entries")
    check(lit > 0.9, f"render mostly empty: {lit:.3f} lit")
    check(0.05 < float(rgb.mean()) < 0.95, f"render mean {float(rgb.mean()):.4f}")

    # rasterize() warm, 20 iterations fenced by synchronize, against the plain path
    xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
    st = renderer.make_settings(cam, pcd, device)

    def run(settings):
        return rast.rasterize(xyz, opacity, settings, shs=shs, scales=scales,
                              rotations=rotations, active_sh_degree=3)

    plain = st._replace(backend="plain")
    with torch.inference_mode():
        ref = run(plain)
        got = run(st)
        err = float((got["render"] - ref["render"]).abs().max())
        check(err <= 1e-4, f"rasterize kernels vs plain: max|err| {err}")
        timings = {}
        for name, settings, iters in (("kernels", st, 20), ("plain", plain, 3)):
            run(settings)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                run(settings)
            torch.cuda.synchronize()
            timings[name] = (time.perf_counter() - t0) / iters
    mpix = FULL_W * FULL_H / 1e6
    say("time", f"rasterize {FULL_W}x{FULL_H} {FULL_N} pts SH3: kernels "
        f"{timings['kernels'] * 1e3:.3f} ms = {mpix / timings['kernels']:.2f} MPix/s; plain "
        f"{timings['plain'] * 1e3:.3f} ms = {mpix / timings['plain']:.3f} MPix/s; "
        f"max|err| {err:.2e} | {card}")
    return counts


# --- phases 6, 6b and 7: the training path -------------------------------


def render_psnr(pcd, cams, device) -> list:
    """PSNR of the vanilla renderer's image of ``pcd`` against each camera's
    fixture image."""
    from gaustudio_torch import renderers
    from gaustudio_torch.utils.image import load_image

    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    got = []
    for cam in cams:
        out = renderer.render(cam, pcd)
        gt, _ = load_image(os.path.join(FIXTURE, "images", cam.image_name))
        got.append(psnr(out["render"].permute(1, 2, 0), torch.from_numpy(gt).to(device)))
    return got


def train_fixture(out_dir: str, device, card: str) -> dict:
    """gs-train on the fixture's views from its sparse points; returns the
    launch counts of the run."""
    from gaustudio_torch import models
    from gaustudio_torch.scripts import train as gs_train
    from gaustudio_torch.utils.ply import fetch_ply

    src = os.path.join(out_dir, "train_src")
    out = os.path.join(out_dir, "train_out")
    for d in (src, out):
        shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(FIXTURE, "images"), os.path.join(src, "images"))
    shutil.copy(os.path.join(FIXTURE, "cameras.json"), src)
    os.makedirs(os.path.join(src, "sparse", "0"))
    sparse = os.path.join(src, "sparse", "0", "points3D.ply")
    shutil.copy(os.path.join(FIXTURE, "sparse_points.ply"), sparse)

    reset_counts()
    t0 = time.perf_counter()
    history = gs_train.main(["-s", src, "-o", out, "--dataset", "vanilla", "--iterations",
                             str(FIXTURE_TRAIN_ITERS), "--save_every", str(FIXTURE_TRAIN_ITERS),
                             "--device", device.type, "--gpu", str(device.index or 0)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    last = history[-1]
    say("train", f"gs-train {FIXTURE_TRAIN_ITERS} iterations on mini_scene: {wall:.2f} s wall; "
        f"loss {last['loss']:.5f}, train PSNR {last['psnr']:.3f}; launches {json.dumps(counts)}"
        f" | {card}")
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")
    check(math.isfinite(last["loss"]), f"non-finite loss {last['loss']}")

    cams = load_cameras(os.path.join(FIXTURE, "cameras.json"))
    xyz, rgb, _ = fetch_ply(sparse)
    init = models.make({"name": "vanilla_pcd"}, device=device)
    init.create_from_attribute(xyz=xyz, rgb=rgb)
    ply = os.path.join(out, "point_cloud", f"iteration_{FIXTURE_TRAIN_ITERS}", "point_cloud.ply")
    trained = load_model(ply, 1, device)  # SH degree 1 from iteration 1000
    check(trained.num_points != init.num_points,
          f"densification left the point count at {trained.num_points}")
    before, after = np.mean(render_psnr(init, cams, device)), np.mean(render_psnr(trained, cams, device))
    say("train", f"points {init.num_points} -> {trained.num_points}; mean PSNR over "
        f"{len(cams)} views: initial {before:.4f} dB, trained {after:.4f} dB (need +3)")
    check(after >= before + 3.0, f"training gained {after - before:.3f} dB < 3 dB")
    return counts


def train_kernels_vs_plain(device, card: str, steps: int = 100) -> None:
    """The same training steps through the kernels and through the plain
    versions: final mean PSNR within 0.1 dB."""
    from gaustudio_torch import datasets
    from gaustudio_torch.pipelines import train as T

    ds = datasets.make({"name": "vanilla", "source_path": FIXTURE})
    pcd = load_model(os.path.join(FIXTURE, "gaussians.ply"), 0, device)
    # the fixture-fit schedule of tools/make_fixture.py (no densify or reset)
    cfg = T.TrainConfig(iterations=steps, densify_from_iter=10 ** 9,
                        opacity_reset_interval=10 ** 9, sh_increase_interval=10 ** 9,
                        lr_xyz_init=0.0008, lr_xyz_final=0.00008, lr_xyz_max_steps=steps)
    trainer = T.Trainer(pcd, ds, cfg, device=device)
    batches = [trainer.batch(c) for c in trainer.cameras]
    order = np.random.default_rng(0).integers(len(batches), size=steps)
    kernel_settings = trainer.settings()
    final = {}
    for name, settings in (("kernels", kernel_settings),
                           ("plain", kernel_settings._replace(backend="plain"))):
        state = T.init_state(pcd, device)
        t0 = time.perf_counter()
        for i in order:
            state, metrics = T.train_step(state, batches[i], settings, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.no_grad():
            scores = []
            for b in batches:
                s = kernel_settings._replace(viewmatrix=b.viewmatrix, projmatrix=b.projmatrix,
                                             campos=b.campos, bg=torch.zeros(3, device=device))
                out = T.render_from_params(state.params, state.active_sh_degree, s)
                scores.append(psnr(out["render"], b.gt_image))
        final[name] = (state, float(np.mean(scores)), wall)
        say("train", f"{steps} steps from the fixture model with the {name} versions: "
            f"{wall:.2f} s, last loss {float(metrics['loss']):.5f}, mean PSNR "
            f"{final[name][1]:.4f} dB | {card}")
    diff = {k: float((final["kernels"][0].params[k] - final["plain"][0].params[k]).abs().max())
            for k in T.PARAMS}
    gap = final["kernels"][1] - final["plain"][1]
    say("train", f"kernels - plain PSNR {gap:+.4f} dB (tol 0.1); largest parameter difference "
        + ", ".join(f"{k} {v:.3e}" for k, v in diff.items()))
    check(abs(gap) <= 0.1, f"kernel and plain training differ by {gap:.4f} dB")


def step_breakdown(state, batch, settings, cfg) -> dict:
    """train_step's stages, each between CUDA events: forward rasterize(),
    loss, backward (and, inside it, the compositor's backward node: K4 and
    its wrapper), Adam with the statistics."""
    from gaustudio_torch.ops import ssim
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.pipelines.optimizers.general import adam_update, exp_lr_schedule

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    device = batch.gt_image.device
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    ev[0].record()
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    offset = torch.zeros((state.num_points, 2), device=device, requires_grad=True)
    out = T.render_from_params(params, state.active_sh_degree, s, means2d_offset=offset)
    ev[1].record()
    node = out["render"].grad_fn  # the compositor's autograd node
    node.register_prehook(lambda grad_outputs: ev[5].record())
    node.register_hook(lambda grad_inputs, grad_outputs: ev[6].record())
    bg = torch.zeros(3, device=device)
    pred = out["render"] + bg[:, None, None] * (1.0 - out["rendered_final_opacity"][0])
    loss = ssim.rgb_loss(pred, batch.gt_image, cfg.lambda_dssim)
    ev[2].record()
    grads = torch.autograd.grad(loss, [params[k] for k in T.PARAMS] + [offset])
    ev[3].record()
    with torch.no_grad():
        visible = out["radii"] > 0
        _ = (state.xyz_grad_accum + torch.where(visible, grads[-1].norm(dim=-1), 0.0),
             state.denom + visible.float(), torch.maximum(state.max_radii2d, out["radii"].float()))
        lrs = {"xyz": exp_lr_schedule(cfg.lr_xyz_init, cfg.lr_xyz_final,
                                      cfg.lr_xyz_max_steps)(state.step),
               "f_dc": cfg.lr_f_dc, "f_rest": cfg.lr_f_rest, "opacity": cfg.lr_opacity,
               "scale": cfg.lr_scale, "rot": cfg.lr_rot}
        adam_update(dict(zip(T.PARAMS, grads[:-1])), state.opt, state.params, lrs)
    ev[4].record()
    torch.cuda.synchronize()
    names = ("forward rasterize()", "loss", "backward", "Adam + statistics")
    times = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    times["K4 + wrapper inside backward"] = ev[5].elapsed_time(ev[6])
    return times


def train_at_scale(out_dir: str, ply: str, cams_path: str, device, card: str, label: str,
                   steps: int = 30) -> None:
    """``steps`` training steps and one densify from a seeded jitter of a
    scene, against ground truth rendered from the scene with the kernels."""
    from gaustudio_torch import renderers
    from gaustudio_torch.pipelines import train as T

    pcd = load_model(ply, 3, device)
    cams = load_cameras(cams_path)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    for cam in cams:
        cam.image = renderer.render(cam, pcd)["render"].permute(1, 2, 0).clone()
    gen = torch.Generator(device=device).manual_seed(0)
    pcd._xyz = pcd._xyz + torch.randn(pcd._xyz.shape, generator=gen, device=device) * 0.004
    pcd._f_dc = pcd._f_dc + torch.randn(pcd._f_dc.shape, generator=gen, device=device) * 0.2

    class _Views(list):
        cameras_extent = 2.0

    cfg = T.TrainConfig(densify_grad_threshold=1e-5)
    trainer = T.Trainer(pcd, _Views(cams), cfg, device=device)
    state = trainer.state._replace(active_sh_degree=3)
    batches = [trainer.batch(c) for c in cams]
    settings = trainer.settings()
    W, H = settings.image_width, settings.image_height
    reset_counts()
    losses, wall = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = T.train_step(state, batches[i % len(batches)], settings, cfg)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    k4_launches = read_counts()["render_tiles_backward"]
    check(k4_launches == steps, f"K4 launched {k4_launches} times in {steps} steps")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
    runs = [step_breakdown(state, batches[i % len(batches)], settings, cfg) for i in range(5)]
    breakdown = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    n_before = state.num_points
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, info = T.densify_and_prune(state, trainer.generator, trainer.extent, cfg, True)
    torch.cuda.synchronize()
    densify_ms = (time.perf_counter() - t0) * 1e3
    for k, v in state.params.items():
        check(torch.isfinite(v).all(), f"{label}: non-finite {k} after training")
    say("train", f"{label}: {W}x{H}, {n_before} Gaussians, SH 3: loss {losses[0]:.5f} (step 1) "
        f"-> {losses[-1]:.5f} (step {steps}); {statistics.median(wall[5:]):.3f} ms/it (median "
        f"of steps 6-{steps}, each fenced by synchronize; min {min(wall[5:]):.3f}, max "
        f"{max(wall[5:]):.3f}); K4 launches {k4_launches} | {card}")
    say("train", f"{label}: one step by stage (CUDA events, median of 5 steps, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()) + f" | {card}")
    say("train", f"{label}: densify_and_prune {densify_ms:.3f} ms: {n_before} -> "
        f"{state.num_points} points ({info['n_clone']} clones, {info['n_split']} splits, "
        f"{info['n_prune_opacity'] + info['n_prune_big']} pruned) | {card}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "gaustudio_torch", "build", "smoke"),
                        help="directory for the generated scene and the rendered images")
    args = parser.parse_args(argv)

    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gaustudio_torch.utils import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    print(card, flush=True)
    say("card", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    os.makedirs(args.out, exist_ok=True)

    # phase 2: build
    t0 = time.perf_counter()
    kernels.load()
    say("build", f"{time.perf_counter() - t0:.2f} s to build and load "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is None else round(kernels.build_seconds, 2)} s)"
        f" {os.path.basename(kernels.library_path())}")
    log = os.path.join(kernels.BUILD_DIR, "nvcc.log")
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    say("build", line.strip())

    # phase 3: kernels against their plain versions
    from gaustudio_torch import renderers

    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    mini_pcd = load_model(os.path.join(FIXTURE, "gaussians.ply"), 0, device)
    mini_cam = load_cameras(os.path.join(FIXTURE, "cameras.json"))[0]
    mini_pre = view_preprocess(renderer, mini_cam, mini_pcd)
    errs = compare_kernels(mini_pre, mini_cam.image_width, mini_cam.image_height)
    errs["render_tiles_backward"], _ = compare_backward(
        mini_pre, mini_cam.image_width, mini_cam.image_height, seed=0)
    ply, cams_path = write_full_scene(args.out)
    full_pcd = load_model(ply, 3, device)
    full_cam = load_cameras(cams_path)[1]
    full_pre = view_preprocess(renderer, full_cam, full_pcd)
    full_errs = compare_kernels(full_pre, FULL_W, FULL_H)
    full_errs["render_tiles_backward"], k4_args = compare_backward(full_pre, FULL_W, FULL_H, seed=1)
    errs = {k: max(errs[k], full_errs[k]) for k in errs}
    times = time_kernels(full_pre, FULL_W, FULL_H, card,
                         lambda: view_preprocess(renderer, full_cam, full_pcd))
    from gaustudio_torch.ops import composite

    times["render_tiles_backward"] = (
        cuda_ms(lambda: composite.render_tiles_backward(*k4_args), 20),
        cuda_ms(lambda: composite.render_tiles_backward_plain(*k4_args), 2))
    say("time", f"render_tiles_backward {FULL_W}x{FULL_H}: kernel "
        f"{times['render_tiles_backward'][0]:.4f} ms, plain "
        f"{times['render_tiles_backward'][1]:.4f} ms | {card}")
    del full_pcd, full_pre, mini_pre, k4_args

    # phase 4: the render path on the fixture, against GOLDEN.json
    main_path_fixture(args.out, device)

    # phase 5: the render path at full width
    render_counts = main_path_full(args.out, ply, cams_path, device, card)

    # phase 6: the training path on the fixture
    train_counts = train_fixture(args.out, device, card)

    # phase 6b: the kernels against the plain versions inside training
    train_kernels_vs_plain(device, card)

    # phase 7: training at the two training shapes
    train_at_scale(args.out, ply, cams_path, device, card, "1080p/300k")
    small_ply, small_cams = write_full_scene(args.out, n=SMALL_N, W=SMALL_W, H=SMALL_H,
                                             name="small")
    train_at_scale(args.out, small_ply, small_cams, device, card, "512/100k")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": render_counts[name] + train_counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, replaces) in KERNELS.items()
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
