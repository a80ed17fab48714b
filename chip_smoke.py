#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gaustudio_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --ab PARENT    # K1-K6 of two checkouts, in turns

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card: its name and power limit (nvidia-smi); TF32 off; whether PIL
   imports (else images decode through the port's stdlib PNG reader);
2. build: the CUDA kernels of gaustudio_torch/csrc, compiled with nvcc at
   first use, one nvcc per source (build seconds and ptxas register counts);
3. kernels: each kernel (K1 duplicate_with_keys, K2 identify_tile_ranges,
   K3 render_tiles, K4 render_tiles_backward; K1 without the cull, K5
   render_surfel_tiles and K6 render_surfel_tiles_backward) against its plain
   PyTorch version on the card, on a mini_scene view (vanilla, and the same
   model as 2DGS surfels) and on one 1920x1080 view of a 300k-Gaussian
   SH-3 model (K1-K4) and of a 200k-surfel SH-3 model (K1, K2, K5, K6), with
   the tolerances stated below; then each kernel's time against its plain
   version's (and, for K2, torch.searchsorted's) at the 1080p shapes (K1, K2
   and torch.searchsorted on the device by torch.profiler, K1 over every op
   of its wrapper, with the host time of a call beside it; the others by
   CUDA events), and the time of the torch-op stages (activations +
   preprocess, the sort); then K1-K6 on the hard cases (hard_case: one
   Gaussian or surfel in every tile, warps that end far apart, more than
   256 entries a pixel, a ragged image whose bottom tiles hold an odd number
   of rows), K1 in both modes on its own (k1_case: a full-screen primitive
   among thousands of small ones, 1, 31 and 33 primitives, rows with no
   tiles inside a warp, a view where the cull keeps nothing) and K2 on empty
   and single-entry tiles;
4. render path on the fixture: gs-render on tests/fixtures/mini_scene, and
   the renderer's PSNR against GOLDEN.json (within 0.15 dB);
5. render path at full width: gs-render of the 300k model from three
   1920x1080 cameras, with the launch counts of that run, the lit-fraction
   guard, rasterize() timed warm against the plain path, and the device's
   busy share of a warm render;
6. training path on the fixture: gs-train for 1000 iterations from the
   fixture's sparse points (densification at 600-1000), with the launch
   counts of that run, and the PSNR of the exported model against that of
   the initial point cloud (at least 3 dB better);
6b. training with the kernels against training with the plain versions:
   30 steps from the fixture's model, one camera sequence, final PSNR
   within 0.1 dB;
7. training at full width: 30 steps and one densify at 1920x1080 / 300k /
   SH 3 and at 512x512 / 100k, with ms per iteration, the device's busy
   share of a step and a breakdown;
8. 2DGS render path at full width: gs-render --config 2dgs of the 200k-surfel
   model from three 1920x1080 cameras, with the launch counts, the lit
   fraction (alpha > 0.01), rasterize_surfels() timed warm against the
   plain path, and the device's busy share of a warm render;
9. 2DGS training path on the fixture: gs-train --config 2dgs from the
   fixture's sparse points as in phase 6, with the launch counts, a
   2-column scale export and the exported model's PSNR against that of the
   initial point cloud (at least 2 dB better);
9b. 2DGS training with the kernels against the plain versions: 12 steps,
   one camera sequence, final PSNR within 0.1 dB;
10. 2DGS training at 512x512 / 60k surfels: 30 steps and one densify, with
   ms per iteration, the device's busy share of a step and a breakdown.

Each path (phases 4, 5, 6, 8 and 9) is driven with every launch count set to
0 just before it and read just after; a kernel of the path that was not
launched fails the run. The report's ``launches`` sums the counts of the
render and training paths (phases 5, 6, 8 and 9). The last two lines are
{"kernels": [...]} and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device. Imports no jax
and nothing of the JAX package or its benchmark scripts.

``--ab PARENT`` runs none of the phases: it times K1 with the cull, K2, K3
and K4 at 1080p/300k and K1 without the cull, K5 and K6 at 1080p/200k
surfels (K1 by the device time of every op of its wrapper and by host time
per call) through the gaustudio_torch of the checkout at PARENT and of this
one, in turns (parent, this, this, parent), each in a process of its own
(``--time-backward --tree DIR``, which prints the times as one JSON line),
and prints each ratio.
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
# K5 and K6 are held to K3's and K4's tolerances, for the same reasons: the
# intersection and alpha are one unfused helper (gs_surfel_hit in common.cuh).
SURFEL_N = 200_000  # bench_all.py bench_surfel_render
SURFEL_TRAIN_W = SURFEL_TRAIN_H = 512  # bench_all.py bench_surfel_train_step
SURFEL_TRAIN_N = 60_000
SURFEL_FIXTURE_GAIN_DB = 2.0  # tests/test_train_surfel.py:86
SURFEL_CONFIG = {"name": "vanilla_pcd", "attributes": {
    "xyz": 3, "opacity": 1, "f_dc": 3, "f_rest": 45, "scale": 2, "rot": 4}}

# The bound of a kernel: the larger of the bytes its function must move (each
# input read once, each output written once) over the memory rate, and its
# float32 operations over the float32 peak outside the tensor cores, for one
# H100 SXM (NVIDIA's data sheet, dense f32 rate). Operations per unit of
# work are counted from the sources: K1 ~79 per (Gaussian, rect tile) and
# pass in tile_max_alpha_keep; K2 1 compare per entry; per (entry, pixel)
# pair a pixel evaluates, K3 ~20 (power, exp, alpha, tests, blend), K4 ~60,
# K5 ~45 (gs_surfel_hit ~33, the tests and the 13-value blend) and K6 ~110
# (the hit and the VJP of the intersection).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS = {"duplicate_with_keys": 79, "identify_tile_ranges": 1, "render_tiles": 20,
       "render_tiles_backward": 60, "render_surfel_tiles": 45,
       "render_surfel_tiles_backward": 110}

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
    "render_surfel_tiles": ("gaustudio_torch/csrc/composite_surfel.cu",
                            "gaustudio_tpu/ops/rasterize_surfel_pallas.py:409"),
    "render_surfel_tiles_backward": ("gaustudio_torch/csrc/composite_surfel_bwd.cu",
                                     "gaustudio_tpu/ops/rasterize_surfel_pallas_bwd.py:57 (B8), "
                                     "gaustudio_tpu/ops/rasterize_pallas_bwd.py:451 (B5)"),
}
# K1's kernels by name, of this design and of the one before it (so that
# --ab can print a parent's by-name time too)
K1_KERNEL_NAMES = ("count_entries_kernel", "scan_warp_counts_kernel", "write_entries_kernel",
                   "count_tiles_kernel", "write_keys_kernel")
FORWARD = ("duplicate_with_keys", "identify_tile_ranges", "render_tiles")
SURFEL_FORWARD = ("duplicate_with_keys", "identify_tile_ranges", "render_surfel_tiles")


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


def scene_cameras(W: int, H: int) -> list:
    """cameras.json entries of three WxH views: bench.py's camera
    (tan(fov_x/2) = 0.85) yawed by -0.02, 0 and +0.02 rad."""
    focal = W / (2.0 * 0.85)
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
    return cams


def write_scene(out_dir: str, params: dict, W: int, H: int, name: str,
                config=None) -> tuple[str, str]:
    """A PLY of the raw attributes ``params`` (written from the host) and a
    cameras.json of the three views of scene_cameras."""
    from gaustudio_torch.models.vanilla import VanillaPointCloud

    ply = os.path.join(out_dir, f"{name}_scene.ply")
    VanillaPointCloud.from_jax_params(params, device="cpu", config=config).export(ply)
    cams_path = os.path.join(out_dir, f"{name}_cameras.json")
    with open(cams_path, "w") as f:
        json.dump(scene_cameras(W, H), f)
    return ply, cams_path


def _sh3(colors: np.ndarray, seed: int) -> dict:
    """SH degree-3 attributes: the base colour as band 0, seeded bands 1-3."""
    from gaustudio_torch.ops.sh import RGB2SH

    rng = np.random.default_rng(seed + 1)
    return {"f_dc": RGB2SH(colors),
            "f_rest": (rng.normal(size=(colors.shape[0], 45)) * 0.05).astype(np.float32)}


def make_scene(n: int = FULL_N, seed: int = 0):
    """(xyz, scales, quats, opacities, colours) of n Gaussians with realistic
    screen coverage at 1080p: the port's copy of bench.py make_scene, the same
    seeded draws in the same order, so the scenes are the JAX benchmark's."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.normal(size=n) * 1.1
    xyz[:, 1] = rng.normal(size=n) * 0.65
    xyz[:, 2] = rng.uniform(0.8, 6.0, n)
    scales = (np.exp(rng.normal(size=(n, 3)) * 0.4) * 0.008).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return xyz, scales, quats, opac, colors


def full_scene_params(n: int = FULL_N, seed: int = 0) -> dict:
    """The raw attributes of an n-point SH-degree-3 vanilla scene: geometry,
    opacity and base colour from make_scene, the higher SH bands seeded noise."""
    xyz, scales, quats, opac, colors = make_scene(n, seed=seed)
    return {"xyz": xyz, "opacity": np.log(opac / (1.0 - opac))[:, None], **_sh3(colors, seed),
            "scale": np.log(scales), "rot": quats}


def write_full_scene(out_dir: str, seed: int = 0, n: int = FULL_N, W: int = FULL_W,
                     H: int = FULL_H, name: str = "full") -> tuple[str, str]:
    """The PLY of full_scene_params and the cameras of write_scene."""
    return write_scene(out_dir, full_scene_params(n, seed), W, H, name)


def surfel_scene_params(n: int = SURFEL_N, seed: int = 0) -> dict:
    """The raw attributes of an n-surfel SH-degree-3 2DGS scene from the
    generator of bench_all.py bench_surfel_render (2-column scales), with
    seeded SH bands 1-3 as full_scene_params seeds them."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.normal(size=n) * 1.1
    xyz[:, 1] = rng.normal(size=n) * 0.65
    xyz[:, 2] = rng.uniform(0.8, 6.0, n)
    scales = (np.exp(rng.normal(size=(n, 2)) * 0.4) * 0.01).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return {"xyz": xyz, "opacity": np.log(opac / (1.0 - opac))[:, None], **_sh3(colors, seed),
            "scale": np.log(scales), "rot": quats}


def write_surfel_scene(out_dir: str, seed: int = 0, n: int = SURFEL_N, W: int = FULL_W,
                       H: int = FULL_H, name: str = "surfel") -> tuple[str, str]:
    """The PLY of surfel_scene_params and the cameras of write_scene."""
    return write_scene(out_dir, surfel_scene_params(n, seed), W, H, name, config=SURFEL_CONFIG)


def write_surfel_train_scene(out_dir: str, seed: int = 0, n: int = SURFEL_TRAIN_N,
                             W: int = SURFEL_TRAIN_W, H: int = SURFEL_TRAIN_H,
                             name: str = "surfel_train") -> tuple[str, str]:
    """bench_all.py's _train_scene(n, two_d=True): camera-facing surfels of
    log-scale -4.6, opacity 0.1, SH degree 0 of uniform colours."""
    from gaustudio_torch.ops.sh import RGB2SH

    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.normal(size=n) * 0.8
    xyz[:, 1] = rng.normal(size=n) * 0.6
    xyz[:, 2] = rng.uniform(1.2, 5.0, n)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    return write_scene(out_dir, {
        "xyz": xyz, "opacity": np.full((n, 1), math.log(0.1 / 0.9), np.float32),
        "f_dc": RGB2SH(rng.uniform(size=(n, 3)).astype(np.float32)),
        "f_rest": np.zeros((n, 45), np.float32), "scale": np.full((n, 2), -4.6, np.float32),
        "rot": rot}, W, H, name, config=SURFEL_CONFIG)


def load_model(ply: str, sh: int, device, config=None):
    from gaustudio_torch import models

    pcd = models.make(config or {"name": "vanilla_pcd"}, device=device)
    pcd.load(ply)
    pcd.active_sh_degree = sh
    return pcd


def load_cameras(path: str, device):
    from gaustudio_torch.datasets.utils import JSON_to_camera

    with open(path) as f:
        return [JSON_to_camera(cj, device=device) for cj in json.load(f)]


def view_preprocess(renderer, cam, pcd):
    """The Preprocessed of one view, exactly as rasterize() computes it."""
    from gaustudio_torch.ops import gaussian

    xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
    st = renderer.make_settings(cam, pcd, xyz.device)
    return gaussian.preprocess(
        xyz, opacity.reshape(-1), st.viewmatrix, st.projmatrix, st.campos,
        st.image_width, st.image_height, st.tanfovx, st.tanfovy, shs=shs,
        sh_degree=pcd.active_sh_degree, scales=scales, rotations=rotations)


def view_preprocess_surfel(renderer, cam, pcd):
    """The SurfelPre of one view, exactly as rasterize_surfels() computes it."""
    from gaustudio_torch.ops import rasterize_surfel

    xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
    st = renderer.make_settings(cam, pcd, xyz.device)
    return rasterize_surfel.preprocess_surfel(
        xyz, opacity, st.viewmatrix, st.projmatrix, st.campos, st.image_width,
        st.image_height, scales=scales, rotations=rotations, shs=shs,
        sh_degree=pcd.active_sh_degree)


# --- phase 3: kernels against their plain versions ----------------------


def compare_kernels(pre, W: int, H: int) -> dict:
    """Each kernel against its plain version on the same inputs; returns
    {kernel: max abs error} and raises on a disagreement."""
    from gaustudio_torch.ops import binning, composite

    gx, gy = (W + 15) // 16, (H + 15) // 16
    k1_err, keys, gids = compare_k1(pre, gx, True, f"{W}x{H}")
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
    check(k2_err == 0, "K2 disagrees with its plain version")
    check(int_mismatch == 0, "K3 median id / n_contrib disagree with the plain version")
    return {"duplicate_with_keys": k1_err, "identify_tile_ranges": k2_err, "render_tiles": k3_err}


def backward_args(pre, W: int, H: int, seed: int) -> tuple:
    """K4's arguments on one vanilla view: the kernels' binning and forward,
    seeded random cotangents on colour, depth, final T and median depth, and
    a nonzero bg."""
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
    return (b.ranges, b.point_list, pre.means2d, pre.conic, pre.opacities, pre.colors,
            pre.depths, bg, fwd.final_T, fwd.n_contrib, *cts, gx, gy, W, H)


def compare_backward(pre, W: int, H: int, seed: int):
    """K4 against its plain version on the arguments of backward_args.
    Returns (max abs error, the arguments)."""
    from gaustudio_torch.ops import composite

    args = backward_args(pre, W, H, seed)
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


def _named(key: str, names) -> bool:
    return names is None or any(n in key for n in names)


def device_us_by_op(fn, iters: int = 20, names=None) -> dict:
    """{CUDA kernel or copy: mean device microseconds per call of ``fn``},
    from torch.profiler over ``iters`` warm calls. On the card the profiler
    can return a window without the kernels' events: a window with no
    device time in an op named by one of ``names`` (in any op with None) is
    taken again, three windows at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ops = {ev.key: float(getattr(ev, "self_device_time_total", None)
                             or getattr(ev, "self_cuda_time_total", 0.0)) / iters
               for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
        if any(us > 0 and _named(key, names) for key, us in ops.items()):
            break
    return ops


def device_ms(fn, names=None, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn`` in the CUDA kernels whose
    names hold one of ``names`` (every kernel and copy with None), from
    torch.profiler over ``iters`` warm calls; raises where the profiler
    recorded no device time for them."""
    us = sum(t for key, t in device_us_by_op(fn, iters, names).items() if _named(key, names))
    check(us > 0, f"torch.profiler recorded no device time for the kernels {names}")
    return us / 1e3


def k1_breakdown(fn) -> tuple[float, str]:
    """(device ms of K1's kernels by name, each op's device microseconds per
    call) of one profiled window of ``fn``, which calls K1's wrapper."""
    ops = device_us_by_op(fn, names=K1_KERNEL_NAMES)
    named = sum(us for key, us in ops.items() if _named(key, K1_KERNEL_NAMES))
    check(named > 0, f"torch.profiler recorded no device time for the kernels {K1_KERNEL_NAMES}")
    return named / 1e3, ", ".join(f"{key.split('(')[0].replace('void ', '').strip()} {us:.2f}"
                                  for key, us in ops.items())


def host_us(fn, iters: int = 20) -> float:
    """Host microseconds per call of ``fn`` (the enqueue, and any wait of its own)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def busy_share(tag: str, fn, wall_s: float, card: str) -> None:
    """Prints the device's busy share of one warm call of ``fn``: the device
    time of every kernel and copy that torch.profiler records in it (mean of
    5 calls) over ``wall_s``, the call's host-clock wall unprofiled (the mean
    or median of the calls already timed)."""
    busy = device_ms(fn, iters=5)
    say("time", f"{tag}: device busy {busy:.4f} ms of {wall_s * 1e3:.4f} ms wall per call, "
        f"busy share {busy / (wall_s * 1e3):.4f} (torch.profiler) | {card}")


def time_kernels(pre, W: int, H: int, card: str, preprocess) -> dict:
    """{kernel: (ms, plain_ms[, library_ms])} at the shapes of one view; also
    prints the time of the stages of rasterize() that are torch ops
    (``preprocess`` is the call that made ``pre``).

    K1, K2 and K2's yardstick torch.searchsorted move ~10 MB a call, less
    device time than their wrappers take on the host, so CUDA events around
    back-to-back calls would time the host. K1's ms is the device time of
    every kernel and copy its wrapper launches (its two kernels and the
    read-back of the entry count; the kernels by name are printed too), K2's
    and torch.searchsorted's that of their kernels by name, each printed
    beside the host microseconds per wrapper call. K3's ms is from CUDA
    events."""
    from gaustudio_torch.ops import binning, composite

    with torch.inference_mode():
        preprocess_ms = cuda_ms(preprocess, 20)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    keys, gids = binning.duplicate_with_keys(pre, gx)
    sorted_keys, order = torch.sort(keys, stable=True)
    ranges = binning.identify_tile_ranges(sorted_keys, gx * gy)
    args = (ranges, gids[order], pre.means2d, pre.conic, pre.opacities, pre.colors,
            pre.depths, gx, gy, W, H)
    # K2's library yardstick: one torch.searchsorted of every tile's first key
    bounds = torch.arange(gx * gy + 1, dtype=torch.int64, device=keys.device) << 32
    calls = {
        "duplicate_with_keys": (lambda: binning.duplicate_with_keys(pre, gx), None),
        "identify_tile_ranges": (lambda: binning.identify_tile_ranges(sorted_keys, gx * gy),
                                 ("identify_tile_ranges_kernel",)),
        "torch.searchsorted": (lambda: torch.searchsorted(sorted_keys, bounds), ("searchsorted",)),
    }
    dev = {name: (device_ms(fn, names), host_us(fn)) for name, (fn, names) in calls.items()}
    for name, (ms, us) in dev.items():
        say("time", f"{name} {W}x{H}: device {ms:.4f} ms (torch.profiler), host {us:.1f} us "
            f"per call | {card}")
    named_ms, by_op = k1_breakdown(calls["duplicate_with_keys"][0])
    say("time", f"duplicate_with_keys {W}x{H}: its kernels by name {named_ms:.4f} ms of the "
        f"{dev['duplicate_with_keys'][0]:.4f} ms of every op; us per call by op: {by_op} "
        f"(torch.profiler) | {card}")
    k2, lib = dev["identify_tile_ranges"][0], dev["torch.searchsorted"][0]
    say("time", f"identify_tile_ranges on the device: {k2 / lib:.3f}x torch.searchsorted's time "
        f"({'slower' if k2 > lib else 'no slower'}) | {card}")
    times = {
        "duplicate_with_keys": (dev["duplicate_with_keys"][0],
                                cuda_ms(lambda: binning.duplicate_with_keys_plain(pre, gx), 5)),
        "identify_tile_ranges": (
            k2, cuda_ms(lambda: binning.identify_tile_ranges_plain(sorted_keys, gx * gy), 5), lib),
        "render_tiles": (
            cuda_ms(lambda: composite.render_tiles(*args), 20),
            cuda_ms(lambda: composite.render_tiles_plain(*args), 3)),
    }
    sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), 20)
    for name, (ms, plain_ms, *_) in times.items():
        say("time", f"{name} {W}x{H}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms | {card}")
    say("time", f"torch.sort of {keys.shape[0]} keys: {sort_ms:.4f} ms | {card}")
    say("time", f"activations + preprocess {W}x{H}: {preprocess_ms:.4f} ms | {card}")
    return times


def surfel_args(pre, W: int, H: int, seed: int) -> tuple:
    """(binning, K5's arguments, K5's output, K6's arguments) of one surfel
    view: the kernels' binning without the cull and forward, and seeded random
    cotangents on every differentiable output."""
    from gaustudio_torch.ops import binning, composite_surfel, rasterize_surfel

    gx, gy = (W + 15) // 16, (H + 15) // 16
    device = pre.depths.device
    b = binning.bin_gaussians(rasterize_surfel.binning_input(pre), gx, gy, cull=False)
    fwd_args = (b.ranges, b.point_list, pre.M, pre.Dk, pre.mean2d, pre.opacities, pre.colors,
                pre.normal_view, gx, gy, W, H)
    out = composite_surfel.render_surfel_tiles(*fwd_args)
    gen = torch.Generator(device=device).manual_seed(seed)
    cts = [torch.randn(shape, generator=gen, device=device)
           for shape in ((3, H, W), (H, W), (H, W), (3, H, W), (H, W), (H, W))]
    bwd_args = fwd_args[:8] + (out.final_T, out.n_contrib, *cts) + fwd_args[8:]
    return b, fwd_args, out, bwd_args


def compare_surfel_kernels(pre, W: int, H: int, seed: int):
    """K1 without the cull, K5 and K6 against their plain versions on one
    surfel view (K6 with seeded random cotangents on every differentiable
    output). Returns ({kernel: max abs error}, K5's arguments, K6's
    arguments)."""
    from gaustudio_torch.ops import composite_surfel, rasterize_surfel

    k1_err, _, _ = compare_k1(rasterize_surfel.binning_input(pre), (W + 15) // 16, False,
                              f"{W}x{H} surfels")
    b, fwd_args, out, bwd_args = surfel_args(pre, W, H, seed)
    check(b.num_rendered == int(pre.tiles_touched.sum()),
          "K1 without the cull dropped entries of the rects")
    out_p = composite_surfel.render_surfel_tiles_plain(*fwd_args)
    torch.cuda.synchronize()
    k5_err, int_mismatch = 0.0, 0
    for name, a, ref in zip(out._fields, out, out_p):
        if a.dtype == torch.int32:
            int_mismatch += int((a != ref).sum())
        else:
            check(torch.isfinite(a).all(), f"K5 {name}: non-finite values")
            k5_err = max(k5_err, float((a - ref).abs().max()))
            torch.testing.assert_close(a, ref, atol=K3_ATOL, rtol=K3_RTOL, msg=f"K5 {name}")
    check(int_mismatch == 0, "K5 median id / n_contrib disagree with the plain version")

    got = composite_surfel.render_surfel_tiles_backward(*bwd_args)
    want = composite_surfel.render_surfel_tiles_backward_plain(*bwd_args)
    torch.cuda.synchronize()
    k6_err, scaled = 0.0, {}
    for name, a, ref in zip(got._fields, got, want):
        check(torch.isfinite(a).all(), f"K6 d_{name}: non-finite values")
        scale = float(ref.abs().max()) + 1e-6
        k6_err = max(k6_err, float((a - ref).abs().max()))
        scaled[name] = float((a - ref).abs().max()) / scale
        torch.testing.assert_close(a / scale, ref / scale, rtol=K4_RTOL, atol=K4_ATOL,
                                   msg=f"K6 d_{name} (scaled by {scale:.4g})")
    say("kernels", f"{W}x{H} surfels: num_rendered {b.num_rendered} ({pre.depths.shape[0]} "
        f"surfels, max {int((b.ranges[:, 1] - b.ranges[:, 0]).max())} per tile); K1 (no cull) "
        f"max|err| {k1_err}; K5 max|err| {k5_err:.3e} (tol {K3_ATOL:g} + {K3_RTOL:g}*|x|), "
        f"int mismatches {int_mismatch}; K6 max|err| {k6_err:.3e}, scaled by the plain "
        "max|value| " + ", ".join(f"d_{k} {v:.3e}" for k, v in scaled.items())
        + f" (tol rtol {K4_RTOL:g}, atol {K4_ATOL:g} on scaled values)")
    return ({"duplicate_with_keys": k1_err, "render_surfel_tiles": k5_err,
             "render_surfel_tiles_backward": k6_err}, fwd_args, bwd_args)


# --- phase 3: hard cases of K2-K6 -----------------------------------------

HARD_CASES = ("hot", "warp_skip", "multi_batch", "ragged")


def hard_case(name: str, device, surfel: bool = False):
    """(pre, W, H) of one seeded view that stresses one part of the
    compositors (K3 and K4; K5 and K6 with ``surfel``: the same primitives as
    camera-facing surfels), the camera at the origin looking down +z
    (tan(fov/2) = 0.7):

    * hot: one broad primitive (index 0) in front of 400 small ones on a
      160x128 view; it lies in every tile, so every tile adds into its row;
    * warp_skip: one 16x16 tile; a broad faint primitive in front of 150 tiny
      ones on the top two pixel rows, so the top warps walk ~150 positions
      and the bottom warps one;
    * multi_batch: 1500 faint primitives on a 32x32 view, so pixels apply more
      than 256 entries: several staged batches and flushes per tile;
    * ragged: 600 primitives over a 150x117 view, whose right tiles hold 6
      columns and bottom tiles 5 rows of the image: the second pixel of a
      thread's pair lies below the image there.
    """
    from gaustudio_torch.ops import gaussian, rasterize_surfel

    rng = np.random.default_rng(HARD_CASES.index(name) + 11)
    if name == "hot":
        W, H, n = 160, 128, 400
        px, py = np.r_[W / 2, rng.uniform(0, W, n)], np.r_[H / 2, rng.uniform(0, H, n)]
        z, size = np.r_[1.5, rng.uniform(2.0, 5.0, n)], np.r_[0.8, rng.uniform(0.02, 0.05, n)]
        op = np.r_[0.5, rng.uniform(0.3, 0.9, n)]
    elif name == "warp_skip":
        W = H = 16
        n = 150
        px, py = np.r_[7.5, rng.uniform(0, 16, n)], np.r_[7.5, rng.uniform(0, 1, n)]
        z, size = np.r_[1.0, rng.uniform(2.0, 3.0, n)], np.r_[1.0, np.full(n, 0.003)]
        op = np.r_[0.2, rng.uniform(0.5, 0.9, n)]
    elif name == "multi_batch":
        W = H = 32
        n = 1500
        px, py = rng.uniform(0, W, n), rng.uniform(0, H, n)
        z, size, op = rng.uniform(2.0, 4.0, n), np.full(n, 0.7), rng.uniform(0.01, 0.03, n)
    elif name == "ragged":
        W, H, n = 150, 117, 600
        px, py = rng.uniform(0, W, n), rng.uniform(0, H, n)
        z, size, op = rng.uniform(2.0, 5.0, n), rng.uniform(0.02, 0.08, n), rng.uniform(0.3, 0.9, n)
    else:
        raise ValueError(f"unknown hard case {name!r}")
    tan = 0.7
    # world points at depth z that project onto the pixel centres (px, py)
    xyz = np.stack([((2 * px + 1) / W - 1) * tan * z, ((2 * py + 1) / H - 1) * tan * z, z], 1)
    scales = np.repeat(size[:, None], 2 if surfel else 3, 1)
    quats = np.zeros((len(z), 4))
    quats[:, 0] = 1.0  # surfels face the camera
    colors = rng.uniform(0, 1, (len(z), 3))
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1 / tan
    P[2, 2] = 100 / (100 - 0.01)
    P[2, 3] = -(100 * 0.01) / (100 - 0.01)
    P[3, 2] = 1.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    view, proj, campos = t(np.eye(4)), t(P.T), torch.zeros(3, device=device)
    if surfel:
        pre = rasterize_surfel.preprocess_surfel(
            t(xyz), t(op), view, proj, campos, W, H, scales=t(scales), rotations=t(quats),
            colors_precomp=t(colors))
    else:
        pre = gaussian.preprocess(t(xyz), t(op), view, proj, campos, W, H, tan, tan,
                                  colors_precomp=t(colors), scales=t(scales), rotations=t(quats))
    return pre, W, H


def check_hard_case(name: str, ranges, point_list, n_contrib, W: int, H: int) -> str:
    """Raises unless the binning and forward of a hard case stress what the
    case is for; returns a summary line."""
    from gaustudio_torch.ops.composite import image_to_tiles

    gx, gy = (W + 15) // 16, (H + 15) // 16
    warp_last = image_to_tiles(n_contrib, gx, gy).reshape(gx * gy, 8, 32).max(dim=-1).values
    spread = int((warp_last.max(dim=1).values - warp_last.min(dim=1).values).max())
    hot_tiles = int((point_list == 0).sum())
    most = int((ranges[:, 1] - ranges[:, 0]).max())
    nc_max = int(n_contrib.max())
    if name == "hot":
        check(hot_tiles == gx * gy, f"hot: entry 0 lies in {hot_tiles} of {gx * gy} tiles")
    elif name == "warp_skip":
        check(spread >= 100, f"warp_skip: the warps' largest n_contrib differ by {spread} < 100")
    elif name == "multi_batch":
        check(nc_max > 256, f"multi_batch: largest n_contrib {nc_max} <= 256")
    else:
        lit_edge = int((n_contrib[H - 1] > 0).sum()) + int((n_contrib[:, W - 1] > 0).sum())
        check((H % 16) % 2 == 1 and W % 16 != 0 and lit_edge > 0,
              f"ragged: {W}x{H} (bottom tiles hold {H % 16} rows), {lit_edge} lit pixels on the "
              "last row and column")
    return (f"{W}x{H}, {gx * gy} tiles, entry 0 in {hot_tiles} tiles, largest run {most}, "
            f"largest n_contrib {nc_max}, largest spread of a tile's warp maxima {spread}")


def k2_cases(device) -> dict:
    """name -> (sorted keys, number of tiles) with empty first, interior and
    last tiles, and single entries."""
    def keys(tiles):
        tiles = torch.tensor(tiles, dtype=torch.int64, device=device)
        return (tiles << 32) | torch.arange(tiles.shape[0], device=device)

    return {"empty first, interior and last tiles": (keys([2, 2, 3, 5, 5, 5, 9]), 12),
            "single entry": (keys([7]), 12), "single entry in the first tile": (keys([0]), 12),
            "single entry in the last tile": (keys([11]), 12),
            "one full tile": (keys([4] * 300), 12)}


K1_CASES = ("full_screen", "n1", "n31", "n33", "zero_tile_rows", "all_culled")


def k1_case_arrays(name: str, W: int = FULL_W, H: int = FULL_H) -> dict:
    """The fields of a Preprocessed, as float32 / int32 / bool numpy arrays
    (seeded), of a view that stresses K1's warp walk, with K1 in both modes
    held to its plain version on it:

    * full_screen: one primitive (index n // 4) whose rect is the whole grid
      (8160 tiles at 1920x1080), the tiles at its rim culled, among small
      ones (4000 on a view above 512x512, else 200);
    * n1, n31, n33: 1, 31 and 33 primitives, so that the only or last warp
      is ragged, with rects up to ~16 tiles wide;
    * zero_tile_rows: every third row and one whole warp (rows 64-95) have
      tiles_touched 0, valid False and a rect of garbage (its min past its
      max), which the walk must never decode;
    * all_culled: every opacity below 1/255, so the cull keeps nothing
      (L = 0), while without it every rect tile stays.
    """
    rng = np.random.default_rng(K1_CASES.index(name) + 41)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    n = {"n1": 1, "n31": 31, "n33": 33}.get(name, 4000 if W * H > 512 * 512 else 200)
    mx, my = rng.uniform(0, W, n), rng.uniform(0, H, n)
    radius = rng.uniform(2, 120 if n < 64 else 24, n)
    sx, sy = radius / 3 * rng.uniform(0.6, 1.0, n), radius / 3 * rng.uniform(0.6, 1.0, n)
    rho = rng.uniform(-0.5, 0.5, n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)  # the conic inverts [[sx^2, r sx sy], [r sx sy, sy^2]]
    conic = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det], 1)
    rect_min = np.stack([np.clip(np.floor((mx - radius) / 16), 0, gx),
                         np.clip(np.floor((my - radius) / 16), 0, gy)], 1)
    rect_max = np.stack([np.clip(np.floor((mx + radius + 15) / 16), 0, gx),
                         np.clip(np.floor((my + radius + 15) / 16), 0, gy)], 1)
    op = rng.uniform(0.02, 0.95, n)
    if name == "full_screen":
        i = n // 4
        mx[i], my[i], op[i] = W / 2, H / 2, 0.9
        # q ~ 16 at the corner tiles' inner corners, above the cull's
        # threshold 2 ln(0.9 x 255) = 10.9
        a = 16 / (max(W / 2 - 16, 1) ** 2 + max(H / 2 - 16, 1) ** 2)
        conic[i] = (a, 0.0, a)
        rect_min[i], rect_max[i] = (0, 0), (gx, gy)
    elif name == "all_culled":
        op = rng.uniform(0.0005, 0.0039, n)
    tiles = (rect_max - rect_min).prod(1)
    if name == "zero_tile_rows":
        zero = np.zeros(n, bool)
        zero[::3] = zero[64:96] = True
        tiles[zero] = 0
        rect_min[zero] = rng.integers(0, max(gx, gy), (int(zero.sum()), 2)) + 5
        rect_max[zero] = rect_min[zero] - rng.integers(1, 5, (int(zero.sum()), 2))
    f32, i32 = np.float32, np.int32
    return {"valid": tiles > 0, "depths": rng.uniform(0.5, 20.0, n).astype(f32),
            "means2d": np.stack([mx, my], 1).astype(f32), "conic": conic.astype(f32),
            "opacities": op.astype(f32), "colors": np.zeros((n, 3), f32),
            "radii": np.where(tiles > 0, np.ceil(radius), 0).astype(i32),
            "rect_min": rect_min.astype(i32), "rect_max": rect_max.astype(i32),
            "tiles_touched": tiles.astype(i32)}


def k1_case(name: str, device, W: int = FULL_W, H: int = FULL_H):
    """(Preprocessed, W, H) of k1_case_arrays on ``device``."""
    from gaustudio_torch.ops.gaussian import Preprocessed

    arrays = k1_case_arrays(name, W, H)
    return Preprocessed(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()}), W, H


def check_k1_case(name: str, pre, W: int, H: int, gids, entries_without_cull: int) -> None:
    """Raises unless a case of k1_case stresses what it is for; ``gids`` are
    K1's indices with the cull, ``entries_without_cull`` its entry count
    without."""
    tiles, n = pre.tiles_touched, pre.tiles_touched.shape[0]
    if name == "full_screen":
        i, full = n // 4, ((W + 15) // 16) * ((H + 15) // 16)
        kept = int((gids == i).sum())
        check(int(tiles[i]) == full and 0 < kept < full,
              f"full_screen: primitive {i} has {int(tiles[i])} rect tiles of {full}, "
              f"{kept} kept by the cull")
    elif name in ("n1", "n31", "n33"):
        check(n == int(name[1:]), f"{name}: {n} primitives")
    elif name == "zero_tile_rows":
        zero = tiles == 0
        check(bool(zero[64:96].all()) and 0 < int(zero[:32].sum()) < 32
              and bool((pre.rect_min[zero] > pre.rect_max[zero]).all()),
              "zero_tile_rows: no warp with both kinds of rows, or no warp of zero rows, "
              "or a zero row with an ordered rect")
    elif name == "all_culled":
        check(gids.shape[0] == 0 and entries_without_cull > 0,
              f"all_culled: {gids.shape[0]} entries kept, {entries_without_cull} without the cull")


def compare_k1(pre, grid_x: int, cull: bool, what: str) -> tuple:
    """K1 against its plain version on ``pre``; raises unless keys and
    indices are equal element for element. Returns (max abs error, the
    kernel's keys, its indices)."""
    from gaustudio_torch.ops import binning

    keys, gids = binning.duplicate_with_keys(pre, grid_x, cull)
    keys_p, gids_p = binning.duplicate_with_keys_plain(pre, grid_x, cull)
    mode = "" if cull else " (no cull)"
    check(keys.shape == keys_p.shape and gids.shape == gids_p.shape,
          f"K1{mode} {what}: entry count {keys.shape[0]} != plain {keys_p.shape[0]}")
    err = max(int((keys - keys_p).abs().max()), int((gids - gids_p).abs().max())) \
        if keys.numel() else 0
    check(err == 0, f"K1{mode} {what}: disagrees with its plain version (max|err| {err})")
    return err, keys, gids


def compare_hard_cases(device) -> dict:
    """K1-K4 against their plain versions on the hard cases, K1 without the
    cull, K5 and K6 on their surfel forms, K1 in both modes on the cases of
    k1_case and K2 on those of k2_cases; returns {kernel: max abs error}."""
    from gaustudio_torch.ops import binning

    errs = {}
    for name in HARD_CASES:
        pre, W, H = hard_case(name, device)
        k_errs = compare_kernels(pre, W, H)
        k_errs["render_tiles_backward"], args = compare_backward(pre, W, H, seed=4)
        say("kernels", f"hard case {name}, K3 and K4: " + check_hard_case(
            name, args[0], args[1], args[9], W, H))
        pre, W, H = hard_case(name, device, surfel=True)
        surfel_errs, _, args = compare_surfel_kernels(pre, W, H, seed=5)
        say("kernels", f"hard case {name}, K5 and K6: " + check_hard_case(
            name, args[0], args[1], args[9], W, H))
        for k, err in {**k_errs, **surfel_errs}.items():
            errs[k] = max(errs.get(k, 0), err)
    for name in K1_CASES:
        pre, W, H = k1_case(name, device)
        gx = (W + 15) // 16
        entries, gids = [], None
        for cull in (True, False):
            err, keys, got = compare_k1(pre, gx, cull, f"case {name}")
            errs["duplicate_with_keys"] = max(errs.get("duplicate_with_keys", 0), err)
            entries.append(keys.shape[0])
            gids = got if cull else gids
        check_k1_case(name, pre, W, H, gids, entries[1])
        say("kernels", f"K1 case {name}: {pre.depths.shape[0]} primitives on {W}x{H}, largest "
            f"rect {int(pre.tiles_touched.max())} tiles, {int((pre.tiles_touched == 0).sum())} "
            f"with none; entries {entries[0]} with the cull, {entries[1]} without; "
            "max|err| 0 in both modes")
    for name, (keys, num_tiles) in k2_cases(device).items():
        got = binning.identify_tile_ranges(keys, num_tiles)
        want = binning.identify_tile_ranges_plain(keys, num_tiles)
        err = int((got - want).abs().max())
        say("kernels", f"K2 case {name}: max|err| {err}")
        check(err == 0, f"K2 disagrees with its plain version: {name}")
    return errs


def pairs_walked(ranges, final_T, n_contrib, W: int, H: int) -> tuple[int, int]:
    """(forward, backward) (entry, pixel) pairs this data needs a compositor
    to evaluate. Forward: a pixel whose final T >= 0.01 cannot have stopped
    (the stop needs T (1 - alpha) < 1e-4 with alpha <= 0.99), so it
    evaluates its tile's whole run; any other pixel at least its first
    n_contrib + 1 entries. Backward: each pixel's positions below n_contrib."""
    from gaustudio_torch.ops.composite import image_to_tiles

    gx, gy = (W + 15) // 16, (H + 15) // 16
    count = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    per_px = image_to_tiles(torch.ones((H, W), dtype=torch.int64, device=ranges.device), gx, gy)
    run = count[:, None] * per_px  # 0 past the image's edge
    nc = image_to_tiles(n_contrib.to(torch.int64), gx, gy)
    open_px = image_to_tiles(final_T, gx, gy) >= 0.01
    fwd = torch.where(open_px, run, torch.minimum(nc + 1, run))
    return int(fwd.sum()), int(nc.sum())


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vanilla_bounds(pre, W: int, H: int) -> dict:
    """{kernel: (bound ms, bound_by)} of K1-K4 on one vanilla view, for the
    inputs of this run (K4 with the forward's n_contrib)."""
    from gaustudio_torch.ops import binning, composite

    gx, gy = (W + 15) // 16, (H + 15) // 16
    n, T, P = pre.depths.shape[0], gx * gy, W * H
    b = binning.bin_gaussians(pre, gx, gy)
    L = b.num_rendered
    out = composite.render_tiles(b.ranges, b.point_list, pre.means2d, pre.conic, pre.opacities,
                                 pre.colors, pre.depths, gx, gy, W, H)
    fwd_pairs, bwd_pairs = pairs_walked(b.ranges, out.final_T, out.n_contrib, W, H)
    rect_tiles = int(((pre.rect_max - pre.rect_min).prod(dim=1) * (pre.tiles_touched > 0)).sum())
    gauss_in = n * 40  # means2d, conic, opacity, colour, depth
    return {
        # means2d, conic, opacity, rects, tiles, depth in; key + index out
        "duplicate_with_keys": bound_ms(n * 48 + L * 12,
                                        2 * OPS["duplicate_with_keys"] * rect_tiles),
        "identify_tile_ranges": bound_ms(L * 8 + T * 8, OPS["identify_tile_ranges"] * L),
        "render_tiles": bound_ms(T * 8 + L * 4 + gauss_in + P * 36,
                                 OPS["render_tiles"] * fwd_pairs),
        "render_tiles_backward": bound_ms(T * 8 + L * 4 + 2 * gauss_in + P * 32,
                                          OPS["render_tiles_backward"] * bwd_pairs),
    }


def surfel_bounds(bwd_args, W: int, H: int) -> dict:
    """{kernel: (bound ms, bound_by)} of K5 and K6 on one surfel view."""
    ranges, point_list, final_T, n_contrib = bwd_args[0], bwd_args[1], bwd_args[8], bwd_args[9]
    gx, gy = (W + 15) // 16, (H + 15) // 16
    n, T, P, L = bwd_args[5].shape[0], gx * gy, W * H, point_list.shape[0]
    fwd_pairs, bwd_pairs = pairs_walked(ranges, final_T, n_contrib, W, H)
    gauss_in = n * 84  # M, Dk, centre, opacity, colour, normal
    return {
        # 13 float outputs + 2 int outputs per pixel
        "render_surfel_tiles": bound_ms(T * 8 + L * 4 + gauss_in + P * 52,
                                        OPS["render_surfel_tiles"] * fwd_pairs),
        # final_T, n_contrib and 10 cotangent values per pixel; 21 sums per surfel
        "render_surfel_tiles_backward": bound_ms(T * 8 + L * 4 + 2 * gauss_in + P * 48,
                                                 OPS["render_surfel_tiles_backward"] * bwd_pairs),
    }


def time_surfel_kernels(pre, fwd_args, bwd_args, W: int, H: int, card: str) -> dict:
    """{kernel: (ms, plain_ms)} of K5 and K6 at the shapes of one view; also
    prints K1's time without the cull on the same view (the device time of
    every op of its wrapper, as time_kernels takes it with the cull, its
    kernels by name, its host time per call) beside its bound: the bytes of
    rects, tiles and depth read and of the entries written."""
    from gaustudio_torch.ops import binning, rasterize_surfel
    from gaustudio_torch.ops import composite_surfel as cs

    bin_in = rasterize_surfel.binning_input(pre)
    gx = (W + 15) // 16
    k1 = lambda: binning.duplicate_with_keys(bin_in, gx, cull=False)  # noqa: E731
    entries = k1()[0].shape[0]
    bound, by = bound_ms(bin_in.depths.shape[0] * 24 + entries * 12, 0)
    named_ms, by_op = k1_breakdown(k1)
    say("time", f"duplicate_with_keys without the cull {W}x{H} surfels ({entries} entries): "
        f"device {device_ms(k1):.4f} ms (torch.profiler, every op; its kernels by name "
        f"{named_ms:.4f} ms; us per call by op: {by_op}), "
        f"host {host_us(k1):.1f} us per call, bound {bound:.4f} ms ({by}); plain "
        f"{cuda_ms(lambda: binning.duplicate_with_keys_plain(bin_in, gx, cull=False), 5):.4f}"
        f" ms | {card}")

    times = {
        "render_surfel_tiles": (cuda_ms(lambda: cs.render_surfel_tiles(*fwd_args), 20),
                                cuda_ms(lambda: cs.render_surfel_tiles_plain(*fwd_args), 2)),
        "render_surfel_tiles_backward": (
            cuda_ms(lambda: cs.render_surfel_tiles_backward(*bwd_args), 20),
            cuda_ms(lambda: cs.render_surfel_tiles_backward_plain(*bwd_args), 2)),
    }
    for name, (ms, plain_ms) in times.items():
        say("time", f"{name} {W}x{H} ({fwd_args[1].shape[0]} entries): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms | {card}")
    return times


# --- phases 4 and 5: the main path ----------------------------------------


def _wrappers() -> dict:
    from gaustudio_torch.ops import binning, composite, composite_surfel

    return {"duplicate_with_keys": binning.duplicate_with_keys,
            "identify_tile_ranges": binning.identify_tile_ranges,
            "render_tiles": composite.render_tiles,
            "render_tiles_backward": composite.render_tiles_backward,
            "render_surfel_tiles": composite_surfel.render_surfel_tiles,
            "render_surfel_tiles_backward": composite_surfel.render_surfel_tiles_backward}


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
    cams = load_cameras(os.path.join(FIXTURE, "cameras.json"), device)
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
    cam = load_cameras(cams_path, device)[1]
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
        busy_share(f"rasterize {FULL_W}x{FULL_H} {FULL_N} pts SH3", lambda: run(st),
                   timings["kernels"], card)
    return counts


# --- phases 6, 6b and 7: the training path -------------------------------


def render_psnr(pcd, cams, device, renderer_name: str = "vanilla_renderer") -> list:
    """PSNR of the renderer's image of ``pcd`` against each camera's fixture
    image."""
    from gaustudio_torch import renderers
    from gaustudio_torch.utils.image import load_image

    renderer = renderers.make({"name": renderer_name}, device=device)
    got = []
    for cam in cams:
        out = renderer.render(cam, pcd)
        gt, _ = load_image(os.path.join(FIXTURE, "images", cam.image_name))
        got.append(psnr(out["render"].permute(1, 2, 0), torch.from_numpy(gt).to(device)))
    return got


def train_fixture(out_dir: str, device, card: str, surfel: bool = False) -> dict:
    """gs-train (``--config 2dgs`` with ``surfel``) on the fixture's views from
    its sparse points; returns the launch counts of the run."""
    from gaustudio_torch import models
    from gaustudio_torch.scripts import train as gs_train
    from gaustudio_torch.utils.ply import fetch_ply, read_ply

    tag = "2dgs" if surfel else "vanilla"
    src = os.path.join(out_dir, "train_src")
    out = os.path.join(out_dir, f"train_out_{tag}")
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
                             "--config", tag, "--device", device.type,
                             "--gpu", str(device.index or 0)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    last = history[-1]
    say("train", f"gs-train --config {tag} {FIXTURE_TRAIN_ITERS} iterations on mini_scene: "
        f"{wall:.2f} s wall; loss {last['loss']:.5f}, train PSNR {last['psnr']:.3f}; launches "
        f"{json.dumps(counts)} | {card}")
    path = (SURFEL_FORWARD + ("render_surfel_tiles_backward",) if surfel
            else FORWARD + ("render_tiles_backward",))
    check(all(counts[k] > 0 for k in path), f"a kernel was not launched: {counts}")
    check(math.isfinite(last["loss"]), f"non-finite loss {last['loss']}")

    cams = load_cameras(os.path.join(FIXTURE, "cameras.json"), device)
    xyz, rgb, _ = fetch_ply(sparse)
    config = SURFEL_CONFIG if surfel else None
    init = models.make(config or {"name": "vanilla_pcd"}, device=device)
    init.create_from_attribute(xyz=xyz, rgb=rgb)
    ply = os.path.join(out, "point_cloud", f"iteration_{FIXTURE_TRAIN_ITERS}", "point_cloud.ply")
    if surfel:
        scales = sorted(k for k in read_ply(ply)["vertex"] if k.startswith("scale"))
        say("train", f"2DGS export scale properties: {scales}")
        check(scales == ["scale_0", "scale_1"], f"2DGS export has scale properties {scales}")
    trained = load_model(ply, 1, device, config)  # SH degree 1 from iteration 1000
    check(trained.num_points != init.num_points,
          f"densification left the point count at {trained.num_points}")
    renderer = "surfel_renderer" if surfel else "vanilla_renderer"
    gain = SURFEL_FIXTURE_GAIN_DB if surfel else 3.0
    before = np.mean(render_psnr(init, cams, device, renderer))
    after = np.mean(render_psnr(trained, cams, device, renderer))
    say("train", f"{tag}: points {init.num_points} -> {trained.num_points}; mean PSNR over "
        f"{len(cams)} views: initial {before:.4f} dB, trained {after:.4f} dB (need +{gain:g})")
    check(after >= before + gain, f"{tag} training gained {after - before:.3f} dB < {gain} dB")
    return counts


def train_kernels_vs_plain(device, card: str, steps: int, surfel: bool = False) -> None:
    """The same training steps through the kernels and through the plain
    versions, from the fixture's model (its first two scale columns for
    ``surfel``): final mean PSNR within 0.1 dB."""
    from gaustudio_torch import datasets
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.pipelines import train_surfel as TS

    ds = datasets.make({"name": "vanilla", "source_path": FIXTURE})
    pcd = load_model(os.path.join(FIXTURE, "gaussians.ply"), 0, device)
    # the fixture-fit schedule of tools/make_fixture.py (no densify or reset)
    cfg = T.TrainConfig(iterations=steps, densify_from_iter=10 ** 9,
                        opacity_reset_interval=10 ** 9, sh_increase_interval=10 ** 9,
                        lr_xyz_init=0.0008, lr_xyz_final=0.00008, lr_xyz_max_steps=steps)
    if surfel:
        pcd._scale = pcd._scale[:, :2].contiguous()
        scfg = TS.SurfelTrainConfig(base=cfg)
        trainer = TS.SurfelTrainer(pcd, ds, scfg, device=device)
        step = lambda state, batch, settings: TS.train_step_surfel(state, batch, settings, scfg)  # noqa: E731
        render = TS.render_surfels_from_params
    else:
        trainer = T.Trainer(pcd, ds, cfg, device=device)
        step = lambda state, batch, settings: T.train_step(state, batch, settings, cfg)  # noqa: E731
        render = T.render_from_params
    tag = "2dgs" if surfel else "vanilla"
    batches = [trainer.batch(c) for c in trainer.cameras]
    order = np.random.default_rng(0).integers(len(batches), size=steps)
    kernel_settings = trainer.settings()
    final = {}
    for name, settings in (("kernels", kernel_settings),
                           ("plain", kernel_settings._replace(backend="plain"))):
        state = T.init_state(pcd, device)
        t0 = time.perf_counter()
        for i in order:
            state, metrics = step(state, batches[i], settings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.no_grad():
            scores = []
            for b in batches:
                s = kernel_settings._replace(viewmatrix=b.viewmatrix, projmatrix=b.projmatrix,
                                             campos=b.campos, bg=torch.zeros(3, device=device))
                out = render(state.params, state.active_sh_degree, s)
                scores.append(psnr(out["render"], b.gt_image))
        final[name] = (state, float(np.mean(scores)), wall)
        say("train", f"{tag}: {steps} steps from the fixture model with the {name} versions: "
            f"{wall:.2f} s, last loss {float(metrics['loss']):.5f}, mean PSNR "
            f"{final[name][1]:.4f} dB | {card}")
    diff = {k: float((final["kernels"][0].params[k] - final["plain"][0].params[k]).abs().max())
            for k in T.PARAMS}
    gap = final["kernels"][1] - final["plain"][1]
    say("train", f"{tag}: kernels - plain PSNR {gap:+.4f} dB (tol 0.1); largest parameter "
        "difference " + ", ".join(f"{k} {v:.3e}" for k, v in diff.items()))
    check(abs(gap) <= 0.1, f"{tag}: kernel and plain training differ by {gap:.4f} dB")


def step_breakdown(state, batch, settings, render, loss_fn, cfg) -> dict:
    """One training step's stages, each between CUDA events: the forward
    ``render`` (rasterize() or rasterize_surfels()), ``loss_fn(out, gt)``,
    backward (and, inside it, the compositor's backward node: K4 or K6 and
    its wrapper), Adam with the statistics."""
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.pipelines.optimizers.general import adam_update, exp_lr_schedule

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    device = batch.gt_image.device
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    ev[0].record()
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    offset = torch.zeros((state.num_points, 2), device=device, requires_grad=True)
    out = render(params, state.active_sh_degree, s, means2d_offset=offset)
    ev[1].record()
    node = out["render"].grad_fn  # the compositor's autograd node
    node.register_prehook(lambda grad_outputs: ev[5].record())
    node.register_hook(lambda grad_inputs, grad_outputs: ev[6].record())
    loss = loss_fn(out, batch.gt_image)
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
    names = ("forward", "loss", "backward", "Adam + statistics")
    times = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    times["compositor backward node inside backward"] = ev[5].elapsed_time(ev[6])
    return times


def train_at_scale(out_dir: str, ply: str, cams_path: str, device, card: str, label: str,
                   steps: int = 30, surfel: bool = False) -> None:
    """``steps`` training steps and one densify from a seeded jitter of a
    scene, against ground truth rendered from the scene with the kernels."""
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import ssim
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.pipelines import train_surfel as TS

    pcd = load_model(ply, 3, device, SURFEL_CONFIG if surfel else None)
    cams = load_cameras(cams_path, device)
    renderer = renderers.make({"name": "surfel_renderer" if surfel else "vanilla_renderer"},
                              device=device)
    for cam in cams:
        cam.image = renderer.render(cam, pcd)["render"].permute(1, 2, 0).clone()
    gen = torch.Generator(device=device).manual_seed(0)
    pcd._xyz = pcd._xyz + torch.randn(pcd._xyz.shape, generator=gen, device=device) * 0.004
    pcd._f_dc = pcd._f_dc + torch.randn(pcd._f_dc.shape, generator=gen, device=device) * 0.2

    class _Views(list):
        cameras_extent = 2.0

    cfg = T.TrainConfig(densify_grad_threshold=1e-5)
    zero_bg = torch.zeros(3, device=device)
    if surfel:
        scfg = TS.SurfelTrainConfig(base=cfg)
        trainer = TS.SurfelTrainer(pcd, _Views(cams), scfg, device=device)
        step = lambda state, batch: TS.train_step_surfel(state, batch, settings, scfg)  # noqa: E731
        render = TS.render_surfels_from_params
        loss_fn = lambda out, gt: TS.surfel_loss(out, gt, zero_bg, scfg)[0]  # noqa: E731
        backward_kernel = "render_surfel_tiles_backward"
    else:
        trainer = T.Trainer(pcd, _Views(cams), cfg, device=device)
        step = lambda state, batch: T.train_step(state, batch, settings, cfg)  # noqa: E731
        render = T.render_from_params
        loss_fn = lambda out, gt: ssim.rgb_loss(  # noqa: E731
            out["render"] + zero_bg[:, None, None] * (1.0 - out["rendered_final_opacity"][0]),
            gt, cfg.lambda_dssim)
        backward_kernel = "render_tiles_backward"
    state = trainer.state._replace(active_sh_degree=3)
    batches = [trainer.batch(c) for c in cams]
    settings = trainer.settings()
    W, H = settings.image_width, settings.image_height
    reset_counts()
    losses, wall = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    bwd_launches = read_counts()[backward_kernel]
    check(bwd_launches == steps, f"{backward_kernel} launched {bwd_launches} times in {steps} steps")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
    busy_share(f"{label} training step", lambda: step(state, batches[0]),
               statistics.median(wall[5:]) / 1e3, card)
    runs = [step_breakdown(state, batches[i % len(batches)], settings, render, loss_fn, cfg)
            for i in range(5)]
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
        f"{max(wall[5:]):.3f}); {backward_kernel} launches {bwd_launches} | {card}")
    say("train", f"{label}: one step by stage (CUDA events, median of 5 steps, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()) + f" | {card}")
    say("train", f"{label}: densify_and_prune {densify_ms:.3f} ms: {n_before} -> "
        f"{state.num_points} points ({info['n_clone']} clones, {info['n_split']} splits, "
        f"{info['n_prune_opacity'] + info['n_prune_big']} pruned) | {card}")


# --- phase 8: the 2DGS render path ----------------------------------------


def main_path_surfel(out_dir: str, ply: str, cams_path: str, device, card: str) -> dict:
    """gs-render --config 2dgs of the 200k-surfel model from three 1080p
    cameras; rasterize_surfels() warm against its plain path."""
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import rasterize_surfel
    from gaustudio_torch.scripts import render as gs_render
    from gaustudio_torch.utils.image import read_png

    reset_counts()
    t0 = time.perf_counter()
    images = gs_render.main(["-m", ply, "-s", cams_path, "--sh", "3", "--config", "2dgs",
                             "--device", "cuda", "-o", os.path.join(out_dir, "surfel")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    say("surfel", f"gs-render --config 2dgs {FULL_VIEWS} views of {FULL_W}x{FULL_H}, {SURFEL_N} "
        f"surfels: {wall:.2f} s wall (load, render, PNG); launches {json.dumps(counts)}")
    check(all(counts[k] > 0 for k in SURFEL_FORWARD), f"a kernel was not launched: {counts}")
    pngs = sorted(os.listdir(images))
    check(len(pngs) == FULL_VIEWS, pngs)
    img = read_png(os.path.join(images, pngs[0]))
    check(img.shape == (FULL_H, FULL_W, 3), img.shape)

    pcd = load_model(ply, 3, device, SURFEL_CONFIG)
    cam = load_cameras(cams_path, device)[1]
    renderer = renderers.make({"name": "surfel_renderer"}, device=device)
    out = renderer.render(cam, pcd)
    rgb, alpha = out["render"], out["rendered_final_opacity"]
    check(rgb.shape == (3, FULL_H, FULL_W) and torch.isfinite(rgb).all(),
          f"render {tuple(rgb.shape)} is not a finite [3, {FULL_H}, {FULL_W}] image")
    for key in ("rendered_normal", "rendered_depth", "rendered_dist_m2"):
        check(torch.isfinite(out[key]).all(), f"non-finite {key}")
    lit = float((alpha > 0.01).float().mean())
    say("surfel", f"lit fraction (alpha > 0.01) {lit:.4f} (guard > 0.5), mean colour "
        f"{float(rgb.mean()):.4f}, {out['num_rendered']} entries")
    check(lit > 0.5, f"surfel render mostly empty: {lit:.3f} lit")

    xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
    st = renderer.make_settings(cam, pcd, device)

    def run(settings):
        return rasterize_surfel.rasterize_surfels(xyz, opacity, settings, scales=scales,
                                                  rotations=rotations, shs=shs,
                                                  active_sh_degree=3)

    plain = st._replace(backend="plain")
    with torch.inference_mode():
        ref = run(plain)
        got = run(st)
        err = float((got["render"] - ref["render"]).abs().max())
        check(err <= 1e-4, f"rasterize_surfels kernels vs plain: max|err| {err}")
        timings = {}
        for name, settings, iters in (("kernels", st, 20), ("plain", plain, 2)):
            run(settings)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                run(settings)
            torch.cuda.synchronize()
            timings[name] = (time.perf_counter() - t0) / iters
        mpix = FULL_W * FULL_H / 1e6
        say("time", f"rasterize_surfels {FULL_W}x{FULL_H} {SURFEL_N} surfels SH3: kernels "
            f"{timings['kernels'] * 1e3:.3f} ms = {mpix / timings['kernels']:.2f} MPix/s; plain "
            f"{timings['plain'] * 1e3:.3f} ms = {mpix / timings['plain']:.3f} MPix/s; "
            f"max|err| {err:.2e} | {card}")
        busy_share(f"rasterize_surfels {FULL_W}x{FULL_H} {SURFEL_N} surfels SH3",
                   lambda: run(st), timings["kernels"], card)
    return counts


# --- the kernels of two checkouts, in turns ---------------------------------

# (key of the --time-backward line, unit): K1 with the cull (1080p/300k) and
# without it (1080p/200k surfels), by the device time of every op of its
# wrapper and by host time per call, and by its kernels' names; K2; K3-K6
AB_TIMES = (("duplicate_with_keys", "ms"), ("duplicate_with_keys_host", "us"),
            ("duplicate_with_keys_by_name", "ms"), ("duplicate_with_keys_nocull", "ms"),
            ("duplicate_with_keys_nocull_host", "us"), ("duplicate_with_keys_nocull_by_name", "ms"),
            ("identify_tile_ranges", "ms"), ("render_tiles", "ms"),
            ("render_tiles_backward", "ms"), ("render_surfel_tiles", "ms"),
            ("render_surfel_tiles_backward", "ms"))


def time_for_ab(device, card: str, reps: int = 3) -> dict:
    """Each time of AB_TIMES, ``reps`` times, through the gaustudio_torch that
    this process imported, on phase 3's middle 1080p view, scenes and
    cotangents: K1 and K2 by torch.profiler over 20 calls (device_ms), K1's
    host time over 20 calls (host_us), K3-K6 by CUDA events over 20 calls.
    Only calls that every checkout since K1's no-cull mode has."""
    import gaustudio_torch
    from gaustudio_torch import renderers
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.models.vanilla import VanillaPointCloud
    from gaustudio_torch.ops import binning, composite, composite_surfel, rasterize_surfel
    from gaustudio_torch.utils import kernels

    kernels.load()
    cam = JSON_to_camera(scene_cameras(FULL_W, FULL_H)[1], device=device)
    gx, gy = (FULL_W + 15) // 16, (FULL_H + 15) // 16
    result = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(gaustudio_torch.__file__))),
              "card": card}
    pcd = VanillaPointCloud.from_jax_params(full_scene_params(), device=device)
    pcd.active_sh_degree = 3
    pre = view_preprocess(renderers.make({"name": "vanilla_renderer"}, device=device), cam, pcd)
    args = backward_args(pre, FULL_W, FULL_H, seed=1)
    fwd_args = args[:7] + args[-4:]
    sorted_keys, _ = torch.sort(binning.duplicate_with_keys(pre, gx)[0], stable=True)
    bin_in = None

    def k1(cull):
        return lambda: binning.duplicate_with_keys(pre if cull else bin_in, gx, cull)

    calls = {
        "duplicate_with_keys": lambda: device_ms(k1(True)),
        "duplicate_with_keys_host": lambda: host_us(k1(True)),
        "duplicate_with_keys_by_name": lambda: device_ms(k1(True), K1_KERNEL_NAMES),
        "identify_tile_ranges": lambda: device_ms(
            lambda: binning.identify_tile_ranges(sorted_keys, gx * gy)),
        "render_tiles": lambda: cuda_ms(lambda: composite.render_tiles(*fwd_args), 20),
        "render_tiles_backward": lambda: cuda_ms(
            lambda: composite.render_tiles_backward(*args), 20),
    }
    for name, fn in calls.items():
        result[name] = [fn() for _ in range(reps)]
    del pcd, pre, args, fwd_args, sorted_keys
    pcd = VanillaPointCloud.from_jax_params(surfel_scene_params(), device=device,
                                            config=SURFEL_CONFIG)
    pcd.active_sh_degree = 3
    pre = view_preprocess_surfel(renderers.make({"name": "surfel_renderer"}, device=device),
                                 cam, pcd)
    bin_in = rasterize_surfel.binning_input(pre)
    _, fwd_args, _, bwd_args = surfel_args(pre, FULL_W, FULL_H, seed=3)
    calls = {
        "duplicate_with_keys_nocull": lambda: device_ms(k1(False)),
        "duplicate_with_keys_nocull_host": lambda: host_us(k1(False)),
        "duplicate_with_keys_nocull_by_name": lambda: device_ms(k1(False), K1_KERNEL_NAMES),
        "render_surfel_tiles": lambda: cuda_ms(
            lambda: composite_surfel.render_surfel_tiles(*fwd_args), 20),
        "render_surfel_tiles_backward": lambda: cuda_ms(
            lambda: composite_surfel.render_surfel_tiles_backward(*bwd_args), 20),
    }
    for name, fn in calls.items():
        result[name] = [fn() for _ in range(reps)]
    return result


def ab_kernels(parent: str, card: str) -> None:
    """The times of AB_TIMES of the checkout at ``parent`` and of this one,
    taken in turns (parent, this, this, parent), each in a process of its own
    on this card; prints each mean and ratio."""
    runs = []
    for tree in (parent, REPO, REPO, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-backward",
                               "--tree", tree], capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"--time-backward --tree {tree} failed:\n"
              f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        say("ab", json.dumps(runs[-1]))
    for name, unit in AB_TIMES:
        before = statistics.mean(t for r in (runs[0], runs[3]) for t in r[name])
        after = statistics.mean(t for r in (runs[1], runs[2]) for t in r[name])
        say("ab", f"{name}: parent {before:.4f} {unit}, this checkout {after:.4f} {unit}, ratio "
            f"{after / before:.4f} (means of 2 x 3 windows of 20 calls) | {card}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "gaustudio_torch", "build", "smoke"),
                        help="directory for the generated scene and the rendered images")
    parser.add_argument("--ab", metavar="PARENT",
                        help="only time K1-K6 of the checkout at PARENT and of this one, "
                             "in turns (parent, this, this, parent)")
    parser.add_argument("--time-backward", action="store_true",
                        help="only time K1 (both modes), K2 and the compositors K3-K6 at the "
                             "1080p shapes and print one JSON line")
    parser.add_argument("--tree", default=REPO,
                        help="with --time-backward: the checkout whose gaustudio_torch to use")
    args = parser.parse_args(argv)

    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    if args.time_backward:
        print(json.dumps(time_for_ab(device, card)), flush=True)
        return 0
    print(card, flush=True)
    if args.ab:
        ab_kernels(os.path.abspath(args.ab), card)
        return 0
    from gaustudio_torch.utils import kernels

    say("card", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    try:
        import PIL

        say("card", f"PIL {PIL.__version__} imports: images decode through it")
    except ImportError:
        say("card", "PIL does not import: images decode through the stdlib PNG reader")
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
                    check(" 0 bytes spill stores, 0 bytes spill loads" in line
                          or "spill" not in line, f"ptxas spilled registers: {line.strip()}")

    # phase 3: kernels against their plain versions
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import composite

    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    surfel_renderer = renderers.make({"name": "surfel_renderer"}, device=device)
    mini_pcd = load_model(os.path.join(FIXTURE, "gaussians.ply"), 0, device)
    mini_cam = load_cameras(os.path.join(FIXTURE, "cameras.json"), device)[0]
    mini_pre = view_preprocess(renderer, mini_cam, mini_pcd)
    errs = compare_kernels(mini_pre, mini_cam.image_width, mini_cam.image_height)
    errs["render_tiles_backward"], _ = compare_backward(
        mini_pre, mini_cam.image_width, mini_cam.image_height, seed=0)
    mini_surfel_errs, _, _ = compare_surfel_kernels(
        view_preprocess_surfel(surfel_renderer, mini_cam, mini_pcd), mini_cam.image_width,
        mini_cam.image_height, seed=2)
    ply, cams_path = write_full_scene(args.out)
    full_pcd = load_model(ply, 3, device)
    full_cam = load_cameras(cams_path, device)[1]
    full_pre = view_preprocess(renderer, full_cam, full_pcd)
    full_errs = compare_kernels(full_pre, FULL_W, FULL_H)
    full_errs["render_tiles_backward"], k4_args = compare_backward(full_pre, FULL_W, FULL_H, seed=1)
    errs = {k: max(errs[k], full_errs[k]) for k in errs}
    times = time_kernels(full_pre, FULL_W, FULL_H, card,
                         lambda: view_preprocess(renderer, full_cam, full_pcd))
    times["render_tiles_backward"] = (
        cuda_ms(lambda: composite.render_tiles_backward(*k4_args), 20),
        cuda_ms(lambda: composite.render_tiles_backward_plain(*k4_args), 2))
    say("time", f"render_tiles_backward {FULL_W}x{FULL_H}: kernel "
        f"{times['render_tiles_backward'][0]:.4f} ms, plain "
        f"{times['render_tiles_backward'][1]:.4f} ms | {card}")
    bounds = vanilla_bounds(full_pre, FULL_W, FULL_H)
    del full_pcd, full_pre, mini_pre, k4_args

    surfel_ply, surfel_cams = write_surfel_scene(args.out)
    surfel_pcd = load_model(surfel_ply, 3, device, SURFEL_CONFIG)
    surfel_pre = view_preprocess_surfel(surfel_renderer, load_cameras(surfel_cams, device)[1], surfel_pcd)
    surfel_errs, k5_args, k6_args = compare_surfel_kernels(surfel_pre, FULL_W, FULL_H, seed=3)
    errs["duplicate_with_keys"] = max(errs["duplicate_with_keys"], mini_surfel_errs[
        "duplicate_with_keys"], surfel_errs["duplicate_with_keys"])
    for k in ("render_surfel_tiles", "render_surfel_tiles_backward"):
        errs[k] = max(mini_surfel_errs[k], surfel_errs[k])
    times.update(time_surfel_kernels(surfel_pre, k5_args, k6_args, FULL_W, FULL_H, card))
    bounds.update(surfel_bounds(k6_args, FULL_W, FULL_H))
    del surfel_pcd, surfel_pre, k5_args, k6_args
    for k, err in compare_hard_cases(device).items():
        errs[k] = max(errs[k], err)

    # phase 4: the render path on the fixture, against GOLDEN.json
    main_path_fixture(args.out, device)

    # phase 5: the render path at full width
    path_counts = [main_path_full(args.out, ply, cams_path, device, card)]

    # phase 6: the training path on the fixture
    path_counts.append(train_fixture(args.out, device, card))

    # phase 6b: the kernels against the plain versions inside training (the
    # plain half is launch-bound, 2-4 s a step on the host: 30 steps keep the
    # script well inside its time)
    train_kernels_vs_plain(device, card, steps=30)

    # phase 7: training at the two training shapes
    train_at_scale(args.out, ply, cams_path, device, card, "1080p/300k")
    small_ply, small_cams = write_full_scene(args.out, n=SMALL_N, W=SMALL_W, H=SMALL_H,
                                             name="small")
    train_at_scale(args.out, small_ply, small_cams, device, card, "512/100k")

    # phase 8: the 2DGS render path at full width
    path_counts.append(main_path_surfel(args.out, surfel_ply, surfel_cams, device, card))

    # phase 9: the 2DGS training path on the fixture
    path_counts.append(train_fixture(args.out, device, card, surfel=True))

    # phase 9b: the kernels against the plain versions inside 2DGS training
    train_kernels_vs_plain(device, card, steps=12, surfel=True)

    # phase 10: 2DGS training at 512x512 / 60k surfels
    st_ply, st_cams = write_surfel_train_scene(args.out)
    train_at_scale(args.out, st_ply, st_cams, device, card, "2DGS 512/60k", surfel=True)

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(c[name] for c in path_counts), "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1],
         "library_ms": times[name][2] if len(times[name]) > 2 else None}
        for name, (src, replaces) in KERNELS.items()
    ]}
    check(all(k["launches"] > 0 for k in report["kernels"]), f"unlaunched kernel: {report}")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
