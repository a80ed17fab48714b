#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gaustudio_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card: its name and power limit (nvidia-smi); TF32 off;
2. build: the CUDA kernels of gaustudio_torch/csrc, compiled with nvcc at
   first use (build seconds and ptxas register counts);
3. kernels: each kernel (K1 duplicate_with_keys, K2 identify_tile_ranges,
   K3 render_tiles) against its plain PyTorch version on the card, on a
   mini_scene view and on one 1920x1080 view of a 300k-Gaussian,
   SH-degree-3 model, with the tolerances stated below; then each kernel's
   time against its plain version's at the 1080p shapes, and the time of
   the torch-op stages (activations + preprocess, the sort);
4. main path on the fixture: gs-render on tests/fixtures/mini_scene, and the
   renderer's PSNR against GOLDEN.json (within 0.15 dB);
5. main path at full width: gs-render of the 300k model from three 1920x1080
   cameras, with every kernel's launch count from that run, the lit-fraction
   guard, and rasterize() timed warm against the plain path.

The last two lines are {"kernels": [...]} and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device. Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_scene")
GOLDEN_PSNR_TOL = 0.15
FULL_W, FULL_H, FULL_N, FULL_VIEWS = 1920, 1080, 300_000, 3
# K1 and K2 are integer results and must agree exactly. K3 walks each pixel
# in the same order as its plain version and rounds its decisions the same way
# (csrc/common.cuh), while its blend may use fused multiply-adds: its float
# outputs agree to rounding, abs 1e-5 + rel 1e-5, and its int outputs exactly.
K3_ATOL = K3_RTOL = 1e-5

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "duplicate_with_keys": ("gaustudio_torch/csrc/binning.cu",
                            "gaustudio_tpu/ops/binning_fast.py:230"),
    "identify_tile_ranges": ("gaustudio_torch/csrc/binning.cu",
                             "gaustudio_tpu/ops/binning_fast.py:472"),
    "render_tiles": ("gaustudio_torch/csrc/composite.cu",
                     "gaustudio_tpu/ops/rasterize_pallas.py:136"),
}


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


def write_full_scene(out_dir: str, seed: int = 0) -> tuple[str, str]:
    """A 300k-point SH-degree-3 vanilla PLY and a cameras.json of three
    1920x1080 views. Geometry, opacity and base colour come from
    bench.make_scene; the higher SH bands are seeded noise."""
    from bench import make_scene
    from gaustudio_torch.models.vanilla import VanillaPointCloud
    from gaustudio_torch.ops.sh import RGB2SH

    xyz, scales, quats, opac, colors = make_scene(FULL_N, seed=seed)
    rng = np.random.default_rng(seed + 1)
    f_rest = (rng.normal(size=(FULL_N, 45)) * 0.05).astype(np.float32)
    pcd = VanillaPointCloud.from_jax_params({
        "xyz": xyz, "opacity": np.log(opac / (1.0 - opac))[:, None],
        "f_dc": RGB2SH(colors), "f_rest": f_rest, "scale": np.log(scales), "rot": quats,
    })
    ply = os.path.join(out_dir, "full_scene.ply")
    pcd.export(ply)

    tanfov = 0.85  # bench.py's camera
    focal = FULL_W / (2.0 * tanfov)
    cams = []
    for i in range(FULL_VIEWS):
        ang = 0.02 * (i - 1)
        c, s = math.cos(ang), math.sin(ang)
        cams.append({
            "id": i, "img_name": f"view_{i:02d}", "width": FULL_W, "height": FULL_H,
            "position": [0.05 * (i - 1), 0.0, 0.0],
            "rotation": [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
            "fx": focal, "fy": focal,
        })
    cams_path = os.path.join(out_dir, "full_cameras.json")
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


def reset_counts() -> None:
    from gaustudio_torch.ops import binning, composite

    binning.duplicate_with_keys.launches = 0
    binning.identify_tile_ranges.launches = 0
    composite.render_tiles.launches = 0


def read_counts() -> dict:
    from gaustudio_torch.ops import binning, composite

    return {
        "duplicate_with_keys": binning.duplicate_with_keys.launches,
        "identify_tile_ranges": binning.identify_tile_ranges.launches,
        "render_tiles": composite.render_tiles.launches,
    }


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
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")

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
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")
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
    errs = compare_kernels(view_preprocess(renderer, mini_cam, mini_pcd),
                           mini_cam.image_width, mini_cam.image_height)
    ply, cams_path = write_full_scene(args.out)
    full_pcd = load_model(ply, 3, device)
    full_cam = load_cameras(cams_path)[1]
    full_pre = view_preprocess(renderer, full_cam, full_pcd)
    full_errs = compare_kernels(full_pre, FULL_W, FULL_H)
    errs = {k: max(errs[k], full_errs[k]) for k in errs}
    times = time_kernels(full_pre, FULL_W, FULL_H, card,
                         lambda: view_preprocess(renderer, full_cam, full_pcd))
    del full_pcd, full_pre

    # phase 4: the main path on the fixture, against GOLDEN.json
    main_path_fixture(args.out, device)

    # phase 5: the main path at full width; its launch counts go in the report
    counts = main_path_full(args.out, ply, cams_path, device, card)

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], "max_abs_err": errs[name],
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
