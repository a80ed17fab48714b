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
   render_surfel_tiles and K6 render_surfel_tiles_backward; K7
   preprocess_forward, K8 preprocess_backward) against its plain PyTorch
   version on the card (K8 also against torch autograd), on a mini_scene
   view (vanilla, and the same model as 2DGS surfels) and on one 1920x1080
   view of a 300k-Gaussian SH-3 model (K1-K4, K7, K8) and of a
   200k-surfel SH-3 model (K1, K2, K5, K6), with the tolerances stated
   below; then each kernel's time against its plain version's (and, for K2,
   torch.searchsorted's) at the 1080p shapes (K1, K2 and torch.searchsorted
   on the device by torch.profiler, K1 over every op of its wrapper, with
   the host time of a call beside it; K7 and K8 by torch.profiler and CUDA
   events, also at 3M Gaussians x 1237x822, with their bytes bounds, launches and
   registers; the others by CUDA events), and the time of the torch-op
   stages (activations + preprocess, the sort); then K1-K6 on the hard cases
   (hard_case: one Gaussian or surfel in every tile, warps that end far
   apart, more than 256 entries a pixel, a ragged image whose bottom tiles
   hold an odd number of rows), K1 in both modes on its own (k1_case: a full-screen primitive
   among thousands of small ones, 1, 31 and 33 primitives, rows with no
   tiles inside a warp, a view where the cull keeps nothing), K7 and K8 on every
   branch of gaussian.preprocess and its hard rows (k7_case) and K2 on empty
   and single-entry tiles;
4. render path on the fixture: gs-render on tests/fixtures/mini_scene, and
   the renderer's PSNR against GOLDEN.json (within 0.15 dB);
5. render path at full width: gs-render of the 300k model from three
   1920x1080 cameras, with the launch counts of that run, the lit-fraction
   guard, rasterize() timed warm against the plain path, the device's
   busy share of a warm render, and the middle view's rasterize() with K7
   against the same call with backend="plain" (compare_k7_render);
6. training path on the fixture: gs-train for 1000 iterations from the
   fixture's sparse points (densification at 600-1000), with the launch
   counts of that run, and the PSNR of the exported model against that of
   the initial point cloud (at least 3 dB better);
6b. training with the kernels against training with the plain versions:
   10 steps from the fixture's model, one camera sequence, final PSNR
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
9b. 2DGS training with the kernels against the plain versions: 6 steps,
   one camera sequence, final PSNR within 0.1 dB;
10. 2DGS training at 512x512 / 60k surfels: 30 steps and one densify, with
   ms per iteration, the device's busy share of a step and a breakdown;
11. mesh extraction: gs-extract-mesh on the fixture with GOLDEN.json's
   extract_kw (mesh F1 and chamfer against gt_mesh.ply at the thresholds of
   tests/test_golden_e2e.py); bench_all.py's extraction workload (60k
   Gaussians on the unit sphere, 12 orbit views at 512 px) through
   extract_mesh, cold and warm (extract_mesh_s, extract_mesh_warm_s), held
   on every third view against the same extraction through the plain
   compositor (F1 at least 0.999 at half a voxel), and as surfels through
   --config 2dgs; and
   gs-extract-mesh with its defaults on 300k Gaussians of the sphere from 36
   orbit cameras at 1920x1080: the grid's dims, the wall, the peak device
   memory, the device's busy share, the ms a view of the render, the
   integrate and the file writes, and the seconds of marching tetrahedra.
   K1, K2 and K3 (K5 for 2dgs) must launch there, K4 and K6 must not;
12. the model and renderer variants: gs-render --config mip, gsplat (on the
   300k scene of phase 5), pcd (its xyz and colours, written with store_ply)
   and scaffold (30k anchors at the config's widths from make_scene(30000)'s
   means: 300k decoded Gaussians) from the three 1080p cameras, each with
   its launches (K1-K3, not K4), lit fraction, middle view through the
   kernels against the plain path (K3's tolerance), with K7 against the
   plain path (compare_k7_render), rasterize() wall and busy share;
   mip's filtered opacities at most the raw ones, gsplat's image
   not vanilla's; then 30 Scaffold steps at 1080p against the vanilla
   scene's renders (K1-K4, ms/it, stages, busy share) and one
   adjust_anchors, timed; 6 Scaffold steps on the fixture with the kernels
   against the plain versions (final PSNR within 0.1 dB); and gs-train
   --config scaffold on the fixture, its exported model's PSNR against its
   first logged PSNR at or above the gate taken from the JAX trainer;
13. point extraction and the mesh tools: gs-extract-pcd on mini_scene
   (vanilla and --config 2dgs, with their launches), then every other view
   through the kernels against the plain compositor and binning (surface ids
   equal but at pixels within 1e-5 of a threshold, fused normals within 1e-4
   but at ids a re-vote tie touches, SAP meshes F1 at least 0.999 at half a
   SAP voxel); gs-extract-pcd with its defaults on phase 11's 300k sphere from
   36 cameras at 1920x1080 (points before and after cleaning, SAP faces, the
   wall, peak device memory, busy share, per-stage times; >= 95% of the
   normals outward, the mesh within 2 SAP voxels of the sphere); and, on
   phase 11's full-width mesh, gs-render-mesh from the 36 cameras (covered
   fraction, ms a view of rasterize and files, the middle view held to a
   float64 per-pixel reference), gs-texture-mesh from phase 11's 12 views
   (covered share > 0.8) and gs-from-mesh -n 3 with gs-render of its
   Gaussians at 1080p through K1-K3 (launches, lit fraction, rasterize()
   wall), also on gs-extract-pcd's closed SAP mesh (lit > 0.5);
14. gs-init and gs-process-data: phase 11's 300k sphere at opacity 0.95
   rendered through K1-K3 from three orbit rings of 12 cameras (elevations
   -30, 0 and +30 degrees, radius 3, 1920x1080, 60 degrees along the short
   side) and written as a nerfstudio capture (RGB, 16-bit median depth in
   millimetres, masks of final opacity > 0.5, a 20k-point
   sparse/0/points3D.bin); then on --device cuda (a) gs-process-data --init
   depth (its points: one a pixel of positive depth at 480x270, median
   | |p| - 1 | <= 0.01), (b) gs-init -w --initializer VisualHull, its pose
   step building from the capture's points3D.bin (no hull vertex more than
   sqrt(3) voxels inside the sphere; a Gaussian a face), with the wall, busy
   share and peak device memory of each, (c) gs-process-data --init
   gaussiansky (100^2 Gaussians) and (d) 30 steps of gs-train --dataset
   nerfstudio from (b)'s cloud through K1-K4 (ms/it; the loss of the last 5
   steps below that of the first 5); whether PIL and cv2 import;
15. the flythrough, host IO and observability: gs-render --flythrough of
   phase 5's 300k model along a 90-camera path at 1920x1080 (a 90-degree yaw
   arc about (0, 0, 3.4) centred on bench.py's identity view, proper
   rotations, seeded jitter, three speed outliers): (a) the camera chain's
   counts (the JAX chain's 77 / 40 / 40 / 78), host ms, the peak host
   memory it allocates (tracemalloc) and the process's peak RSS; (b) the
   CLI's launches (K1-K3, not K4 or K6), one 1080p PNG a frame named by its
   index, the wall, and a staged run's render and file ms a frame and lit
   fractions (the middle frame > 0.9);
   (c) the first, middle and last frames through the kernels against the
   plain path (K3's tolerance); (d) the device's busy share of a frame; (e)
   points3D.bin of the 300k means (tracks of 4) and images.bin of the path
   (4096 keypoints an image) read by the native and the Python readers:
   equal, dtypes too, with their ms (the native library must build); (f) a
   COLMAP database of the path (PINHOLE cameras, keypoints, sequential
   matches, two-view geometries) read back, and the known-pose model
   written and read back; (g) trace / annotate around three frames (the
   trace holds the 'frame' regions and render_tiles kernel events); (h) the
   rasterizer's debug snapshot: none of a finite frame, one naming the
   opacities when one is NaN, and the ms debug adds to a frame;
16. multi-device on the one card (gaustudio_torch.parallel): (a) the
   DPTrainer on make_mesh(1, 1), one rank over NCCL, against the Trainer:
   30 steps and one densify at 1080p / 300k / SH 3 (phase 7's scene), one
   camera sequence and seed: final PSNR within 0.1 dB, points within 0.1%,
   ms/it of both; (b) two ranks sharing the card (gloo, by the backend
   rule), dp=2 x gs=1 then dp=1 x gs=2: step 1's reduced gradient of each
   rank's rows against a one-process reference (the mean of the dp views'
   gradients) at K4's tolerance, the collectives' bytes a step, then 30
   steps and one densify (PSNR within 0.1 dB of the reference: a
   one-process dp=2 step, and (a)'s Trainer for gs=2) and ms/it; (c) the
   camera-parallel render of four 1080p views over the two ranks, the 300k
   model (K1-K3) and the 200k surfels (K1 without the cull, K2, K5), every
   buffer against the single-process rasterize() at K3's tolerance; (d)
   gs-extract-mesh under the two ranks at phase 11's full width, with files
   (the CLI) and without: wall and busy share, the fused volume against the
   single-process fusion (weights equal, tsdf within 1e-5), the mesh against
   phase 11's (F1 >= 0.999 at half a voxel) and the CLI's file names; (e)
   gs-train --gs_shards 2 under torch.distributed.run with two ranks on
   mini_scene for 300 iterations (dp=1 x gs=2; rank 0's files; the exported
   model's PSNR above the initial cloud's). A rank that fails fails the run;
17. the capture and at-scale training tools (gaustudio_torch/tools) at their
   defaults, each through K1-K4: (a) make_fixture (10 views at 128 px,
   8000 Gaussians refit for 250 iterations, mesh extraction) against
   tests/fixtures/mini_scene: cameras.json within 1e-6, gt_mesh.ply equal,
   the images equal as uint8 but at triangle edges (at most 0.5% of the
   pixels; one level at most off the edges), the refit's mean PSNR within
   0.5 dB of GOLDEN.json, its mesh within tests/test_golden_e2e.py's F1
   and chamfer bounds; (b) train_at_scale at 512 px, 64 views (every 8th
   held out), 2000 initial points and 7000 iterations (densify 600-5500,
   an opacity reset at 3000, SH to degree 3): at least 15,000
   points, held-out PSNR >= 26 dB, no non-finite parameter, with ms/it,
   wall and the busy share of a step of the trained state; (c)
   train_scaffold at 256 px, 24 views, 6000 anchors, 2000 iterations: the
   loss falls, held-out PSNR rises; (d) demo_e2e at 256 px, 1500
   iterations, 5000 Gaussians: PSNR rises, the mesh has > 100 faces. (b)
   runs in a process of its own (--tools-at-scale) beside (a), (c), (d).

Each path (phases 4, 5, 6, 8, 9, 11, 12, 13, 14, 15, 16 and 17) is driven
with every launch count set to 0 just before it and read just after; a
kernel of the path that was not launched fails the run. The report's
``launches`` sums the counts of the render, training, mesh, variant,
point-extraction, initialization, flythrough, multi-device and tools paths
(phases 5, 6, 8, 9 and 11-17; phase 16's of each rank but (e)'s, whose
processes are the CLI's). The elapsed time is printed after each phase
and for the whole script.
The last two lines are
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
# K7 computes gaussian.preprocess op for op, unfused, so its integer outputs,
# valid, depth, mean, conic and opacity agree exactly; its colour sums the SH
# terms in another order than the einsum, within K3's tolerance.
K7_COLOR_ATOL = K7_COLOR_RTOL = 1e-5
# K8 recomputes K7's forward and sums its gradients fused and in another
# order: each gradient, scaled by the plain version's max |value|, within
# K8_ATOL of gaussian.preprocess_backward_plain and of torch autograd through
# gaussian.preprocess, which lie as far apart themselves in float32
# (tests/test_torch_preprocess_backward.py). Rows whose colour lies within
# K8_COLOR_EDGE of 0 are left out of the SH and mean gradients: K8's gate of
# the colour's clamp reads K7's SH sum, which rounds otherwise than the
# einsum's.
K8_ATOL = 1e-4
K8_COLOR_EDGE = 1e-5
SURFEL_N = 200_000  # bench_all.py bench_surfel_render
SURFEL_TRAIN_W = SURFEL_TRAIN_H = 512  # bench_all.py bench_surfel_train_step
SURFEL_TRAIN_N = 60_000
SURFEL_FIXTURE_GAIN_DB = 2.0  # tests/test_train_surfel.py:86
# steps of the kernels-against-plain training checks (phases 6b and 9b); the
# plain halves take 2-10 s a step on the host
TRAIN_CHECK_STEPS = 10
SURFEL_CHECK_STEPS = 6
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
# (the hit and the VJP of the intersection); K7 ~300 per Gaussian (the
# covariances, the rects and the SH 3 colour), K8 ~600 (K7's geometry and
# colour again, and their gradients).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS = {"duplicate_with_keys": 79, "identify_tile_ranges": 1, "render_tiles": 20,
       "render_tiles_backward": 60, "render_surfel_tiles": 45,
       "render_surfel_tiles_backward": 110, "preprocess_forward": 300,
       "preprocess_backward": 600}

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
    "preprocess_forward": ("gaustudio_torch/csrc/preprocess.cu",
                           "none: gaustudio_tpu/ops/gaussian.py preprocess is left to XLA's "
                           "fusion"),
    "preprocess_backward": ("gaustudio_torch/csrc/preprocess.cu",
                            "none: the gradients of gaustudio_tpu/ops/gaussian.py preprocess "
                            "are left to jax.grad and XLA"),
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


def scene_cameras(W: int, H: int, n: int = FULL_VIEWS) -> list:
    """cameras.json entries of n WxH views: bench.py's camera
    (tan(fov_x/2) = 0.85) yawed by 0.02 (i - 1) rad (-0.02, 0 and +0.02 for
    the three of the scenes)."""
    focal = W / (2.0 * 0.85)
    cams = []
    for i in range(n):
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


def view_inputs(renderer, cam, pcd) -> dict:
    """preprocess's keyword arguments for one view, as rasterize() passes them."""
    xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
    st = renderer.make_settings(cam, pcd, xyz.device)
    return dict(means3d=xyz, opacities=opacity.reshape(-1), viewmatrix=st.viewmatrix,
                projmatrix=st.projmatrix, campos=st.campos, image_width=st.image_width,
                image_height=st.image_height, tan_fovx=st.tanfovx, tan_fovy=st.tanfovy, shs=shs,
                sh_degree=pcd.active_sh_degree, scales=scales, rotations=rotations)


def view_preprocess(renderer, cam, pcd):
    """The Preprocessed of one view, as rasterize() computes it under autograd
    (gaussian.preprocess, the plain version of K7)."""
    from gaustudio_torch.ops import gaussian

    return gaussian.preprocess(**view_inputs(renderer, cam, pcd))


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


def profiled_device_s(fn) -> float:
    """Device seconds (every kernel and copy torch.profiler records) of one
    call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(float(getattr(ev, "self_device_time_total", None)
                     or getattr(ev, "self_cuda_time_total", 0.0))
               for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA) / 1e6
    check(busy > 0, "torch.profiler recorded no device time")
    return busy


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
    k1_case, K7 on those of k7_case and K2 on those of k2_cases; returns
    {kernel: max abs error}."""
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
    for name in K7_CASES:
        kw, _, _ = k7_case(name, device)
        errs["preprocess_forward"] = max(errs.get("preprocess_forward", 0.0),
                                         compare_k7(kw, f"case {name}"))
        errs["preprocess_backward"] = max(errs.get("preprocess_backward", 0.0),
                                          compare_k8(kw, f"case {name}", seed=len(name)))
    for name, (keys, num_tiles) in k2_cases(device).items():
        got = binning.identify_tile_ranges(keys, num_tiles)
        want = binning.identify_tile_ranges_plain(keys, num_tiles)
        err = int((got - want).abs().max())
        say("kernels", f"K2 case {name}: max|err| {err}")
        check(err == 0, f"K2 disagrees with its plain version: {name}")
    return errs


# --- phase 3: K7 preprocess_forward against gaussian.preprocess ----------

K7_CASES = ("sh16", "sh16_deg1", "sh1", "sh4", "sh9", "sh25_deg0", "sh25_deg3", "colors",
            "cov3d", "scale_modifier", "intrinsics", "antialias", "intrinsics_antialias",
            "offset", "n0", "n1", "n31", "n33", "edges", "cov3d_edges")
K7_W, K7_H, K7_N = 1237, 822, 3_000_000  # the 3M timing: a Mip-NeRF 360 view and model


def k7_camera(W: int, H: int, seed: int) -> dict:
    """A seeded camera turned off every axis: (viewmatrix, projmatrix, campos,
    intrinsics) as float32 numpy arrays, the W2V rotation R and translation t
    (float64) and tan(fov / 2) (x, y), with tan_x 0.7 and square pixels."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4) * np.array([4.0, 0.3, 0.3, 0.3])
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    t = rng.normal(size=3)
    w2v = np.eye(4)
    w2v[:3, :3], w2v[:3, 3] = R, t
    tan_x = 0.7
    tan_y = tan_x * H / W
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1] = 1 / tan_x, 1 / tan_y
    P[2, 2] = 100 / (100 - 0.01)
    P[2, 3] = -(100 * 0.01) / (100 - 0.01)
    P[3, 2] = 1.0
    f32 = np.float32
    return {"viewmatrix": w2v.T.astype(f32), "projmatrix": (w2v.T @ P.T).astype(f32),
            "campos": (-R.T @ t).astype(f32), "R": R, "t": t, "tan": (tan_x, tan_y),
            "intrinsics": np.array([W / (2 * tan_x), H / (2 * tan_y), 0.47 * W, 0.53 * H], f32)}


def k7_case(name: str, device) -> tuple:
    """(preprocess's keyword arguments, W, H) of one seeded view that takes
    one branch of preprocess, or its hard rows, on ``device``; 3000 Gaussians
    on 200x120 (but n0-n33), rows in view space mapped to the world:

    * sh16, sh16_deg1, sh1, sh4, sh9, sh25_deg0, sh25_deg3: K SH
      coefficients at an active degree (3 unless named), max_deg capped at 3;
    * colors: colors_precomp; cov3d: cov3d_precomp (random positive
      definite); scale_modifier: 1.37;
    * intrinsics (gsplat's projection, principal point off centre),
      antialias, intrinsics_antialias, offset (a means2d_offset);
    * n0, n1, n31, n33: that many Gaussians (none, a ragged last warp);
    * edges: behind the camera, at the near plane (z 0.2 and a float step
      either side), w about 0 (z 0, +-1e-8), opacity at and around 1/255
      (and 0, 1e-13), means and rects far off screen that clamp to the
      grid's edges, huge (1e3, 50) and sub-pixel (1e-4, 1e-7, 0) scales;
    * cov3d_edges: cov3d_precomp with det <= 0 (indefinite), negative
      definite, zero and overflowing (1e30) covariances.
    """
    rng = np.random.default_rng(K7_CASES.index(name) + 71)
    W, H = 200, 120
    cam = k7_camera(W, H, K7_CASES.index(name))
    n = {"n0": 0, "n1": 1, "n31": 31, "n33": 33}.get(name, 3000)
    tan_x, tan_y = cam["tan"]
    vz = rng.uniform(0.5, 8.0, n)
    vx, vy = rng.uniform(-1.3, 1.3, n) * tan_x * vz, rng.uniform(-1.3, 1.3, n) * tan_y * vz
    scales = np.exp(rng.normal(size=(n, 3)) * 0.6) * 0.03
    op = rng.uniform(0.0, 1.0, n)
    if name == "edges":
        vz[:6] = [-1.0, -0.1, 0.0, 1e-8, -1e-8, 0.2]  # behind, w ~ 0, the near plane
        vz[6:8] = np.nextafter(np.float32(0.2), np.float32([0, 1])).astype(np.float64)
        vx[:8] = vy[:8] = 0.01
        op[8:14] = [1 / 255, float(np.float32(1 / 255)), float(np.nextafter(
            np.float32(1 / 255), np.float32(1))), 0.0, 1e-13, 1e-3]
        vx[14:20] = np.array([-3, 3, -30, 30, -1.5, 1.5]) * tan_x * vz[14:20]  # off screen
        vy[17:23] = np.array([-3, 3, 30, -1.5, 1.5, -30]) * tan_y * vz[17:23]
        scales[14:23] *= 40.0
        scales[23:28] = np.array([1e3, 50.0, 1e-4, 1e-7, 0.0])[:, None]
    world = (np.stack([vx, vy, vz], 1) - cam["t"]) @ cam["R"]  # R^T (v - t)
    quats = rng.normal(size=(n, 4))  # not normalised, as build_cov3d takes them
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    kw = dict(means3d=f32(world), opacities=f32(op), viewmatrix=f32(cam["viewmatrix"]),
              projmatrix=f32(cam["projmatrix"]), campos=f32(cam["campos"]), image_width=W,
              image_height=H, tan_fovx=tan_x, tan_fovy=tan_y)
    if name.startswith("cov3d"):
        A = rng.normal(size=(n, 3, 3)) * 0.03
        cov = A @ A.transpose(0, 2, 1)
        if name == "cov3d_edges":
            cov[:4] = [[[1, 10, 0], [10, 1, 0], [0, 0, 1]], -np.eye(3) * 5, np.zeros((3, 3)),
                       np.eye(3) * 1e30]
            cov[4:8] = np.array([[1.0, 3.0, 0.5], [3.0, 1.0, 0.2], [0.5, 0.2, 1.0]]) * 0.01
        kw["cov3d_precomp"] = f32(cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])
    else:
        kw.update(scales=f32(scales), rotations=f32(quats))
    if name == "colors":
        kw["colors_precomp"] = f32(rng.uniform(0, 1, (n, 3)))
    else:
        num, deg = {"sh1": (1, 3), "sh4": (4, 3), "sh9": (9, 3), "sh25_deg0": (25, 0),
                    "sh25_deg3": (25, 3), "sh16_deg1": (16, 1)}.get(name, (16, 3))
        kw.update(shs=f32(rng.normal(size=(n, num, 3)) * 0.3), sh_degree=deg)
    if name == "scale_modifier":
        kw["scale_modifier"] = 1.37
    if name.startswith("intrinsics"):
        kw["intrinsics"] = f32(cam["intrinsics"])
    if name.endswith("antialias"):
        kw["antialias"] = True
    if name == "offset":
        kw["means2d_offset"] = f32(rng.normal(size=(n, 2)) * 3.0)
    return kw, W, H


def compare_k7(kw: dict, what: str) -> float:
    """K7 against gaussian.preprocess on the same arguments, under
    torch.inference_mode(); raises unless valid and the integer outputs are
    equal, depth, mean, conic and opacity equal bit for bit (NaN where the
    plain version has NaN) and the colour within K7_COLOR_*. Returns the
    colour's max abs error."""
    from gaustudio_torch.ops import gaussian

    with torch.inference_mode():
        got = gaussian.preprocess_forward(**kw)
        want = gaussian.preprocess(**kw)
    torch.cuda.synchronize()
    color_err = 0.0
    for name, g, w in zip(got._fields, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"K7 {what}: {name} {tuple(g.shape)} {g.dtype} != plain {tuple(w.shape)} {w.dtype}")
        if not g.is_floating_point():
            bad = int((g != w).sum())
            check(bad == 0, f"K7 {what}: {name} differs from the plain version in {bad} rows")
        elif name == "colors":
            if g.numel():
                color_err = float((g - w).abs().nan_to_num(0.0).max())
            torch.testing.assert_close(g, w, rtol=K7_COLOR_RTOL, atol=K7_COLOR_ATOL,
                                       equal_nan=True, msg=f"K7 {what}: colors")
        else:
            torch.testing.assert_close(g, w, rtol=0.0, atol=0.0, equal_nan=True,
                                       msg=f"K7 {what}: {name}")
    say("kernels", f"K7 {what}: {got.depths.shape[0]} Gaussians, {int(got.valid.sum())} valid, "
        f"{int(got.tiles_touched.sum())} rect tiles; integer outputs and valid equal, depth, mean, "
        f"conic and opacity bit-equal, colour max|err| {color_err:.3e} (tol {K7_COLOR_ATOL:g} + "
        f"{K7_COLOR_RTOL:g}*|x|)")
    return color_err


def k7_bytes(kw: dict) -> int:
    """The bytes K7 must move for these arguments: each input read once (the
    SH bands it reads), the Preprocessed record written once (65 B a
    Gaussian)."""
    from gaustudio_torch.ops.sh import RASTER_MAX_DEGREE

    n = kw["means3d"].shape[0]
    per = 12 + 4 + (24 if kw.get("cov3d_precomp") is not None else 12 + 16) + 65
    if kw.get("shs") is not None:
        num = kw["shs"].shape[1]
        deg = min(kw.get("sh_degree", 3), RASTER_MAX_DEGREE, int(round(num ** 0.5)) - 1)
        per += 12 * (max(deg, -1) + 1) ** 2
    else:
        per += 12
    if kw.get("means2d_offset") is not None:
        per += 8
    return n * per


def k7_scene(n: int, W: int, H: int, device, seed: int = 0) -> dict:
    """preprocess's keyword arguments for n seeded SH-3 Gaussians in and
    around the frustum of k7_camera(W, H, seed), made on the device."""
    cam = k7_camera(W, H, seed)
    tan_x, tan_y = cam["tan"]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    g = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    vz = 1.0 + 19.0 * u(n)
    view = torch.stack([(2.4 * u(n) - 1.2) * tan_x * vz, (2.4 * u(n) - 1.2) * tan_y * vz, vz], 1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    quats = g(n, 4)
    return dict(means3d=((view - t(cam["t"])) @ t(cam["R"])).contiguous(),
                opacities=torch.sigmoid(g(n)), viewmatrix=t(cam["viewmatrix"]),
                projmatrix=t(cam["projmatrix"]), campos=t(cam["campos"]), image_width=W,
                image_height=H, tan_fovx=tan_x, tan_fovy=tan_y,
                scales=torch.exp(g(n, 3) * 0.7 - 4.5),
                rotations=quats / quats.norm(dim=1, keepdim=True),
                shs=g(n, 16, 3) * 0.3, sh_degree=3)


def kernel_registers(name: str) -> dict:
    """{each instantiation of the kernel ``name`` (its mangled name):
    registers a thread} from ptxas's report in build/nvcc.log (empty where
    this process loaded a library built before it)."""
    import re

    from gaustudio_torch.utils import kernels

    regs, entry = {}, None
    log = os.path.join(kernels.BUILD_DIR, "nvcc.log")
    if not os.path.exists(log):
        return regs
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and name in entry:
                regs[entry] = int(m.group(1))
                entry = None
    return regs


def time_k7(kw: dict, label: str, card: str) -> tuple:
    """(K7 ms, plain ms, bound ms, bound_by) at the shapes of ``kw``,
    printed with K7's launches in the timing and its registers: K7 by the
    device time of its kernel (torch.profiler, as K1; at 300k its host time
    a call exceeds its device time) and by CUDA events, the plain
    preprocess (gaussian.preprocess and its SH colours) by CUDA events, both
    under torch.inference_mode()."""
    from gaustudio_torch.ops import gaussian

    n = kw["means3d"].shape[0]
    k7 = lambda: gaussian.preprocess_forward(**kw)  # noqa: E731
    with torch.inference_mode():
        before = gaussian.preprocess_forward.launches
        ms = device_ms(k7, ("preprocess_forward",))
        events_ms = cuda_ms(k7, 20, warmup=2)
        us = host_us(k7)
        launches = gaussian.preprocess_forward.launches - before
        plain_ms = cuda_ms(lambda: gaussian.preprocess(**kw), 5)
    nbytes = k7_bytes(kw)
    bound, by = bound_ms(nbytes, OPS["preprocess_forward"] * n)
    regs = kernel_registers("preprocess_forward_kernel")
    say("time", f"preprocess_forward (K7) {label}, {n} Gaussians: kernel {ms:.4f} ms (torch.profiler; "
        f"CUDA events {events_ms:.4f} ms), host {us:.1f} us per call, bound {bound:.4f} ms ({by}: "
        f"{nbytes / max(n, 1):.0f} B a Gaussian), {100 * bound / ms:.1f}% of it; plain "
        f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x); {launches} launches; registers "
        f"{max(regs.values()) if regs else 'not in this build log'} (most of its "
        f"{len(regs)} instantiations) | {card}")
    return ms, plain_ms, bound, by


def k8_cotangents(n: int, device, seed: int, zero_share: float = 0.3) -> dict:
    """Seeded upstream gradients of preprocess's outputs laid out as K4
    leaves them: views of one [n, 10] accumulator, all zero on about
    ``zero_share`` of the rows (those no tile touched)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    acc = torch.randn((n, 10), generator=gen, device=device)
    acc[torch.rand(n, generator=gen, device=device) < zero_share] = 0.0
    return dict(d_means2d=acc[:, 0:2], d_conic=acc[:, 2:5], d_opacities=acc[:, 5],
                d_colors=acc[:, 6:9], d_depths=acc[:, 9])


def compare_k8(kw: dict, what: str, seed: int = 0) -> float:
    """K8 against gaussian.preprocess_backward_plain and against torch autograd
    through gaussian.preprocess, on seeded upstream gradients in K4's layout
    (k8_cotangents): each gradient finite where the plain one is, within
    K8_ATOL of both once scaled by the plain one's max |value| (but the SH and
    mean gradients of rows whose colour lies within K8_COLOR_EDGE of 0),
    exact zeros on the rows with no upstream gradient, one launch. Returns
    the largest scaled error."""
    from gaustudio_torch.ops import gaussian, sh as sh_ops

    n = kw["means3d"].shape[0]
    cot = k8_cotangents(n, kw["means3d"].device, seed)
    before = gaussian.preprocess_backward.launches
    got = gaussian.preprocess_backward(**kw, **cot)
    launched = gaussian.preprocess_backward.launches - before
    plain = gaussian.preprocess_backward_plain(**kw, **cot)
    leaves = {k: kw[k].clone().requires_grad_(True) for k in plain._fields
              if kw.get(k) is not None}
    with torch.enable_grad():
        pre = gaussian.preprocess(**{**kw, **leaves})
        loss = sum((getattr(pre, k) * cot["d_" + k].reshape(getattr(pre, k).shape)).sum()
                   for k in ("depths", "means2d", "conic", "opacities", "colors"))
        auto = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                    allow_unused=True)))
    torch.cuda.synchronize()
    check(launched == (1 if n else 0), f"K8 {what}: {launched} launches for one call")
    rows = lambda t: t.reshape(n, t.numel() // n if n else 0)  # noqa: E731
    zero = torch.stack([rows(v).abs().sum(1) for v in cot.values()]).sum(0) == 0
    edge = torch.zeros(n, dtype=torch.bool, device=zero.device)
    if kw.get("shs") is not None and n:
        shs = kw["shs"]
        max_deg = min(sh_ops.RASTER_MAX_DEGREE, int(round(shs.shape[1] ** 0.5)) - 1)
        rgb = sh_ops.eval_sh_masked(kw.get("sh_degree", 3), shs.transpose(-1, -2), (
            lambda d: d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-18))(
                kw["means3d"] - kw["campos"]), max_deg) + 0.5
        edge = (rgb.abs() < K8_COLOR_EDGE).any(-1)
    worst = 0.0
    for name, g, p in zip(plain._fields, got, plain):
        if p is None:
            check(g is None, f"K8 {what}: {name} given where the plain version has none")
            continue
        a = auto[name] if auto.get(name) is not None else torch.zeros_like(p)
        check(g.shape == p.shape and g.dtype == p.dtype, f"K8 {what}: {name} {tuple(g.shape)}")
        check(not rows(g)[zero].any(), f"K8 {what}: {name} not zero on untouched rows")
        keep = ~edge if name in ("shs", "means3d") else torch.ones_like(edge)
        g, p, a = rows(g)[keep], rows(p)[keep], rows(a)[keep]
        finite = torch.isfinite(p)
        check(bool((torch.isfinite(g) == finite).all()), f"K8 {what}: {name} finite elsewhere "
              "than the plain version's")
        scale = float(p[finite].abs().max()) if finite.any() else 0.0
        scale = scale if scale > 0.0 else 1.0
        for ref, label in ((p, "plain"), (a, "autograd")):
            err = float((g[finite] - ref[finite]).abs().max()) / scale if finite.any() else 0.0
            check(err <= K8_ATOL, f"K8 {what}: {name} off the {label} version by {err:.3e} of "
                  f"its largest |value| {scale:.3e} (tol {K8_ATOL:g})")
            worst = max(worst, err)
    say("kernels", f"K8 {what}: {n} Gaussians, {int(zero.sum())} with no upstream gradient "
        f"(exact zeros), {int(edge.sum())} with a colour within {K8_COLOR_EDGE:g} of 0 left out of "
        f"the SH and mean gradients; every gradient within {worst:.3e} of the plain version and "
        f"of autograd, scaled (tol {K8_ATOL:g}); {launched} launch")
    return worst


def k8_bytes(kw: dict) -> int:
    """The bytes K8 must move for these arguments: the upstream gradients it
    reads (depth, mean, conic, and colour with SH, opacity with antialias),
    each input it reads once (the SH bands it reads), each gradient it
    writes once (d_SH whole rows); the gradients handed on unchanged move
    nothing."""
    from gaustudio_torch.ops.sh import RASTER_MAX_DEGREE

    n = kw["means3d"].shape[0]
    per = 4 + 8 + 12 + 12 + 12  # d_depth, d_mean2d, d_conic read; mean read, d_mean written
    per += 2 * (24 if kw.get("cov3d_precomp") is not None else 12 + 16)
    if kw.get("shs") is not None:
        num = kw["shs"].shape[1]
        deg = min(kw.get("sh_degree", 3), RASTER_MAX_DEGREE, int(round(num ** 0.5)) - 1)
        per += 12 + 12 * (max(deg, -1) + 1) ** 2 + 12 * num
    if kw.get("antialias"):
        per += 4 + 4 + 4
    return n * per


def time_k8(kw: dict, label: str, card: str) -> tuple:
    """(K8 ms, plain ms, bound ms, bound_by) at the shapes of ``kw`` on
    k8_cotangents, printed with K8's launches in the timing and its
    registers: K8 by the device time of its kernel (torch.profiler) and by
    CUDA events, preprocess_backward_plain by CUDA events."""
    from gaustudio_torch.ops import gaussian

    n = kw["means3d"].shape[0]
    cot = k8_cotangents(n, kw["means3d"].device, seed=9)
    k8 = lambda: gaussian.preprocess_backward(**kw, **cot)  # noqa: E731
    before = gaussian.preprocess_backward.launches
    ms = device_ms(k8, ("preprocess_backward",))
    events_ms = cuda_ms(k8, 20, warmup=2)
    us = host_us(k8)
    launches = gaussian.preprocess_backward.launches - before
    plain_ms = cuda_ms(lambda: gaussian.preprocess_backward_plain(**kw, **cot), 3)
    nbytes = k8_bytes(kw)
    bound, by = bound_ms(nbytes, OPS["preprocess_backward"] * n)
    regs = kernel_registers("preprocess_backward_kernel")
    say("time", f"preprocess_backward (K8) {label}, {n} Gaussians: kernel {ms:.4f} ms "
        f"(torch.profiler; CUDA events {events_ms:.4f} ms), host {us:.1f} us per call, bound "
        f"{bound:.4f} ms ({by}: {nbytes / max(n, 1):.0f} B a Gaussian), {100 * bound / ms:.1f}% "
        f"of it; plain {plain_ms:.4f} ms ({plain_ms / ms:.1f}x); {launches} launches; registers "
        f"{max(regs.values()) if regs else 'not in this build log'} (most of its {len(regs)} "
        f"instantiations: {regs}) | {card}")
    return ms, plain_ms, bound, by


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
    from gaustudio_torch.ops import binning, composite, composite_surfel, gaussian

    return {"duplicate_with_keys": binning.duplicate_with_keys,
            "identify_tile_ranges": binning.identify_tile_ranges,
            "render_tiles": composite.render_tiles,
            "render_tiles_backward": composite.render_tiles_backward,
            "render_surfel_tiles": composite_surfel.render_surfel_tiles,
            "render_surfel_tiles_backward": composite_surfel.render_surfel_tiles_backward,
            "preprocess_forward": gaussian.preprocess_forward,
            "preprocess_backward": gaussian.preprocess_backward}


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
    compare_k7_render(renderer, cam, pcd, f"{FULL_W}x{FULL_H} vanilla")
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


# --- phase 11: mesh extraction (gs-extract-mesh) ---------------------------

# bench_all.py bench_extract_mesh: 60k Gaussians on the unit sphere (seed 4,
# SH 0), 12 orbit views at 512 px (radius 3, FoV 60), stride 1, no downsample,
# voxel 0.02, min weight 2. The full width: 300k Gaussians of the same
# generator, 36 orbit cameras at 1920x1080 through the CLI's defaults.
MESH_N, MESH_SEED, MESH_VIEWS, MESH_SIZE, MESH_RADIUS = 60_000, 4, 12, 512, 3.0
MESH_KW = {"stride": 1, "downsample": 1, "voxel_size": 0.02, "min_weight": 2.0}
MESH_FULL_N, MESH_FULL_CAMS = 300_000, 36
# surface samples of the F1 between two meshes at half a voxel: with 20000
# (mesh_f1_score's default) two equal meshes of the unit sphere would score
# well below 0.999, the samples lying ~0.025 apart
MESH_F1_SAMPLES = 1_000_000
# what a mesh-extraction path may launch: the forward kernels, never a backward
MESH_NEVER = ("render_tiles_backward", "render_surfel_tiles_backward")


def sphere_points(n: int = MESH_N, seed: int = MESH_SEED) -> tuple:
    """bench_all.py bench_extract_mesh's scene: n points on the unit sphere
    and their uniform colours, the same seeded draws in the same order."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts, rng.uniform(size=(n, 3)).astype(np.float32)


def sphere_model(n: int, device, config=None):
    """The model bench_all.py makes of sphere_points: create_from_attribute
    (scales from the 3 nearest neighbours, opacity 0.1), SH degree 0."""
    from gaustudio_torch import models

    pcd = models.make(config or {"name": "vanilla_pcd"}, device=device)
    xyz, rgb = sphere_points(n)
    pcd.create_from_attribute(xyz=xyz, rgb=rgb)
    pcd.active_sh_degree = 0
    return pcd


def orbit_cameras(num_cam: int, size: int, device, radius: float = MESH_RADIUS) -> list:
    from gaustudio_torch.cameras.camera_paths import get_path_from_orbit

    return get_path_from_orbit(np.zeros(3), radius, num_cam=num_cam, image_size=size,
                               fov_deg=60, device=device)


def write_orbit_cameras(path: str, num_cam: int, W: int, H: int,
                        radius: float = MESH_RADIUS) -> str:
    """A cameras.json of num_cam orbit views at WxH: FoVx 60 degrees and
    the same focal length along y."""
    from gaustudio_torch.datasets.utils import camera_to_JSON

    entries = []
    for i, cam in enumerate(orbit_cameras(num_cam, W, "cpu", radius)):
        cj = camera_to_JSON(i, cam)
        cj.update(height=H, fy=cj["fx"], cy=H / 2)
        entries.append(cj)
    with open(path, "w") as f:
        json.dump(entries, f)
    return path


def plain_renderer(renderer):
    """``renderer`` with its settings switched to the plain compositor and
    binning."""
    kernel_settings = renderer.make_settings
    renderer.make_settings = lambda *a: kernel_settings(*a)._replace(backend="plain")
    return renderer


def mesh_counts(tag: str, counts: dict, forward: tuple, phase: str = "mesh") -> None:
    say(phase, f"{tag}: launches {json.dumps(counts)}")
    check(all(counts[k] > 0 for k in forward), f"{tag}: a kernel was not launched: {counts}")
    check(all(counts[k] == 0 for k in MESH_NEVER), f"{tag}: a backward kernel ran: {counts}")


def mesh_fixture(out_dir: str) -> dict:
    """gs-extract-mesh on mini_scene with GOLDEN.json's extract_kw, scored
    against gt_mesh.ply at the thresholds of tests/test_golden_e2e.py."""
    from gaustudio_torch.scripts import extract_mesh as gs_extract_mesh
    from gaustudio_torch.utils.mesh import load_mesh, mesh_f1_score

    with open(os.path.join(FIXTURE, "GOLDEN.json")) as f:
        golden = json.load(f)
    kw = golden["extract_kw"]
    reset_counts()
    path = gs_extract_mesh.main([
        "-m", os.path.join(FIXTURE, "gaussians.ply"), "-s", os.path.join(FIXTURE, "cameras.json"),
        "-o", os.path.join(out_dir, "mesh_fixture"), "--sh", "0", "--device", "cuda",
        "--stride", str(kw["stride"]), "--resolution", str(kw["downsample"]),
        "--voxel_size", str(kw["voxel_size"]), "--sdf_trunc", str(kw["sdf_trunc"]),
        "--min_weight", str(kw["min_weight"])])
    counts = read_counts()
    mesh_counts("mini_scene", counts, FORWARD)
    verts, faces = load_mesh(path)
    gt = load_mesh(os.path.join(FIXTURE, "gt_mesh.ply"))
    f1 = mesh_f1_score(verts, faces, *gt, golden["f1_tau"])
    floor, ceiling = golden["mesh_f1"] - 0.03, golden["mesh_chamfer"] * 1.25 + 1e-4
    say("mesh", f"mini_scene: {len(verts)} vertices, {len(faces)} faces; F1 {f1['f1']:.4f} at "
        f"tau {golden['f1_tau']} (golden {golden['mesh_f1']}, floor {floor:.4f}), chamfer "
        f"{f1['chamfer']:.5f} (golden {golden['mesh_chamfer']}, ceiling {ceiling:.5f})")
    check(f1["f1"] >= floor, f"mini_scene mesh F1 {f1['f1']:.4f}")
    check(f1["chamfer"] <= ceiling, f"mini_scene mesh chamfer {f1['chamfer']:.5f}")
    return counts


def mesh_bench(out_dir: str, device, card: str) -> list:
    """bench_all.py's extraction workload through extract_mesh: cold (the
    process's first extraction) and warm, the kernels against the plain
    compositor on every third view, and the scene as surfels through
    gs-extract-mesh --config 2dgs."""
    from gaustudio_torch import renderers
    from gaustudio_torch.pipelines.mesh_extraction import extract_mesh
    from gaustudio_torch.scripts import extract_mesh as gs_extract_mesh
    from gaustudio_torch.utils.mesh import load_mesh, mesh_f1_score

    pcd = sphere_model(MESH_N, device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    reset_counts()
    timings, meshes = [], []
    for _ in range(2):
        cams = orbit_cameras(MESH_VIEWS, MESH_SIZE, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meshes.append(extract_mesh(pcd, renderer, cams, device=device, **MESH_KW))
        torch.cuda.synchronize()
        timings.append(time.perf_counter() - t0)
    counts = read_counts()
    mesh_counts(f"extract_mesh {MESH_N} Gaussians", counts, FORWARD)
    verts, faces = meshes[1]
    check(len(verts) > 1000 and len(faces) > 1000, f"{len(faces)} faces")
    check(np.array_equal(meshes[0][1], faces), "the warm extraction's faces differ from the cold's")
    radius = float(np.median(np.linalg.norm(verts, axis=1)))
    say("mesh", f"extract_mesh_s {timings[0]:.4f}, extract_mesh_warm_s {timings[1]:.4f} "
        f"({MESH_VIEWS} views at {MESH_SIZE}x{MESH_SIZE}, {MESH_N} Gaussians, voxel "
        f"{MESH_KW['voxel_size']}; host clock fenced by synchronize): {len(verts)} vertices, "
        f"{len(faces)} faces, median radius {radius:.4f} | {card}")
    check(abs(radius - 1.0) < 0.05, f"the sphere's mesh has median radius {radius:.4f}")

    # against the plain compositor on every third view (its per-rank loop
    # takes seconds a view on the host)
    plain = plain_renderer(renderers.make({"name": "vanilla_renderer"}, device=device))
    kw = dict(MESH_KW, stride=3)
    kernel_mesh = extract_mesh(pcd, renderer, orbit_cameras(MESH_VIEWS, MESH_SIZE, device),
                               device=device, **kw)
    t0 = time.perf_counter()
    plain_mesh = extract_mesh(pcd, plain, orbit_cameras(MESH_VIEWS, MESH_SIZE, device),
                              device=device, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    f1 = mesh_f1_score(*kernel_mesh, *plain_mesh, tau=0.5 * MESH_KW["voxel_size"],
                       n_samples=MESH_F1_SAMPLES)
    say("mesh", f"kernels against the plain compositor, {MESH_VIEWS // 3} views: "
        f"{len(kernel_mesh[1])} / {len(plain_mesh[1])} faces, F1 {f1['f1']:.6f} at half a voxel "
        f"({MESH_F1_SAMPLES} samples a mesh; floor 0.999), chamfer {f1['chamfer']:.3e}; "
        f"plain {plain_s:.2f} s | {card}")
    check(f1["f1"] >= 0.999, f"kernel and plain meshes differ: F1 {f1['f1']:.6f}")

    surfels = sphere_model(MESH_N, "cpu", SURFEL_CONFIG)  # its first two scale columns
    ply = os.path.join(out_dir, "mesh_surfel_scene.ply")
    surfels.export(ply)
    cams_path = write_orbit_cameras(os.path.join(out_dir, "mesh_surfel_cameras.json"),
                                    MESH_VIEWS, MESH_SIZE, MESH_SIZE)
    reset_counts()
    t0 = time.perf_counter()
    path = gs_extract_mesh.main([
        "-m", ply, "-s", cams_path, "-o", os.path.join(out_dir, "mesh_surfel"), "--config", "2dgs",
        "--device", "cuda", "--stride", "1", "--resolution", "1",
        "--voxel_size", str(MESH_KW["voxel_size"]), "--min_weight", str(MESH_KW["min_weight"])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    surfel_counts = read_counts()
    mesh_counts("gs-extract-mesh --config 2dgs", surfel_counts, SURFEL_FORWARD)
    sv, sf = load_mesh(path)
    say("mesh", f"gs-extract-mesh --config 2dgs, {MESH_N} surfels: {wall:.2f} s wall, "
        f"{len(sv)} vertices, {len(sf)} faces | {card}")
    check(len(sf) > 1000, f"the surfel mesh has {len(sf)} faces")
    return [counts, surfel_counts]


def mesh_full(out_dir: str, device, card: str) -> dict:
    """gs-extract-mesh with its defaults on 300k Gaussians of the sphere and
    36 orbit cameras at 1920x1080 (12 views at 960x540): the wall, the peak
    device memory, the device's busy share, and a staged run of the same
    pipeline with per-stage times."""
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import mcubes, tsdf
    from gaustudio_torch.pipelines import mesh_extraction as ME
    from gaustudio_torch.scripts import extract_mesh as gs_extract_mesh
    from gaustudio_torch.utils.mesh import load_mesh

    ply = os.path.join(out_dir, "mesh_full_scene.ply")
    sphere_model(MESH_FULL_N, "cpu").export(ply)
    cams_path = write_orbit_cameras(os.path.join(out_dir, "mesh_full_cameras.json"),
                                    MESH_FULL_CAMS, FULL_W, FULL_H)
    argv = ["-m", ply, "-s", cams_path, "-o", os.path.join(out_dir, "mesh_full"),
            "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    path = gs_extract_mesh.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    mesh_counts(f"gs-extract-mesh {MESH_FULL_N} Gaussians, {FULL_W}x{FULL_H}", counts, FORWARD)
    verts, faces = load_mesh(path)
    check(len(faces) > 1000, f"the full-width mesh has {len(faces)} faces")
    check(np.isfinite(verts).all(), "non-finite vertices")
    n_views = len(os.listdir(os.path.join(out_dir, "mesh_full", "masks")))
    check(n_views == MESH_FULL_CAMS // 3, f"{n_views} views written")

    busy = profiled_device_s(lambda: gs_extract_mesh.main(argv))

    # the same pipeline, stage by stage, each fenced by synchronize
    from gaustudio_torch import models
    from gaustudio_torch.datasets.utils import JSON_to_camera

    pcd = models.make({"name": "vanilla_pcd"}, device=device)
    pcd.load(ply)
    pcd.active_sh_degree = 0
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    with open(cams_path) as f:
        cams = [JSON_to_camera(cj, device=device).downsample_scale(2) for cj in json.load(f)[::3]]
    lo, hi = tsdf.integrate_points_bounds(pcd.get_attribute("xyz"))
    vol = tsdf.volume_from_bounds(lo, hi, 0.01, 0.04, max_dim=384, device=device)
    stage_dir = os.path.join(out_dir, "mesh_full_stages")
    os.makedirs(os.path.join(stage_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(stage_dir, "masks"), exist_ok=True)
    stages = {"render": [], "integrate": [], "files": []}

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    for cam in cams:
        t0 = clock()
        out = renderer.render(cam, pcd)
        invalid = out["rendered_final_opacity"][0] < 0.5
        depth = torch.where(invalid, 0.0, out["rendered_median_depth"][0])
        t1 = clock()
        tsdf.integrate(vol, depth, cam.intrinsics, cam.extrinsics)
        t2 = clock()
        ME._save_view_files(stage_dir, cam.image_name, cam, invalid.cpu().numpy(),
                            out["render"].permute(1, 2, 0).cpu().numpy())
        t3 = clock()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(dt * 1e3)
    X, Y, Z = vol.tsdf.shape
    t0 = clock()
    for z0 in range(0, Z - 1, 4):
        mcubes._slab_triangles(vol.tsdf[:, :, z0:z0 + 5], vol.weight[:, :, z0:z0 + 5], z0, 0.0,
                               5.0)
    slabs_s = clock() - t0
    t0 = clock()
    sv, sf = mcubes.marching_tetrahedra(vol.tsdf, 0.0, weight=vol.weight, min_weight=5.0,
                                        origin=vol.origin.cpu().numpy(),
                                        voxel_size=float(vol.voxel_size), slab=4)
    mt_s = clock() - t0
    check(np.array_equal(sf, faces), "the staged run's faces differ from gs-extract-mesh's")

    med = {k: statistics.median(v) for k, v in stages.items()}
    say("mesh", f"full width: grid {X}x{Y}x{Z} (voxel {float(vol.voxel_size):.4f}), "
        f"{len(cams)} views at {cams[0].image_width}x{cams[0].image_height}, {MESH_FULL_N} "
        f"Gaussians: {len(verts)} vertices, {len(faces)} faces | {card}")
    say("mesh", f"full width: gs-extract-mesh {wall:.3f} s wall (load, render, fuse, mesh, "
        f"files), peak device memory {peak / 2 ** 30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated), device busy {busy:.3f} s of the profiled run, busy "
        f"share {busy / wall:.4f} of the unprofiled wall (torch.profiler) | {card}")
    say("mesh", "full width by stage (host clock fenced by synchronize, median of "
        f"{len(cams)} views, ms a view): render {med['render']:.3f}, integrate "
        f"{med['integrate']:.3f}, file writes {med['files']:.3f}; marching tetrahedra "
        f"{mt_s:.3f} s, of which the device's slabs {slabs_s:.3f} s and the host's dedup and "
        f"winding {mt_s - slabs_s:.3f} s | {card}")
    return counts


# --- phase 12: the model and renderer variants ----------------------------

# gs-render --config mip|gsplat|pcd|scaffold at 1080p (the 300k scene of
# phase 5; pcd its xyz and colours; scaffold anchors at the config's widths
# from make_scene(30000)'s means: about 30k anchors, 300k decoded Gaussians),
# Scaffold training at that width, and gs-train --config scaffold on the
# fixture. The lit-fraction guard of a render: colour > 0 in more than this
# share of the pixels.
VARIANT_LIT_MIN = {"mip": 0.9, "gsplat": 0.9, "pcd": 0.5, "scaffold": 0.5}
SCAFFOLD_SCENE_N, SCAFFOLD_SEED = 30_000, 0
# the offsets' scaling and the decoded Gaussians' base scale: sigmoid(0) = 0.5
# of 0.016 is make_scene's median scale 0.008
SCAFFOLD_LOG_SCALES = (math.log(0.05), math.log(0.016))
SCAFFOLD_STEPS = 30
SCAFFOLD_CHECK_STEPS = 6  # kernels against plain, on the fixture (phase 6b's check)
SCAFFOLD_FIXTURE_ITERS = 500
# The JAX ScaffoldTrainer on mini_scene from its sparse points, 500 iterations,
# on the CPU (``JAX_PLATFORMS=cpu python -m tests.test_torch_scaffold 500``):
# the exported model's mean PSNR over the fixture's views against the first
# logged (iteration 100) training PSNR. The gate is that gain less 1 dB.
SCAFFOLD_JAX_GAIN_DB = 13.731001655432792  # 18.8152 (iteration 100) -> 32.5462 dB
SCAFFOLD_FIXTURE_GATE_DB = SCAFFOLD_JAX_GAIN_DB - 1.0
TRAIN_PATH = FORWARD + ("render_tiles_backward",)


def scaffold_config() -> dict:
    from gaustudio_torch.config import builtin_config_path, load_config

    return dict(load_config(builtin_config_path("scaffold"))["model"]["pointcloud"])


def scaffold_model(xyz: np.ndarray, device, seed: int = SCAFFOLD_SEED):
    """Anchors of the scaffold config (10 offsets, a 32-wide feature, voxel
    0.001) at the voxels of ``xyz``: offsets and features N(0, 1) from
    ``seed``, offset scaling 0.05 and base scale 0.016, the heads drawn by the
    model's generator seeded with ``seed``."""
    from gaustudio_torch import models

    pcd = models.make({**scaffold_config(), "seed": seed}, device=device)
    pcd.create_from_attribute(xyz=xyz)
    n, k = pcd.num_points, pcd.n_offsets
    rng = np.random.default_rng(seed)
    pcd._offset = torch.from_numpy(rng.normal(size=(n, 3 * k)).astype(np.float32)).to(device)
    pcd._anchor_feat = torch.from_numpy(
        rng.normal(size=(n, pcd.feat_dim)).astype(np.float32)).to(device)
    scale = np.empty((n, 6), np.float32)
    scale[:, :3], scale[:, 3:] = SCAFFOLD_LOG_SCALES
    pcd._scale = torch.from_numpy(scale).to(device)
    return pcd


def write_variant_scenes(out_dir: str, device) -> dict:
    """{config: PLY} of the variants' models: the 300k scene as a plain point
    cloud (store_ply) and the Scaffold anchors (with the heads' sidecar)."""
    from gaustudio_torch.utils.ply import store_ply

    xyz, _, _, _, colors = make_scene(FULL_N, seed=0)
    pcd_ply = os.path.join(out_dir, "pcd_scene.ply")
    store_ply(pcd_ply, xyz, (colors * 255.0).astype(np.uint8))
    scaffold_ply = os.path.join(out_dir, "scaffold_scene.ply")
    scaffold_model(make_scene(SCAFFOLD_SCENE_N, seed=SCAFFOLD_SEED)[0], device).export(scaffold_ply)
    return {"pcd": pcd_ply, "scaffold": scaffold_ply}


def compare_rasterize(got: dict, ref: dict, what: str) -> float:
    """rasterize() through the kernels against its plain path: floats within
    K3's tolerance, int outputs exact; returns the largest float error."""
    err = 0.0
    for key, a in got.items():
        b = ref[key]
        if not isinstance(a, torch.Tensor) or a.dtype != torch.float32:
            check(torch.equal(torch.as_tensor(a), torch.as_tensor(b)), f"{what}: {key} differs")
            continue
        check(torch.isfinite(a).all(), f"{what}: non-finite {key}")
        err = max(err, float((a - b).abs().max()))
        torch.testing.assert_close(a, b, atol=K3_ATOL, rtol=K3_RTOL, msg=f"{what}: {key}")
    return err


def compare_k7_render(renderer, cam, pcd, what: str) -> float:
    """rasterize() of one view with its preprocess through K7 (autograd off)
    against the same call with ``backend="plain"`` (gaussian.preprocess and
    the plain binning and compositor): int outputs equal, floats within K3's
    tolerance (compare_rasterize), and K7 launched once, by the first call
    alone. Returns the largest float error."""
    from gaustudio_torch.ops import gaussian
    from gaustudio_torch.ops import rasterize as rast

    with torch.no_grad():
        xyz, shs, colors, opacity, scales, rotations, cov3d = (
            renderer.get_gaussians_properties(cam, pcd))
    st = renderer.make_settings(cam, pcd, xyz.device)
    active = getattr(pcd, "active_sh_degree", None) if shs is not None else None

    def run(settings):
        return rast.rasterize(xyz, opacity, settings, shs=shs, colors_precomp=colors,
                              scales=scales, rotations=rotations, cov3D_precomp=cov3d,
                              active_sh_degree=active)

    before = gaussian.preprocess_forward.launches
    with torch.inference_mode():
        got = run(st)
        launched = gaussian.preprocess_forward.launches - before
        ref = run(st._replace(backend="plain"))
    check(launched == 1 and gaussian.preprocess_forward.launches - before == 1,
          f"{what}: K7 launched {launched} times for its render, "
          f"{gaussian.preprocess_forward.launches - before - launched} for the plain path's")
    err = compare_rasterize(got, ref, f"{what}: K7 against the plain path")
    say("kernels", f"{what}: rasterize with K7 against the plain path, {xyz.shape[0]} "
        f"Gaussians, {got['num_rendered']} entries: int outputs equal, max|err| {err:.2e} (tol "
        f"{K3_ATOL:g} + {K3_RTOL:g}*|x|); K7 launched once")
    return err


def variant_render(out_dir: str, config: str, ply: str, cams_path: str, device, card: str):
    """gs-render --config ``config`` of ``ply`` from the three 1080p cameras,
    then the middle view through the kernels against the plain path, timed.
    Returns (launch counts, model, renderer, camera, render)."""
    from gaustudio_torch import models, renderers
    from gaustudio_torch.config import builtin_config_path, load_config
    from gaustudio_torch.ops import rasterize as rast
    from gaustudio_torch.scripts import render as gs_render

    reset_counts()
    t0 = time.perf_counter()
    images = gs_render.main(["-m", ply, "-s", cams_path, "--sh", "3", "--config", config,
                             "--device", "cuda", "-o", os.path.join(out_dir, f"variant_{config}")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    say("variants", f"gs-render --config {config} {FULL_VIEWS} views of {FULL_W}x{FULL_H}: "
        f"{wall:.2f} s wall (load, render, PNG); launches {json.dumps(counts)}")
    check(all(counts[k] > 0 for k in FORWARD), f"{config}: a kernel was not launched: {counts}")
    check(counts["render_tiles_backward"] == 0, f"{config}: the backward ran: {counts}")
    check(len(os.listdir(images)) == FULL_VIEWS, os.listdir(images))

    conf = load_config(builtin_config_path(config))
    pcd = models.make(conf["model"]["pointcloud"], device=device)
    pcd.load(ply)
    pcd.active_sh_degree = 3
    renderer = renderers.make(conf["renderer"], device=device)
    cam = load_cameras(cams_path, device)[1]
    out = renderer.render(cam, pcd)
    rgb = out["render"]
    check(rgb.shape == (3, FULL_H, FULL_W) and torch.isfinite(rgb).all(),
          f"{config}: render {tuple(rgb.shape)} is not a finite [3, {FULL_H}, {FULL_W}] image")
    lit = float((rgb.sum(0) > 0).float().mean())
    say("variants", f"{config}: lit fraction {lit:.4f} (guard > {VARIANT_LIT_MIN[config]}), mean "
        f"{float(rgb.mean()):.4f}, {out['num_rendered']} entries, {pcd.num_points} points")
    check(lit > VARIANT_LIT_MIN[config], f"{config}: render mostly empty: {lit:.3f} lit")

    with torch.inference_mode():
        xyz, shs, colors, opacity, scales, rotations, cov3d = (
            renderer.get_gaussians_properties(cam, pcd))
        st = renderer.make_settings(cam, pcd, device)

        def run(settings):
            return rast.rasterize(xyz, opacity, settings, shs=shs, colors_precomp=colors,
                                  scales=scales, rotations=rotations, cov3D_precomp=cov3d,
                                  active_sh_degree=3 if shs is not None else None)

        t0 = time.perf_counter()
        ref = run(st._replace(backend="plain"))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = compare_rasterize(run(st), ref, f"{config} kernels against plain")
        run(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run(st)
        torch.cuda.synchronize()
        kernels_s = (time.perf_counter() - t0) / 20
        say("time", f"{config}: rasterize {FULL_W}x{FULL_H} {xyz.shape[0]} Gaussians: kernels "
            f"{kernels_s * 1e3:.3f} ms wall (mean of 20 warm calls) = "
            f"{FULL_W * FULL_H / 1e6 / kernels_s:.2f} MPix/s; plain {plain_s * 1e3:.1f} ms (one "
            f"call); kernels - plain max|err| {err:.2e} (tol {K3_ATOL:g} + {K3_RTOL:g}*|x|, int "
            f"outputs exact) | {card}")
        busy_share(f"{config}: rasterize {FULL_W}x{FULL_H}", lambda: run(st), kernels_s, card)
    compare_k7_render(renderer, cam, pcd, config)
    return counts, pcd, renderer, cam, out


def scaffold_step_breakdown(state, batch, settings, cfg, heads, k: int) -> dict:
    """One Scaffold step's stages between CUDA events: the decode and
    rasterize() forward, the loss, the backward (and inside it K4's node),
    Adam with the statistics."""
    from gaustudio_torch.ops import rasterize as rast
    from gaustudio_torch.pipelines import train_scaffold as TSc

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    device = batch.gt_image.device
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    ev[0].record()
    params = {key: v.detach().requires_grad_(True) for key, v in state.params.items()}
    offset2d = torch.zeros((state.num_anchors * k, 2), device=device, requires_grad=True)
    xyz, color, opacity, scales, rots, neural_op = TSc.decode_scaffold(params, heads, s.campos, k)
    out = rast.rasterize(xyz, opacity, s, colors_precomp=color, scales=scales, rotations=rots,
                         means2D_offset=offset2d)
    ev[1].record()
    node = out["render"].grad_fn
    node.register_prehook(lambda grad_outputs: ev[5].record())
    node.register_hook(lambda grad_inputs, grad_outputs: ev[6].record())
    loss = TSc.scaffold_loss(out, opacity, scales, batch.gt_image, cfg)
    ev[2].record()
    leaves = list(params.values()) + [offset2d]
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]  # rot is not decoded
    ev[3].record()
    with torch.no_grad():
        live = (out["radii"] > 0) & (opacity > 0.0)
        _ = (state.offset_grad_accum + torch.where(live, grads[-1].norm(dim=-1), 0.0),
             torch.clamp(neural_op, 0.0, 1.0).reshape(-1, k).sum(1), live.reshape(-1, k).any(1))
        TSc.shared_adam_update(dict(zip(params, grads[:-1])), state.mu, state.nu,
                               state.opt_count, state.params,
                               TSc.learning_rates(state.params, state.step, cfg))
    ev[4].record()
    torch.cuda.synchronize()
    names = ("decode + forward", "loss", "backward", "Adam + statistics")
    times = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    times["K4's node inside backward"] = ev[5].elapsed_time(ev[6])
    return times


def scaffold_train_full(pcd, ply: str, cams_path: str, device, card: str) -> dict:
    """SCAFFOLD_STEPS steps of the full-width anchors against the three 1080p
    views of the 300k vanilla scene, then one adjust_anchors call (its
    interval set to the steps taken); returns the launch counts of the steps."""
    from gaustudio_torch import renderers
    from gaustudio_torch.pipelines import train_scaffold as TSc

    cams = load_cameras(cams_path, device)
    vanilla = renderers.make({"name": "vanilla_renderer"}, device=device)
    target = load_model(ply, 3, device)
    for cam in cams:
        cam.image = vanilla.render(cam, target)["render"].permute(1, 2, 0).clone()
    del target
    cfg = TSc.ScaffoldTrainConfig(update_interval=SCAFFOLD_STEPS)
    trainer = TSc.ScaffoldTrainer(pcd, cams, cfg, device=device)
    batches = [trainer.batch(c) for c in cams]
    settings = trainer.settings()
    k = pcd.n_offsets
    step = lambda state, b: TSc.train_step_scaffold(state, b, settings, cfg, pcd.mlp, k)  # noqa: E731
    state = trainer.state
    reset_counts()
    losses, wall = [], []
    for i in range(SCAFFOLD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    label = f"Scaffold {FULL_W}x{FULL_H}, {state.num_anchors} anchors x {k}"
    check(all(counts[key] > 0 for key in TRAIN_PATH), f"{label}: a kernel was not launched: "
          f"{counts}")
    check(counts["render_tiles_backward"] == SCAFFOLD_STEPS, f"{label}: K4 launches {counts}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
    median = statistics.median(wall[5:])
    say("train", f"{label}: loss {losses[0]:.5f} (step 1) -> {losses[-1]:.5f} (step "
        f"{SCAFFOLD_STEPS}); {median:.3f} ms/it (median of steps 6-{SCAFFOLD_STEPS}, each fenced "
        f"by synchronize; min {min(wall[5:]):.3f}, max {max(wall[5:]):.3f}); {metrics['num_rendered']}"
        f" entries; launches {json.dumps(counts)} | {card}")
    busy_share(f"{label} training step", lambda: step(state, batches[0]), median / 1e3, card)
    runs = [scaffold_step_breakdown(state, batches[i % len(batches)], settings, cfg, pcd.mlp, k)
            for i in range(5)]
    say("train", f"{label}: one step by stage (CUDA events, median of 5 steps, ms): "
        + ", ".join(f"{key} {statistics.median(r[key] for r in runs):.3f}" for key in runs[0])
        + f" | {card}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adjusted = TSc.adjust_anchors(state, cfg, pcd)
    torch.cuda.synchronize()
    adjust_ms = (time.perf_counter() - t0) * 1e3
    for key, v in adjusted.params.items():
        check(torch.isfinite(v).all(), f"{label}: non-finite {key} after adjust_anchors")
    say("train", f"{label}: adjust_anchors {adjust_ms:.3f} ms: {state.num_anchors} -> "
        f"{adjusted.num_anchors} anchors (statistics of {SCAFFOLD_STEPS} steps, interval "
        f"{cfg.update_interval}) | {card}")
    return counts


def scaffold_kernels_vs_plain(device, card: str, steps: int = SCAFFOLD_CHECK_STEPS) -> None:
    """The same Scaffold steps through the kernels and through the plain
    versions, from one model of the fixture's sparse points (scaffold_model),
    one camera sequence: final mean PSNR within 0.1 dB."""
    from gaustudio_torch import datasets
    from gaustudio_torch.ops import rasterize as rast
    from gaustudio_torch.pipelines import train_scaffold as TSc
    from gaustudio_torch.utils.ply import fetch_ply

    ds = datasets.make({"name": "vanilla", "source_path": FIXTURE})
    pcd = scaffold_model(fetch_ply(os.path.join(FIXTURE, "sparse_points.ply"))[0], device)
    cfg = TSc.ScaffoldTrainConfig(update_from=10 ** 9)
    trainer = TSc.ScaffoldTrainer(pcd, ds, cfg, device=device)
    batches = [trainer.batch(c) for c in trainer.cameras]
    order = np.random.default_rng(0).integers(len(batches), size=steps)
    kernel_settings = trainer.settings()
    k = pcd.n_offsets
    final = {}
    for name, settings in (("kernels", kernel_settings),
                           ("plain", kernel_settings._replace(backend="plain"))):
        state = TSc.init_scaffold_state(pcd, device)
        t0 = time.perf_counter()
        for i in order:
            state, metrics = TSc.train_step_scaffold(state, batches[i], settings, cfg, pcd.mlp, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.no_grad():
            scores = []
            for b in batches:
                s = kernel_settings._replace(viewmatrix=b.viewmatrix, projmatrix=b.projmatrix,
                                             campos=b.campos, bg=torch.zeros(3, device=device))
                xyz, color, opacity, scales, rots, _ = TSc.decode_scaffold(
                    state.params, pcd.mlp, b.campos, k)
                out = rast.rasterize(xyz, opacity, s, colors_precomp=color, scales=scales,
                                     rotations=rots)
                scores.append(psnr(out["render"], b.gt_image))
        final[name] = (float(np.mean(scores)), wall)
        say("train", f"scaffold: {steps} steps, {pcd.num_points} anchors of the fixture with the "
            f"{name} versions: {wall:.2f} s, last loss {float(metrics['loss']):.5f}, mean PSNR "
            f"{final[name][0]:.4f} dB | {card}")
    gap = final["kernels"][0] - final["plain"][0]
    say("train", f"scaffold: kernels - plain PSNR {gap:+.4f} dB (tol 0.1)")
    check(abs(gap) <= 0.1, f"scaffold: kernel and plain training differ by {gap:.4f} dB")


def scaffold_train_fixture(out_dir: str, device, card: str) -> dict:
    """gs-train --config scaffold on the fixture's views from its sparse
    points: the exported model's mean PSNR against the first logged PSNR, at
    least SCAFFOLD_FIXTURE_GATE_DB better; returns the launch counts."""
    from gaustudio_torch import models
    from gaustudio_torch.scripts import train as gs_train

    src = os.path.join(out_dir, "train_src")
    out = os.path.join(out_dir, "train_out_scaffold")
    for d in (src, out):
        shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(FIXTURE, "images"), os.path.join(src, "images"))
    shutil.copy(os.path.join(FIXTURE, "cameras.json"), src)
    os.makedirs(os.path.join(src, "sparse", "0"))
    shutil.copy(os.path.join(FIXTURE, "sparse_points.ply"),
                os.path.join(src, "sparse", "0", "points3D.ply"))
    iters = SCAFFOLD_FIXTURE_ITERS
    reset_counts()
    t0 = time.perf_counter()
    history = gs_train.main(["-s", src, "-o", out, "--dataset", "vanilla", "--iterations",
                             str(iters), "--save_every", str(iters), "--config", "scaffold",
                             "--device", "cuda", "--gpu", str(device.index or 0)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    say("train", f"gs-train --config scaffold {iters} iterations on mini_scene: {wall:.2f} s "
        f"wall; {int(history[-1]['num_points'])} anchors; launches {json.dumps(counts)} | {card}")
    check(all(counts[key] > 0 for key in TRAIN_PATH), f"a kernel was not launched: {counts}")
    pcd = models.make(scaffold_config(), device=device)
    pcd.load(os.path.join(out, "point_cloud", f"iteration_{iters}", "point_cloud.ply"))
    cams = load_cameras(os.path.join(FIXTURE, "cameras.json"), device)
    after = float(np.mean(render_psnr(pcd, cams, device, "scaffold_renderer")))
    first = history[0]
    gain = after - first["psnr"]
    say("train", f"scaffold: first logged PSNR {first['psnr']:.4f} dB (iteration "
        f"{first['iter']}), exported model {after:.4f} dB mean over {len(cams)} views: "
        f"{gain:+.4f} dB (gate {SCAFFOLD_FIXTURE_GATE_DB:+.4f}: the JAX CPU run's "
        f"{SCAFFOLD_JAX_GAIN_DB:+.4f} less 1)")
    check(gain >= SCAFFOLD_FIXTURE_GATE_DB, f"scaffold fixture gain {gain:.3f} dB")
    return counts


def variants(out_dir: str, ply: str, cams_path: str, device, card: str) -> list:
    """Phase 12; returns the launch counts of its paths."""
    from gaustudio_torch import renderers

    scenes = write_variant_scenes(out_dir, device)
    counts = []
    for config in ("mip", "gsplat"):
        c, pcd, renderer, cam, out = variant_render(out_dir, config, ply, cams_path, device, card)
        counts.append(c)
        if config == "mip":
            raw = pcd.get_attribute("opacity")
            check(bool((pcd.get_opacity_with_3D_filter <= raw).all()),
                  "mip: a filtered opacity exceeds its raw opacity")
            say("variants", f"mip: filtered opacity mean {float(pcd.get_opacity_with_3D_filter.mean()):.4f}"
                f" <= raw {float(raw.mean()):.4f}; filter from the first view, median "
                f"{float(pcd.filter_3D.median()):.3e}")
        else:
            vanilla = renderers.make({"name": "vanilla_renderer"}, device=device).render(cam, pcd)
            diff = float((out["render"] - vanilla["render"]).abs().max())
            say("variants", f"gsplat - vanilla image max|diff| {diff:.4f} on the same model")
            check(diff > 1e-3, "gsplat renders the vanilla image")
    counts.append(variant_render(out_dir, "pcd", scenes["pcd"], cams_path, device, card)[0])
    c, scaffold, _, _, _ = variant_render(out_dir, "scaffold", scenes["scaffold"], cams_path,
                                          device, card)
    counts.append(c)
    counts.append(scaffold_train_full(scaffold, ply, cams_path, device, card))
    scaffold_kernels_vs_plain(device, card)
    counts.append(scaffold_train_fixture(out_dir, device, card))
    return counts


# --- phase 13: point extraction and the mesh tools --------------------------

# gs-extract-pcd's kernels-against-plain check takes every other mini_scene
# view (the plain compositor's per-rank loop takes seconds a view on the host)
PCD_FIXTURE_STRIDE = 2
# a surface-id difference between the two paths must sit this close to one of
# the float thresholds that choose the samples (opacity 0.5 and 0.1, median
# depth against 0.8 x the scene radius)
PCD_TIE_TOL = 1e-5
PCD_NORMAL_TOL = 1e-4
REVOTE_THRESHOLD = 0.8  # pcd_extraction.vote_normals' consistency threshold
# Gaussians at which the re-vote may keep a sample on one path and drop it on
# the other (render noise at the threshold) before the check fails
REVOTE_FLIP_MAX = 5
PCD_GRID = 128  # gs-extract-pcd's SAP grid (mesh_sap's default)
# gs-from-mesh's render: orbit views at radius 2.5, where the sphere covers
# most of the 1080p frame (at radius 3 it covers about half)
FROM_MESH_RADIUS, FROM_MESH_VIEWS = 2.5, 3
RASTER_CHECK_PIXELS = 256  # pixels of the middle view held to raster_reference
RASTER_EMPTY_PIXELS = 32  # ... of them drawn over the whole view, the rest near its coverage
RASTER_GROW_PX = 2
STAGED_STRIDE = 3  # the staged runs time every third view's files
# phase 11's full-width extraction wrote every third camera at half size
MESH_FULL_STRIDE, MESH_FULL_DOWNSAMPLE = 3, 2


def sap_voxel(xyz: np.ndarray, grid_res: int = PCD_GRID) -> float:
    """The world size of one voxel of ShapeAsPoints' grid over ``xyz``."""
    return (float(np.max(xyz.max(0) - xyz.min(0))) * 1.2 + 1e-6) / grid_res


def sap_f1(a: tuple, b: tuple, xyz: np.ndarray) -> dict:
    """Phase 11's mesh F1 (MESH_F1_SAMPLES a mesh) of two SAP meshes at half
    a SAP voxel of the cloud ``xyz``."""
    from gaustudio_torch.utils.mesh import mesh_f1_score

    return mesh_f1_score(*a, *b, tau=0.5 * sap_voxel(xyz), n_samples=MESH_F1_SAMPLES)


def pcd_samples(renderer, pcd, cams: list, radius: float) -> tuple:
    """Each view's render and surface samples (pcd_extraction.surface_samples)."""
    from gaustudio_torch.pipelines import pcd_extraction as P

    outs = [renderer.render(cam, pcd) for cam in cams]
    return outs, [P.surface_samples(o, cam, radius) for o, cam in zip(outs, cams)]


def compare_pcd_backends(config: str, device, card: str) -> None:
    """mini_scene's surface samples, fused normals and SAP meshes through the
    kernels against the plain compositor and binning, every
    PCD_FIXTURE_STRIDE-th view."""
    from scipy.spatial import cKDTree

    from gaustudio_torch import models, renderers
    from gaustudio_torch.config import builtin_config_path, load_config
    from gaustudio_torch.datasets.utils import getNerfppNorm
    from gaustudio_torch.pipelines import pcd_extraction as P

    conf = load_config(builtin_config_path(config))
    pcd = models.make(conf["model"]["pointcloud"], device=device)
    pcd.load(os.path.join(FIXTURE, "gaussians.ply"))
    pcd.active_sh_degree = 0
    cams = load_cameras(os.path.join(FIXTURE, "cameras.json"), device)[::PCD_FIXTURE_STRIDE]
    radius = getNerfppNorm(cams)["radius"]
    outs, kern = pcd_samples(renderers.make(conf["renderer"], device=device), pcd, cams, radius)
    plain_outs, plain = pcd_samples(plain_renderer(renderers.make(conf["renderer"], device=device)),
                                    pcd, cams, radius)
    differ, loose = 0, set()
    for out, plain_out, k, p in zip(outs, plain_outs, kern, plain):
        opacity, med = out["rendered_final_opacity"][0], out["rendered_median_depth"][0]
        near = ((opacity - 0.5).abs() < PCD_TIE_TOL) | ((opacity - 0.1).abs() < PCD_TIE_TOL) | (
            (med - 0.8 * radius).abs() < PCD_TIE_TOL)
        diff = k["valid"] ^ p["valid"]
        check(bool(near[diff].all()), f"{config}: {int((diff & ~near).sum())} pixels choose other "
              "surface samples through the kernels than through the plain path, off every threshold")
        ids, plain_ids = out["rendered_median_id"][0], plain_out["rendered_median_id"][0]
        both = k["valid"] & p["valid"]
        check(torch.equal(ids[both], plain_ids[both]), f"{config}: the median ids differ")
        differ += int(diff.sum())
        loose.update(ids[diff].tolist() + plain_ids[diff].tolist())
    flipped, flips, noise, dn = revote_ties(pcd, kern, plain, cams)
    say("pcd", f"--config {config}: re-vote: {len(flips)} samples kept on one path and dropped "
        f"on the other (id, distance - {REVOTE_THRESHOLD} through the kernels, through the plain "
        f"path: {', '.join(f'{i} {a:+.3e} {b:+.3e}' for i, a, b in flips) or 'none'}); the "
        f"paths' distances differ by at most {noise:.3e}, their sample normals by {dn:.3e}")
    check(len(flipped) <= REVOTE_FLIP_MAX, f"{config}: the re-vote parts the paths at "
          f"{len(flipped)} ids (at most {REVOTE_FLIP_MAX})")
    loose |= flipped
    fused = {}
    for name, samples in (("kernels", kern), ("plain", plain)):
        fused[name] = P.normal_fusion(pcd, [s["ids"] for s in samples],
                                      [s["normals"] for s in samples],
                                      [s["conf"] for s in samples], cams)
    (ids_k, n_k), (ids_p, n_p) = fused["kernels"], fused["plain"]
    check(set(ids_k.tolist()) ^ set(ids_p.tolist()) <= loose,
          f"{config}: the surface ids differ beyond the {differ} pixels at a threshold")
    common, ik, ip = np.intersect1d(ids_k, ids_p, return_indices=True)
    # the kNN smoothing carries a loose id's normal to its neighbours
    xyz = pcd._xyz[torch.as_tensor(common, device=device)].cpu().numpy()
    _, nbrs = cKDTree(xyz).query(xyz, k=min(10, len(xyz)))
    keep = ~np.isin(common[nbrs], list(loose)).any(1)
    err = float(np.abs(n_k[ik][keep] - n_p[ip][keep]).max())
    check(err <= PCD_NORMAL_TOL, f"{config}: fused normals differ by {err:.3e}")

    meshes, clouds = {}, {}
    for name, (ids, normals) in fused.items():
        xyz = pcd._xyz[torch.as_tensor(ids, device=device)].cpu().numpy()
        clouds[name] = P.clean_point_cloud(xyz, P.surface_colors(pcd, ids), normals)
        meshes[name] = P.mesh_sap(clouds[name][0], clouds[name][2], device=device)
    f1 = sap_f1(meshes["kernels"], meshes["plain"], clouds["kernels"][0])
    say("pcd", f"--config {config}, {len(cams)} mini_scene views, kernels against plain: "
        f"{len(ids_k)} / {len(ids_p)} surface ids ({differ} pixels differ, each within "
        f"{PCD_TIE_TOL:g} of a threshold; {len(loose)} ids at a threshold or parted by the "
        f"re-vote), fused normals max|err| {err:.3e} on the {int(keep.sum())} common ids with "
        f"no such id among their kNN neighbours ({len(common) - int(keep.sum())} left out; "
        f"tol {PCD_NORMAL_TOL:g}), SAP meshes {len(meshes['kernels'][1])} / "
        f"{len(meshes['plain'][1])} faces, F1 {f1['f1']:.6f} at half a SAP voxel "
        f"({MESH_F1_SAMPLES} samples a mesh; floor 0.999) | {card}")
    check(f1["f1"] >= 0.999, f"{config}: kernel and plain SAP meshes differ: F1 {f1['f1']:.6f}")


def revote_distances(pcd, samples: list, cams: list) -> torch.Tensor:
    """Each sample's distance from its Gaussian's first-vote mean normal,
    which the re-vote compares with REVOTE_THRESHOLD, in sample order."""
    from gaustudio_torch.pipelines import pcd_extraction as P

    ids, normals = [s["ids"] for s in samples], [s["normals"] for s in samples]
    # with an infinite threshold the re-vote keeps every sample: the first mean
    uniq, mean = P.vote_normals(pcd._xyz, ids, normals, [s["conf"] for s in samples], cams,
                                consistency_threshold=math.inf)
    cat_ids, cat_normals = torch.cat(ids), torch.cat(normals)
    return torch.linalg.norm(cat_normals.double() - mean[torch.searchsorted(uniq, cat_ids)], dim=1)


def revote_ties(pcd, kern: list, plain: list, cams: list) -> tuple:
    """The samples that the re-vote keeps on one path and drops on the
    other, at the pixels valid on both: (their Gaussian ids, a list of
    (id, distance - REVOTE_THRESHOLD through the kernels, through the plain
    path)), the largest difference between the two paths' distances over
    every such sample, and the largest difference of a sample's normal."""
    d = {}
    for name, samples in (("kernels", kern), ("plain", plain)):
        d[name] = revote_distances(pcd, samples, cams)
    pos_k, pos_p, start_k, start_p = [], [], 0, 0
    for k, p in zip(kern, plain):
        both = (k["valid"] & p["valid"]).flatten()
        rank_k = torch.cumsum(k["valid"].flatten().long(), 0) - 1
        rank_p = torch.cumsum(p["valid"].flatten().long(), 0) - 1
        pos_k.append(rank_k[both] + start_k)
        pos_p.append(rank_p[both] + start_p)
        start_k += len(k["ids"])
        start_p += len(p["ids"])
    pos_k, pos_p = torch.cat(pos_k), torch.cat(pos_p)
    d_k, d_p = d["kernels"][pos_k], d["plain"][pos_p]
    n_k = torch.cat([s["normals"] for s in kern])[pos_k]
    n_p = torch.cat([s["normals"] for s in plain])[pos_p]
    noise = float((d_k - d_p).abs().max()) if len(pos_k) else 0.0
    dn = float((n_k - n_p).abs().max()) if len(pos_k) else 0.0
    flip = (d_k < REVOTE_THRESHOLD) != (d_p < REVOTE_THRESHOLD)
    ids = torch.cat([s["ids"] for s in kern])[pos_k][flip].tolist()
    rows = list(zip(ids, (d_k[flip] - REVOTE_THRESHOLD).tolist(),
                    (d_p[flip] - REVOTE_THRESHOLD).tolist()))
    return set(ids), rows, noise, dn


def pcd_fixture(out_dir: str, device, card: str) -> list:
    """gs-extract-pcd on mini_scene through the CLI (vanilla and --config
    2dgs), each with its launches, then against the plain path."""
    from gaustudio_torch.scripts import extract_pcd as gs_extract_pcd
    from gaustudio_torch.utils.mesh import load_mesh
    from gaustudio_torch.utils.ply import fetch_ply

    # a PLY model's cloud lands beside it (<model>_fused.ply): a copy in out_dir
    model = os.path.join(out_dir, "pcd_fixture.ply")
    shutil.copy(os.path.join(FIXTURE, "gaussians.ply"), model)
    counts = []
    for config, forward in (("vanilla", FORWARD), ("2dgs", SURFEL_FORWARD)):
        reset_counts()
        fused, mesh = gs_extract_pcd.main([
            "-m", model, "-c", os.path.join(FIXTURE, "cameras.json"), "-o",
            os.path.join(out_dir, f"pcd_{config}"), "--sh", "0", "--config", config,
            "--device", "cuda"])
        counts.append(read_counts())
        mesh_counts(f"gs-extract-pcd --config {config} mini_scene", counts[-1], forward, "pcd")
        xyz, _, normals = fetch_ply(fused)
        verts, faces = load_mesh(mesh)
        say("pcd", f"gs-extract-pcd --config {config} mini_scene: {len(xyz)} points, SAP mesh "
            f"{len(verts)} vertices, {len(faces)} faces")
        check(len(xyz) > 100 and len(faces) > 100 and np.isfinite(normals).all(),
              f"{config}: {len(xyz)} points, {len(faces)} faces")
        compare_pcd_backends(config, device, card)
    return counts


def pcd_full(out_dir: str, device, card: str) -> dict:
    """gs-extract-pcd with its defaults (every view at full size, SAP at grid
    128) on phase 11's 300k sphere from its 36 cameras at 1920x1080: the
    wall, peak device memory, busy share, the sphere's checks, and a staged
    run with per-stage times."""
    from gaustudio_torch import renderers
    from gaustudio_torch.datasets.utils import getNerfppNorm
    from gaustudio_torch.models.sap import ShapeAsPoints
    from gaustudio_torch.ops import dpsr
    from gaustudio_torch.pipelines import pcd_extraction as P
    from gaustudio_torch.scripts import extract_pcd as gs_extract_pcd
    from gaustudio_torch.utils.mesh import load_mesh
    from gaustudio_torch.utils.ply import fetch_ply

    ply = os.path.join(out_dir, "mesh_full_scene.ply")
    cams_path = os.path.join(out_dir, "mesh_full_cameras.json")
    argv = ["-m", ply, "-c", cams_path, "-o", os.path.join(out_dir, "pcd_full"), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fused, mesh = gs_extract_pcd.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    mesh_counts(f"gs-extract-pcd {MESH_FULL_N} Gaussians, {FULL_W}x{FULL_H}", counts, FORWARD,
                "pcd")
    xyz, _, normals = fetch_ply(fused)
    verts, faces = load_mesh(mesh)
    radial = float(((normals * xyz).sum(1) > 0).mean())
    voxel = sap_voxel(xyz)
    off = float(np.median(np.abs(np.linalg.norm(verts, axis=1) - 1.0)))
    check(np.isfinite(xyz).all() and np.isfinite(normals).all(), "non-finite fused points")
    check(radial >= 0.95, f"{radial:.4f} of the fused normals point outward")
    check(len(faces) > 1000, f"the SAP mesh has {len(faces)} faces")
    check(off < 2 * voxel, f"the SAP mesh lies {off:.4f} from the sphere (voxel {voxel:.4f})")

    busy = profiled_device_s(lambda: gs_extract_pcd.main(argv))

    # the same pipeline, stage by stage, each fenced by synchronize
    pcd = load_model(ply, 0, device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    cams = load_cameras(cams_path, device)
    radius = getNerfppNorm(cams)["radius"]
    timed = set(range(0, len(cams), STAGED_STRIDE))
    stage_dir = os.path.join(out_dir, "pcd_full_stages")
    for sub in ("images", "normals", "masks"):
        os.makedirs(os.path.join(stage_dir, sub), exist_ok=True)
    per_view = {"render": [], "filter + normals": [], "files": []}
    samples = []

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    for i, cam in enumerate(cams):
        t0 = clock()
        out = renderer.render(cam, pcd)
        t1 = clock()
        s = P.surface_samples(out, cam, radius)
        t2 = clock()
        samples.append(s)
        if i not in timed:  # every view's samples, the files of every STAGED_STRIDE-th
            continue
        P._save_view_files(stage_dir, cam.image_name, cam, out["render"].permute(1, 2, 0).cpu().numpy(),
                           s["cam_normals"].cpu().numpy(), s["fg"].cpu().numpy())
        t3 = clock()
        for key, dt in zip(per_view, (t1 - t0, t2 - t1, t3 - t2)):
            per_view[key].append(dt * 1e3)
    stages = {}
    t0 = clock()
    ids, mean_normals = P.vote_normals(pcd._xyz, [s["ids"] for s in samples],
                                       [s["normals"] for s in samples],
                                       [s["conf"] for s in samples], cams)
    surf_xyz, mean_normals = pcd._xyz[ids].cpu().numpy(), mean_normals.cpu().numpy()
    t1 = clock()
    smoothed = P.smooth_normals(surf_xyz, mean_normals)
    t2 = clock()
    cleaned = P.clean_point_cloud(surf_xyz, P.surface_colors(pcd, ids), smoothed)
    t3 = clock()
    sap = ShapeAsPoints.from_pointcloud(cleaned[0], cleaned[2], {"grid_res": PCD_GRID},
                                        device=device)
    grid = sap.psr_grid()
    t4 = clock()
    _, sap_faces, _ = dpsr.mc_from_psr(grid)
    t5 = clock()
    for key, a, b in (("fusion", t0, t1), ("kNN smoothing", t1, t2), ("cleaning", t2, t3),
                      ("DPSR solve", t3, t4), ("marching", t4, t5)):
        stages[key] = b - a
    # float atomics (index_add_) sum in another order each run: the counts may
    # part by a hair
    check(len(cleaned[0]) == len(xyz) and abs(len(sap_faces) - len(faces)) <= 1e-3 * len(faces),
          f"the staged run's cloud or mesh differs from gs-extract-pcd's: {len(cleaned[0])} / "
          f"{len(xyz)} points, {len(sap_faces)} / {len(faces)} faces")

    med = {k: statistics.median(v) for k, v in per_view.items()}
    say("pcd", f"full width: {len(cams)} views at {FULL_W}x{FULL_H}, {MESH_FULL_N} Gaussians: "
        f"{len(ids)} points before cleaning, {len(xyz)} after; SAP grid {PCD_GRID}^3 (voxel "
        f"{voxel:.5f}): {len(verts)} vertices, {len(faces)} faces; {radial:.4f} of the normals "
        f"point outward (floor 0.95); median |r - 1| of the vertices {off:.5f} (ceiling "
        f"{2 * voxel:.5f}) | {card}")
    say("pcd", f"full width: gs-extract-pcd {wall:.3f} s wall (load, render, filter, fuse, "
        f"clean, mesh, files), peak device memory {peak / 2 ** 30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated), device busy {busy:.3f} s of the profiled run, busy "
        f"share {busy / wall:.4f} of the unprofiled wall (torch.profiler) | {card}")
    say("pcd", "full width by stage (host clock fenced by synchronize; median of "
        f"{len(timed)} views, ms a view): render {med['render']:.3f}, filter + normals "
        f"{med['filter + normals']:.3f}, file writes {med['files']:.3f}; seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" | {card}")
    return counts


def screen64(verts: torch.Tensor, cam) -> tuple:
    """float64 pixel positions (x, y) and view z of ``verts`` in ``cam``."""
    v = verts.double()
    v1 = torch.cat([v, torch.ones_like(v[:, :1])], 1)
    hom = v1 @ cam.full_proj_transform.to(v).double()
    ndc = hom[:, :3] / (hom[:, 3:4] + 1e-9)
    W, H = int(cam.image_width), int(cam.image_height)
    return (((ndc[:, 0] + 1) * W - 1) / 2, ((ndc[:, 1] + 1) * H - 1) / 2,
            (v1 @ cam.world_view_transform.to(v).double())[:, 2])


def raster_reference(verts: torch.Tensor, faces: torch.Tensor, cam, pixels) -> tuple:
    """A plain reference of rasterize_mesh in float64, one pixel at a time:
    every front triangle's edge functions at the pixel centre, the least
    perspective-correct depth and the smallest triangle id within (1 + 1e-6)
    of it. Returns per pixel (depth, id, -1 where empty) and the depth each
    triangle has there (inf where it misses), as a list."""
    x, y, z = screen64(verts, cam)
    f = faces.long()
    xs, ys, zs = x[f], y[f], z[f]  # [F, 3]
    front = (zs > 1e-3).all(1)
    depths, ids, per_tri = [], [], []
    for px, py in pixels:
        # E(p) = dy * (px - ax) - dx * (py - ay) over the edges (1, 2), (2, 0), (0, 1)
        e = torch.stack([(ys[:, b] - ys[:, a]) * (px - xs[:, a]) - (xs[:, b] - xs[:, a])
                         * (py - ys[:, a]) for a, b in ((1, 2), (2, 0), (0, 1))], 1)
        area = e.sum(1)
        inside = ((e >= 0).all(1) | (e <= 0).all(1)) & (area.abs() > 1e-12) & front
        lam = e / torch.where(area.abs() > 1e-12, area, 1.0)[:, None]
        d = 1.0 / torch.clamp_min((lam / zs).sum(1), 1e-9)
        d = torch.where(inside & (d > 1e-3), d, torch.inf)
        zmin = d.min()
        win = torch.nonzero(d <= zmin * (1 + 1e-6)).flatten()
        depths.append(float(zmin) if torch.isfinite(zmin) else 0.0)
        ids.append(int(win.min()) if torch.isfinite(zmin) else -1)
        per_tri.append(d)
    return np.array(depths), np.array(ids), per_tri


def raster_pixels(frag, n: int, seed: int) -> np.ndarray:
    """n seeded pixels (x, y) of ``frag``'s view: RASTER_EMPTY_PIXELS drawn
    over the whole view, the rest from its coverage grown by
    RASTER_GROW_PX pixels, where a pixel the float64 reference covers and
    the device does not would lie."""
    rng = np.random.default_rng(seed)
    H, W = frag.mask.shape
    n_any = min(RASTER_EMPTY_PIXELS, n)
    k = 2 * RASTER_GROW_PX + 1
    grown = torch.nn.functional.max_pool2d(frag.mask[None, None].float(), k, 1, RASTER_GROW_PX)
    near = torch.nonzero(grown[0, 0] > 0).cpu().numpy()[:, ::-1]
    anywhere = np.stack([rng.integers(0, W, n_any), rng.integers(0, H, n_any)], 1)
    if not len(near):
        return np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], 1)
    return np.concatenate([near[rng.choice(len(near), n - n_any, replace=len(near) < n - n_any)],
                           anywhere])


def bary_bound(verts, faces, cam, tri: np.ndarray, pix: np.ndarray) -> tuple:
    """The float64 barycentrics [n, 3] of triangles ``tri`` at pixels ``pix``
    (rasterize_mesh's l0, l1, 1 - l0 - l1: edges (1, 2), (2, 0), (0, 1)) and
    a first-order bound [n, 3] on the float32 rasterizer's error in them:
    the screen corners' float32 rounding (measured, the corners projected as
    rasterize_mesh projects them) times the edge function's slope, plus 4
    roundings of each product and sum of its terms, carried through the
    division by the area."""
    from gaustudio_torch.ops.gaussian import ndc2pix, transform_points

    W, H = int(cam.image_width), int(cam.image_height)
    sx, sy, _ = (c.cpu().numpy() for c in screen64(verts, cam))
    hom = transform_points(verts.float(), cam.full_proj_transform.float())
    ndc = hom[:, :3] / (hom[:, 3:4] + 1e-9)
    fx, fy = ndc2pix(ndc[:, 0], W).cpu().numpy(), ndc2pix(ndc[:, 1], H).cpu().numpy()
    f = faces.long().cpu().numpy()[tri]
    dv = np.maximum(np.abs(fx[f] - sx[f]), np.abs(fy[f] - sy[f])).max(1)  # [n]
    px, py = pix[:, 0].astype(np.float64), pix[:, 1].astype(np.float64)
    u = 2.0 ** -24
    e, de = [], []
    for a, b in ((1, 2), (2, 0), (0, 1)):
        ax, ay, bx, by = sx[f[:, a]], sy[f[:, a]], sx[f[:, b]], sy[f[:, b]]
        dx, dy = bx - ax, by - ay
        e.append(dy * (px - ax) - dx * (py - ay))
        slope = np.abs(py - by) + np.abs(bx - px) + np.abs(py - ay) + np.abs(px - ax)
        terms = np.abs(dy * px) + np.abs(dx * py) + np.abs(dy * ax) + np.abs(dx * ay)
        de.append(dv * slope + 4 * u * terms)
    e, de = np.stack(e, 1), np.stack(de, 1)
    area = e.sum(1, keepdims=True)
    lam = e / area
    d_area = de.sum(1, keepdims=True) + u * np.abs(area)
    bound = (de + np.abs(lam) * d_area) / np.abs(area) + u * np.abs(lam)
    bound[:, 2] = bound[:, 0] + bound[:, 1] + u
    return lam, bound


def check_raster(frag, verts, faces, cam, n: int = RASTER_CHECK_PIXELS, seed: int = 0) -> str:
    """Holds ``frag`` on n seeded pixels (raster_pixels) to raster_reference:
    covered alike, depth within 1e-5 relative, the same triangle except at a
    tie (the device's triangle within 1e-5 of the least depth there, or the
    pixel within 1e-3 px of a triangle's edge, where the float32 and float64
    inside tests may part), and the device triangle's barycentrics within
    twice bary_bound's bound of their float64 values (a triangle of a pixel
    or two at 1080p rounds them by ~1e-3 in float32)."""
    W, H = int(cam.image_width), int(cam.image_height)
    pix = raster_pixels(frag, n, seed)
    ref_d, ref_id, per_tri = raster_reference(verts, faces, cam, [(float(x), float(y))
                                                                   for x, y in pix])
    got_d = frag.depth[pix[:, 1], pix[:, 0]].cpu().numpy()
    got_id = frag.tri_id[pix[:, 1], pix[:, 0]].cpu().numpy()
    sx, sy, _ = (c.cpu().numpy() for c in screen64(verts, cam))
    ties = mismatched = 0
    rel = 0.0
    for i in range(n):
        both = ref_id[i] >= 0 and got_id[i] >= 0
        if both:
            rel = max(rel, abs(got_d[i] - ref_d[i]) / ref_d[i])
        if ref_id[i] == got_id[i]:
            continue
        tie = both and float(per_tri[i][got_id[i]]) <= ref_d[i] * (1 + 1e-5)
        for t in (t for t in (ref_id[i], got_id[i]) if t >= 0):
            corners = np.stack([sx, sy], 1)[faces[t].long().cpu().numpy()]
            tie |= any(_segment_distance(pix[i], corners[a], corners[b]) < 1e-3
                       for a, b in ((0, 1), (1, 2), (2, 0)))
        ties += int(tie)
        mismatched += int(not tie)
    check(mismatched == 0, f"{mismatched} of {n} pixels take another triangle than the reference")
    check(rel <= 1e-5, f"mesh depth differs from the reference by {rel:.3e} relative")
    hit = got_id >= 0
    check(int(hit.sum()) >= n // 2, f"only {int(hit.sum())} of {n} pixels are covered")
    lam, bound = bary_bound(verts, faces, cam, got_id[hit], pix[hit])
    err = np.abs(frag.bary[pix[hit, 1], pix[hit, 0]].double().cpu().numpy() - lam)
    ratio = float((err / (2 * bound)).max())
    check(ratio <= 1.0, f"barycentrics differ from the reference by {ratio:.3f}x their bound")
    return (f"{n} pixels ({int(hit.sum())} covered, {int((ref_id >= 0).sum())} by the reference): "
            f"depth max rel err {rel:.3e} (tol 1e-5), {ties} ties, ids otherwise equal; "
            f"barycentrics max|err| {float(err.max()):.3e}, at most {ratio:.3f}x twice their "
            f"float32 bound (bound median {float(np.median(bound)):.2e}, max "
            f"{float(bound.max()):.2e})")


def _segment_distance(p, a, b) -> float:
    d = b - a
    u = np.clip(np.dot(p - a, d) / max(np.dot(d, d), 1e-24), 0, 1)
    return float(np.linalg.norm(a + u * d - p))


def write_texture_cameras(work_dir: str, cams_path: str, stride: int = MESH_FULL_STRIDE,
                          downsample: int = MESH_FULL_DOWNSAMPLE) -> str:
    """``work_dir``/cameras.json: the cameras of the views gs-extract-mesh
    rendered into ``work_dir``/images (every ``stride``-th camera of
    ``cams_path``, downsampled by ``downsample``), for gs-texture-mesh."""
    from gaustudio_torch.datasets.utils import JSON_to_camera, camera_to_JSON

    with open(cams_path) as f:
        entries = json.load(f)[::stride]
    cams = [JSON_to_camera(cj, device="cpu").downsample_scale(downsample) for cj in entries]
    path = os.path.join(work_dir, "cameras.json")
    with open(path, "w") as f:
        json.dump([camera_to_JSON(i, cam) for i, cam in enumerate(cams)], f)
    return path


def mesh_tools(out_dir: str, device, card: str) -> list:
    """gs-render-mesh on phase 11's full-width mesh from the 36 cameras at
    1080p (timed by stage, the middle view held to raster_reference);
    gs-texture-mesh from phase 11's 12 views at 960x540; gs-from-mesh -n 3
    and gs-render of its Gaussians at 1080p through K1-K3, of phase 11's
    mesh and of gs-extract-pcd's (pcd_full's) SAP mesh."""
    from gaustudio_torch.ops import mesh_raster
    from gaustudio_torch.scripts import render_mesh as gs_render_mesh
    from gaustudio_torch.scripts import texture_mesh as gs_texture_mesh
    from gaustudio_torch.utils.mesh import load_mesh

    mesh = os.path.join(out_dir, "mesh_full", "fused_mesh.ply")
    cams_path = os.path.join(out_dir, "mesh_full_cameras.json")
    render_dir = os.path.join(out_dir, "render_mesh")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs_render_mesh.main(["-m", mesh, "-c", cams_path, "-o", render_dir, "--device", "cuda"])
    wall = time.perf_counter() - t0
    for sub in ("depth", "normal"):
        check(len(os.listdir(os.path.join(render_dir, sub))) == MESH_FULL_CAMS, f"{sub} files")

    v_np, f_np = load_mesh(mesh)
    verts = torch.from_numpy(v_np).to(device)
    faces = torch.from_numpy(f_np.astype(np.int64)).to(device)
    fnormals = mesh_raster.face_normals(verts, faces)
    cams = load_cameras(cams_path, device)
    stage_dir = os.path.join(out_dir, "render_mesh_stages")
    for sub in ("color", "depth", "normal"):
        os.makedirs(os.path.join(stage_dir, sub), exist_ok=True)
    ras_ms, file_ms, covered = [], [], []
    for cam in cams[::STAGED_STRIDE]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frag = mesh_raster.rasterize_mesh(verts, faces, cam.world_view_transform,
                                          cam.full_proj_transform, FULL_W, FULL_H)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gs_render_mesh.save_view(stage_dir, cam.image_name, cam,
                                 gs_render_mesh.view_images(frag, fnormals, faces))
        t2 = time.perf_counter()
        ras_ms.append((t1 - t0) * 1e3)
        file_ms.append((t2 - t1) * 1e3)
        covered.append(float(frag.mask.float().mean()))
    middle = cams[len(cams) // 2]
    frag = mesh_raster.rasterize_mesh(verts, faces, middle.world_view_transform,
                                      middle.full_proj_transform, FULL_W, FULL_H)
    check(torch.isfinite(frag.depth).all() and torch.isfinite(frag.bary).all(), "non-finite frags")
    held = check_raster(frag, verts, faces, middle)
    say("meshtools", f"gs-render-mesh {len(f_np)} faces, {len(cams)} views at {FULL_W}x{FULL_H}: "
        f"{wall:.3f} s wall; covered fraction {statistics.mean(covered):.4f} (mean of the timed "
        f"views); by stage (host clock fenced by synchronize, median of {len(ras_ms)} views, ms a "
        f"view): rasterize "
        f"{statistics.median(ras_ms):.3f}, files {statistics.median(file_ms):.3f}; middle view "
        f"against raster_reference: {held} | {card}")
    # phase 11's mesh has holes where its views' final opacity is below 0.5
    # (the middle of the sphere's disc): it covers about 0.18 of a view
    check(min(covered) > 0.1, f"a mesh view is mostly empty: {min(covered):.3f}")

    tex_cams = write_texture_cameras(os.path.join(out_dir, "mesh_full"), cams_path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, share = gs_texture_mesh.main(["-m", mesh, "-c", tex_cams, "-o",
                                     os.path.join(out_dir, "textured_mesh.ply"), "--device", "cuda"])
    wall = time.perf_counter() - t0
    say("meshtools", f"gs-texture-mesh from {MESH_FULL_CAMS // MESH_FULL_STRIDE} views at "
        f"{FULL_W // MESH_FULL_DOWNSAMPLE}x{FULL_H // MESH_FULL_DOWNSAMPLE}: {share:.4f} of "
        f"{len(v_np)} vertices covered (floor 0.8), {wall:.3f} s wall | {card}")
    check(share > 0.8, f"gs-texture-mesh covered {share:.4f} of the vertices")

    # gs-from-mesh on phase 11's mesh, whose holes bound what its Gaussians
    # can light (at least 0.9 of the mesh's own coverage of the view), and on
    # gs-extract-pcd's SAP mesh, a closed sphere (more than half the view)
    counts, lit, cover = from_mesh_render(mesh, "phase 11's mesh", out_dir, device, card)
    check(lit >= 0.9 * cover, f"gs-from-mesh's render lights {lit:.4f} of a view the mesh covers "
          f"{cover:.4f} of")
    sap_counts, lit, _ = from_mesh_render(os.path.join(out_dir, "pcd_full", "fused_mesh.ply"),
                                          "gs-extract-pcd's SAP mesh", out_dir, device, card)
    check(lit > 0.5, f"gs-from-mesh's render of the SAP mesh is mostly empty: {lit:.4f} lit")
    return [counts, sap_counts]


def from_mesh_render(mesh: str, tag: str, out_dir: str, device, card: str) -> tuple:
    """gs-from-mesh -n 3 of ``mesh``, then gs-render of its Gaussians from
    FROM_MESH_VIEWS orbit views at 1080p (radius FROM_MESH_RADIUS) through
    K1-K3, with the launches, and the middle view timed warm through
    rasterize(). Returns (launch counts, lit fraction, the fraction of that
    view the mesh itself covers)."""
    from gaustudio_torch import models, renderers
    from gaustudio_torch.ops import mesh_raster
    from gaustudio_torch.ops import rasterize as rast
    from gaustudio_torch.scripts import mesh2gs as gs_from_mesh
    from gaustudio_torch.scripts import render as gs_render
    from gaustudio_torch.utils.mesh import load_mesh

    name = os.path.basename(os.path.dirname(mesh))
    gs_ply = os.path.join(out_dir, f"from_mesh_{name}.ply")
    t0 = time.perf_counter()
    gs_from_mesh.main(["-m", mesh, "-o", gs_ply, "-n", "3", "--device", "cuda"])
    from_wall = time.perf_counter() - t0
    views = write_orbit_cameras(os.path.join(out_dir, "from_mesh_cameras.json"), FROM_MESH_VIEWS,
                                FULL_W, FULL_H, radius=FROM_MESH_RADIUS)
    reset_counts()
    images = gs_render.main(["-m", gs_ply, "-s", views, "--sh", "1", "--device", "cuda", "-o",
                             os.path.join(out_dir, f"from_mesh_render_{name}"),
                             "model.pointcloud.sh_degree=1"])
    counts = read_counts()
    mesh_counts(f"gs-render of gs-from-mesh's Gaussians ({tag}), {FULL_W}x{FULL_H}", counts,
                FORWARD, "meshtools")
    check(len(os.listdir(images)) == FROM_MESH_VIEWS, os.listdir(images))

    v_np, f_np = load_mesh(mesh)
    pcd = models.make({"name": "vanilla_pcd", "sh_degree": 1}, device=device)
    pcd.load(gs_ply)
    pcd.active_sh_degree = 1
    check(pcd.num_points == 3 * len(f_np), f"{pcd.num_points} Gaussians for {len(f_np)} faces")
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    cam = load_cameras(views, device)[FROM_MESH_VIEWS // 2]
    cover = float(mesh_raster.rasterize_mesh(
        torch.from_numpy(v_np).to(device), torch.from_numpy(f_np.astype(np.int64)).to(device),
        cam.world_view_transform, cam.full_proj_transform, FULL_W, FULL_H).mask.float().mean())
    with torch.inference_mode():
        xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
        st = renderer.make_settings(cam, pcd, device)

        def run():
            return rast.rasterize(xyz, opacity, st, shs=shs, scales=scales, rotations=rotations,
                                  active_sh_degree=1)

        out = run()
        finite = all(bool(torch.isfinite(out[k]).all()) for k in (
            "render", "rendered_depth", "rendered_median_depth", "rendered_final_opacity"))
        lit = float((out["render"].sum(0) > 0).float().mean())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        torch.cuda.synchronize()
        ras_s = (time.perf_counter() - t0) / 20
    say("meshtools", f"gs-from-mesh -n 3 ({tag}): {pcd.num_points} Gaussians from {len(f_np)} "
        f"faces in {from_wall:.3f} s; gs-render at {FULL_W}x{FULL_H} (orbit radius "
        f"{FROM_MESH_RADIUS}): {out['num_rendered']} entries, lit fraction {lit:.4f} (the mesh "
        f"covers {cover:.4f} of the view), outputs finite {finite}; rasterize() "
        f"{ras_s * 1e3:.3f} ms wall (mean of 20 warm calls) | {card}")
    check(finite, "gs-from-mesh's render has non-finite outputs")
    return counts, lit, cover


# --- phase 14: gs-init and gs-process-data ------------------------------------

# The capture: phase 11's full-width sphere (300k Gaussians) at opacity 0.95,
# so every silhouette is solid, rendered from three orbit rings of 12
# cameras at elevations -30, 0 and +30 degrees (radius 3) at 1920x1080,
# written as a nerfstudio capture with 16-bit median depth in millimetres,
# masks of final opacity > 0.5 and a 20k-point sample of the sphere as
# sparse/0/points3D.bin. The field of view is 60 degrees along the short
# side, so the sphere (39 degrees across from radius 3) lies inside every
# frame: the visual hull carves what a view does not see.
CAPTURE_RINGS, CAPTURE_PER_RING, CAPTURE_RADIUS = (-30.0, 0.0, 30.0), 12, 3.0
CAPTURE_FOV_SHORT = 60.0
CAPTURE_OPACITY, CAPTURE_SPARSE_N = 0.95, 20_000
DEPTH_DOWNSAMPLE = 4  # the depth initializer's default
DEPTH_MEDIAN_TOL = 0.01  # median | |p| - 1 | of the fused points, of the radius
HULL_RES = 128  # the VisualHull initializer's default grid
SKY_RES = 100  # the gaussiansky initializer's default resolution
INIT_TRAIN_STEPS = 30
INIT_NEVER = ("render_surfel_tiles", "render_surfel_tiles_backward")


def capture_cameras(W: int, H: int, device, rings=CAPTURE_RINGS, per_ring: int = CAPTURE_PER_RING,
                    radius: float = CAPTURE_RADIUS) -> list:
    """Orbit rings about the origin at the given elevations, ``per_ring``
    cameras each, at WxH: a field of view of CAPTURE_FOV_SHORT degrees along
    the short side and the same focal length along both; named
    frame_00000, frame_00001, ..."""
    from gaustudio_torch.cameras.camera_paths import get_path_from_orbit
    from gaustudio_torch.datasets.utils import JSON_to_camera, camera_to_JSON

    fov_x = 2 * math.degrees(math.atan(math.tan(math.radians(CAPTURE_FOV_SHORT / 2))
                                       * W / min(W, H)))
    cams = []
    for elevation in rings:
        for cam in get_path_from_orbit(np.zeros(3), radius, elevation=elevation, num_cam=per_ring,
                                       image_size=W, fov_deg=fov_x, device="cpu"):
            cj = camera_to_JSON(len(cams), cam)
            cj.update(height=H, fy=cj["fx"], cy=H / 2, img_name=f"frame_{len(cams):05d}")
            cams.append(JSON_to_camera(cj, device=device))
    return cams


def capture_views(renderer, pcd, cams):
    """Per camera (rgb [H, W, 3], median depth [H, W], final opacity [H, W])
    of the render, as host arrays."""
    for cam in cams:
        out = renderer.render(cam, pcd)
        yield (out["render"].permute(1, 2, 0).cpu().numpy(),
               out["rendered_median_depth"][0].cpu().numpy(),
               out["rendered_final_opacity"][0].cpu().numpy())


def write_capture(root: str, cams: list, views, sparse_xyz: np.ndarray,
                  sparse_rgb: np.ndarray) -> list:
    """A nerfstudio capture of ``cams`` and their ``views``:
    transforms.json (per-frame fl_x, fl_y, cx, cy, w, h in float64; the camera-to-world
    pose in OpenGL axes, which the loader's ``c2w[:, 1:3] *= -1`` undoes),
    images/ (RGB PNGs, filter 0), depths/ (16-bit median depth in
    millimetres, 0 where the final opacity is at most 0.5), masks/ (255
    where it is above) and sparse/0/points3D.bin. Returns the depth maps as
    written (uint16)."""
    from gaustudio_torch.cameras import fov2focal
    from gaustudio_torch.datasets.utils import write_points3D_binary
    from gaustudio_torch.utils.image import BackgroundWriter, write_png

    for sub in ("images", "depths", "masks", os.path.join("sparse", "0")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    frames, depths = [], []
    with BackgroundWriter() as writer:
        for cam, (rgb, depth, alpha) in zip(cams, views):
            name = f"{cam.image_name}.png"
            c2w = np.linalg.inv(cam.extrinsics.cpu().numpy().astype(np.float64))
            c2w[:, 1:3] *= -1  # COLMAP's axes -> nerfstudio's
            frames.append({"file_path": f"images/{name}", "mask_path": f"masks/{name}",
                           "depth_file_path": f"depths/{name}", "w": cam.image_width,
                           "h": cam.image_height,
                           "fl_x": fov2focal(cam.FoVx, cam.image_width),
                           "fl_y": fov2focal(cam.FoVy, cam.image_height),
                           "cx": cam.image_width * cam.principal_point_ndc[0],
                           "cy": cam.image_height * cam.principal_point_ndc[1],
                           "transform_matrix": c2w.tolist()})
            solid = alpha > 0.5
            depth_mm = np.where(solid, np.clip(np.round(depth * 1000.0), 0, 65535), 0)
            depths.append(depth_mm.astype(np.uint16))
            writer.submit(write_png, os.path.join(root, "images", name),
                          np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8))
            writer.submit(write_png, os.path.join(root, "depths", name), depths[-1])
            writer.submit(write_png, os.path.join(root, "masks", name),
                          (solid * 255).astype(np.uint8))
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"frames": frames}, f)
    write_points3D_binary(sparse_xyz, sparse_rgb,
                          os.path.join(root, "sparse", "0", "points3D.bin"))
    return depths


def downsampled_valid(depths: list, scale: int = DEPTH_DOWNSAMPLE) -> int:
    """Pixels with depth > 0 after Camera.downsample_scale(scale)'s
    nearest-exact resample of each depth map."""
    total = 0
    for d in depths:
        h, w = d.shape
        small = torch.nn.functional.interpolate(
            torch.from_numpy(d.astype(np.float32))[None, None],
            size=(round(h / scale), round(w / scale)), mode="nearest-exact")
        total += int((small > 0).sum())
    return total


def timed_cli(fn) -> tuple:
    """(result, wall s, peak device bytes) of one fenced call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def init_full(out_dir: str, device, card: str) -> dict:
    """gs-process-data and gs-init on a capture the port renders of phase
    11's full-width sphere (K1-K3), then gs-train from gs-init's cloud
    (K1-K4): (a) --init depth, (b) --initializer VisualHull (the pose step
    builds from the capture's points3D.bin), (c) --init gaussiansky, (d) 30
    steps of gs-train. Returns the launch counts of the phase."""
    from gaustudio_torch import renderers
    from gaustudio_torch.datasets.utils import getNerfppNorm
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.pipelines.initializers import mask as vh
    from gaustudio_torch.scripts import initialize as gs_init
    from gaustudio_torch.scripts import process_data as gs_process_data
    from gaustudio_torch.scripts import train as gs_train
    from gaustudio_torch.utils.ply import fetch_ply

    for module in ("PIL", "cv2"):
        try:
            __import__(module)
            say("init", f"{module} imports")
        except ImportError:
            say("init", f"{module} does not import")

    root = os.path.join(out_dir, "capture")
    shutil.rmtree(root, ignore_errors=True)
    reset_counts()
    pcd = sphere_model(MESH_FULL_N, device)
    pcd._opacity = torch.full_like(pcd._opacity, math.log(CAPTURE_OPACITY / (1 - CAPTURE_OPACITY)))
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    cams = capture_cameras(FULL_W, FULL_H, device)
    xyz, rgb = sphere_points(MESH_FULL_N)
    t0 = time.perf_counter()
    depths = write_capture(root, cams, capture_views(renderer, pcd, cams), xyz[:CAPTURE_SPARSE_N],
                           (rgb[:CAPTURE_SPARSE_N] * 255).astype(np.uint8))
    capture_s = time.perf_counter() - t0
    del pcd
    say("init", f"capture: {len(cams)} views at {FULL_W}x{FULL_H} of {MESH_FULL_N} Gaussians "
        f"(opacity {CAPTURE_OPACITY}) rendered and written as nerfstudio in {capture_s:.3f} s; "
        f"{sum(int((d > 0).sum()) for d in depths)} depth pixels | {card}")

    # (a) gs-process-data --init depth
    ws_a = os.path.join(out_dir, "init_depth")
    argv = ["--dataset", "nerfstudio", "-s", root, "-o", ws_a, "--init", "depth",
            "--device", "cuda", "--overwrite"]
    model, wall, peak = timed_cli(lambda: gs_process_data.main(argv))
    busy = profiled_device_s(lambda: gs_process_data.main(argv))
    fused = model._xyz
    want = downsampled_valid(depths)
    dev = (torch.linalg.norm(fused, dim=1) - 1.0).abs()
    med, p99 = float(dev.median()), float(torch.quantile(dev, 0.99))
    say("init", f"(a) gs-process-data --init depth: {model.num_points} points (capture's depth > 0 "
        f"pixels at {round(FULL_W / DEPTH_DOWNSAMPLE)}x{round(FULL_H / DEPTH_DOWNSAMPLE)}: {want}), "
        f"median | |p| - 1 | {med:.6f}, 99th percentile {p99:.6f}; {wall:.3f} s wall, busy "
        f"{busy:.3f} s of a second run, busy share {busy / wall:.4f}, peak device memory "
        f"{peak / 2 ** 30:.3f} GiB | {card}")
    check(model.num_points == want, f"(a) fused {model.num_points} points, {want} valid depths")
    check(med <= DEPTH_MEDIAN_TOL, f"(a) median | |p| - 1 | {med} above {DEPTH_MEDIAN_TOL} of the "
          "sphere's radius (1)")
    check(torch.isfinite(fused).all(), "(a) non-finite points")
    del model, fused, dev

    # (b) gs-init --initializer VisualHull, its pose step building from the
    # capture's sparse/0/points3D.bin (hloc's should_skip)
    meshes = []
    build = vh.VisualHullInitializer.build_model

    def spy(self, model):
        meshes.append(self.mesh)
        return build(self, model)

    argv = ["--dataset", "nerfstudio", "-s", root, "-o", root, "-w", "--initializer",
            "VisualHull", "--device", "cuda"]
    vh.VisualHullInitializer.build_model = spy
    try:
        ply, wall, peak = timed_cli(lambda: gs_init.main(argv))
        busy = profiled_device_s(lambda: gs_init.main(argv))
    finally:
        vh.VisualHullInitializer.build_model = build
    verts, faces = meshes[0]
    radius = getNerfppNorm(cams)["min_radius"]
    voxel = 2 * radius / (HULL_RES - 1)
    depth_in = float(1.0 - np.linalg.norm(verts, axis=1).min())
    hull_xyz, _, _ = fetch_ply(ply)
    say("init", f"(b) gs-init --initializer VisualHull (grid {HULL_RES}^3, voxel {voxel:.4f}): "
        f"{len(verts)} vertices, {len(faces)} faces, {len(hull_xyz)} Gaussians; deepest vertex "
        f"{depth_in:.4f} inside the sphere ({depth_in / voxel:.3f} voxels); {wall:.3f} s wall, "
        f"busy {busy:.3f} s of a second run, busy share {busy / wall:.4f}, peak device memory "
        f"{peak / 2 ** 30:.3f} GiB | {card}")
    check(len(faces) > 1000, f"(b) the hull has {len(faces)} faces")
    check(depth_in <= math.sqrt(3) * voxel, f"(b) a hull vertex {depth_in} inside the sphere")
    check(len(hull_xyz) == len(faces), f"(b) {len(hull_xyz)} Gaussians of {len(faces)} faces")

    # (c) gs-process-data --init gaussiansky
    sky = gs_process_data.main(["--dataset", "nerfstudio", "-s", root, "-o",
                                os.path.join(out_dir, "init_sky"), "--init", "gaussiansky",
                                "--device", "cuda"])
    say("init", f"(c) gs-process-data --init gaussiansky: {sky.num_points} Gaussians")
    check(sky.num_points == SKY_RES ** 2, f"(c) {sky.num_points} Gaussians")
    check(sky._xyz.device.type == "cuda", "(c) the model is not on the card")

    # (d) gs-train from (b)'s cloud, each step fenced and its loss kept
    losses, steps_ms = [], []
    step = T.Trainer.step

    def timed_step(self, batch, settings):
        t0 = time.perf_counter()
        state, metrics = step(self, batch, settings)
        losses.append(float(metrics["loss"]))
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        return state, metrics

    T.Trainer.step = timed_step
    try:
        gs_train.main(["-s", root, "-o", os.path.join(out_dir, "init_train"), "--dataset",
                       "nerfstudio", "--iterations", str(INIT_TRAIN_STEPS), "--save_every",
                       str(INIT_TRAIN_STEPS), "--device", "cuda"])
    finally:
        T.Trainer.step = step
    counts = read_counts()
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    say("init", f"(d) gs-train --dataset nerfstudio from (b)'s {len(hull_xyz)} Gaussians: "
        f"{INIT_TRAIN_STEPS} steps, {statistics.median(steps_ms[5:]):.3f} ms/it (median of steps "
        f"6-{INIT_TRAIN_STEPS}, each fenced by its loss's read), loss of the first 5 steps "
        f"{first:.5f}, of the last 5 {last:.5f} | {card}")
    check(len(losses) == INIT_TRAIN_STEPS, f"(d) {len(losses)} steps")
    check(last < first, f"(d) the loss did not fall: {first} -> {last}")
    say("init", f"capture, gs-init, gs-process-data and gs-train: launches {json.dumps(counts)}")
    check(all(counts[k] > 0 for k in TRAIN_PATH), f"a kernel was not launched: {counts}")
    check(all(counts[k] == 0 for k in INIT_NEVER), f"a surfel kernel ran: {counts}")
    return counts


# --- phase 15: the flythrough, host IO and observability --------------------

# The path: FLY_N cameras on a FLY_ARC_DEG yaw arc about (0, 0, FLY_RADIUS)
# at radius FLY_RADIUS, each facing the centre: the arc is centred on
# bench.py's identity view, which looks into the scene's Gaussians (z in
# 0.8-6). Seeded position jitter, and three cameras lifted in y as speed
# outliers. The JAX package's chain (validate, keyframes, smoothing,
# resampling) keeps FLY_COUNTS of it on the CPU; a CPU test holds both
# packages to those counts.
FLY_N, FLY_ARC_DEG, FLY_RADIUS, FLY_JITTER = 90, 90.0, 3.4, 0.004
FLY_LIFTS, FLY_LIFT = (20, 50, 75), 0.4
FLY_COUNTS = (77, 40, 40, 78)
NATIVE_TRACK, NATIVE_KEYPOINTS = 4, 4096  # points3D.bin track length, keypoints an image
DB_MATCHES = 1024  # matches of each sequential pair in the COLMAP database
DEBUG_TURNS, DEBUG_RUN = 6, 20  # (h): 6 x (off, on, on, off) runs of 20 renders


def flythrough_cameras(n: int = FLY_N, W: int = FULL_W, H: int = FULL_H,
                       arc_deg: float = FLY_ARC_DEG, lifts=FLY_LIFTS, seed: int = 0) -> list:
    """cameras.json entries of the flythrough path (see FLY_N), at bench.py's
    focal length (tan(fov_x/2) = 0.85)."""
    rng = np.random.default_rng(seed)
    focal = W / (2.0 * 0.85)
    centre = np.array([0.0, 0.0, FLY_RADIUS])
    cams = []
    for i in range(n):
        yaw = math.radians(-arc_deg / 2 + arc_deg * i / (n - 1))
        c, s = math.cos(yaw), math.sin(yaw)
        rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        check(abs(np.linalg.det(rot) - 1.0) < 1e-12, f"camera {i} is not a proper rotation")
        pos = centre - FLY_RADIUS * rot[:, 2] + rng.normal(size=3) * FLY_JITTER
        if i in lifts:
            pos[1] += FLY_LIFT
        cams.append({"id": i, "img_name": f"path_{i:03d}", "width": W, "height": H,
                     "position": pos.tolist(), "rotation": rot.tolist(), "fx": focal, "fy": focal})
    return cams


FLY_CHAIN = ("validate_paths", "downsample_cameras", "smoothen_cameras",
             "upsample_cameras_velocity")


def flythrough_chain(path_json: str, device) -> dict:
    """gs-render --flythrough's camera chain on a cameras.json, as the CLI
    runs it: the count after each stage and the host ms of the chain
    (scipy's first import, which smoothing pays, apart); the process's peak
    RSS (getrusage) before and after it; and, from a second run of the chain
    under tracemalloc, the peak host memory the chain itself allocates
    (numpy arrays and Python objects; the cameras' tensors live on
    ``device``)."""
    import resource
    import tracemalloc

    from gaustudio_torch.cameras import camera_paths

    path = camera_paths.get_path_from_json(path_json, device=device)
    t0 = time.perf_counter()
    import scipy.signal  # noqa: F401

    import_ms = (time.perf_counter() - t0) * 1e3

    def chain():
        cams, counts = path, []
        for stage in FLY_CHAIN:
            cams = getattr(camera_paths, stage)(cams)
            counts.append(len(cams))
        return cams, counts

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    cams, counts = chain()
    ms = (time.perf_counter() - t0) * 1e3
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    tracemalloc.start()
    try:
        chain()
        traced_peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return {"counts": counts, "ms": ms, "import_ms": import_ms, "rss_before_kib": rss0,
            "rss_after_kib": rss1, "traced_peak_bytes": traced_peak,
            "names": [c.image_name for c in cams], "cameras": cams}


def png_size(path: str) -> tuple:
    """(width, height) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[12:16] == b"IHDR", f"{path} is not a PNG")
    return tuple(int.from_bytes(head[i:i + 4], "big") for i in (16, 20))


def write_points3d_tracks(path: str, xyz: np.ndarray, rgb: np.ndarray, track: int,
                          seed: int) -> None:
    """points3D.bin with ``track`` seeded (image id, point2D index) pairs a
    point, written in one numpy pass (COLMAP's layout, packed)."""
    rng = np.random.default_rng(seed)
    rec = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("error", "<f8"),
                    ("track_len", "<u8"), ("track", "<i4", 2 * track)])
    buf = np.zeros(len(xyz), rec)
    buf["id"] = np.arange(1, len(xyz) + 1)
    buf["xyz"], buf["rgb"] = xyz, rgb
    buf["error"] = rng.uniform(0.1, 2.0, len(xyz))
    buf["track_len"] = track
    buf["track"] = rng.integers(0, NATIVE_KEYPOINTS, (len(xyz), 2 * track))
    with open(path, "wb") as f:
        f.write(np.uint64(len(xyz)).tobytes())
        f.write(buf.tobytes())


def path_w2c(cj: dict) -> np.ndarray:
    """The world -> camera matrix [4, 4] of a cameras.json entry."""
    c2w = np.eye(4)
    c2w[:3, :3] = np.asarray(cj["rotation"])
    c2w[:3, 3] = cj["position"]
    return np.linalg.inv(c2w)


def check_equal_arrays(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    check(got.dtype == want.dtype, f"{what}: dtype {got.dtype} against {want.dtype}")
    check(np.array_equal(got, want), f"{what} differs")


def native_readers(work: str, xyz: np.ndarray, path: list, card: str) -> None:
    """Phase 15 (e): points3D.bin of ``xyz`` (tracks of NATIVE_TRACK) and
    images.bin of the path's cameras (NATIVE_KEYPOINTS keypoints each), read
    by the native and the Python readers: equal, dtypes too, with each
    reader's ms."""
    from gaustudio_torch.datasets import utils as dsu
    from gaustudio_torch.utils import native

    ok = native.available()
    built = ("loaded a library built before this process" if native.build_seconds is None
             else f"built by g++ in this process in {native.build_seconds:.3f} s")
    say("fly", f"(e) native reader available: {ok} ({built}: "
        f"{os.path.relpath(native.library_path(), REPO)})")
    if not ok:
        say("fly", f"(e) the compiler said:\n{native.build_error}")
    check(ok, "the native COLMAP reader did not build")
    rng = np.random.default_rng(5)
    pts = os.path.join(work, "points3D.bin")
    write_points3d_tracks(pts, xyz.astype(np.float64), rng.integers(0, 256, (len(xyz), 3)),
                          NATIVE_TRACK, seed=6)
    ims = {}
    for i, cj in enumerate(path):
        w2c = path_w2c(cj)
        ims[i + 1] = dsu.ColmapImage(
            i + 1, dsu.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, f"{cj['img_name']}.png",
            rng.uniform(0, (cj["width"], cj["height"]), (NATIVE_KEYPOINTS, 2)),
            rng.integers(-1, len(xyz), NATIVE_KEYPOINTS).astype(np.int64))
    imgs = os.path.join(work, "images.bin")
    dsu.write_extrinsics_binary(ims, imgs)
    times = {}
    for name, fn in (("points3D native", native.read_points3d_binary),
                     ("points3D python", dsu.read_points3D_binary_python),
                     ("images native", native.read_images_binary),
                     ("images python", dsu.read_extrinsics_binary_python)):
        t0 = time.perf_counter()
        times[name] = (fn(pts if name.startswith("points") else imgs),
                       (time.perf_counter() - t0) * 1e3)
    for got, want, what in zip(times["points3D native"][0], times["points3D python"][0],
                               ("xyz", "rgb", "error")):
        check_equal_arrays(got, want, f"(e) points3D {what}")
    check(times["points3D python"][0][1].dtype == np.int64, "(e) rgb is not int64")
    native_ims, python_ims = times["images native"][0], times["images python"][0]
    check(sorted(native_ims) == sorted(python_ims) == sorted(ims), "(e) image ids differ")
    for k, im in python_ims.items():
        q, t, cid, name, xys, pids = native_ims[k]
        for got, want, what in ((q, im.qvec, "qvec"), (t, im.tvec, "tvec"), (xys, im.xys, "xys"),
                                (pids, im.point3D_ids, "point3D_ids")):
            check_equal_arrays(got, want, f"(e) image {k} {what}")
        check((cid, name) == (im.camera_id, im.name), f"(e) image {k} camera id or name")
    for kind in ("points3D", "images"):
        nat, py = times[f"{kind} native"][1], times[f"{kind} python"][1]
        size = os.path.getsize(pts if kind == "points3D" else imgs)
        say("fly", f"(e) {kind}.bin ({size / 2 ** 20:.1f} MiB): native {nat:.3f} ms, python "
            f"{py:.3f} ms, python / native {py / nat:.2f}; equal, dtypes too | {card}")


def colmap_database(work: str, path: list, card: str) -> None:
    """Phase 15 (f): a COLMAP database of the path's cameras (PINHOLE, one an
    image), NATIVE_KEYPOINTS keypoints an image, sequential matches and
    two-view geometries, read back; then the known-pose model of the path
    (create_images_from_pose_dict) read back by the port's readers."""
    from gaustudio_torch.datasets import utils as dsu
    from gaustudio_torch.utils import colmap_db as cdb

    rng = np.random.default_rng(7)
    db_path = os.path.join(work, "database.db")
    t0 = time.perf_counter()
    db = cdb.COLMAPDatabase.connect(db_path)
    try:
        db.create_tables()
        image_ids, keypoints = [], []
        for cj in path:
            W, H = cj["width"], cj["height"]
            cam_id = db.add_camera("PINHOLE", W, H, [cj["fx"], cj["fy"], W / 2, H / 2])
            image_ids.append(db.add_image(f"{cj['img_name']}.png", cam_id))
            keypoints.append(rng.uniform(0, (W, H), (NATIVE_KEYPOINTS, 2)).astype(np.float32))
            db.add_keypoints(image_ids[-1], keypoints[-1])
        matches = {}
        for a, b in zip(image_ids, image_ids[1:]):
            m = rng.integers(0, NATIVE_KEYPOINTS, (DB_MATCHES, 2)).astype(np.uint32)
            matches[(a, b)] = m
            db.add_matches(a, b, m)
            db.add_two_view_geometry(a, b, m)
        db.commit()
        write_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cams = db.execute("SELECT camera_id, model, width, height, params FROM cameras").fetchall()
        check(len(cams) == len(path), f"(f) {len(cams)} cameras")
        for (cid, model, W, H, params), cj in zip(cams, path):
            check((model, W, H) == (1, cj["width"], cj["height"]), f"(f) camera {cid}")
            check(np.array_equal(cdb.blob_to_array(params, np.float64),
                                 [cj["fx"], cj["fy"], W / 2, H / 2]), f"(f) camera {cid} params")
        names = [r[0] for r in db.execute("SELECT name FROM images ORDER BY image_id")]
        check(names == [f"{cj['img_name']}.png" for cj in path], "(f) image names")
        for iid, rows, cols, blob in db.execute("SELECT image_id, rows, cols, data FROM keypoints"):
            check(np.array_equal(cdb.blob_to_array(blob, np.float32, (rows, cols)),
                                 keypoints[image_ids.index(iid)]), f"(f) keypoints of {iid}")
        for table in ("matches", "two_view_geometries"):
            rows = db.execute(f"SELECT pair_id, rows, cols, data FROM {table}").fetchall()
            check(len(rows) == len(matches), f"(f) {len(rows)} {table}")
            for pair_id, r, c, blob in rows:
                pair = cdb.pair_id_to_image_ids(pair_id)
                check(np.array_equal(cdb.blob_to_array(blob, np.uint32, (r, c)), matches[pair]),
                      f"(f) {table} of {pair}")
        configs = {r[0] for r in db.execute("SELECT config FROM two_view_geometries")}
        check(configs == {2}, f"(f) two-view configs {configs}")
        read_ms = (time.perf_counter() - t0) * 1e3
    finally:
        db.close()

    model = os.path.join(work, "known_pose")
    shutil.rmtree(model, ignore_errors=True)
    cj = path[0]
    cdb.create_cameras_and_points_bin(model, {1: {
        "width": cj["width"], "height": cj["height"], "fx": cj["fx"], "fy": cj["fy"],
        "cx": cj["width"] / 2, "cy": cj["height"] / 2}})
    poses = {f"{c['img_name']}.png": path_w2c(c) for c in path}
    cdb.create_images_from_pose_dict(model, poses)
    intr = dsu.read_intrinsics_binary(os.path.join(model, "cameras.bin"))
    check(intr[1].model == "PINHOLE" and (intr[1].width, intr[1].height) == (cj["width"], cj["height"]),
          f"(f) cameras.bin {intr}")
    for reader, name in ((dsu.read_extrinsics_binary, "images.bin"),
                         (dsu.read_extrinsics_text, "images.txt")):
        images = reader(os.path.join(model, name))
        check(sorted(im.name for im in images.values()) == sorted(poses), f"(f) {name} names")
        for im in images.values():
            w2c = poses[im.name]
            check(np.abs(dsu.qvec2rotmat(im.qvec) - w2c[:3, :3]).max() < 1e-12
                  and np.abs(im.tvec - w2c[:3, 3]).max() < 1e-12, f"(f) {name} pose of {im.name}")
    xyz, _, _ = dsu.read_points3D_binary(os.path.join(model, "points3D.bin"))
    check(len(xyz) == 0, "(f) the known-pose points3D.bin is not empty")
    say("fly", f"(f) COLMAP database: {len(path)} PINHOLE cameras and images, "
        f"{NATIVE_KEYPOINTS} keypoints each, {len(matches)} sequential pairs of {DB_MATCHES} "
        f"matches and two-view geometries: written in {write_ms:.3f} ms, read back and equal in "
        f"{read_ms:.3f} ms; the known-pose model of {len(poses)} images reads back "
        f"(images.bin, images.txt) within 1e-12 | {card}")


def flythrough_full(out_dir: str, ply: str, device, card: str) -> dict:
    """gs-render --flythrough of phase 5's 300k model along the FLY_N-camera
    path at 1920x1080 through K1-K3, with (a) the camera chain's counts, host
    ms and host memory, (b) the CLI's launches, frames
    and wall and a staged run's render and file ms a frame, (c) the first,
    middle and last frames through the kernels against the plain path, (d)
    the device's busy share of a frame, (e) the native COLMAP readers, (f)
    colmap_db, (g) trace / annotate and (h) the rasterizer's debug snapshot.
    Returns the launch counts of the CLI's run."""
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import rasterize as rast
    from gaustudio_torch.scripts import render as gs_render
    from gaustudio_torch.utils.image import BackgroundWriter, read_png, write_png
    from gaustudio_torch.utils.observability import annotate, trace

    work = os.path.join(out_dir, "flythrough")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = flythrough_cameras(W=FULL_W, H=FULL_H)
    path_json = os.path.join(work, "path.json")
    with open(path_json, "w") as f:
        json.dump(path, f)

    # (a) the camera chain, as gs-render --flythrough runs it
    chain = flythrough_chain(path_json, device)
    say("fly", f"(a) path of {FLY_N} cameras at {FULL_W}x{FULL_H} (proper rotations): "
        f"{' -> '.join(f'{s} {n}' for s, n in zip(FLY_CHAIN, chain['counts']))} (JAX chain on "
        f"the CPU: {FLY_COUNTS}); {chain['ms']:.3f} ms of host time (and "
        f"{chain['import_ms']:.3f} ms to import scipy.signal first); peak host allocation "
        f"{chain['traced_peak_bytes'] / 2 ** 20:.3f} MiB (tracemalloc); the process's peak RSS "
        f"{chain['rss_before_kib'] / 1024:.1f} MiB before the chain, "
        f"{chain['rss_after_kib'] / 1024:.1f} MiB after (getrusage) | {card}")
    check(tuple(chain["counts"]) == FLY_COUNTS, f"(a) chain counts {chain['counts']}")
    names = chain["names"]

    # (b) gs-render --flythrough, the main path
    reset_counts()
    t0 = time.perf_counter()
    images = gs_render.main(["-m", ply, "-s", path_json, "--flythrough", "--sh", "3",
                             "--device", device.type, "-o", os.path.join(work, "cli")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    say("fly", f"(b) gs-render --flythrough: {len(names)} frames of {FULL_W}x{FULL_H}, {FULL_N} "
        f"Gaussians SH 3 in {wall:.3f} s wall (load, chain, render, PNG); launches "
        f"{json.dumps(counts)}")
    check(all(counts[k] > 0 for k in FORWARD), f"a kernel was not launched: {counts}")
    check(all(counts[k] == 0 for k in MESH_NEVER), f"a backward kernel ran: {counts}")
    pngs = sorted(os.listdir(images))
    check(pngs == [f"{n}.png" for n in names], f"(b) frames {pngs[:3]}... against {names[:3]}...")
    check(all(png_size(os.path.join(images, p)) == (FULL_W, FULL_H) for p in pngs),
          "(b) a frame is not 1920x1080")

    # the staged run: every frame rendered and read back, then written
    pcd = load_model(ply, 3, device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    cams = chain["cameras"]
    frames, lit = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cam in cams:
        out = renderer.render(cam, pcd)
        lit.append((out["render"].sum(0) > 0).float().mean())
        frames.append(gs_render.frame_pixels(out).cpu().numpy())
    render_s = (time.perf_counter() - t0) / len(cams)
    staged = os.path.join(work, "staged")
    os.makedirs(staged)
    t0 = time.perf_counter()
    with BackgroundWriter() as writer:
        for cam, frame in zip(cams, frames):
            writer.submit(write_png, os.path.join(staged, f"{cam.image_name}.png"), frame)
    files_ms = (time.perf_counter() - t0) / len(cams) * 1e3
    lit = torch.stack(lit).cpu()
    mid = len(cams) // 2
    say("fly", f"(b) staged: render + read-back {render_s * 1e3:.3f} ms a frame, PNG writes "
        f"{files_ms:.3f} ms a frame (two writer threads); lit fraction of the middle frame "
        f"{float(lit[mid]):.4f} (guard > 0.9), smallest {float(lit.min()):.4f} | {card}")
    check(float(lit[mid]) > 0.9, f"(b) middle frame mostly empty: {float(lit[mid]):.3f} lit")
    check(np.array_equal(read_png(os.path.join(images, pngs[mid])), frames[mid]),
          "(b) the CLI's middle frame is not the staged run's")
    del frames

    # (c) the first, middle and last frames through the kernels against the plain path
    errs = []
    for i in (0, mid, len(cams) - 1):
        cam = cams[i]
        xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
        st = renderer.make_settings(cam, pcd, device)
        with torch.inference_mode():
            got, ref = (rast.rasterize(xyz, opacity, s, shs=shs, scales=scales,
                                       rotations=rotations, active_sh_degree=3)
                        for s in (st, st._replace(backend="plain")))
            errs.append(compare_rasterize(got, ref, f"(c) frame {cam.image_name}"))
    say("fly", f"(c) frames {cams[0].image_name}, {cams[mid].image_name}, {cams[-1].image_name}: "
        f"kernels against plain max|err| {', '.join(f'{e:.3e}' for e in errs)} (floats abs "
        f"{K3_ATOL} + rel {K3_RTOL}, ints equal)")

    # (d) the device's busy share of a warm frame
    busy_share(f"flythrough frame {FULL_W}x{FULL_H} {FULL_N} pts SH3 (render + read-back)",
               lambda: gs_render.frame_pixels(renderer.render(cams[mid], pcd)).cpu(),
               render_s, card)

    # (e) the native COLMAP readers, (f) the COLMAP database
    native_readers(work, pcd._xyz.detach().cpu().numpy(), path, card)
    colmap_database(work, path, card)

    # (g) trace / annotate around three frames
    with trace(os.path.join(work, "trace"), "flythrough", device) as trace_path:
        for cam in (cams[0], cams[mid], cams[-1]):
            with annotate("frame"):
                gs_render.frame_pixels(renderer.render(cam, pcd)).cpu()
    check(os.path.exists(trace_path), f"(g) no trace file {trace_path}")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    regions = [e for e in events if e.get("name") == "frame"]
    kernels_seen = [e for e in events if str(e.get("cat", "")).lower() == "kernel"
                    and "render_tiles" in e.get("name", "")]
    say("fly", f"(g) trace {os.path.basename(trace_path)}: "
        f"{os.path.getsize(trace_path) / 2 ** 20:.2f} MiB, {len(events)} events, "
        f"{len(regions)} 'frame' regions, {len(kernels_seen)} render_tiles kernel events")
    check(len(regions) >= 3, f"(g) {len(regions)} 'frame' regions")
    check(len(kernels_seen) >= 3, f"(g) {len(kernels_seen)} render_tiles kernel events")

    # (h) the rasterizer's debug snapshot
    snap = os.path.join(work, "snapshot_fw.dump")
    debug = renderers.make({"name": "vanilla_renderer", "debug": True}, device=device)
    saved_env = os.environ.get("GS_DEBUG_SNAPSHOT")
    os.environ["GS_DEBUG_SNAPSHOT"] = snap
    try:
        debug.render(cams[mid], pcd)
        check(not os.path.exists(snap), "(h) a snapshot of a finite frame")
        walls = {"off": [], "on": []}
        for _ in range(DEBUG_TURNS):  # in turns: off, on, on, off
            for key, r in (("off", renderer), ("on", debug), ("on", debug), ("off", renderer)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DEBUG_RUN):
                    r.render(cams[mid], pcd)
                torch.cuda.synchronize()
                walls[key].append((time.perf_counter() - t0) / DEBUG_RUN)
        opacity = pcd._opacity
        pcd._opacity = opacity.detach().clone()
        pcd._opacity[FULL_N // 2] = float("nan")
        try:
            debug.render(cams[mid], pcd)
        finally:
            pcd._opacity = opacity
    finally:
        if saved_env is None:
            del os.environ["GS_DEBUG_SNAPSHOT"]
        else:
            os.environ["GS_DEBUG_SNAPSHOT"] = saved_env
    check(os.path.exists(snap), "(h) no snapshot of a frame with a NaN opacity")
    bad = torch.load(snap)["bad_leaves"]
    off, on = statistics.median(walls["off"]), statistics.median(walls["on"])
    q_off, q_on = (statistics.quantiles(walls[k], n=4) for k in ("off", "on"))
    say("fly", f"(h) debug: no snapshot of the finite frame; with one NaN opacity the snapshot "
        f"names {bad} ({os.path.getsize(snap) / 2 ** 20:.1f} MiB); a finite frame's render "
        f"{off * 1e3:.3f} ms without debug (quartiles {q_off[0] * 1e3:.3f}-{q_off[2] * 1e3:.3f}), "
        f"{on * 1e3:.3f} ms with it ({q_on[0] * 1e3:.3f}-{q_on[2] * 1e3:.3f}): "
        f"{(on - off) * 1e3:+.3f} ms (medians of {2 * DEBUG_TURNS} runs of {DEBUG_RUN} each, in "
        f"turns) | {card}")
    check("['inputs']['opacities']" in bad, f"(h) the snapshot does not name the opacities: {bad}")
    return counts


# --- phase 16: multi-device on the one card -----------------------------------

# 30 steps at 1080p / 300k / SH 3 (phase 7's scene and jitter) with one densify
# at step 25; the DP runs are held to their one-process references
DP_STEPS, DP_DENSIFY_AT = 30, 25
DP_PSNR_TOL = 0.1  # dB, phase 6b's gate
DP_POINTS_TOL = 1e-3  # relative, points after the densify
DP_RENDER_VIEWS = 4  # (c): four 1080p views over two ranks
DP_CLI_ITERS = 300  # (e): gs-train --gs_shards 2 on mini_scene


class Views(list):
    """Cameras as a dataset: the training scenes' extent."""

    cameras_extent = 2.0


def dp_config():
    from gaustudio_torch.pipelines import train as T

    return T.TrainConfig(iterations=DP_STEPS, densify_grad_threshold=1e-5,
                         densify_from_iter=DP_DENSIFY_AT - 1,
                         densification_interval=DP_DENSIFY_AT,
                         opacity_reset_interval=10 ** 9, sh_increase_interval=10 ** 9)


def dp_scene(ply: str, cams_path: str, device) -> tuple:
    """Phase 7's training scene: ground truth rendered through K1-K3 from the
    model, which is then jittered with a seeded generator on the card."""
    from gaustudio_torch import renderers

    pcd = load_model(ply, 3, device)
    cams = load_cameras(cams_path, device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    for cam in cams:
        cam.image = renderer.render(cam, pcd)["render"].permute(1, 2, 0).clone()
    gen = torch.Generator(device=device).manual_seed(0)
    pcd._xyz = pcd._xyz + torch.randn(pcd._xyz.shape, generator=gen, device=device) * 0.004
    pcd._f_dc = pcd._f_dc + torch.randn(pcd._f_dc.shape, generator=gen, device=device) * 0.2
    return pcd, Views(cams)


def with_sh3(trainer):
    """``trainer`` (Trainer or DPTrainer) with its state at SH degree 3."""
    state = trainer.state
    if hasattr(state, "shard"):
        trainer.state = state._replace(shard=state.shard._replace(active_sh_degree=3))
    else:
        trainer.state = state._replace(active_sh_degree=3)
    return trainer


def timed_train(trainer) -> tuple:
    """(history, ms of each step) of ``trainer.train`` for DP_STEPS steps:
    each step is fenced by the read of its loss in the logging callback."""
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.train(iterations=DP_STEPS, log_every=1,
                         callback=lambda m: stamps.append(time.perf_counter()))
    return hist, list(np.diff([t0] + stamps) * 1e3)


def final_psnr(state, views, settings) -> float:
    """Mean PSNR over ``views`` of a full (gathered) state's render."""
    from gaustudio_torch.pipelines import train as T

    device = state.params["xyz"].device
    scores = []
    with torch.no_grad():
        for cam in views:
            s = settings._replace(viewmatrix=cam.world_view_transform.to(device),
                                  projmatrix=cam.full_proj_transform.to(device),
                                  campos=cam.camera_center.to(device),
                                  bg=torch.zeros(3, device=device))
            out = T.render_from_params(state.params, state.active_sh_degree, s)
            scores.append(psnr(out["render"].permute(1, 2, 0), cam.image.to(device)))
    return float(np.mean(scores))


def single_gradients(state, batch, settings, cfg) -> tuple:
    """One process's gradient of one view: ({name: [N, ...]}, the viewspace
    gradient [N, 2], the radii as float), the loss as the training step takes it."""
    from gaustudio_torch.ops import ssim
    from gaustudio_torch.pipelines import train as T

    device = batch.gt_image.device
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    offset = torch.zeros((state.num_points, 2), device=device, requires_grad=True)
    out = T.render_from_params(params, state.active_sh_degree, s, means2d_offset=offset)
    loss = ssim.rgb_loss(out["render"], batch.gt_image, cfg.lambda_dssim)
    grads = torch.autograd.grad(loss, [params[k] for k in T.PARAMS] + [offset])
    return dict(zip(T.PARAMS, grads[:-1])), grads[-1], out["radii"].float()


def dp_reference_train(pcd, views, cfg, n_dp: int, device):
    """One process that takes the DP step of n_dp views: each view's gradient
    alone, meaned; the DP statistics and Adam of train_dp.dp_optimise; the
    schedule's densify. The same camera draws as the DPTrainer. Returns the
    final state and the settings."""
    from gaustudio_torch.parallel.train_dp import dp_optimise
    from gaustudio_torch.pipelines import train as T

    trainer = with_sh3(T.Trainer(pcd, views, cfg, seed=0, device=device))
    state, settings = trainer.state, trainer.settings()
    batches = [trainer.batch(c) for c in views]
    rng = np.random.default_rng(0)
    for it in range(1, DP_STEPS + 1):
        per = [single_gradients(state, batches[int(i)], settings, cfg)
               for i in rng.integers(len(batches), size=n_dp)]
        with torch.no_grad():
            grads = {k: sum(p[0][k] for p in per) / n_dp for k in T.PARAMS}
            stats = {"vs_grad": sum(p[1] for p in per) / n_dp,
                     "visible": sum((p[2] > 0).float() for p in per),
                     "radii": torch.stack([p[2] for p in per]).amax(dim=0)}
        state = dp_optimise(state, grads, stats, cfg, n_dp)
        if cfg.densify_from_iter < it < cfg.densify_until_iter \
                and it % cfg.densification_interval == 0:
            state, _ = T.densify_and_prune(state, trainer.generator, trainer.extent, cfg,
                                           it > cfg.opacity_reset_interval)
    return state, settings


def scaled_grad_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (atol + rtol |want|), both scaled by max |want|: at
    most 1 within K4's tolerance."""
    scale = float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / scale / (K4_ATOL + K4_RTOL * want.abs() / scale)).max())


def dp_one_rank(ply: str, cams_path: str, device, card: str) -> tuple:
    """(a) the DPTrainer on make_mesh(1, 1), one rank over NCCL, against the
    single-device Trainer: 30 steps and one densify, one camera sequence and
    seed, each trainer twice in turns (Trainer, DP, DP, Trainer) for ms/it.
    Returns (the first DP run's launches, the Trainer's final PSNR and
    points)."""
    import torch.distributed as dist

    from gaustudio_torch.parallel import make_mesh
    from gaustudio_torch.parallel.train_dp import DPTrainer
    from gaustudio_torch.pipelines import train as T

    pcd, views = dp_scene(ply, cams_path, device)
    cfg = dp_config()
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, device=device)
    backend = dist.get_backend()
    setup_s = time.perf_counter() - t0
    runs = {"Trainer": [], "DPTrainer": []}
    for name in ("Trainer", "DPTrainer", "DPTrainer", "Trainer"):
        trainer = with_sh3(T.Trainer(pcd, views, cfg, seed=0, device=device)
                           if name == "Trainer" else DPTrainer(pcd, views, cfg, mesh=mesh, seed=0))
        reset_counts()
        _, ms = timed_train(trainer)
        state = trainer.host_state() if name == "DPTrainer" else trainer.state
        runs[name].append((statistics.median(ms[5:]), read_counts(), state))
    settings = trainer.settings()
    (ms_s, counts_single, single), (ms_s2, _, _) = runs["Trainer"]
    (ms_d, counts, full), (ms_d2, _, _) = runs["DPTrainer"]
    psnr_single = final_psnr(single, views, settings)
    psnr_dp = final_psnr(full, views, settings)
    n_single, n_dp = single.num_points, full.num_points
    del runs, single, full, trainer
    dist.destroy_process_group()
    say("dp", f"(a) one rank, backend {backend}: DPTrainer on make_mesh(1, 1) against the "
        f"Trainer, {FULL_W}x{FULL_H}, {pcd.num_points} Gaussians, SH 3, {DP_STEPS} steps, densify "
        f"at {DP_DENSIFY_AT}: final mean PSNR {psnr_dp:.4f} against {psnr_single:.4f} dB "
        f"(gap {psnr_dp - psnr_single:+.4f}, tol {DP_PSNR_TOL}); points {n_dp} against "
        f"{n_single}; ms/it (median of steps 6-{DP_STEPS}, each fenced by its loss's read; in "
        f"turns Trainer, DP, DP, Trainer) DP {ms_d:.3f} / {ms_d2:.3f}, Trainer {ms_s:.3f} / "
        f"{ms_s2:.3f}; mesh set-up {setup_s:.3f} s | {card}")
    say("dp", f"(a) launches: DPTrainer {json.dumps(counts)}; Trainer {json.dumps(counts_single)}")
    check(abs(psnr_dp - psnr_single) <= DP_PSNR_TOL,
          f"(a) DPTrainer and Trainer differ by {psnr_dp - psnr_single:.4f} dB")
    check(abs(n_dp - n_single) <= DP_POINTS_TOL * n_single,
          f"(a) points after the densify: {n_dp} against {n_single}")
    check(all(counts[k] == DP_STEPS for k in FORWARD + ("render_tiles_backward",)),
          f"(a) the DP steps' launches: {counts}")
    return counts, psnr_single, n_single


def dp_train_rank(ply: str, cams_path: str, dev) -> dict:
    """(b) on one of two ranks that share the card (gloo, by the rule):
    dp=2 x gs=1, then dp=1 x gs=2. After step 1 the rank's reduced gradient
    against a one-process reference (the mean of the dp views' gradients);
    then 30 steps and one densify through the DPTrainer."""
    import torch.distributed as dist

    from gaustudio_torch.parallel import make_mesh
    from gaustudio_torch.parallel.mesh import Collectives, init_distributed
    from gaustudio_torch.parallel.train_dp import DPTrainer, dp_gradients
    from gaustudio_torch.pipelines import train as T

    device = init_distributed(dev)
    pcd, views = dp_scene(ply, cams_path, device)
    cfg = dp_config()
    out = {}
    for dp, gs in ((2, 1), (1, 2)):
        mesh = make_mesh(dp, gs, device=dev)
        comm = Collectives(mesh)
        dpt = with_sh3(DPTrainer(pcd, views, cfg, mesh=mesh, seed=0))
        settings = dpt.settings()
        draws = np.random.default_rng(0).integers(len(views), size=dp)  # step 1's views
        batches = [dpt.batch(views[int(i)]) for i in draws]
        comm.nbytes = 0
        grads, _, _ = dp_gradients(comm, dpt.state, batches[comm.dp_rank], settings, cfg)
        step_bytes = comm.nbytes
        full = dpt.host_state()
        lo, hi = comm.own_rows(full.num_points)
        per = [single_gradients(full, b, settings, cfg)[0] for b in batches]
        errs = {k: scaled_grad_error(grads[k], sum(p[k] for p in per)[lo:hi] / dp)
                for k in T.PARAMS}
        del full, per
        reset_counts()
        _, ms = timed_train(dpt)
        counts = read_counts()
        full = dpt.host_state()
        out[f"{dp}x{gs}"] = {
            "backend": dist.get_backend(comm.gs_group if gs > 1 else comm.dp_group),
            "rows": hi - lo, "grad_err": errs, "step_bytes": step_bytes,
            "ms": statistics.median(ms[5:]), "psnr": final_psnr(full, views, settings),
            "points": full.num_points, "launches": counts}
        del dpt, full
    return out


def dp_render_rank(ply: str, surfel_ply: str, cams4_path: str, dev) -> dict:
    """(c) on one of two ranks: the camera-parallel render of four 1080p
    views (two a rank) of the 300k model (K1-K3) and of the 200k-surfel model
    (K1 without the cull, K2, K5), every buffer against the single-process
    rasterize() of the same view."""
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import rasterize as rast
    from gaustudio_torch.ops import rasterize_surfel
    from gaustudio_torch.parallel import make_mesh
    from gaustudio_torch.parallel.mesh import Collectives, init_distributed
    from gaustudio_torch.parallel.render_dp import make_dp_render_fn, stack_cameras

    device = init_distributed(dev)
    comm = Collectives(make_mesh(2, 1, device=dev))
    cams = load_cameras(cams4_path, device)
    out = {}
    for name, path, config in (("vanilla_renderer", ply, None),
                               ("surfel_renderer", surfel_ply, SURFEL_CONFIG)):
        pcd = load_model(path, 3, device, config)
        renderer = renderers.make({"name": name}, device=device)
        settings, render_fn = renderer.dp_render_closure(cams, pcd)
        views = stack_cameras(cams)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        block = make_dp_render_fn(comm, settings, render_fn)(views)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        per = len(cams) // comm.dp
        worst, equal = 0.0, True
        for j in range(per):
            cam = cams[comm.dp_rank * per + j]
            xyz, shs, _, opacity, scales, rotations, _ = renderer.get_gaussians_properties(cam, pcd)
            st = renderer.make_settings(cam, pcd, device)
            with torch.inference_mode():
                if name == "surfel_renderer":
                    ref = dict(rasterize_surfel.rasterize_surfels(
                        xyz, opacity, st, scales=scales, rotations=rotations, shs=shs,
                        active_sh_degree=3))
                    ref["rendered_final_opacity"] = ref["rendered_alpha"]
                else:
                    ref = rast.rasterize(xyz, opacity, st, shs=shs, scales=scales,
                                         rotations=rotations, active_sh_degree=3)
            for k, v in block.items():
                got, want = v[j], ref[k]
                if got.is_floating_point():
                    err = (got - want).abs()
                    check(bool((err <= K3_ATOL + K3_RTOL * want.abs()).all()),
                          f"(c) {name} {k} of view {comm.dp_rank * per + j}: max|err| "
                          f"{float(err.max())}")
                    worst = max(worst, float(err.max()))
                    equal &= bool(torch.equal(got, want))
                else:
                    check(bool(torch.equal(got, want)), f"(c) {name} {k} differs")
        out[name] = {"keys": sorted(block), "max_err": worst, "equal": equal, "wall_s": wall,
                     "launches": counts, "views": per}
        del pcd
    return out


def dp_mesh_rank(mesh_ply: str, mesh_cams: str, out_dir: str, dev) -> dict:
    """(d) on one of two ranks: gs-extract-mesh with its defaults at phase 11's
    full width, through the CLI (files written) and through extract_mesh
    without files: the wall and the device's busy share of each; then, on
    rank 0, each fused volume against the single-process fusion, each mesh
    against phase 11's single-process mesh and the file names against its."""
    import torch.distributed as dist

    from gaustudio_torch import renderers
    from gaustudio_torch.ops import tsdf
    from gaustudio_torch.parallel import make_mesh
    from gaustudio_torch.parallel.mesh import init_distributed
    from gaustudio_torch.pipelines import mesh_extraction as ME
    from gaustudio_torch.scripts import extract_mesh as gs_extract_mesh
    from gaustudio_torch.utils.mesh import load_mesh, mesh_f1_score

    device = init_distributed(dev)
    rank = dist.get_rank()
    dp_dir = os.path.join(out_dir, "mesh_full_dp")
    argv = ["-m", mesh_ply, "-s", mesh_cams, "-o", dp_dir, "--device", device.type]
    pcd = load_model(mesh_ply, 0, device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    cams = load_cameras(mesh_cams, device)
    out = {"rank": rank}
    meshes = {}
    for tag, fn in (("files", lambda: gs_extract_mesh.main(argv)),
                    ("no files", lambda: ME.extract_mesh(pcd, renderer, cams, device=device))):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[tag] = {"wall_s": time.perf_counter() - t0, "launches": read_counts()}
        out[tag]["busy_s"] = profiled_device_s(fn)
        meshes[tag] = load_mesh(got) if isinstance(got, str) else got

    # the fused volumes, with and without files, against the single-process fusion
    views = [c.downsample_scale(2) for c in cams[::3]]
    lo, hi = tsdf.integrate_points_bounds(pcd.get_attribute("xyz"))
    fresh = lambda: tsdf.volume_from_bounds(lo, hi, 0.01, 0.04, max_dim=384,  # noqa: E731
                                            device=device)
    mesh = make_mesh(dp=2, gs=1, device=dev)
    vols = {"files": ME._fuse_views_dp(renderer, pcd, views, fresh(),
                                       os.path.join(out_dir, "mesh_full_dp_volume"), mesh),
            "no files": ME._fuse_views_dp(renderer, pcd, views, fresh(), None, mesh)}
    if rank != 0:
        return out
    ref = fresh()
    for camera, depth in ME.iter_fused_depths(renderer, pcd, views):
        tsdf.integrate(ref, depth, camera.intrinsics, camera.extrinsics)
    single = load_mesh(os.path.join(out_dir, "mesh_full", "fused_mesh.ply"))
    tau = 0.5 * float(ref.voxel_size)
    # what gs-extract-mesh writes (phase 13 adds a cameras.json to phase 11's directory)
    names = lambda d: sorted(n for n in (os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                                         for r, _, fs in os.walk(d) for f in fs)
                             if n == "fused_mesh.ply" or n.split(os.sep)[0] in ("images", "masks"))
    for tag, vol in vols.items():
        seen = ref.weight > 0
        out[tag].update(
            grid=tuple(ref.tsdf.shape),
            weights_equal=bool(torch.equal(vol.weight, ref.weight)),
            tsdf_err=float((vol.tsdf[seen] - ref.tsdf[seen]).abs().max()),
            faces=len(meshes[tag][1]), single_faces=len(single[1]),
            same_mesh=bool(np.array_equal(meshes[tag][1], single[1])
                           and np.array_equal(meshes[tag][0], single[0])),
            f1=mesh_f1_score(*meshes[tag], *single, tau=tau, n_samples=MESH_F1_SAMPLES)["f1"])
    got, want = names(dp_dir), names(os.path.join(out_dir, "mesh_full"))
    out["files"].update(names_equal=got == want, n_files=len(got),
                        names_differ=sorted(set(got) ^ set(want))[:10])
    return out


def dp_rank_phases(ply: str, cams_path: str, surfel_ply: str, cams4_path: str,
                   mesh_ply: str, mesh_cams: str, out_dir: str, dev=None) -> dict:
    """(b), (c) and (d) on one of the two ranks (``dev``: None, each rank on
    the card of its local rank; "cpu" for a rehearsal on the CPU)."""
    return {"train": dp_train_rank(ply, cams_path, dev),
            "render": dp_render_rank(ply, surfel_ply, cams4_path, dev),
            "mesh": dp_mesh_rank(mesh_ply, mesh_cams, out_dir, dev)}


def dp_cli(out_dir: str, device, card: str) -> None:
    """(e) gs-train --gs_shards 2 under torch.distributed.run with two ranks
    on the card, on mini_scene (phase 6's copy) for DP_CLI_ITERS iterations:
    the mesh line, rank 0's files, and the exported model's PSNR against the
    initial cloud's."""
    from gaustudio_torch import models
    from gaustudio_torch.utils.ply import fetch_ply

    src = os.path.join(out_dir, "train_src")
    out = os.path.join(out_dir, "train_out_dp")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "gaustudio_torch.scripts.train", "-s", src, "-o", out, "--dataset", "vanilla",
           "--iterations", str(DP_CLI_ITERS), "--save_every", str(DP_CLI_ITERS),
           "--gs_shards", "2", "--device", device.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": REPO})
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"(e) torchrun gs-train exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if "Multi-device" in ln or "torch.distributed" in ln]
    check(any("dp=1 x gs=2" in ln for ln in lines), f"(e) no 'dp=1 x gs=2' line: {proc.stdout}")
    ply = os.path.join(out, "point_cloud", f"iteration_{DP_CLI_ITERS}", "point_cloud.ply")
    check(os.path.exists(ply) and os.path.exists(os.path.join(out, "cameras.json")),
          "(e) rank 0 wrote no point_cloud.ply or cameras.json")
    cams = load_cameras(os.path.join(FIXTURE, "cameras.json"), device)
    xyz, rgb, _ = fetch_ply(os.path.join(src, "sparse", "0", "points3D.ply"))
    init = models.make({"name": "vanilla_pcd"}, device=device)
    init.create_from_attribute(xyz=xyz, rgb=rgb)
    before = float(np.mean(render_psnr(init, cams, device)))
    after = float(np.mean(render_psnr(load_model(ply, 0, device), cams, device)))
    say("dp", f"(e) torchrun --nproc_per_node 2 gs-train --gs_shards 2, {DP_CLI_ITERS} "
        f"iterations on mini_scene: {' / '.join(lines)}; {wall:.2f} s wall (two processes "
        f"time-share the card); mean PSNR over {len(cams)} views: initial {before:.4f} dB, "
        f"exported {after:.4f} dB | {card}")
    check(after > before, f"(e) the exported model's PSNR {after:.4f} <= the initial {before:.4f}")


def multi_device(out_dir: str, ply: str, cams_path: str, surfel_ply: str, device,
                 card: str) -> list:
    """Phase 16: (a) one rank over NCCL, (b)-(d) two ranks sharing the card
    over gloo, (e) the CLI under torchrun. Returns the launch counts of the
    paths: (a)'s DP run and each rank's (b)-(d)."""
    from gaustudio_torch.parallel.dryrun import run_ranks

    t_phase = time.perf_counter()
    counts_a, psnr_single, n_single = dp_one_rank(ply, cams_path, device, card)
    torch.cuda.empty_cache()

    cams4_path = os.path.join(out_dir, "dp_render_cameras.json")
    with open(cams4_path, "w") as f:
        json.dump(scene_cameras(FULL_W, FULL_H, DP_RENDER_VIEWS), f)
    mesh_ply = os.path.join(out_dir, "mesh_full_scene.ply")
    mesh_cams = os.path.join(out_dir, "mesh_full_cameras.json")
    t0 = time.perf_counter()
    dev = None if device.type == "cuda" else device.type
    ranks = run_ranks(2, dp_rank_phases, ply, cams_path, surfel_ply, cams4_path, mesh_ply,
                      mesh_cams, out_dir, dev, device=dev, timeout=900)
    ranks_s = time.perf_counter() - t0
    say("dp", "(b)-(d) two ranks time-share the one card, so their ms/it and walls are no "
        f"scaling figure; the two ranks took {ranks_s:.2f} s (spawn, kernel load, scenes)")

    # (b) against the one-process references: dp=2 emulated here, gs=2 (a)'s Trainer
    pcd, views = dp_scene(ply, cams_path, device)
    ref_state, settings = dp_reference_train(pcd, views, dp_config(), 2, device)
    refs = {"2x1": (final_psnr(ref_state, views, settings), ref_state.num_points),
            "1x2": (psnr_single, n_single)}
    del pcd, views, ref_state
    for shape in ("2x1", "1x2"):
        for r, res in enumerate(ranks):
            b = res["train"][shape]
            worst = max(b["grad_err"].values())
            say("dp", f"(b) {shape} rank {r}, backend {b['backend']}: {b['rows']} rows; step 1's "
                f"reduced gradient against the one-process reference, max |err| / (atol + rtol "
                f"|ref|) after scaling by the reference's max |g|: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in b["grad_err"].items())
                + f" (at most 1: rtol {K4_RTOL}, atol {K4_ATOL}); collectives "
                f"{b['step_bytes']} bytes a step from this rank; {b['ms']:.3f} ms/it; final "
                f"PSNR {b['psnr']:.4f} dB against the reference's {refs[shape][0]:.4f}; points "
                f"{b['points']} against {refs[shape][1]}; launches {json.dumps(b['launches'])} "
                f"| {card}")
            check(worst <= 1.0, f"(b) {shape} rank {r}: gradient off the reference: {b['grad_err']}")
            check(abs(b["psnr"] - refs[shape][0]) <= DP_PSNR_TOL,
                  f"(b) {shape} rank {r}: PSNR {b['psnr']:.4f} against {refs[shape][0]:.4f}")
            check(b["launches"]["render_tiles_backward"] == DP_STEPS,
                  f"(b) {shape} rank {r}: launches {b['launches']}")
    for r, res in enumerate(ranks):
        for name, c in res["render"].items():
            path = SURFEL_FORWARD if name == "surfel_renderer" else FORWARD
            say("dp", f"(c) {name} rank {r}: {c['views']} of {DP_RENDER_VIEWS} views at "
                f"{FULL_W}x{FULL_H} in {c['wall_s'] * 1e3:.2f} ms; buffers {c['keys']} against "
                f"the single-process rasterize(): max|err| {c['max_err']:.3e}, bitwise equal "
                f"{c['equal']}; launches {json.dumps(c['launches'])} | {card}")
            check(all(c["launches"][k] == c["views"] for k in path),
                  f"(c) {name} rank {r}: launches {c['launches']}")
    m = ranks[0]["mesh"]
    for tag in ("files", "no files"):
        d = m[tag]
        say("dp", f"(d) gs-extract-mesh under 2 ranks, {tag}: {d['wall_s']:.3f} s wall, device "
            f"busy {d['busy_s']:.3f} s of a second run (rank 0), busy share "
            f"{d['busy_s'] / d['wall_s']:.4f}; grid {d['grid']}; weights equal "
            f"{d['weights_equal']}, tsdf max|err| {d['tsdf_err']:.3e} where the weight > 0; "
            f"{d['faces']} faces against the single process's {d['single_faces']} (vertices and "
            f"faces equal: {d['same_mesh']}), F1 {d['f1']:.6f} at half a voxel "
            f"({MESH_F1_SAMPLES} samples); rank 0 launches "
            f"{json.dumps(d['launches'])}, rank 1 {json.dumps(ranks[1]['mesh'][tag]['launches'])}"
            f" | {card}")
        check(d["weights_equal"] and d["tsdf_err"] <= 1e-5 and d["f1"] >= 0.999,
              f"(d) {tag}: the fused volume or mesh is off the single process's: {d}")
    check(m["files"]["names_equal"], "(d) the 2-rank CLI wrote other file names than the "
          f"single process: {m['files']['names_differ']}")
    say("dp", f"(d) the 2-rank CLI wrote the single process's {m['files']['n_files']} file names")

    dp_cli(out_dir, device, card)
    say("dp", f"phase 16: {time.perf_counter() - t_phase:.1f} s wall | {card}")
    paths = [counts_a]
    for res in ranks:
        paths.append(res["train"]["2x1"]["launches"])
        paths.append(res["train"]["1x2"]["launches"])
        paths.extend(c["launches"] for c in res["render"].values())
        paths.extend(res["mesh"][tag]["launches"] for tag in ("files", "no files"))
    return paths


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


# --- phase 17: the capture and at-scale training tools ----------------------
#
# gaustudio_torch/tools at their defaults, each through its run(): (a)
# make_fixture (10 views at 128 px, 8000 Gaussians refit for 250
# iterations) against the committed fixture; (b) train_at_scale (512 px, 64
# views, every 8th held out, 2000 initial points, 7000 iterations) against
# the JAX run's bar; (c) train_scaffold (256 px, 24 views, 6000 anchors,
# 2000 iterations); (d) demo_e2e (256 px, 1500 iterations, 5000 Gaussians).

TOOLS_PSNR_TOL = 0.5  # dB of GOLDEN.json's psnr_mean, the refit on another trainer
TOOLS_EDGE_SHARE = 0.005  # fixture pixels that may differ, all at triangle edges
TOOLS_NEVER = ("render_surfel_tiles", "render_surfel_tiles_backward")
TOOLS_BUSY_STEPS = 5  # timed steps of the trained state for the busy share
TOOLS_AT_SCALE_TIMEOUT_S = 900  # (b): 7000 steps at ~36 ms and its capture


def tools_counts(tag: str, counts: dict) -> None:
    say("tools", f"{tag}: launches {json.dumps(counts)}")
    check(all(counts[k] > 0 for k in TRAIN_PATH), f"{tag}: a kernel was not launched: {counts}")
    check(all(counts[k] == 0 for k in TOOLS_NEVER), f"{tag}: a surfel kernel ran: {counts}")


def edge_pixels(tri_id: np.ndarray) -> np.ndarray:
    """Pixels whose 3x3 neighbourhood holds another triangle id (or the
    background): where two rasterizers may break ties differently."""
    H, W = tri_id.shape
    pad = np.pad(tri_id, 1, mode="edge")
    edge = np.zeros((H, W), bool)
    for dy in range(3):
        for dx in range(3):
            edge |= pad[dy:dy + H, dx:dx + W] != tri_id
    return edge


def fixture_image_diff(out_dir: str, device) -> dict:
    """The port's fixture images against the committed PNGs as uint8:
    pixels that differ, those of them at triangle edges of the port's
    fragments, and the largest channel difference off the edges."""
    from gaustudio_torch.ops import mesh_raster as MR
    from gaustudio_torch.tools import make_fixture
    from gaustudio_torch.utils.image import load_rgb8

    verts, faces = make_fixture.scene_mesh()
    v = torch.from_numpy(verts).to(device)
    f = torch.from_numpy(faces.astype(np.int64)).to(device)
    with open(os.path.join(FIXTURE, "GOLDEN.json")) as fh:
        golden = json.load(fh)
    cams = make_fixture.fixture_cameras(golden["views"], golden["size"], device)
    diff = {"pixels": 0, "differ": 0, "at_edges": 0, "off_edge_max": 0}
    for cam in cams:
        got = load_rgb8(os.path.join(out_dir, "images", cam.image_name)).astype(np.int32)
        want = load_rgb8(os.path.join(FIXTURE, "images", cam.image_name)).astype(np.int32)
        frag = MR.rasterize_mesh(v, f, cam.world_view_transform, cam.full_proj_transform,
                                 cam.image_width, cam.image_height)
        edge = edge_pixels(frag.tri_id.cpu().numpy())
        delta = np.abs(got - want).max(axis=-1)
        diff["pixels"] += delta.size
        diff["differ"] += int((delta > 0).sum())
        diff["at_edges"] += int(((delta > 0) & edge).sum())
        diff["off_edge_max"] = max(diff["off_edge_max"], int(delta[~edge].max(initial=0)))
    return diff


def tools_fixture(out_dir: str, device, card: str) -> dict:
    """(a) make_fixture at its defaults against tests/fixtures/mini_scene:
    cameras.json within 1e-6, gt_mesh.ply equal, the images equal as uint8
    but at triangle edges (at most TOOLS_EDGE_SHARE of the pixels, and off
    the edges at most one level), the refit's mean PSNR within
    TOOLS_PSNR_TOL of GOLDEN.json, its mesh within the bounds of
    tests/test_golden_e2e.py:100-101."""
    from gaustudio_torch.tools import make_fixture
    from gaustudio_torch.utils.ply import read_ply

    out = os.path.join(out_dir, "tools_fixture")
    with open(os.path.join(FIXTURE, "GOLDEN.json")) as fh:
        want = json.load(fh)
    reset_counts()
    t0 = time.perf_counter()
    got = make_fixture.run(make_fixture.parse_args(["--out", out, "--device", "cuda"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    tools_counts("make_fixture", counts)
    with open(os.path.join(out, "cameras.json")) as fh:
        cams = json.load(fh)
    with open(os.path.join(FIXTURE, "cameras.json")) as fh:
        ref = json.load(fh)
    check(len(cams) == len(ref), "make_fixture wrote another number of cameras")
    cam_err = 0.0
    for c, r in zip(cams, ref):
        check(c["img_name"] == r["img_name"] and c["width"] == r["width"], f"camera {c['id']}")
        for k in ("position", "rotation", "fx", "fy", "cx", "cy"):
            cam_err = max(cam_err, float(np.abs(np.subtract(c[k], r[k])).max()))
    mesh, ref_mesh = (read_ply(os.path.join(d, "gt_mesh.ply")) for d in (out, FIXTURE))
    mesh_equal = all(np.array_equal(mesh[e][k], ref_mesh[e][k])
                     for e in ref_mesh for k in ref_mesh[e]) and mesh.keys() == ref_mesh.keys()
    diff = fixture_image_diff(out, device)
    floor, ceiling = want["mesh_f1"] - 0.03, want["mesh_chamfer"] * 1.25 + 1e-4
    say("tools", f"(a) make_fixture {wall:.1f} s: cameras.json max |err| {cam_err:.3g}; "
        f"gt_mesh.ply equal {mesh_equal}; images: {diff['differ']} of {diff['pixels']} pixels "
        f"differ ({diff['differ'] / diff['pixels']:.5f}), {diff['at_edges']} at edges, off "
        f"the edges at most {diff['off_edge_max']} level(s); refit PSNR {got['psnr_mean']} "
        f"(GOLDEN {want['psnr_mean']} +- {TOOLS_PSNR_TOL}); mesh F1 {got['mesh_f1']} (floor "
        f"{floor:.4f}), chamfer {got['mesh_chamfer']} (ceiling {ceiling:.5f}) | {card}")
    check(cam_err <= 1e-6, f"cameras.json off by {cam_err}")
    check(mesh_equal, "gt_mesh.ply differs from the committed one")
    check(diff["differ"] <= TOOLS_EDGE_SHARE * diff["pixels"], f"fixture images: {diff}")
    check(diff["off_edge_max"] <= 1, f"fixture images differ off the edges: {diff}")
    check(abs(got["psnr_mean"] - want["psnr_mean"]) <= TOOLS_PSNR_TOL, "refit PSNR off GOLDEN")
    check(got["mesh_f1"] >= floor and got["mesh_chamfer"] <= ceiling, "refit mesh off GOLDEN")
    return counts


def trained_busy_share(tag: str, trainer, card: str) -> None:
    """The device's busy share of a step of the trained state (busy_share
    over the median host wall of TOOLS_BUSY_STEPS unprofiled steps, each
    fenced by synchronize())."""
    settings = trainer.settings()
    batch = trainer.batch(trainer.cameras[0])
    step = lambda: trainer.step(batch, settings)  # noqa: E731
    step()
    walls = []
    for _ in range(TOOLS_BUSY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    busy_share(f"{tag}: a step of the trained state ({trainer.state.num_points} points)", step,
               statistics.median(walls), card)


def tools_at_scale(out_dir: str, device, card: str) -> dict:
    """(b) train_at_scale at the JAX tool's defaults, held to its bar."""
    from gaustudio_torch.tools import train_at_scale as tas

    args = tas.parse_args(["--out", os.path.join(out_dir, "tools_train_at_scale"),
                           "--device", "cuda"])
    reset_counts()
    t0 = time.perf_counter()
    summary, trainer = tas.train_and_evaluate(args)
    wall = time.perf_counter() - t0
    counts = read_counts()
    tools_counts("train_at_scale", counts)
    with open(os.path.join(args.out, "metrics.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    densify = [m for m in logged if "num_points_after" in m]
    say("tools", f"(b) train_at_scale {summary['size']} px, {summary['views_train']} + "
        f"{summary['views_heldout']} views, {summary['iters']} iterations: held-out PSNR "
        f"{summary['psnr_heldout_before']} -> {summary['psnr_heldout_after']} dB, points "
        f"{summary['init_points']} -> {summary['final_points']} ({len(densify)} densify calls, "
        f"the largest {max((m['num_points_after'] for m in densify), default=0)}), "
        f"{summary['train_ms_per_iter']} ms/it, training {summary['train_wall_s']} s, "
        f"the tool {wall:.1f} s; non-finite rows {summary['nonfinite_rows']} | {card}")
    check(summary["platform"] == "cuda", "train_at_scale did not train on the card")
    tas.check_bars(summary, args)
    trained_busy_share("(b) train_at_scale", trainer, card)
    return counts


def tools_scaffold(out_dir: str, card: str) -> dict:
    """(c) train_scaffold at its defaults: the loss falls, held-out PSNR rises."""
    from gaustudio_torch.tools import train_scaffold

    reset_counts()
    t0 = time.perf_counter()
    summary = train_scaffold.run(train_scaffold.parse_args(
        ["--out", os.path.join(out_dir, "tools_train_scaffold"), "--device", "cuda"]))
    wall = time.perf_counter() - t0
    counts = read_counts()
    tools_counts("train_scaffold", counts)
    say("tools", f"(c) train_scaffold {summary['size']} px, {summary['iters']} iterations: "
        f"loss {summary['loss_first']:.4f} -> {summary['loss_last']:.4f}, held-out PSNR "
        f"{summary['psnr_heldout_before']} -> {summary['psnr_heldout_after']} dB, anchors "
        f"{summary['init_anchors']} -> {summary['final_anchors']}, "
        f"{summary['train_ms_per_iter']} ms/it, the tool {wall:.1f} s | {card}")
    train_scaffold.check_bars(summary)
    return counts


def tools_demo(out_dir: str, card: str) -> dict:
    """(d) demo_e2e at its defaults: PSNR rises, the mesh has > 100 faces."""
    from gaustudio_torch.tools import demo_e2e

    reset_counts()
    t0 = time.perf_counter()
    summary = demo_e2e.run(demo_e2e.parse_args(
        ["--out", os.path.join(out_dir, "tools_demo_e2e"), "--device", "cuda"]))
    wall = time.perf_counter() - t0
    counts = read_counts()
    tools_counts("demo_e2e", counts)
    say("tools", f"(d) demo_e2e {json.dumps(summary)}; the tool {wall:.1f} s | {card}")
    check(summary["psnr_after"] > summary["psnr_before"], "demo_e2e: PSNR did not rise")
    check(summary["mesh_faces"] > 100, f"demo_e2e: a mesh of {summary['mesh_faces']} faces")
    return counts


def tools(out_dir: str, device, card: str) -> list:
    """Phase 17: the launch counts of (a)-(d). (b), the longest, runs in a
    process of its own (``--tools-at-scale``) while this one runs (a), (c)
    and (d): every step is host-bound, and the card's machine has 8 cores.
    Its counts come back as the last line of its output."""
    t0 = time.perf_counter()
    log_path = os.path.join(out_dir, "tools_at_scale.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tools-at-scale",
                                 "--out", out_dir], stdout=log, stderr=subprocess.STDOUT)
    try:
        counts = [tools_fixture(out_dir, device, card), tools_scaffold(out_dir, card),
                  tools_demo(out_dir, card)]
        say("tools", f"(a), (c), (d) {time.perf_counter() - t0:.1f} s; waiting for (b)")
        rc = proc.wait(timeout=TOOLS_AT_SCALE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as log:
        lines = log.read().splitlines()
    for line in lines[:-1]:
        if line.startswith("["):
            print(line, flush=True)
    check(rc == 0, "phase 17 (b) failed:\n" + "\n".join(lines[-40:]))
    counts.append(json.loads(lines[-1]))
    say("tools", f"phase 17 {time.perf_counter() - t0:.1f} s | {card}")
    return counts


def lap(phase: str, started: float) -> None:
    say("time", f"phases 1-{phase}: {time.perf_counter() - started:.1f} s since the start")


def kernels_report(path_counts: list, errs: dict, times: dict, bounds: dict) -> dict:
    """The {"kernels": [...]} line: each kernel's launches summed over the
    main paths' counts, with its error, times and bound."""
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(c[name] for c in path_counts), "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1],
         "library_ms": times[name][2] if len(times[name]) > 2 else None}
        for name, (src, replaces) in KERNELS.items()
    ]}


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
    parser.add_argument("--tools-at-scale", action="store_true",
                        help="only run phase 17 (b) into --out and print its launch counts "
                             "as the last line")
    args = parser.parse_args(argv)

    # phase 1: the card
    started = time.perf_counter()
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
    if args.tools_at_scale:
        print(json.dumps(tools_at_scale(args.out, device, card)), flush=True)
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
    mini_kw = view_inputs(renderer, mini_cam, mini_pcd)
    errs["preprocess_forward"] = compare_k7(mini_kw, "mini_scene view")
    errs["preprocess_backward"] = compare_k8(mini_kw, "mini_scene view", seed=0)
    errs["render_tiles_backward"], _ = compare_backward(
        mini_pre, mini_cam.image_width, mini_cam.image_height, seed=0)
    mini_surfel_errs, _, _ = compare_surfel_kernels(
        view_preprocess_surfel(surfel_renderer, mini_cam, mini_pcd), mini_cam.image_width,
        mini_cam.image_height, seed=2)
    ply, cams_path = write_full_scene(args.out)
    full_pcd = load_model(ply, 3, device)
    full_cam = load_cameras(cams_path, device)[1]
    full_kw = view_inputs(renderer, full_cam, full_pcd)
    full_pre = view_preprocess(renderer, full_cam, full_pcd)
    full_errs = compare_kernels(full_pre, FULL_W, FULL_H)
    full_errs["preprocess_forward"] = compare_k7(full_kw, f"{FULL_W}x{FULL_H} view")
    full_errs["preprocess_backward"] = compare_k8(full_kw, f"{FULL_W}x{FULL_H} view", seed=1)
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
    k7 = time_k7(full_kw, f"{FULL_W}x{FULL_H}", card)
    times["preprocess_forward"], bounds["preprocess_forward"] = k7[:2], k7[2:]
    k8 = time_k8(full_kw, f"{FULL_W}x{FULL_H}", card)
    times["preprocess_backward"], bounds["preprocess_backward"] = k8[:2], k8[2:]
    del full_pcd, full_pre, mini_pre, k4_args, full_kw, mini_kw
    scene_3m = k7_scene(K7_N, K7_W, K7_H, device)
    time_k7(scene_3m, f"{K7_W}x{K7_H}", card)
    time_k8(scene_3m, f"{K7_W}x{K7_H}", card)
    del scene_3m

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
    lap("3", started)

    # phase 4: the render path on the fixture, against GOLDEN.json
    main_path_fixture(args.out, device)
    lap("4", started)

    # phase 5: the render path at full width
    path_counts = [main_path_full(args.out, ply, cams_path, device, card)]
    lap("5", started)

    # phase 6: the training path on the fixture
    path_counts.append(train_fixture(args.out, device, card))
    lap("6", started)

    # phase 6b: the kernels against the plain versions inside training (the
    # plain half is launch-bound, 2-4 s a step on the host: 10 steps keep the
    # script, phase 17 included, inside its time)
    train_kernels_vs_plain(device, card, steps=TRAIN_CHECK_STEPS)
    lap("6b", started)

    # phase 7: training at the two training shapes
    train_at_scale(args.out, ply, cams_path, device, card, "1080p/300k")
    small_ply, small_cams = write_full_scene(args.out, n=SMALL_N, W=SMALL_W, H=SMALL_H,
                                             name="small")
    train_at_scale(args.out, small_ply, small_cams, device, card, "512/100k")
    lap("7", started)

    # phase 8: the 2DGS render path at full width
    path_counts.append(main_path_surfel(args.out, surfel_ply, surfel_cams, device, card))
    lap("8", started)

    # phase 9: the 2DGS training path on the fixture
    path_counts.append(train_fixture(args.out, device, card, surfel=True))
    lap("9", started)

    # phase 9b: the kernels against the plain versions inside 2DGS training
    train_kernels_vs_plain(device, card, steps=SURFEL_CHECK_STEPS, surfel=True)
    lap("9b", started)

    # phase 10: 2DGS training at 512x512 / 60k surfels
    st_ply, st_cams = write_surfel_train_scene(args.out)
    train_at_scale(args.out, st_ply, st_cams, device, card, "2DGS 512/60k", surfel=True)
    lap("10", started)

    # phase 11: mesh extraction: gs-extract-mesh on the fixture, bench_all.py's
    # workload (and as surfels), and at full width
    path_counts.append(mesh_fixture(args.out))
    path_counts.extend(mesh_bench(args.out, device, card))
    path_counts.append(mesh_full(args.out, device, card))
    lap("11", started)

    # phase 12: the model and renderer variants (mip, gsplat, pcd, scaffold)
    # and Scaffold-GS training
    path_counts.extend(variants(args.out, ply, cams_path, device, card))
    lap("12", started)

    # phase 13: point extraction and the mesh tools (gs-extract-pcd on the
    # fixture and at full width; gs-render-mesh, gs-texture-mesh and
    # gs-from-mesh on phase 11's full-width mesh)
    path_counts.extend(pcd_fixture(args.out, device, card))
    path_counts.append(pcd_full(args.out, device, card))
    path_counts.extend(mesh_tools(args.out, device, card))
    lap("13", started)

    # phase 14: gs-init and gs-process-data on a capture rendered of phase 11's
    # sphere (K1-K3), then gs-train from gs-init's cloud (K1-K4)
    path_counts.append(init_full(args.out, device, card))
    lap("14", started)

    # phase 15: gs-render --flythrough of the 300k scene at 1080p (K1-K3), the
    # native COLMAP readers, colmap_db, trace / annotate and the debug snapshot
    path_counts.append(flythrough_full(args.out, ply, device, card))
    lap("15", started)

    # phase 16: multi-device on the one card: the DPTrainer on one rank over
    # NCCL; two ranks sharing the card over gloo for the sharded step, the
    # camera-parallel render and gs-extract-mesh; gs-train under torchrun
    path_counts.extend(multi_device(args.out, ply, cams_path, surfel_ply, device, card))
    lap("16", started)

    # phase 17: the capture and at-scale training tools (make_fixture,
    # train_at_scale, train_scaffold, demo_e2e) at their defaults (K1-K4)
    path_counts.extend(tools(args.out, device, card))

    say("time", f"chip_smoke {time.perf_counter() - started:.1f} s | {card}")
    report = kernels_report(path_counts, errs, times, bounds)
    check(all(k["launches"] > 0 for k in report["kernels"]), f"unlaunched kernel: {report}")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
