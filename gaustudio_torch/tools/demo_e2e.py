"""End-to-end demo on the port: train -> evaluate PSNR -> extract a mesh
(counterpart of the JAX package's ``tools/demo_e2e.py``).

A self-contained synthetic capture (a Gaussian-splat "object" rendered from
an orbit is the ground truth), trained from a perturbed init with full
densification, evaluated for PSNR, then surfaced with the TSDF mesh
extractor: gs-train + gs-extract-mesh without dataset files. Prints a JSON
summary and writes it into ``--out``.

    python -m gaustudio_torch.tools.demo_e2e [--size 256] [--iters 1500]
        [--n 5000] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gaustudio_torch.tools import build_path
from gaustudio_torch.tools.make_fixture import CaptureList
from gaustudio_torch.utils.misc import resolve_device


def make_capture(n, size, num_cam=24, seed=0, device=None):
    """Ground-truth scene: a blobby 'object' of n Gaussians on a sphere
    surface and in its interior, rendered from an orbit. Returns the model
    and the cameras, each with its image."""
    from gaustudio_torch import models, renderers
    from gaustudio_torch.cameras import camera_paths

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    # surface shell + some volume fill
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = np.where(rng.uniform(size=n) < 0.7,
                      0.5 + 0.04 * rng.normal(size=n),
                      rng.uniform(0.1, 0.5, size=n)).astype(np.float32)
    # low-frequency bumps so views have structure
    bump = 0.08 * np.sin(3 * dirs[:, 0]) * np.cos(4 * dirs[:, 1])
    xyz = dirs * (radius + bump.astype(np.float32))[:, None]
    rgb = (0.5 + 0.45 * np.stack([
        np.sin(5 * xyz[:, 0]), np.cos(7 * xyz[:, 1]), np.sin(6 * xyz[:, 2]),
    ], axis=1)).clip(0.05, 0.95).astype(np.float32)

    gt = models.make({"name": "vanilla_pcd"}, device=device)
    gt.create_from_attribute(xyz=xyz, rgb=rgb)
    gt._opacity = torch.full((n, 1), 3.0, device=device)
    gt.active_sh_degree = 0

    cams = camera_paths.get_path_from_orbit(
        np.zeros(3), 1.8, elevation=15, num_cam=num_cam, image_size=size,
        fov_deg=50, device=device,
    )
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    for cam in cams:
        cam.image = renderer.render(cam, gt)["render"].permute(1, 2, 0).contiguous()
    return gt, cams


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--out", default=build_path("demo_e2e"))
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the current CUDA device")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Capture, train, evaluate and extract; returns the summary."""
    from gaustudio_torch import models, renderers
    from gaustudio_torch.pipelines import mesh_extraction as ME
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.tools.train_at_scale import eval_holdout

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    _, cams = make_capture(args.n, args.size, device=device)
    print(f"capture: {len(cams)} views {args.size}px ({time.perf_counter() - t0:.1f}s)",
          flush=True)

    rng = np.random.default_rng(1)
    n0 = args.n // 4
    pcd = models.make({"name": "vanilla_pcd"}, device=device)
    xyz0 = rng.uniform(-0.6, 0.6, size=(n0, 3)).astype(np.float32)
    pcd.create_from_attribute(xyz=xyz0, rgb=np.full((n0, 3), 0.5, np.float32))

    cfg = T.TrainConfig(
        iterations=args.iters,
        densify_from_iter=200,
        densify_until_iter=int(args.iters * 0.8),
        densification_interval=100,
        opacity_reset_interval=10 ** 9,
        sh_increase_interval=500,
        lr_xyz_init=0.0016, lr_xyz_final=0.00016,
        lr_xyz_max_steps=args.iters,
    )
    trainer = T.Trainer(pcd, CaptureList(cams, 2.0), cfg, device=device)

    def eval_psnr():  # the first four views, as the JAX demo evaluates
        return eval_holdout(trainer, cams[:4])[0]

    psnr0 = eval_psnr()
    print(f"PSNR before: {psnr0:.2f}", flush=True)

    t0 = time.perf_counter()
    trainer.train(iterations=1, log_every=1)
    print(f"warmup: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    trainer.train(iterations=args.iters, log_every=200,
                  callback=lambda m: print(
                      f"  iter {m['iter']:5d} loss {m['loss']:.4f} "
                      f"psnr {m['psnr']:.2f} pts {int(m['num_points'])}", flush=True))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    ms_it = train_s / args.iters * 1e3
    psnr1 = eval_psnr()
    print(f"PSNR after: {psnr1:.2f}  ({ms_it:.1f} ms/it)", flush=True)

    # mesh extraction from the trained model
    os.makedirs(args.out, exist_ok=True)
    T.state_to_model(trainer.state, pcd)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    t0 = time.perf_counter()
    verts, faces = ME.extract_mesh(
        pcd, renderer, cams, voxel_size=0.02, sdf_trunc=0.08,
        min_weight=2.0, stride=2, downsample=1, device=device,
    )
    mesh_s = time.perf_counter() - t0
    print(f"mesh: {len(verts)} verts {len(faces)} faces ({mesh_s:.1f}s)", flush=True)

    # geometric sanity: mesh vertices should hug the GT surface shell
    med_r = float(np.median(np.linalg.norm(verts, axis=1))) if len(verts) else float("nan")
    summary = {
        "views": len(cams), "size": args.size, "iters": args.iters,
        "psnr_before": round(psnr0, 2), "psnr_after": round(psnr1, 2),
        "train_ms_per_iter": round(ms_it, 1),
        "final_points": trainer.state.num_points,
        "mesh_verts": int(len(verts)), "mesh_faces": int(len(faces)),
        "mesh_median_radius": round(med_r, 3),
        "mesh_seconds": round(mesh_s, 1),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
