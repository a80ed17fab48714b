"""Scaffold-GS training on the port (counterpart of the JAX package's
``tools/train_scaffold_tpu.py``).

The capture of ``train_at_scale`` (vertex-coloured, the plain scene) at a
moderate size, trained with the ScaffoldTrainer (anchor-MLP decode, anchor
growing and pruning), with held-out PSNR before and after.

    python -m gaustudio_torch.tools.train_scaffold [--size 256] [--iters 2000]
        [--out DIR] [--device cpu]

Writes ``summary.json`` into ``--out`` (default
``gaustudio_torch/build/train_scaffold``) and asserts that the final loss is
finite and below the first, and that the held-out PSNR rose.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gaustudio_torch.tools import build_path
from gaustudio_torch.tools.make_fixture import set_images
from gaustudio_torch.tools.train_at_scale import (
    holdout_split,
    orbit_rings,
    render_gt,
    scene_mesh_large,
)
from gaustudio_torch.utils.misc import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--holdout_every", type=int, default=6)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--anchors", type=int, default=6000)
    ap.add_argument("--out", default=build_path("train_scaffold"))
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the current CUDA device")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Capture, train and evaluate; writes and returns the summary."""
    from gaustudio_torch import models, renderers
    from gaustudio_torch.ops import ssim as ssim_ops
    from gaustudio_torch.pipelines import train_scaffold as TSc
    from gaustudio_torch.utils.mesh import sample_mesh_surface

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    verts, faces = scene_mesh_large()
    cams = orbit_rings(args.size, args.views, device=device)
    set_images(cams, render_gt(verts, faces, cams, device=device))
    print(f"capture: {len(cams)} views {args.size}px ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    train_cams, test_cams = holdout_split(cams, args.holdout_every)

    pts = sample_mesh_surface(verts, faces, args.anchors, seed=7)
    model = models.make({"name": "scaffold_pcd", "n_offsets": 5, "voxel_size": 0.02},
                        device=device)
    model.create_from_attribute(xyz=pts)
    cfg = TSc.ScaffoldTrainConfig(
        iterations=args.iters,
        update_from=400,
        update_until=int(args.iters * 0.8),
        update_interval=100,
        lr_offset_max_steps=args.iters,
    )
    trainer = TSc.ScaffoldTrainer(model, train_cams, cfg, device=device)
    renderer = renderers.make({"name": "scaffold_renderer"}, device=device)

    def eval_holdout():
        TSc.state_to_scaffold_model(trainer.state, model)
        vals = []
        for cam in test_cams:
            out = renderer.render(cam, model)
            vals.append(float(ssim_ops.psnr(out["render"], cam.image.to(device).permute(2, 0, 1))))
        return float(np.mean(vals)), [round(v, 2) for v in vals]

    psnr0, _ = eval_holdout()
    print(f"held-out PSNR before: {psnr0:.2f}", flush=True)

    t0 = time.perf_counter()
    trainer.train(iterations=1, log_every=1)
    print(f"warmup: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    hist = trainer.train(iterations=args.iters, log_every=100,
                         callback=lambda m: print(
                             f"  iter {m['iter']:5d} loss {m['loss']:.4f} "
                             f"psnr {m['psnr']:.2f} anchors {int(m.get('num_points', -1))}",
                             flush=True))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    ms_it = train_s / args.iters * 1e3

    psnr1, per_view = eval_holdout()
    anchors1 = trainer.state.num_anchors
    print(f"held-out PSNR after: {psnr1:.2f}  anchors {anchors1}  ({ms_it:.1f} ms/it)",
          flush=True)
    summary = {
        "views_train": len(train_cams), "views_heldout": len(test_cams),
        "size": args.size, "iters": args.iters,
        "init_anchors": args.anchors, "final_anchors": anchors1,
        "psnr_heldout_before": round(psnr0, 2),
        "psnr_heldout_after": round(psnr1, 2),
        "psnr_heldout_per_view": per_view,
        "train_ms_per_iter": round(ms_it, 2),
        "train_wall_s": round(train_s, 1),
        "loss_first": hist[0]["loss"],
        "loss_last": hist[-1]["loss"],
        "platform": device.type,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


def check_bars(summary: dict) -> None:
    """The JAX tool's bars: a finite last loss below the first, and a rise
    in held-out PSNR."""
    first, last = summary["loss_first"], summary["loss_last"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"scaffold loss did not fall: {first} -> {last}")
    if not summary["psnr_heldout_after"] > summary["psnr_heldout_before"]:
        raise AssertionError("scaffold training did not improve held-out PSNR")


def main(argv=None):
    check_bars(run(parse_args(argv)))
    print("SCAFFOLD TRAIN OK", flush=True)


if __name__ == "__main__":
    main()
