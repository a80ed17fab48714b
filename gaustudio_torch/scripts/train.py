"""gs-train: 3DGS, 2DGS and Scaffold-GS training (port of
gaustudio_tpu/scripts/train.py).

    python -m gaustudio_torch.scripts.train -s <scene> -o <out> \
        [--dataset colmap|vanilla|nerf] [--config vanilla|2dgs|mip|gsplat|scaffold]

Trains on ``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is asked
for. Starts from ``<scene>/sparse/0/points3D.ply`` when it exists, else from
the COLMAP ``points3D.bin`` beside it, else from ``--init_points`` random
points in the camera extent. Writes the Inria
layout that gs-render reads: ``point_cloud/iteration_N/point_cloud.ply``
and ``cameras.json``. The config picks the trainer as the JAX CLI does: a
``scaffold_pcd`` model trains with the ScaffoldTrainer (anchors, and the MLP
heads in ``point_cloud.ply.mlps.npz``), a ``surfel_renderer`` (``--config
2dgs``) with the SurfelTrainer, and every other config (vanilla, mip,
gsplat) with the vanilla Trainer. A config that no trainer takes (``pcd``,
a plain point cloud) raises ValueError; multi-device training belongs to a
later slice of the port and raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gaustudio_torch.scripts.render import _device


def _refuse_deferred(args) -> None:
    if args.gs_shards is not None:
        raise NotImplementedError(
            "--gs_shards: multi-device training comes to the port with slice 8")


def _refuse_untrainable(config) -> None:
    """The vanilla Trainer and the SurfelTrainer train a model with SH colours
    (xyz, f_dc, f_rest, opacity, scale, rot); a plain point cloud has none."""
    model = config["model"]["pointcloud"].get("name", "vanilla_pcd")
    if model not in ("vanilla_pcd", "mip_pcd", "scaffold_pcd"):
        raise ValueError(f"config {config.get('name', '?')!r}: no trainer takes a {model!r} "
                         "model (gs-train trains vanilla_pcd, mip_pcd and scaffold_pcd)")


def _train_scaffold(args, config, dataset, pcd, device):
    """gs-train of a scaffold_pcd model; returns the logged metrics."""
    from gaustudio_torch.pipelines import train_scaffold as TSc

    tr_conf = config.get("trainer", {})
    opt_params = config.get("optimizer", {}).get("params", {}) or {}
    lr = lambda name, default: float(opt_params.get(name, {}).get("lr", default))  # noqa: E731
    cfg = TSc.ScaffoldTrainConfig(
        iterations=args.iterations,
        lambda_dssim=float(tr_conf.get("lambda_dssim", 0.2)),
        lambda_vol=float(tr_conf.get("lambda_vol", 0.01)),
        lr_anchor=lr("anchor", 0.0), lr_offset_init=lr("offset", 0.01),
        lr_feat=lr("anchor_feat", 0.0075), lr_scale=lr("scale", 0.007), lr_rot=lr("rot", 0.002),
        update_from=int(tr_conf.get("update_from", 1500)),
        update_interval=int(tr_conf.get("update_interval", 100)),
        update_until=int(tr_conf.get("update_until", 15000)),
        grad_threshold=float(tr_conf.get("densify_grad_threshold", 0.0002)),
        min_opacity=float(tr_conf.get("min_opacity", 0.005)),
        success_threshold=float(tr_conf.get("success_threshold", 0.8)),
        white_background=args.white_background,
    )
    trainer = TSc.ScaffoldTrainer(pcd, dataset, cfg, device=device)
    if args.resume or args.checkpoint_every:
        print("WARNING: --resume/--checkpoint_every are not supported for scaffold configs "
              "(anchor+MLP state); use the model config's resume_path to reload a ply")

    def save(iteration):
        out = os.path.join(args.output_dir, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out, exist_ok=True)
        TSc.state_to_scaffold_model(trainer.state, pcd)
        pcd.export(os.path.join(out, "point_cloud.ply"))
        dataset.export(os.path.join(args.output_dir, "cameras.json"))

    def log(m):
        print(f"iter {m['iter']:6d}  loss {m['loss']:.4f}  psnr {m['psnr']:.2f}  "
              f"anchors {int(m['num_points'])}", flush=True)
        if m["iter"] % args.save_every == 0:
            save(m["iter"])

    history = trainer.train(iterations=args.iterations, log_every=100, callback=log,
                            metrics_path=os.path.join(args.output_dir, "metrics.jsonl"))
    save(args.iterations)
    print(f"Training done -> {args.output_dir}")
    return history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="vanilla")
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--output-dir", "-o", required=True)
    parser.add_argument("--iterations", default=30000, type=int)
    parser.add_argument("--resolution", default=1, type=int)
    parser.add_argument("--dataset", default="colmap",
                        help="dataset registry name (colmap, vanilla or nerf in the port)")
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--save_every", default=7000, type=int)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--init_points", default=50000, type=int,
                        help="random-init point count when no sparse points exist")
    parser.add_argument("--resume", default=None,
                        help="checkpoint file (output_dir/ckpt/step_N.pt) to restore the "
                             "whole training state from")
    parser.add_argument("--no_dp", action="store_true",
                        help="single-device training (the port trains on one device)")
    parser.add_argument("--gs_shards", default=None, type=int,
                        help="Gaussian-axis shards for multi-device training (slice 8)")
    parser.add_argument("--checkpoint_every", default=0, type=int,
                        help="save a full training checkpoint every N iterations")
    args, extras = parser.parse_known_args(argv)

    from gaustudio_torch import datasets, models
    from gaustudio_torch.config import builtin_config_path, load_config
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.utils.ply import fetch_ply

    _refuse_deferred(args)
    config_path = args.config if os.path.exists(args.config) else builtin_config_path(args.config)
    config = load_config(config_path, cli_args=extras)
    _refuse_untrainable(config)
    device = _device(args)

    dataset = datasets.make({"name": args.dataset, "source_path": args.source_path,
                             "resolution": args.resolution,
                             "white_background": args.white_background})
    if args.resolution > 1 and args.dataset != "colmap":  # colmap downsamples as it loads
        dataset.downsample_scale(args.resolution)

    pcd = models.make(config["model"]["pointcloud"], device=device)
    sparse_ply = os.path.join(args.source_path, "sparse", "0", "points3D.ply")
    sparse_bin = os.path.join(args.source_path, "sparse", "0", "points3D.bin")
    if os.path.exists(sparse_ply):
        xyz, rgb, _ = fetch_ply(sparse_ply)
        pcd.create_from_attribute(xyz=xyz, rgb=rgb)
    elif os.path.exists(sparse_bin):
        from gaustudio_torch.datasets.utils import read_points3D_binary

        xyz, rgb, _ = read_points3D_binary(sparse_bin)
        pcd.create_from_attribute(xyz=xyz, rgb=rgb / 255.0)
    else:
        n0 = args.init_points
        print(f"No sparse points found; random init of {n0} points")
        rng = np.random.default_rng(args.seed)
        r = dataset.cameras_extent
        xyz = rng.uniform(-r / 2, r / 2, (n0, 3)).astype(np.float32)
        pcd.create_from_attribute(xyz=xyz, rgb=np.full((n0, 3), 0.5, np.float32))

    if config["model"]["pointcloud"].get("name") == "scaffold_pcd":
        return _train_scaffold(args, config, dataset, pcd, device)

    tr_conf = config.get("trainer", {})
    cfg = T.TrainConfig(
        iterations=args.iterations,
        lambda_dssim=float(tr_conf.get("lambda_dssim", 0.2)),
        densify_from_iter=int(tr_conf.get("densify_from_iter", 500)),
        densify_until_iter=int(tr_conf.get("densify_until_iter", 15000)),
        densification_interval=int(tr_conf.get("densification_interval", 100)),
        densify_grad_threshold=float(tr_conf.get("densify_grad_threshold", 0.0002)),
        opacity_reset_interval=int(tr_conf.get("opacity_reset_interval", 3000)),
        percent_dense=float(tr_conf.get("percent_dense", 0.01)),
        white_background=args.white_background,
    )
    if config.get("renderer", {}).get("name") == "surfel_renderer":
        from gaustudio_torch.pipelines import train_surfel as TS

        scfg = TS.SurfelTrainConfig(base=cfg,
                                    lambda_normal=float(tr_conf.get("lambda_normal", 0.05)),
                                    lambda_dist=float(tr_conf.get("lambda_dist", 0.0)))
        trainer = TS.SurfelTrainer(pcd, dataset, scfg, seed=args.seed, device=device)
    else:
        trainer = T.Trainer(pcd, dataset, cfg, seed=args.seed, device=device)
    if args.resume:
        trainer.restore(args.resume)
        print(f"Resumed training state from {args.resume} (step {trainer.state.step}, "
              f"{trainer.state.num_points} points)")

    def save(iteration):
        out = os.path.join(args.output_dir, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out, exist_ok=True)
        T.state_to_model(trainer.state, pcd)
        pcd.export(os.path.join(out, "point_cloud.ply"))
        dataset.export(os.path.join(args.output_dir, "cameras.json"))

    def log(m):
        print(f"iter {m['iter']:6d}  loss {m['loss']:.4f}  psnr {m['psnr']:.2f}  "
              f"points {int(m['num_points'])}", flush=True)
        if m["iter"] % args.save_every == 0:
            save(m["iter"])

    ckpt_kw = {}
    if args.checkpoint_every:
        ckpt_kw = dict(checkpoint_dir=os.path.join(args.output_dir, "ckpt"),
                       checkpoint_every=args.checkpoint_every)
    # metrics.jsonl, and the snapshot of a non-finite loss, land under -o
    history = trainer.train(iterations=args.iterations, log_every=100, callback=log,
                            metrics_path=os.path.join(args.output_dir, "metrics.jsonl"),
                            **ckpt_kw)
    save(args.iterations)
    print(f"Training done -> {args.output_dir}")
    return history


if __name__ == "__main__":
    main()
