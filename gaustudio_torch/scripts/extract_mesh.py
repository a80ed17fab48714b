"""gs-extract-mesh: render depth from the training views -> TSDF -> mesh
(port of gaustudio_tpu/scripts/extract_mesh.py, same flags and defaults).

    python -m gaustudio_torch.scripts.extract_mesh -m <model dir | ply> \
        [-s <cameras.json | COLMAP dir>] [--config vanilla|2dgs|mip|gsplat|scaffold] [--device cuda|cpu]

Runs on ``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is asked
for. The cameras come from ``-s``: a cameras.json, or a COLMAP scene
directory; by default the cameras.json beside the model. Writes
``fused_mesh.ply``, ``images/<name>.png``, ``images/<name>.cam`` and
``masks/<name>.png`` to ``-o`` (default ``<model>/renders/iteration_N``).

Under ``python -m torch.distributed.run --nproc_per_node N -m
gaustudio_torch.scripts.extract_mesh ...`` each rank runs on the card
``LOCAL_RANK`` names (``--device cpu``: on the CPU, over gloo), the views
are rendered and fused camera-parallel, each rank writes its own views'
files, and rank 0 marches and writes the mesh.
"""

from __future__ import annotations

import argparse
import json
import os

from gaustudio_torch.scripts.render import _device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="vanilla", help="config name or path")
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--model", "-m", default=None, help="path to the model")
    parser.add_argument("--source_path", "-s", help="cameras.json or COLMAP scene directory")
    parser.add_argument("--output-dir", "-o", default=None, help="output dir")
    parser.add_argument("--load_iteration", default=-1, type=int)
    parser.add_argument("--resolution", default=2, type=int, help="downscale")
    parser.add_argument("--sh", default=0, type=int, help="default SH degree")
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--clean", action="store_true")
    parser.add_argument("--voxel_size", default=0.01, type=float)
    parser.add_argument("--sdf_trunc", default=0.04, type=float)
    parser.add_argument("--min_weight", default=5.0, type=float)
    parser.add_argument("--stride", default=3, type=int)
    args, extras = parser.parse_known_args(argv)

    from gaustudio_torch import datasets, models, renderers
    from gaustudio_torch.config import builtin_config_path, load_config
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.pipelines.mesh_extraction import extract_mesh
    from gaustudio_torch.utils.misc import searchForMaxIteration

    device = _device(args)
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:  # a torchrun launch: LOCAL_RANK picks the card
        from gaustudio_torch.parallel.mesh import init_distributed

        device = init_distributed(device if device.type == "cpu" else None)
    config_path = args.config if os.path.exists(args.config) else builtin_config_path(args.config)
    config = load_config(config_path, cli_args=extras)
    if args.white_background:
        config["renderer"]["white_background"] = True

    pcd = models.make(config["model"]["pointcloud"], device=device)
    renderer = renderers.make(config["renderer"], device=device)
    pcd.active_sh_degree = args.sh

    model_path = args.model
    if model_path is not None and os.path.isdir(model_path):
        loaded_iter = (searchForMaxIteration(os.path.join(model_path, "point_cloud"))
                       if args.load_iteration == -1 else args.load_iteration)
        work_dir = args.output_dir or os.path.join(
            model_path, "renders", f"iteration_{loaded_iter}")
        print(f"Loading trained model at iteration {loaded_iter}")
        pcd.load(os.path.join(model_path, "point_cloud", f"iteration_{loaded_iter}",
                              "point_cloud.ply"))
    elif model_path is not None and model_path.endswith(".ply"):
        work_dir = args.output_dir or os.path.join(
            os.path.dirname(model_path), os.path.basename(model_path)[:-4])
        pcd.load(model_path)
    else:
        raise SystemExit(f"Model not found at {model_path}")

    if args.source_path is None:
        args.source_path = os.path.join(
            model_path if os.path.isdir(model_path) else os.path.dirname(model_path),
            "cameras.json")
    if args.source_path.endswith(".json"):
        print(f"Loading camera data from {args.source_path}")
        with open(args.source_path) as f:
            cameras = [JSON_to_camera(cj, device=device) for cj in json.load(f)]
    else:
        dataset = datasets.make(
            {"name": "colmap", "source_path": args.source_path, "images": "images"})
        cameras = dataset.all_cameras

    os.makedirs(work_dir, exist_ok=True)
    mesh = extract_mesh(
        pcd, renderer, cameras, work_dir=work_dir, voxel_size=args.voxel_size,
        sdf_trunc=args.sdf_trunc, min_weight=args.min_weight, stride=args.stride,
        downsample=args.resolution, clean=args.clean, device=device)
    if mesh is None:  # a rank other than 0 of a camera-parallel run
        return None
    verts, faces = mesh
    mesh_path = os.path.join(work_dir, "fused_mesh.ply")
    print(f"Extracted mesh: {len(verts)} vertices, {len(faces)} faces -> {mesh_path}")
    return mesh_path


if __name__ == "__main__":
    main()
