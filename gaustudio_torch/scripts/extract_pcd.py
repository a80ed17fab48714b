"""gs-extract-pcd: surface points with fused normals, and a mesh of them
(port of gaustudio_tpu/scripts/extract_pcd.py, same flags and defaults).

    python -m gaustudio_torch.scripts.extract_pcd -m <model dir | ply> \
        [-c cameras.json] [-o dir] [--config vanilla|2dgs|mip|gsplat] \
        [--meshing sap|nksr|poisson|pymeshlab|None] [--device cuda|cpu]

Runs on ``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is asked
for. The cameras come from ``-c``, by default the cameras.json beside the
model. Writes ``fused.ply`` (``<model>_fused.ply`` for a PLY model) and, with
a meshing backend, ``fused_mesh.ply``, beside ``images/``, ``normals/`` and
``masks/`` in ``-o`` (default ``<model>/renders/iteration_N``). The surface
points are the models' Gaussians named by the renderer's median ids, so the
config's model must hold ``_xyz`` and ``_f_dc``, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from gaustudio_torch.scripts.render import _device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="vanilla")
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--camera", "-c", default=None, help="path to cameras.json")
    parser.add_argument("--model", "-m", default=None)
    parser.add_argument("--output-dir", "-o", default=None)
    parser.add_argument("--load_iteration", default=-1, type=int)
    parser.add_argument("--resolution", default=1, type=int)
    parser.add_argument("--sh", default=0, type=int)
    parser.add_argument("--meshing", choices=["sap", "nksr", "poisson", "pymeshlab", "None"],
                        default="sap",
                        help="sap: DPSR on the device; nksr/poisson/pymeshlab: external packages")
    args, extras = parser.parse_known_args(argv)

    from gaustudio_torch import models, renderers
    from gaustudio_torch.config import builtin_config_path, load_config
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.pipelines import pcd_extraction as P
    from gaustudio_torch.utils.mesh import save_mesh
    from gaustudio_torch.utils.misc import searchForMaxIteration
    from gaustudio_torch.utils.ply import store_ply

    device = _device(args)
    config_path = args.config if os.path.exists(args.config) else builtin_config_path(args.config)
    config = load_config(config_path, cli_args=extras)
    pcd = models.make(config["model"]["pointcloud"], device=device)
    renderer = renderers.make(config["renderer"], device=device)
    pcd.active_sh_degree = args.sh

    model_path = args.model
    if model_path is not None and os.path.isdir(model_path):
        loaded_iter = (searchForMaxIteration(os.path.join(model_path, "point_cloud"))
                       if args.load_iteration == -1 else args.load_iteration)
        work_dir = args.output_dir or os.path.join(model_path, "renders",
                                                   f"iteration_{loaded_iter}")
        pcd.load(os.path.join(model_path, "point_cloud", f"iteration_{loaded_iter}",
                              "point_cloud.ply"))
        output_pcd_path = os.path.join(work_dir, "fused.ply")
    elif model_path is not None and model_path.endswith(".ply"):
        work_dir = args.output_dir or os.path.join(os.path.dirname(model_path),
                                                   os.path.basename(model_path)[:-4])
        pcd.load(model_path)
        output_pcd_path = model_path[:-4] + "_fused.ply"
    else:
        raise SystemExit(f"Model not found at {model_path}")

    if args.camera is None:
        args.camera = os.path.join(
            model_path if os.path.isdir(model_path) else os.path.dirname(model_path),
            "cameras.json")
    with open(args.camera) as f:
        cameras = [JSON_to_camera(cj, device=device) for cj in json.load(f)]

    os.makedirs(work_dir, exist_ok=True)
    xyz, colors, normals = P.extract_surface_points(pcd, renderer, cameras, work_dir=work_dir,
                                                    downsample=args.resolution)
    print(f"Point cloud cleaned. Remaining points: {len(xyz)}")
    store_ply(output_pcd_path, xyz, (colors * 255).astype(np.uint8), normals)

    mesh_path = None
    if args.meshing != "None":
        if args.meshing == "sap":
            verts, faces = P.mesh_sap(xyz, normals, device=device)
        elif args.meshing == "nksr":
            verts, faces = P.mesh_nksr(xyz, normals, device=device)
        elif args.meshing == "poisson":
            verts, faces = P.mesh_poisson(xyz, colors, normals)
        else:
            verts, faces = P.mesh_pymeshlab_poisson(output_pcd_path)
        mesh_path = os.path.join(work_dir, "fused_mesh.ply")
        save_mesh(mesh_path, verts, faces)
        print(f"Mesh saved to {mesh_path}")
    return output_pcd_path, mesh_path


if __name__ == "__main__":
    main()
