"""gs-init: pose and geometry initialization of a new capture (port of
gaustudio_tpu/scripts/initialize.py, same flags and defaults).

    python -m gaustudio_torch.scripts.initialize -s <capture> -o <workspace> \
        [--dataset colmap|nerfstudio|...] [--initializer depth|VisualHull|mesh|voxel|tsdf] \
        [--mesh_path mesh.ply] [-w] [--device cuda|cpu]

Runs on ``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is asked
for. The pose step is the JAX CLI's chain: ``hloc``, then ``colmap``, each
tried in turn and its error printed, ending in SystemExit("All pose
initializers failed"); with ``sparse/0/points3D.bin`` already in the
workspace, hloc builds from it without running SfM. The optional geometry
initializer then builds the cloud, and its errors propagate, as do the
card's errors in the pose step. Writes ``<workspace>/sparse/0/points3D.ply``
and ``<workspace>/cameras.json``; returns the PLY's path.
"""

from __future__ import annotations

import argparse
import os

import torch

from gaustudio_torch.scripts.render import _device

# errors of the card, which the pose chain does not swallow
DEVICE_ERRORS = (torch.OutOfMemoryError, torch.AcceleratorError)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="colmap")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--output_dir", "-o", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--initializer", default=None,
                        choices=[None, "depth", "VisualHull", "mesh", "voxel", "tsdf"],
                        help="optional geometry initializer")
    parser.add_argument("--mesh_path", default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--w_mask", "-w", action="store_true")
    parser.add_argument("--resolution", "-r", default=1, type=int)
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, extras = parser.parse_known_args(argv)

    from gaustudio_torch import datasets, models
    from gaustudio_torch.config import load_config
    from gaustudio_torch.pipelines import initializers
    from gaustudio_torch.utils.mesh import load_mesh

    device = _device(args)
    if not os.path.exists(args.source_path):
        raise FileNotFoundError(f"Source path not found: {args.source_path}")
    if args.initializer in ("mesh", "voxel") and not args.mesh_path:
        raise ValueError(f"{args.initializer} initializer requires --mesh_path")

    dataset = datasets.make({"name": args.dataset, "source_path": args.source_path,
                             "w_mask": args.w_mask, "camera_number": 1})
    if args.resolution > 1:
        dataset.downsample_scale(args.resolution)

    custom = load_config(args.config) if args.config else {}

    # pose initialization: hloc, then colmap
    pcd = models.make("general_pcd", device=device)
    final_pcd = None
    for name in ("hloc", "colmap"):
        cfg = {"name": name, "workspace_dir": args.output_dir}
        cfg.update(custom.get("pose_initializer", {}))
        try:
            final_pcd = initializers.make(cfg, device=device)(pcd, dataset,
                                                              overwrite=args.overwrite)
            print(f"Pose initialization completed using {name}")
            break
        except DEVICE_ERRORS:
            raise
        except Exception as e:
            print(f"Error with {name} pose initializer: {e}")
    if final_pcd is None:
        raise SystemExit("All pose initializers failed")

    # the optional geometry initializer
    if args.initializer:
        cfg = {"name": args.initializer, "workspace_dir": args.output_dir}
        cfg.update(custom.get("geometry_initializer", {}))
        init = initializers.make(cfg, device=device)
        if args.initializer in ("mesh", "voxel"):
            final_pcd = init(models.make("general_pcd", device=device),
                             mesh=load_mesh(args.mesh_path), dataset=dataset,
                             overwrite=args.overwrite)
        else:
            final_pcd = init(models.make("general_pcd", device=device), dataset,
                             overwrite=args.overwrite)

    out = os.path.join(args.output_dir, "sparse", "0", "points3D.ply")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    final_pcd.export(out)
    dataset.export(os.path.join(args.output_dir, "cameras.json"))
    print(f"Point cloud exported to: {out}")
    return out


if __name__ == "__main__":
    main()
