"""gs-render-mesh: colour, depth and normal maps of a triangle mesh from a
set of cameras (port of gaustudio_tpu/scripts/render_mesh.py).

    python -m gaustudio_torch.scripts.render_mesh -m mesh.ply -o out \
        [-c cameras.json | -s <COLMAP dir>] [--color] [--device cuda|cpu]

Rasterizes on ``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is
asked for. Writes ``normal/<name>.png`` (face normals flipped to n_z <= 0,
mapped to [0, 1]), ``depth/<name>.png`` (viridis, empty pixels at the far
end), ``color/<name>.cam`` and, with ``--color`` and vertex colours,
``color/<name>.png``. The files are written on two threads beside the next
view's rasterization.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gaustudio_torch.scripts.render import _device


def view_images(frag, fnormals, faces, vcolors=None) -> dict:
    """A view's host images from its fragments: the normal map [H, W, 3] in
    [0, 1], the depth [H, W] with empty pixels at the largest depth (1
    without any), and, given ``vcolors``, the interpolated colours."""
    from gaustudio_torch.ops.mesh_raster import interpolate_attribute

    n = fnormals[torch.clamp_min(frag.tri_id, 0)]
    n = torch.where(n[..., 2:3] > 0, -n, n)  # the JAX package's flip toward the camera
    images = {"normal": torch.where(frag.mask[..., None], (n + 1) / 2, 0.0).cpu().numpy()}
    depth, mask = frag.depth.cpu().numpy(), frag.mask.cpu().numpy()
    images["depth"] = np.where(mask, depth, depth[mask].max() if mask.any() else 1.0)
    if vcolors is not None:
        images["color"] = interpolate_attribute(frag, faces, vcolors).cpu().numpy()
    return images


def save_view(out_dir: str, name: str, camera, images: dict) -> None:
    """A view's PNGs and its .cam file."""
    from gaustudio_torch.pipelines.mesh_extraction import write_cam_file
    from gaustudio_torch.utils.depth import apply_depth_colormap
    from gaustudio_torch.utils.image import save_image

    save_image(os.path.join(out_dir, "normal", f"{name}.png"), images["normal"])
    save_image(os.path.join(out_dir, "depth", f"{name}.png"), apply_depth_colormap(images["depth"]))
    if "color" in images:
        save_image(os.path.join(out_dir, "color", f"{name}.png"), images["color"])
    write_cam_file(os.path.join(out_dir, "color", f"{name}.cam"), camera)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--camera", "-c", default=None, help="path to cameras.json")
    parser.add_argument("--mesh", "-m", required=True)
    parser.add_argument("--source_path", "-s", default=None)
    parser.add_argument("--output-dir", "-o", required=True)
    parser.add_argument("--color", action="store_true", help="render vertex colors")
    args, _ = parser.parse_known_args(argv)

    from gaustudio_torch import datasets
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.ops.mesh_raster import face_normals, rasterize_mesh
    from gaustudio_torch.utils.image import BackgroundWriter
    from gaustudio_torch.utils.ply import read_ply

    device = _device(args)
    data = read_ply(args.mesh)
    v = data["vertex"]
    verts = torch.from_numpy(np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)).to(device)
    faces = torch.from_numpy(np.asarray(data["face"]["vertex_indices"], np.int64)).to(device)
    vcolors = None
    if args.color and "red" in v:
        vc = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
        vcolors = torch.from_numpy(vc / 255.0 if vc.max() > 1 else vc).to(device)

    if args.camera and os.path.exists(args.camera):
        with open(args.camera) as f:
            cameras = [JSON_to_camera(cj, device=device) for cj in json.load(f)]
    else:
        cameras = datasets.make({"name": "colmap", "source_path": args.source_path}).all_cameras

    for sub in ("color", "depth", "normal"):
        os.makedirs(os.path.join(args.output_dir, sub), exist_ok=True)
    fnormals = face_normals(verts, faces)
    with BackgroundWriter() as writer:
        for i, cam in enumerate(cameras):
            frag = rasterize_mesh(verts, faces, cam.world_view_transform, cam.full_proj_transform,
                                  int(cam.image_width), int(cam.image_height))
            writer.submit(save_view, args.output_dir, cam.image_name or f"view_{i:04d}", cam,
                          view_images(frag, fnormals, faces, vcolors))
    print(f"Rendered {len(cameras)} mesh views to {args.output_dir}")
    return args.output_dir


if __name__ == "__main__":
    main()
