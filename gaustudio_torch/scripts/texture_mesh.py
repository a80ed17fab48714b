"""gs-texture-mesh: bake per-vertex colours onto a mesh from posed images
(port of gaustudio_tpu/scripts/texture_mesh.py).

    python -m gaustudio_torch.scripts.texture_mesh -m mesh.ply -o textured.ply \
        [-c cameras.json | -s <COLMAP dir>] [--device cuda|cpu]

With ``-c``, the images are ``images/<name>.png`` beside the cameras.json.
Each vertex takes the colour of the pixel it projects to (rounded half to
even) in every view where the z-buffer shows it (1.01x slack), weighted by
|cos| of the view angle; vertices no view covers get 0.5. Runs on
``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gaustudio_torch.scripts.render import _device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--camera", "-c", default=None)
    parser.add_argument("--mesh", "-m", required=True)
    parser.add_argument("--source-path", "-s", default=None)
    parser.add_argument("--output-path", "-o", required=True)
    args, _ = parser.parse_known_args(argv)

    from gaustudio_torch import datasets
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.ops.gaussian import transform_points
    from gaustudio_torch.ops.mesh_raster import face_normals, rasterize_mesh
    from gaustudio_torch.utils.mesh import load_mesh, save_mesh

    device = _device(args)
    verts_np, faces_np = load_mesh(args.mesh)
    verts = torch.from_numpy(verts_np).to(device)
    faces = torch.from_numpy(faces_np.astype(np.int64)).to(device)

    if args.camera and os.path.exists(args.camera):
        with open(args.camera) as f:
            cameras = [JSON_to_camera(cj, device=device) for cj in json.load(f)]
        image_dir = os.path.join(os.path.dirname(args.camera), "images")
        for cam in cameras:
            p = os.path.join(image_dir, f"{cam.image_name}.png")
            if os.path.exists(p):
                cam.load_image(p)
    else:
        cameras = datasets.make({"name": "colmap", "source_path": args.source_path}).all_cameras

    fn = face_normals(verts, faces)
    vnormals = torch.zeros_like(verts)
    for i in range(3):
        vnormals.index_add_(0, faces[:, i], fn)
    vnormals /= torch.clamp_min(torch.linalg.norm(vnormals, dim=1, keepdim=True), 1e-12)

    acc = torch.zeros((len(verts), 3), dtype=torch.float64, device=device)
    wsum = torch.zeros(len(verts), dtype=torch.float64, device=device)
    for cam in cameras:
        if cam.image is None:
            continue
        H, W = int(cam.image_height), int(cam.image_width)
        wv = cam.world_view_transform.to(device)
        proj = cam.full_proj_transform.to(device)
        depth = rasterize_mesh(verts, faces, wv, proj, W, H).depth
        hom = transform_points(verts, proj)
        ndc = hom[:, :3] / (hom[:, 3:4] + 1e-9)
        px = ((ndc[:, 0] + 1) * W - 1) / 2
        py = ((ndc[:, 1] + 1) * H - 1) / 2
        zv = transform_points(verts, wv)[:, 2]
        xi = torch.clamp(torch.round(px).long(), 0, W - 1)
        yi = torch.clamp(torch.round(py).long(), 0, H - 1)
        in_img = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (zv > 1e-3)
        visible = in_img & (zv <= depth[yi, xi] * 1.01 + 1e-3)

        view_dir = cam.camera_center.to(device)[None, :] - verts
        view_dir = view_dir / torch.clamp_min(torch.linalg.norm(view_dir, dim=1, keepdim=True),
                                              1e-12)
        w = torch.where(visible, torch.abs((view_dir * vnormals).sum(1)), 0.0)
        acc += (w[:, None] * cam.image.to(device)[yi, xi]).double()
        wsum += w.double()

    colors = torch.where(wsum[:, None] > 1e-6, acc / torch.clamp_min(wsum[:, None], 1e-6), 0.5)
    save_mesh(args.output_path, verts_np, faces_np,
              vertex_colors=colors.to(torch.float32).cpu().numpy())
    covered = float((wsum > 0).double().mean())
    print(f"Textured mesh saved to {args.output_path} ({covered * 100:.1f}% vertices covered)")
    return args.output_path, covered


if __name__ == "__main__":
    main()
