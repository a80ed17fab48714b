"""Generate the mini_scene golden fixture on the port (counterpart of the
JAX package's ``tools/make_fixture.py``).

Builds a deterministic textured mesh scene (icosphere + cube), renders a
multi-view capture with the port's mesh rasterizer, fits Gaussians to it
with the port's Trainer, extracts a mesh, and writes what a ``vanilla``
dataset needs (images/, cameras.json, sparse points, the Gaussian PLY, the
GT mesh) and GOLDEN.json (per-view PSNR, mesh F1 against the GT mesh) into
``--out``.

    python -m gaustudio_torch.tools.make_fixture [--out DIR] [--device cpu]

The committed fixture, ``tests/fixtures/mini_scene``, is the JAX tool's
output; this tool writes under ``gaustudio_torch/build/mini_scene`` unless
told otherwise, and ``chip_smoke.py`` holds its output to the committed
one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gaustudio_torch.tools import build_path
from gaustudio_torch.utils.misc import resolve_device

# extraction params shared with tests/test_golden_e2e.py (the stored F1
# golden is measured with them)
EXTRACT_KW = dict(voxel_size=0.035, sdf_trunc=0.14, min_weight=2.0,
                  stride=1, downsample=1, max_dim=96)
F1_TAU = 0.05
LIGHT = np.array([0.4, 0.5, 0.76], np.float32) / np.linalg.norm(
    np.array([0.4, 0.5, 0.76], np.float32))


def icosphere(subdiv: int = 3, radius: float = 1.0):
    t = (1 + 5 ** 0.5) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                cache[key] = len(vlist)
                vlist.append((verts[i] + verts[j]) / 2)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, np.int64)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts.astype(np.float32), faces.astype(np.int32)


def box(center, half):
    c, h = np.asarray(center, np.float32), np.asarray(half, np.float32)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32)
    verts = c + corners * h
    quads = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
             [0, 2, 6, 4], [1, 5, 7, 3]]
    faces = []
    for q in quads:
        faces += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
    return verts, np.array(faces, np.int32)


def scene_mesh():
    sv, sf = icosphere(3, radius=0.8)
    # low-frequency radial bumps so the silhouette isn't a perfect sphere
    r = 1.0 + 0.12 * np.sin(3.1 * sv[:, 0]) * np.cos(2.7 * sv[:, 1])
    sv = sv * r[:, None]
    bv, bf = box([0.85, -0.35, 0.15], [0.3, 0.3, 0.3])
    verts = np.concatenate([sv, bv])
    faces = np.concatenate([sf, bf + len(sv)])
    return verts, faces


def color_fn(p):
    """Procedural vertex colors: smooth bands + a checker accent."""
    p = np.asarray(p, np.float32)
    c = 0.5 + 0.45 * np.stack([
        np.sin(4.0 * p[:, 0]) * np.cos(3.0 * p[:, 1]),
        np.sin(5.0 * p[:, 1] + 1.3),
        np.cos(4.0 * p[:, 2] + 0.7),
    ], axis=1)
    checker = ((np.floor(p[:, 0] * 4) + np.floor(p[:, 1] * 4)
                + np.floor(p[:, 2] * 4)) % 2).astype(np.float32)
    return np.clip(c * (0.7 + 0.3 * checker[:, None]), 0.03, 0.97)


def mesh_shading(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Lambert shade of each face under the tools' fixed light, [F]."""
    from gaustudio_torch.ops import mesh_raster as MR

    light = torch.from_numpy(LIGHT).to(verts.device)
    return 0.35 + 0.65 * torch.abs(MR.face_normals(verts, faces) @ light)


def render_mesh_views(verts, faces, cams, device=None):
    """GT renders through the port's z-buffer mesh rasterizer and a Lambert
    shade, quantised like the stored PNGs; float32 numpy [H, W, 3] each."""
    from gaustudio_torch.ops import mesh_raster as MR

    device = resolve_device(device)
    v = torch.from_numpy(np.asarray(verts, np.float32)).to(device)
    f = torch.from_numpy(np.asarray(faces, np.int64)).to(device)
    vcol = torch.from_numpy(color_fn(verts)).to(device)
    lam = mesh_shading(v, f)
    images = []
    for cam in cams:
        frag = MR.rasterize_mesh(v, f, cam.world_view_transform, cam.full_proj_transform,
                                 int(cam.image_width), int(cam.image_height))
        col = MR.interpolate_attribute(frag, f, vcol)
        shade = torch.where(frag.mask, lam[torch.clamp_min(frag.tri_id, 0)], 0.0)
        img = torch.clamp(col * shade[..., None], 0, 1).cpu().numpy()
        # quantize exactly like the stored PNG so goldens match the loader
        img = np.round(img * 255.0) / 255.0
        images.append(img.astype(np.float32))
    return images


class CaptureList(list):
    """A list of cameras standing in for a dataset: the Trainer reads its
    ``cameras_extent``."""

    def __init__(self, cameras, cameras_extent: float):
        super().__init__(cameras)
        self.cameras_extent = cameras_extent


def set_images(cams, images) -> None:
    """Attach float32 [H, W, 3] images to the cameras, on each camera's device."""
    for cam, img in zip(cams, images):
        cam.image = torch.as_tensor(img, dtype=torch.float32).to(cam.device)


def fit_gaussians(verts, faces, cams, images, n_points, iters, device=None):
    """Surface-sampled init refined by the port's Trainer (no densify)."""
    from gaustudio_torch import models
    from gaustudio_torch.models.utils import inverse_sigmoid
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.utils.mesh import sample_mesh_surface

    device = resolve_device(device)
    xyz = sample_mesh_surface(verts, faces, n_points, seed=3)
    pcd = models.make({"name": "vanilla_pcd"}, device=device)
    pcd.create_from_attribute(
        xyz=xyz, rgb=color_fn(xyz),
        opacity=inverse_sigmoid(np.full((n_points, 1), 0.9, np.float32)),
    )
    pcd.active_sh_degree = 0
    if iters <= 0:
        return pcd
    set_images(cams, images)
    cfg = T.TrainConfig(
        iterations=iters, densify_from_iter=10 ** 9,
        opacity_reset_interval=10 ** 9, sh_increase_interval=10 ** 9,
        lr_xyz_init=0.0008, lr_xyz_final=0.00008, lr_xyz_max_steps=iters,
    )
    trainer = T.Trainer(pcd, CaptureList(cams, 2.0), cfg, device=device)
    trainer.train(iterations=iters, log_every=max(iters // 4, 1),
                  callback=lambda m: print(
                      f"  fit iter {m['iter']} loss {m['loss']:.4f} "
                      f"psnr {m['psnr']:.2f}", flush=True))
    T.state_to_model(trainer.state, pcd)
    return pcd


def eval_psnr(pcd, cams, images, device=None):
    """PSNR of the vanilla renderer's image of each camera against ``images``."""
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import ssim as ssim_ops

    device = resolve_device(device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    vals = []
    for cam, img in zip(cams, images):
        out = renderer.render(cam, pcd)
        gt = torch.as_tensor(img, dtype=torch.float32).to(device).permute(2, 0, 1)
        vals.append(float(ssim_ops.psnr(out["render"], gt)))
    return vals


def fixture_cameras(views: int, size: int, device=None):
    """Two orbit rings (-30 and +28 degrees): top and bottom coverage for
    mesh recall; images named 00000.png, ..."""
    from gaustudio_torch.cameras import camera_paths

    half = views // 2
    cams = camera_paths.get_path_from_orbit(
        np.zeros(3), 3.0, elevation=-30, num_cam=half,
        image_size=size, fov_deg=50, device=device)
    cams += camera_paths.get_path_from_orbit(
        np.zeros(3), 3.0, elevation=28, num_cam=views - half,
        image_size=size, fov_deg=50, device=device)
    for i, cam in enumerate(cams):
        cam.image_name = f"{i:05d}.png"
    return cams


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--points", type=int, default=8000)
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--out", default=build_path("mini_scene"))
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the current CUDA device")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Write the fixture into ``args.out``; returns GOLDEN.json's dict."""
    from gaustudio_torch import renderers
    from gaustudio_torch.datasets.utils import camera_to_JSON
    from gaustudio_torch.pipelines import mesh_extraction as ME
    from gaustudio_torch.utils.image import save_rgb8
    from gaustudio_torch.utils.mesh import mesh_f1_score, sample_mesh_surface, save_mesh
    from gaustudio_torch.utils.ply import store_ply

    device = resolve_device(args.device)
    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)

    verts, faces = scene_mesh()
    cams = fixture_cameras(args.views, args.size, device)

    print("rendering GT views...", flush=True)
    images = render_mesh_views(verts, faces, cams, device)
    for cam, img in zip(cams, images):
        save_rgb8(os.path.join(args.out, "images", cam.image_name),
                  (img * 255).astype(np.uint8))
    with open(os.path.join(args.out, "cameras.json"), "w") as f:
        json.dump([camera_to_JSON(i, c) for i, c in enumerate(cams)], f)

    save_mesh(os.path.join(args.out, "gt_mesh.ply"), verts, faces,
              vertex_colors=color_fn(verts))
    sparse = sample_mesh_surface(verts, faces, 4000, seed=11)
    store_ply(os.path.join(args.out, "sparse_points.ply"), sparse,
              (color_fn(sparse) * 255).astype(np.uint8))

    print(f"fitting {args.points} gaussians ({args.iters} iters)...", flush=True)
    pcd = fit_gaussians(verts, faces, cams, images, args.points, args.iters, device)
    pcd.export(os.path.join(args.out, "gaussians.ply"))

    psnrs = eval_psnr(pcd, cams, images, device)
    print("per-view PSNR:", [round(p, 2) for p in psnrs], flush=True)

    print("extracting mesh...", flush=True)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    mverts, mfaces = ME.extract_mesh(pcd, renderer, cams, device=device, **EXTRACT_KW)
    save_mesh(os.path.join(args.out, "extracted_mesh.ply"), mverts, mfaces)
    f1 = mesh_f1_score(mverts, mfaces, verts, faces, F1_TAU)
    print("mesh F1:", f1, flush=True)

    golden = {
        "views": args.views, "size": args.size, "points": args.points,
        "fit_iters": args.iters,
        "psnr_per_view": [round(p, 3) for p in psnrs],
        "psnr_mean": round(float(np.mean(psnrs)), 3),
        "mesh_f1": round(f1["f1"], 4),
        "mesh_precision": round(f1["precision"], 4),
        "mesh_recall": round(f1["recall"], 4),
        "mesh_chamfer": round(f1["chamfer"], 5),
        "extract_kw": EXTRACT_KW, "f1_tau": F1_TAU,
    }
    with open(os.path.join(args.out, "GOLDEN.json"), "w") as f:
        json.dump(golden, f, indent=1)
    print(json.dumps(golden), flush=True)
    return golden


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
