"""gs-extract-mesh pipeline: multi-view depth render -> TSDF -> mesh
(port of gaustudio_tpu/pipelines/mesh_extraction.py, single device).

Median-depth renders masked where the final opacity is below 0.5, fused into
a TSDF grid on the device, marching-tetrahedra extraction, an optional
connected-component cleanup, and the mvs-texturing output layout (images/,
masks/, per-view .cam files). Camera-parallel fusion over several devices
belongs to a later slice.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from gaustudio_torch.cameras import Camera
from gaustudio_torch.ops import mcubes, tsdf
from gaustudio_torch.utils import mesh as meshu
from gaustudio_torch.utils.image import BackgroundWriter, save_image
from gaustudio_torch.utils.misc import resolve_device


def write_cam_file(path: str, camera: Camera) -> None:
    """mvs-texturing .cam file: the world -> view translation and rotation,
    then the normalised focal length, pixel aspect and principal point. The
    numbers are float32 numpy scalars, formatted as the JAX package formats
    them."""
    K = camera.intrinsics.cpu().numpy()
    fx, fy = K[0, 0], K[1, 1]
    paspect = fy / fx
    width, height = camera.image_width, camera.image_height
    dim_aspect = width / height
    img_aspect = dim_aspect * paspect
    flen = fy / height if img_aspect < 1.0 else fx / width
    ppx = K[0, 2] / width
    ppy = K[1, 2] / height
    P = camera.extrinsics.cpu().numpy()
    s1 = " ".join(str(P[i][j]) for i in range(3) for j in range(3))
    s2 = " ".join(str(P[i][3]) for i in range(3))
    with open(path, "w") as f:
        f.write(f"{s2} {s1}\n")
        f.write(f"{flen} 0 0 {paspect} {ppx} {ppy}\n")


def _save_view_files(work_dir, name, camera, inv_np, rgb_np):
    """One view's files: the render (black where invalid), its mask and its
    .cam file. Runs on a writer thread, beside the next view's render."""
    rgb = np.where(inv_np[..., None], 0.0, rgb_np)
    save_image(os.path.join(work_dir, "images", f"{name}.png"), rgb)
    save_image(os.path.join(work_dir, "masks", f"{name}.png"), (~inv_np).astype(np.float32))
    write_cam_file(os.path.join(work_dir, "images", f"{name}.cam"), camera)


def iter_fused_depths(renderer, pcd, cameras: List[Camera], work_dir=None):
    """Yield each view's (camera, depth map on the render's device): the
    median depth, zeroed where the final opacity is below 0.5, and, with
    ``work_dir``, write the view's files on a BackgroundWriter."""
    if work_dir is not None:
        os.makedirs(os.path.join(work_dir, "images"), exist_ok=True)
        os.makedirs(os.path.join(work_dir, "masks"), exist_ok=True)
    with BackgroundWriter() as writer:
        for i, camera in enumerate(cameras):
            out = renderer.render(camera, pcd)
            invalid = out["rendered_final_opacity"][0] < 0.5
            depth = torch.where(invalid, 0.0, out["rendered_median_depth"][0])
            if work_dir is not None:
                writer.submit(_save_view_files, work_dir, camera.image_name or f"view_{i:04d}",
                              camera, invalid.cpu().numpy(),
                              out["render"].permute(1, 2, 0).cpu().numpy())
            yield camera, depth


def render_fused_depths(renderer, pcd, cameras: List[Camera], work_dir=None):
    """List-returning wrapper of iter_fused_depths."""
    return list(iter_fused_depths(renderer, pcd, cameras, work_dir))


def extract_mesh(
    pcd,
    renderer,
    cameras: List[Camera],
    work_dir: Optional[str] = None,
    voxel_size: float = 0.01,
    sdf_trunc: float = 0.04,
    min_weight: float = 5.0,
    stride: int = 3,
    downsample: int = 2,
    clean: bool = False,
    max_dim: int = 384,
    device=None,
):
    """gs-extract-mesh: every ``stride``-th camera, downsampled, renders its
    masked median depth, which is fused into a TSDF grid on ``device`` (None:
    the current CUDA device) sized from the Gaussians' robust bounds; then
    marching tetrahedra and, with ``clean``, the component cleanup.

    Returns (vertices, faces); writes fused_mesh.ply and the per-view files
    when ``work_dir`` is given.
    """
    device = resolve_device(device)
    cams = [c.downsample_scale(downsample) for c in cameras[::stride]]
    lo, hi = tsdf.integrate_points_bounds(pcd.get_attribute("xyz"))
    vol = tsdf.volume_from_bounds(lo, hi, voxel_size, sdf_trunc, max_dim=max_dim,
                                  device=device)
    # render and integrate view by view: one depth map on the device at a time
    for camera, depth in iter_fused_depths(renderer, pcd, cams, work_dir):
        tsdf.integrate(vol, depth, camera.intrinsics, camera.extrinsics)

    verts, faces = mcubes.marching_tetrahedra(
        vol.tsdf, iso=0.0, weight=vol.weight, min_weight=min_weight,
        origin=vol.origin.cpu().numpy(), voxel_size=float(vol.voxel_size), slab=4)
    if clean:
        verts, faces = meshu.clean_mesh_components(verts, faces, ratio_threshold=0.5)
    if work_dir is not None:
        meshu.save_mesh(os.path.join(work_dir, "fused_mesh.ply"), verts, faces)
    return verts, faces
