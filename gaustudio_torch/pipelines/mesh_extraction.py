"""gs-extract-mesh pipeline: multi-view depth render -> TSDF -> mesh
(port of gaustudio_tpu/pipelines/mesh_extraction.py).

Median-depth renders masked where the final opacity is below 0.5, fused into
a TSDF grid on the device, marching-tetrahedra extraction, an optional
connected-component cleanup, and the mvs-texturing output layout (images/,
masks/, per-view .cam files). In a process group of more than one rank
(torchrun) the views are rendered camera-parallel over the ranks
(``_fuse_views_dp``) and rank 0 marches and writes the mesh.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

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


def _fuse_views_dp(renderer, pcd, cameras: List[Camera], vol, work_dir, mesh):
    """Camera-parallel fusion over the ranks of ``mesh``'s dp axis: each rank
    renders its block of the views.

    The views are grouped by (W, H, FoVx, FoVy), one closure a group (the
    camera-parallel render swaps only the view, projection and camera
    centre). Without ``work_dir`` each group is one make_dp_fuse_fn call
    (the volumes summed over dp). With ``work_dir`` the views render dp at a
    time, every rank gathers the chunk's depths and integrates them in view
    order (as the JAX package's ``integrate_batch``), and each rank writes
    its own views' files under their global names."""
    from gaustudio_torch.parallel import render_dp
    from gaustudio_torch.parallel.mesh import Collectives

    comm = Collectives(mesh)
    groups = {}
    for gi, c in enumerate(cameras):
        key = (int(c.image_width), int(c.image_height), float(c.FoVx), float(c.FoVy))
        groups.setdefault(key, []).append((gi, c))
    if work_dir is not None:
        os.makedirs(os.path.join(work_dir, "images"), exist_ok=True)
        os.makedirs(os.path.join(work_dir, "masks"), exist_ok=True)

    device = vol.tsdf.device
    for indexed in groups.values():
        group = [c for _, c in indexed]
        settings, render_fn = renderer.dp_render_closure(group, pcd)
        if work_dir is None:
            fuse = render_dp.make_dp_fuse_fn(comm, settings, render_fn)
            vol = fuse(vol, render_dp.stack_cameras(group, pad_to=comm.dp, device=device))
            continue
        render = render_dp.make_dp_render_fn(comm, settings, render_fn)
        with BackgroundWriter() as writer:
            for start in range(0, len(indexed), comm.dp):
                chunk = indexed[start:start + comm.dp]
                rc = render_dp.stack_cameras([c for _, c in chunk], pad_to=comm.dp,
                                             device=device)
                out = render(rc)  # this rank's view of the chunk
                invalid = out["rendered_final_opacity"][:, 0] < 0.5
                depth = torch.where(invalid, 0.0, out["rendered_median_depth"][:, 0])
                depths = comm.gather_dp(depth) * rc.valid[:, None, None]
                tsdf.integrate_batch(vol, depths, rc.intrinsics, rc.world_to_cam)
                if comm.dp_rank < len(chunk):  # a pad view writes nothing
                    gi, camera = chunk[comm.dp_rank]
                    writer.submit(_save_view_files, work_dir, camera.image_name or f"view_{gi:04d}",
                                  camera, invalid[0].cpu().numpy(),
                                  out["render"][0].permute(1, 2, 0).cpu().numpy())
    return vol


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

    In a process group of more than one rank, a renderer that does not
    decode its Gaussians per camera fuses camera-parallel
    (``_fuse_views_dp``), and only rank 0 marches: the other ranks return
    None.

    Returns (vertices, faces); writes fused_mesh.ply and the per-view files
    when ``work_dir`` is given.
    """
    device = resolve_device(device)
    cams = [c.downsample_scale(downsample) for c in cameras[::stride]]
    lo, hi = tsdf.integrate_points_bounds(pcd.get_attribute("xyz"))
    vol = tsdf.volume_from_bounds(lo, hi, voxel_size, sdf_trunc, max_dim=max_dim,
                                  device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1 and not renderer.view_dependent_gaussians:
        from gaustudio_torch.parallel import make_mesh

        vol = _fuse_views_dp(renderer, pcd, cams, vol, work_dir,
                             make_mesh(dp=world, gs=1, device=device))
        if dist.get_rank() != 0:
            return None
    else:
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
