"""gs-extract-pcd pipeline: surface points, fused normals and meshing
(port of gaustudio_tpu/pipelines/pcd_extraction.py, single device).

Each view is rendered, its expected depth filtered by a masked bilateral
filter and turned into normals, and its median Gaussian ids kept where the
median depth is inside 0.8 x the scene radius and the final opacity above
0.5: all on the render's device. The normals of each surface Gaussian are
fused over the views with view-angle and distance weights, re-voted for
consistency (float64 sums on the device) and smoothed over their k nearest
neighbours, and the cloud is cleaned of outliers (scipy on the host, as in
the JAX package). ``mesh_sap`` meshes it with DPSR; ``mesh_nksr``,
``mesh_poisson`` and ``mesh_pymeshlab_poisson`` need packages the port does
not ship and raise ImportError without them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gaustudio_torch.cameras import Camera
from gaustudio_torch.datasets.utils import getNerfppNorm
from gaustudio_torch.ops.sh import SH2RGB
from gaustudio_torch.pipelines.mesh_extraction import write_cam_file
from gaustudio_torch.utils.image import BackgroundWriter, save_image


def masked_bilateral_filter(depth: torch.Tensor, mask: torch.Tensor, d: int = 3,
                            sigma_color: float = 75, sigma_space: float = 75):
    """Bilateral filter of ``depth`` [H, W] on the valid pixels of ``mask``,
    which is first eroded by a d x d square; returns (filtered depth, eroded
    mask).

    This computes what the JAX package gets from OpenCV: ``cv2.dilate`` of the
    invalid map (a border that erodes nothing) and ``cv2.bilateralFilter``
    of the depth normalised over the valid pixels, with a circular window of
    radius d // 2, BORDER_REFLECT_101, space weight exp(-r^2 / (2 sigma_space^2))
    and colour weight exp(-delta^2 / (2 sigma_color^2)) (OpenCV reads the
    latter from a 4096-bin table)."""
    depth = depth.to(torch.float32)
    radius = d // 2
    invalid = (~mask.bool()).to(torch.float32)[None, None]
    # max_pool2d pads with -inf: the image edge erodes nothing
    new_mask = F.max_pool2d(invalid, d, stride=1, padding=radius)[0, 0] == 0
    valid = new_mask & torch.isfinite(depth)
    # min and max over the valid pixels; with none, ``valid`` keeps the input
    vmin = torch.where(valid, depth, torch.inf).amin()
    vmax = torch.where(valid, depth, -torch.inf).amax()
    normalized = torch.where(valid, (depth - vmin) / torch.clamp_min(vmax - vmin, 1e-9), 0.0)

    H, W = depth.shape
    padded = F.pad(normalized[None, None], (radius,) * 4, mode="reflect")[0, 0]
    space_coeff = -0.5 / (sigma_space * sigma_space)
    color_coeff = -0.5 / (sigma_color * sigma_color)
    acc = torch.zeros_like(normalized)
    wsum = torch.zeros_like(normalized)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r2 = i * i + j * j
            if r2 > radius * radius:
                continue
            val = padded[radius + i:radius + i + H, radius + j:radius + j + W]
            diff = val - normalized
            w = float(np.float32(np.exp(r2 * space_coeff))) * torch.exp(diff * diff * color_coeff)
            acc += val * w
            wsum += w
    out = acc / wsum * (vmax - vmin) + vmin
    return torch.where(valid, out, depth), new_mask


def surface_samples(out: dict, camera: Camera, scene_radius: float) -> dict:
    """One view's surface samples from its render, on the render's device:
    ``valid`` [H, W] (median depth below 0.8 x ``scene_radius``, final
    opacity above 0.5), ``fg`` (opacity above 0.1, eroded by the filter),
    the camera-space ``cam_normals`` of the filtered depth (-1 off ``fg``),
    and the valid pixels' median Gaussian ``ids``, outward world ``normals``
    and confidences ``conf``.

    The validity test keeps the JAX package's order: the -1 marker is set on
    camera-space normals, which are then rotated to world space, before the
    ``sum > -3`` test; off the axes of the world the rotated marker passes
    it, so the test drops almost nothing."""
    opacity = out["rendered_final_opacity"][0]
    filtered, fg = masked_bilateral_filter(out["rendered_depth"][0], opacity > 0.1)
    cam_normals = torch.where(fg[..., None], camera.depth2normal(filtered, coordinate="camera"),
                              -1.0)
    normals = camera.normal2worldnormal(cam_normals)
    valid = (out["rendered_median_depth"][0] < scene_radius * 0.8) & (opacity > 0.5)
    valid &= normals.sum(-1) > -3
    return {"valid": valid, "fg": fg, "cam_normals": cam_normals,
            "ids": out["rendered_median_id"][0][valid].long(), "normals": -normals[valid],
            "conf": opacity[valid]}


def _view_weights(xyz, normals, confidences, cam_t):
    """Per-sample fusion weight: confidence x |cos(view, normal)| / distance."""
    view_dir = cam_t[None, :] - xyz
    dist = torch.linalg.norm(view_dir, dim=1)
    view_dir = view_dir / torch.clamp_min(dist[:, None], 1e-9)
    view_w = torch.abs(torch.sum(view_dir * normals, dim=1))
    return confidences * view_w / (dist + 1e-6)


def vote_normals(xyz_all: torch.Tensor, all_ids: List[torch.Tensor],
                 all_normals: List[torch.Tensor], all_confidences: List[torch.Tensor],
                 cameras: List[Camera], consistency_threshold: float = 0.8):
    """Weighted normal vote per unique Gaussian id, then a re-vote of the
    samples within ``consistency_threshold`` of the first mean; float64
    sums on the device. Returns (sorted unique ids, unit mean normals
    float64), both on the device."""
    cat_ids = torch.cat(all_ids)
    unique_ids, inverse = torch.unique(cat_ids, sorted=True, return_inverse=True)
    n_unique = len(unique_ids)
    device = cat_ids.device

    def accumulate(mean_normals=None):
        sum_n = torch.zeros((n_unique, 3), dtype=torch.float64, device=device)
        sum_w = torch.zeros(n_unique, dtype=torch.float64, device=device)
        start = 0
        for ids, normals, conf, cam in zip(all_ids, all_normals, all_confidences, cameras):
            inv = inverse[start:start + len(ids)]
            start += len(ids)
            w = _view_weights(xyz_all[ids], normals, conf, cam.extrinsics[:3, 3].to(device))
            if mean_normals is not None:
                keep = torch.linalg.norm(normals.double() - mean_normals[inv], dim=1) \
                    < consistency_threshold
                w = torch.where(keep, w, 0.0)
            sum_n.index_add_(0, inv, (normals * w[:, None]).double())
            sum_w.index_add_(0, inv, w.double())
        mean = sum_n / torch.clamp_min(sum_w[:, None], 1e-12)
        return mean / torch.clamp_min(torch.linalg.norm(mean, dim=1, keepdim=True), 1e-12)

    return unique_ids, accumulate(accumulate())


def smooth_normals(surf_xyz: np.ndarray, mean_normals: np.ndarray, knn: int = 10) -> np.ndarray:
    """Smooth each normal over its ``knn`` nearest neighbours with weights
    exp(-distance / 0.1) (scipy's cKDTree on the host); float32."""
    from scipy.spatial import cKDTree

    dists, nbrs = cKDTree(surf_xyz).query(surf_xyz, k=min(knn, len(surf_xyz)), workers=-1)
    w = np.exp(-dists / 0.1)
    smoothed = np.einsum("nk,nkc->nc", w, mean_normals[nbrs])
    smoothed /= np.maximum(np.linalg.norm(smoothed, axis=1, keepdims=True), 1e-12)
    return smoothed.astype(np.float32)


def normal_fusion(pcd, all_ids, all_normals, all_confidences, cameras: List[Camera],
                  consistency_threshold: float = 0.8, knn: int = 10):
    """Fused normals of the surface Gaussians: (unique ids int64, unit
    normals float32 [n, 3]) on the host."""
    xyz_all = pcd._xyz
    unique_ids, mean_normals = vote_normals(xyz_all, all_ids, all_normals, all_confidences,
                                            cameras, consistency_threshold)
    surf_xyz = xyz_all[unique_ids].cpu().numpy()
    return unique_ids.cpu().numpy(), smooth_normals(surf_xyz, mean_normals.cpu().numpy(), knn)


def clean_point_cloud(xyz, colors, normals, nb_neighbors: int = 50, std_ratio: float = 2.0,
                      angle_threshold: float = np.pi / 4, normal_nb: int = 20):
    """Host outlier removal (scipy): points whose mean distance to their
    ``nb_neighbors`` neighbours exceeds the mean by ``std_ratio`` deviations,
    then points whose normal's mean angle to its ``normal_nb`` neighbours'
    is ``angle_threshold`` or more."""
    from scipy.spatial import cKDTree

    xyz = np.asarray(xyz)
    k = min(nb_neighbors + 1, len(xyz))
    dists, _ = cKDTree(xyz).query(xyz, k=k, workers=-1)
    mean_d = dists[:, 1:].mean(axis=1)
    thr = mean_d.mean() + std_ratio * mean_d.std()
    keep = mean_d <= thr
    xyz, colors, normals = xyz[keep], colors[keep], normals[keep]

    if len(xyz):
        k2 = min(normal_nb + 1, len(xyz))
        _, nbrs = cKDTree(xyz).query(xyz, k=k2, workers=-1)
        nn = normals[nbrs[:, 1:]]
        cosang = np.clip(np.abs(np.einsum("nkc,nc->nk", nn, normals)), -1, 1)
        keep2 = np.arccos(cosang).mean(axis=1) < angle_threshold
        xyz, colors, normals = xyz[keep2], colors[keep2], normals[keep2]
    return xyz, colors, normals


def _save_view_files(work_dir, name, camera, rgb, cam_normals, fg):
    """One view's files: the render, its camera normals, its mask and its
    .cam file. Runs on a writer thread, beside the next view's render."""
    save_image(os.path.join(work_dir, "images", f"{name}.png"), rgb)
    save_image(os.path.join(work_dir, "normals", f"{name}.png"), (cam_normals + 1) / 2)
    save_image(os.path.join(work_dir, "masks", f"{name}.png"), fg.astype(np.float32))
    write_cam_file(os.path.join(work_dir, "images", f"{name}.cam"), camera)


def surface_colors(pcd, ids) -> np.ndarray:
    """RGB in [0, 1] of the Gaussians ``ids``, from their SH band 0."""
    f_dc = pcd._f_dc.reshape(pcd._xyz.shape[0], -1)[:, :3]
    ids = torch.as_tensor(ids, device=f_dc.device)
    return torch.clamp(SH2RGB(f_dc[ids]), 0, 1).cpu().numpy()


def extract_surface_points(pcd, renderer, cameras: List[Camera], work_dir: Optional[str] = None,
                           downsample: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """gs-extract-pcd's points: every camera, downsampled by ``downsample``,
    renders on the model's device; returns the cleaned (xyz, rgb, normal) of
    the surface Gaussians on the host. With ``work_dir``, writes images/,
    normals/, masks/ and the .cam files on two writer threads."""
    if work_dir is not None:
        for sub in ("images", "normals", "masks"):
            os.makedirs(os.path.join(work_dir, sub), exist_ok=True)
    cams = [c.downsample_scale(downsample) for c in cameras] if downsample > 1 else cameras
    scene_radius = getNerfppNorm(cams)["radius"]

    all_ids, all_normals, all_conf = [], [], []
    with BackgroundWriter() as writer:
        for i, camera in enumerate(cams):
            out = renderer.render(camera, pcd)
            s = surface_samples(out, camera, scene_radius)
            all_ids.append(s["ids"])
            all_normals.append(s["normals"])
            all_conf.append(s["conf"])
            if work_dir is not None:
                writer.submit(_save_view_files, work_dir, camera.image_name or f"view_{i:04d}",
                              camera, out["render"].permute(1, 2, 0).cpu().numpy(),
                              s["cam_normals"].cpu().numpy(), s["fg"].cpu().numpy())

    unique_ids, fused_normals = normal_fusion(pcd, all_ids, all_normals, all_conf, cams)
    surface_xyz = pcd._xyz[torch.as_tensor(unique_ids, device=pcd._xyz.device)].cpu().numpy()
    return clean_point_cloud(surface_xyz, surface_colors(pcd, unique_ids), fused_normals)


def mesh_sap(xyz, normals, grid_res: int = 128, sigma: float = 2.0, device=None):
    """DPSR meshing (Shape-As-Points) on ``device`` (None: the current CUDA
    device): (vertices [V, 3], faces [F, 3]) on the host."""
    from gaustudio_torch.models.sap import ShapeAsPoints

    sap = ShapeAsPoints.from_pointcloud(xyz, normals, {"grid_res": grid_res, "psr_sigma": sigma},
                                        device=device)
    return sap.generate_mesh()


def mesh_nksr(xyz, normals, voxel_size: float = 0.008, detail_level: int = 0, device=None):
    """Meshing through the external ``nksr`` package; (vertices, faces)."""
    try:
        from nksr import Reconstructor
    except ImportError as e:
        raise ImportError("Please install nksr to use this feature.") from e
    from gaustudio_torch.utils.misc import resolve_device

    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(xyz), dtype=torch.float32, device=device)
    nrm = torch.as_tensor(np.asarray(normals), dtype=torch.float32, device=device)
    field = Reconstructor(device).reconstruct(pts, nrm, voxel_size=voxel_size,
                                              detail_level=detail_level)
    mesh = field.extract_dual_mesh(mise_iter=2)
    return mesh.v.cpu().numpy(), mesh.f.cpu().numpy()


def mesh_pymeshlab_poisson(pcd_path: str, depth: int = 8):
    """Screened Poisson meshing of the fused PLY through the external
    ``pymeshlab`` package; (vertices, faces)."""
    try:
        import pymeshlab
    except ImportError as e:
        raise ImportError("Please install pymeshlab to use this feature.") from e
    ms = pymeshlab.MeshSet()
    ms.load_new_mesh(pcd_path)
    ms.apply_filter("generate_surface_reconstruction_screened_poisson", depth=depth)
    mesh = ms.current_mesh()
    return mesh.vertex_matrix(), mesh.face_matrix()


def mesh_poisson(xyz, colors, normals, depth: int = 8, density_threshold: float = 0.01):
    """Poisson meshing through the external ``open3d`` package, with its
    lowest-density vertices pruned; (vertices, faces)."""
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError("Please install open3d to use this feature.") from e
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(xyz, np.float64))
    pcd.colors = o3d.utility.Vector3dVector(np.asarray(colors, np.float64))
    pcd.normals = o3d.utility.Vector3dVector(np.asarray(normals, np.float64))
    mesh, densities = o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(
        pcd, depth=depth, width=0, scale=1.2, linear_fit=False)
    densities = np.asarray(densities)
    densities = (densities - densities.min()) / (densities.max() - densities.min() + 1e-12)
    mesh.remove_vertices_by_mask(densities < np.quantile(densities, density_threshold))
    return np.asarray(mesh.vertices), np.asarray(mesh.triangles)
