"""Scenes, cameras and ground-truth images of a benchmark run, made from the
run's seed alone.

Everything here is plain torch on the device it is given: the program under
test receives the raw attributes, the camera dicts and the images, and the
plain reference (``gsbench/reference``) receives the same. Nothing is read
from disk.

The vanilla scene follows the shape of a Mip-NeRF 360 model: a dense central
object, a ground disk around it and a far shell that fills every view's
background, so a 360-degree ring of inward-facing cameras sees a lit,
multi-layer image in every direction (``bench.py``'s lit > 0.9 guard). The
surfel scene is a DTU-like object: surfels tangent to a few blobs on a table
top inside the unit sphere, with opacities that a fitted surface has, seen
from arcs of cameras on the upper hemisphere.

Random draws come from one ``torch.Generator`` on the device, in a fixed
order and in a few large calls; the seed changes the values drawn, never
the number of Gaussians, views or pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_REST = 45  # SH degree 3: 15 coefficients a channel after the DC term
C0 = 0.28209479177387814  # the DC term's SH constant


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any integer up to 2**63) and a
    stream number, so that scene, cameras and images draw independently."""
    mixed = (int(seed) * 1_000_003 + 7919 * stream) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def _quats(n, gen, device):
    q = torch.randn((n, 4), generator=gen, device=device)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _quat_from_normal(nrm):
    """Quaternions (w, x, y, z) that turn the z axis onto the unit ``nrm``."""
    z = torch.zeros_like(nrm)
    z[:, 2] = 1.0
    axis = torch.cross(z, nrm, dim=-1)
    w = 1.0 + nrm[:, 2]
    q = torch.cat([w[:, None], axis], dim=-1)
    flip = w < 1e-6  # a normal along -z: half a turn about x
    q[flip] = torch.tensor([0.0, 1.0, 0.0, 0.0], device=nrm.device)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _logit(p):
    return torch.log(p / (1.0 - p))


def vanilla_scene(cfg: dict, seed: int, device) -> dict:
    """Raw attributes (the trainer's layout: xyz, f_dc, f_rest, opacity as a
    logit, scale as a log, rot) of ``cfg["gaussians"]`` 3D Gaussians."""
    n = int(cfg["gaussians"])
    s = cfg["scene"]
    gen = generator(seed, device, 1)
    n_obj = int(n * s["object_share"])
    n_ground = int(n * s["ground_share"])
    n_far = n - n_obj - n_ground
    f32 = dict(device=device, dtype=torch.float32)
    u = torch.rand((n, 3), generator=gen, **f32)
    xyz = torch.empty((n, 3), **f32)
    # object: uniform in a ball
    d = torch.randn((n_obj, 3), generator=gen, **f32)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    xyz[:n_obj] = d * (s["object_radius"] * u[:n_obj, :1] ** (1.0 / 3.0))
    # ground: a disk under the object (y points down in these cameras' world)
    r = s["ground_radius"] * torch.sqrt(u[n_obj:n_obj + n_ground, 0])
    ang = 2.0 * math.pi * u[n_obj:n_obj + n_ground, 1]
    xyz[n_obj:n_obj + n_ground, 0] = r * torch.cos(ang)
    xyz[n_obj:n_obj + n_ground, 2] = r * torch.sin(ang)
    xyz[n_obj:n_obj + n_ground, 1] = s["ground_y"] + 0.02 * (u[n_obj:n_obj + n_ground, 2] - 0.5)
    # far shell: a sphere about the rig
    d = torch.randn((n_far, 3), generator=gen, **f32)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    lo, hi = s["far_radius"]
    xyz[n_obj + n_ground:] = d * (lo + (hi - lo) * u[n_obj + n_ground:, :1])
    # log-normal scales about each group's sigma
    sigma = torch.empty((n, 1), **f32)
    sigma[:n_obj] = s["object_sigma"]
    sigma[n_obj:n_obj + n_ground] = s["ground_sigma"]
    sigma[n_obj + n_ground:] = s["far_sigma"]
    log_scale = torch.log(sigma) + 0.4 * torch.randn((n, 3), generator=gen, **f32)
    opacity = s["opacity"][0] + (s["opacity"][1] - s["opacity"][0]) * torch.rand(
        (n, 1), generator=gen, **f32)
    rgb = torch.rand((n, 3), generator=gen, **f32)
    return {
        "xyz": xyz,
        "f_dc": (rgb - 0.5) / C0,
        "f_rest": 0.05 * torch.randn((n, SH_REST), generator=gen, **f32),
        "opacity": _logit(opacity),
        "scale": log_scale,
        "rot": _quats(n, gen, device),
    }


def surfel_scene(cfg: dict, seed: int, device) -> dict:
    """Raw attributes of ``cfg["gaussians"]`` 2DGS surfels (2-column scales)
    tangent to the object's blobs and to the table top, normals outward."""
    n = int(cfg["gaussians"])
    s = cfg["scene"]
    gen = generator(seed, device, 1)
    f32 = dict(device=device, dtype=torch.float32)
    n_table = int(n * s["table_share"])
    n_blob = n - n_table
    blobs = torch.tensor(s["blobs"], **f32)  # [B, 4]: centre, radius
    area = 4.0 * math.pi * blobs[:, 3] ** 2
    which = torch.multinomial(area / area.sum(), n_blob, replacement=True, generator=gen)
    d = torch.randn((n_blob, 3), generator=gen, **f32)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    xyz_b = blobs[which, :3] + d * blobs[which, 3:]
    u = torch.rand((n_table, 2), generator=gen, **f32)
    r = s["table_radius"] * torch.sqrt(u[:, 0])
    ang = 2.0 * math.pi * u[:, 1]
    xyz_t = torch.stack([r * torch.cos(ang), r * torch.sin(ang),
                         torch.full_like(r, s["table_z"])], -1)
    nrm_t = torch.zeros_like(xyz_t)
    nrm_t[:, 2] = 1.0
    xyz = torch.cat([xyz_b, xyz_t])
    nrm = torch.cat([d, nrm_t])
    # a random turn of each disk about its normal
    q = _quat_from_normal(nrm)
    spin = math.pi * torch.rand((n,), generator=gen, **f32)
    qs = torch.stack([torch.cos(spin), torch.zeros_like(spin), torch.zeros_like(spin),
                      torch.sin(spin)], -1)
    rot = _quat_mul(q, qs)
    log_scale = math.log(s["sigma"]) + 0.3 * torch.randn((n, 2), generator=gen, **f32)
    opacity = s["opacity"][0] + (s["opacity"][1] - s["opacity"][0]) * torch.rand(
        (n, 1), generator=gen, **f32)
    rgb = torch.rand((n, 3), generator=gen, **f32)
    return {
        "xyz": xyz,
        "f_dc": (rgb - 0.5) / C0,
        "f_rest": 0.05 * torch.randn((n, SH_REST), generator=gen, **f32),
        "opacity": _logit(opacity),
        "scale": log_scale,
        "rot": rot,
    }


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def scene(cfg: dict, seed: int, device) -> dict:
    return (surfel_scene if cfg["model"] == "2dgs" else vanilla_scene)(cfg, seed, device)


def _look_at(position, target, up):
    """Camera-to-world rotation (columns: right, down, forward) of a camera
    at ``position`` looking at ``target``: the 3DGS / OpenCV convention."""
    f = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    f /= np.linalg.norm(f)
    down = -np.asarray(up, np.float64)
    right = np.cross(down, f)
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    return np.stack([right, down, f], axis=1)


def cameras(cfg: dict) -> list:
    """cameras.json entries of every view of the configuration, in order:
    the 360-degree ring (3dgs) or the hemisphere arcs (2dgs). They do not
    depend on the seed: the rig is part of the configuration."""
    c = cfg["cameras"]
    W, H = int(cfg["width"]), int(cfg["height"])
    fx = 0.5 * W / math.tan(0.5 * math.radians(c["fov_x_deg"]))
    poses = []
    if c["kind"] == "ring":
        n = int(cfg["views"])
        for i in range(n):
            a = 2.0 * math.pi * i / n
            h = c["height"] + c["height_wobble"] * math.sin(3.0 * a)
            pos = [c["radius"] * math.cos(a), h, c["radius"] * math.sin(a)]
            poses.append((pos, _look_at(pos, c["target"], c["up"])))
    else:  # arcs on the upper hemisphere
        for elev, count in zip(c["elevations_deg"], c["per_arc"]):
            e = math.radians(elev)
            for j in range(count):
                az = math.radians(c["azimuth_deg"][0] + (c["azimuth_deg"][1] - c["azimuth_deg"][0])
                                  * j / max(count - 1, 1))
                pos = [c["radius"] * math.cos(e) * math.cos(az),
                       c["radius"] * math.cos(e) * math.sin(az), c["radius"] * math.sin(e)]
                poses.append((pos, _look_at(pos, c["target"], c["up"])))
        if len(poses) != int(cfg["views"]):
            raise ValueError(f"{cfg['name']}: arcs hold {len(poses)} views, not {cfg['views']}")
    return [{"id": i, "img_name": f"view_{i:03d}", "width": W, "height": H,
             "position": list(map(float, pos)), "rotation": rot.tolist(), "fx": fx, "fy": fx}
            for i, (pos, rot) in enumerate(poses)]


def split(cfg: dict, cams: list) -> tuple:
    """(training views, held-out views): every ``llffhold``-th view held out
    where the configuration holds one, else all views train."""
    hold = int(cfg.get("llffhold", 0))
    if not hold:
        return list(cams), []
    return ([c for i, c in enumerate(cams) if i % hold],
            [c for i, c in enumerate(cams) if i % hold == 0])


def images(cfg: dict, cams: list, seed: int, device) -> torch.Tensor:
    """[V, H, W, 3] float32 ground truth in [0, 1], one per camera dict:
    a seeded smooth field (a few planar waves a channel over the pixel
    grid) plus fine noise. Computed view by view on ``device``."""
    W, H = int(cfg["width"]), int(cfg["height"])
    out = torch.empty((len(cams), H, W, 3), dtype=torch.float32, device=device)
    ys = torch.linspace(0.0, 1.0, H, device=device)[:, None, None]
    xs = torch.linspace(0.0, 1.0, W, device=device)[None, :, None]
    for k, cam in enumerate(cams):
        gen = generator(seed, device, 1000 + int(cam["id"]))
        freq = 2.0 + 10.0 * torch.rand((6, 2, 3), generator=gen, device=device)
        phase = 2.0 * math.pi * torch.rand((6, 3), generator=gen, device=device)
        field = sum(torch.sin(2.0 * math.pi * (freq[i, 0] * xs + freq[i, 1] * ys) + phase[i])
                    for i in range(6)) / 6.0
        noise = torch.rand((H, W, 3), generator=gen, device=device)
        out[k] = (0.5 + 0.4 * field + 0.1 * (noise - 0.5)).clamp(0.0, 1.0)
    return out
