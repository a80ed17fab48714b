"""Orbit camera paths (port of gaustudio_tpu/cameras/camera_paths.py:26-88).

The poses are computed in float64 numpy, as the JAX package computes them;
the cameras are the port's. The flythrough tools (validation, smoothing,
resampling, cubemaps) belong to a later slice.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from gaustudio_torch.cameras import Camera


def safe_normalize(x, eps=1e-20):
    x = np.asarray(x, np.float64)
    return x / np.sqrt(np.maximum((x * x).sum(-1, keepdims=True), eps))


def look_at(campos, target, opengl=True):
    """Rotation whose columns are (right, up, forward)."""
    campos = np.asarray(campos, np.float64)
    target = np.asarray(target, np.float64)
    if not opengl:
        forward = safe_normalize(target - campos)
    else:
        forward = safe_normalize(campos - target)
    up = np.array([0, 1, 0], np.float64)
    right = np.cross(up, forward)
    if np.linalg.norm(right) < 1e-6:
        up = np.array([1, 0, 0], np.float64)
        right = np.cross(up, forward)
    right = safe_normalize(right)
    up = safe_normalize(np.cross(forward, right))
    return np.stack([right, up, forward], axis=1)


def orbit_camera(elevation, azimuth, radius=1, is_degree=True, target=None,
                 opengl=True):
    """c2w pose [4, 4] orbiting ``target``."""
    if is_degree:
        elevation = np.deg2rad(elevation)
        azimuth = np.deg2rad(azimuth)
    x = radius * np.cos(elevation) * np.sin(azimuth)
    y = radius * np.sin(elevation)
    z = radius * np.cos(elevation) * np.cos(azimuth)
    if target is None:
        target = np.zeros(3, np.float64)
    campos = np.array([x, y, z]) + target
    T = np.eye(4)
    T[:3, :3] = look_at(campos, target, opengl)
    T[:3, 3] = campos
    return T


def get_path_from_orbit(cam_center, cam_radius, elevation=0, num_cam=36,
                        image_size=1024, fov_deg=49.1, device=None) -> List[Camera]:
    """``num_cam`` azimuth steps around ``cam_center``, as cameras on
    ``device`` (None: the current CUDA device).

    Camera(R=...) takes the camera-to-world rotation, so R is the transpose
    of the world-to-camera rotation (the JAX package's fix of the reference,
    which passed the world-to-camera rotation itself)."""
    cameras = []
    for _id, azi in enumerate(np.arange(0, 360, 360 // num_cam, dtype=np.int32)):
        pose = orbit_camera(elevation, float(azi), radius=cam_radius,
                            target=np.asarray(cam_center), opengl=False)
        w2c = np.linalg.inv(pose)
        cameras.append(
            Camera(R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3], FoVx=math.radians(fov_deg),
                   FoVy=math.radians(fov_deg), image_name=f"{_id}",
                   image_width=image_size, image_height=image_size, device=device)
        )
    return cameras
