"""Camera paths: orbits, cubemaps, cameras.json paths, and the flythrough
tools (speed validation, keyframe selection, Savitzky-Golay smoothing,
velocity resampling); port of gaustudio_tpu/cameras/camera_paths.py.

The poses are computed in host numpy, as the JAX package computes them, from
each camera's float32 extrinsics read back to the host; the cameras are the
port's. Where the JAX package deep-copies a camera to give it a new pose, the
port makes a shallow copy: the copy's geometry and name are its own, and it
shares the original's image, mask, background, normal and depth tensors,
which rendering a frame never reads (a deep copy of a 1080p COLMAP camera
is about 50 MB).
"""

from __future__ import annotations

import copy
import json
import math
from typing import List

import numpy as np

from gaustudio_torch.cameras import Camera
from gaustudio_torch.datasets.utils import JSON_to_camera
from gaustudio_torch.utils.pose import (
    get_interpolated_poses,
    quaternion_from_matrix,
    quaternion_matrix,
)


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


def get_path_from_cubemap(cam_center, cam_radius, image_size=1024, device=None) -> List[Camera]:
    """Six axis-aligned views of ``cam_center`` from ``cam_radius`` away, as
    cameras on ``device`` (None: the current CUDA device)."""
    cam_center = np.asarray(cam_center, np.float64)
    views = {
        "front": np.array([0, 0, cam_radius]),
        "back": np.array([0, 0, -cam_radius]),
        "left": np.array([-cam_radius, 0, 0]),
        "right": np.array([cam_radius, 0, 0]),
        "top": np.array([0, cam_radius, 0]),
        "bottom": np.array([0, -cam_radius, 0]),
    }
    cameras = []
    for name, offset in views.items():
        campos = cam_center + offset
        T = np.eye(4)
        T[:3, :3] = look_at(campos, cam_center, opengl=False)
        T[:3, 3] = campos
        T[:3, 1] *= -1
        w2c = np.linalg.inv(T)
        cameras.append(
            Camera(R=w2c[:3, :3].T, T=w2c[:3, 3], FoVx=math.radians(49.1),
                   FoVy=math.radians(49.1), image_name=name,
                   image_width=image_size, image_height=image_size, device=device)
        )
    return cameras


def get_path_from_json(json_path, device=None) -> List[Camera]:
    """The cameras of a cameras.json, on ``device``."""
    with open(json_path) as f:
        camera_data = json.load(f)
    return [JSON_to_camera(cj, device=device) for cj in camera_data]


def _extrinsics(camera) -> np.ndarray:
    """The camera's float32 world -> view matrix [4, 4] on the host."""
    return camera.extrinsics.detach().cpu().numpy()


def _posed(camera, extrinsics):
    """A shallow copy of ``camera`` moved to ``extrinsics`` (see the module's
    docstring)."""
    cam = copy.copy(camera)
    cam.extrinsics = extrinsics
    return cam


def upsample_cameras_velocity(cameras, meters_per_frame=0.1, angles_per_frame=1):
    """Resample the path by slerp to at most ``meters_per_frame`` and
    ``angles_per_frame`` degrees between frames; the frames are named by
    their 8-digit index."""
    new_cameras = []
    total_idx = 0
    for idx in range(len(cameras) - 1):
        cur, nxt = cameras[idx], cameras[idx + 1]
        ce, ne = _extrinsics(cur), _extrinsics(nxt)
        d_t = np.linalg.norm(ne[:3, 3] - ce[:3, 3])
        d_r = np.rad2deg(
            np.arccos(np.clip((np.trace(ce[:3, :3].T @ ne[:3, :3]) - 1) / 2, -1, 1))
        )
        steps = max(max(int(d_t / meters_per_frame), 1), max(int(d_r / angles_per_frame), 1))
        for pose in get_interpolated_poses(ce, ne, steps=steps):
            cam = _posed(cur, pose)
            cam.image_name = str(total_idx).zfill(8)
            new_cameras.append(cam)
            total_idx += 1
    return new_cameras


def downsample_cameras(cameras, translation_threshold=0.1, rotation_threshold=15,
                       min_samples=10):
    """Keyframes: each camera that moved more than ``translation_threshold``
    or turned more than ``rotation_threshold`` degrees from the last kept one;
    the input itself when that keeps fewer than ``min_samples``."""
    if len(cameras) <= min_samples:
        return cameras
    rotation_threshold = np.deg2rad(rotation_threshold)
    out = []
    prev = None
    for cam in cameras:
        if prev is None:
            out.append(cam)
            prev = cam
            continue
        ce, pe = _extrinsics(cam), _extrinsics(prev)
        d_t = np.linalg.norm(ce[:3, 3] - pe[:3, 3])
        d_r = np.arccos(np.clip((np.trace(pe[:3, :3].T @ ce[:3, :3]) - 1) / 2, -1, 1))
        if d_t > translation_threshold or d_r > rotation_threshold:
            out.append(cam)
            prev = cam
    return out if len(out) >= min_samples else cameras


def validate_paths(cameras, window_size_ratio=0.1, speed_tolerance=0.2,
                   discard_outliers=False, return_invalid=False):
    """Sliding-window speed-outlier rejection: a camera whose step exceeds the
    window's mean step by more than ``speed_tolerance`` is dropped."""
    valid, invalid = [], []
    prev = None
    n = len(cameras)
    window = max(3, int(n * window_size_ratio))
    positions = [_extrinsics(c)[:3, 3] for c in cameras]
    for i, cam in enumerate(cameras):
        if prev is None:
            valid.append(cam)
            prev = cam
            continue
        speed = np.linalg.norm(positions[i] - positions[i - 1])
        w0 = max(0, i - window)
        speeds = [
            np.linalg.norm(positions[j] - positions[max(0, j - 1)])
            for j in range(w0, i + 1)
        ]
        threshold = np.mean(speeds) * (1 + speed_tolerance)
        if speed > threshold:
            if not discard_outliers:
                invalid.append(cam)
        else:
            valid.append(cam)
        prev = cam
    if return_invalid:
        return valid, invalid
    return valid


def unwrap_quaternions(qvecs):
    """A hemisphere-consistent quaternion sequence: each flipped to the side
    of its predecessor."""
    out = np.zeros_like(qvecs)
    out[0] = qvecs[0]
    for i in range(1, qvecs.shape[0]):
        dot = np.clip(np.sum(out[i - 1] * qvecs[i]), -1.0, 1.0)
        out[i] = qvecs[i] if dot > 0 else -qvecs[i]
    return out


def smoothen_cameras(cameras, window_size_ratio=0.1, polyorder=2):
    """Savitzky-Golay smoothing of the trajectory's positions and
    (unwrapped) quaternions."""
    from scipy.signal import savgol_filter

    n = len(cameras)
    window = max(3, int(n * window_size_ratio))
    if window <= polyorder:
        window = polyorder + 1
    extrinsics = [_extrinsics(c) for c in cameras]
    translates = np.stack([e[:3, 3] for e in extrinsics])
    qvecs = np.stack([quaternion_from_matrix(e[:3, :3]) for e in extrinsics])
    qvecs = unwrap_quaternions(qvecs)
    for dim in range(3):
        translates[:, dim] = savgol_filter(translates[:, dim], window, polyorder)
    for dim in range(4):
        qvecs[:, dim] = savgol_filter(qvecs[:, dim], window, polyorder)

    out = []
    for cam, t, q in zip(cameras, translates, qvecs):
        q = q / np.linalg.norm(q)
        ext = quaternion_matrix(q)
        ext[:3, 3] = t
        out.append(_posed(cam, ext))
    return out
