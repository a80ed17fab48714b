"""Pose utilities: quaternion conversions, slerp, pose interpolation, pose
orientation and lens undistortion (port of gaustudio_tpu/utils/pose.py).

Host numpy in float64, as the JAX package computes them: these are path and
file tools, not device work.
"""

from __future__ import annotations

import numpy as np


def quaternion_from_matrix(matrix) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z); pose_utils.py:51-90."""
    M = np.asarray(matrix, dtype=np.float64)[:3, :3]
    K = (
        np.array(
            [
                [M[0, 0] - M[1, 1] - M[2, 2], 0, 0, 0],
                [M[0, 1] + M[1, 0], M[1, 1] - M[0, 0] - M[2, 2], 0, 0],
                [M[0, 2] + M[2, 0], M[1, 2] + M[2, 1], M[2, 2] - M[0, 0] - M[1, 1], 0],
                [M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1],
                 M[0, 0] + M[1, 1] + M[2, 2]],
            ]
        )
        / 3.0
    )
    w, V = np.linalg.eigh(K)
    q = V[[3, 0, 1, 2], np.argmax(w)]
    if q[0] < 0.0:
        q = -q
    return q


def quaternion_matrix(quaternion) -> np.ndarray:
    """Quaternion (w, x, y, z) -> homogeneous rotation matrix;
    pose_utils.py:93-121."""
    q = np.asarray(quaternion, dtype=np.float64)
    n = np.dot(q, q)
    if n < np.finfo(float).eps * 4.0:
        return np.eye(4)
    q = q * np.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array(
        [
            [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0],
            [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0],
            [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2], 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def quaternion_slerp(quat0, quat1, fraction: float, spin: int = 0,
                     shortestpath: bool = True) -> np.ndarray:
    """Spherical linear interpolation; pose_utils.py:124-163."""
    q0 = np.asarray(quat0, np.float64).copy()
    q1 = np.asarray(quat1, np.float64).copy()
    q0 /= np.linalg.norm(q0)
    q1 /= np.linalg.norm(q1)
    if fraction == 0.0:
        return q0
    if fraction == 1.0:
        return q1
    d = np.dot(q0, q1)
    if abs(abs(d) - 1.0) < np.finfo(float).eps * 4.0:
        return q0
    if shortestpath and d < 0.0:
        d = -d
        q1 = -q1
    angle = np.arccos(np.clip(d, -1, 1)) + spin * np.pi
    if abs(angle) < np.finfo(float).eps * 4.0:
        return q0
    isin = 1.0 / np.sin(angle)
    q0 *= np.sin((1.0 - fraction) * angle) * isin
    q1 *= np.sin(fraction * angle) * isin
    return q0 + q1


def get_interpolated_poses(pose_a, pose_b, steps: int = 10):
    """Interpolate between two 4x4 poses (slerp rotation + lerp translation);
    pose_utils.py:164-190."""
    pose_a = np.asarray(pose_a, np.float64)
    pose_b = np.asarray(pose_b, np.float64)
    quat_a = quaternion_from_matrix(pose_a[:3, :3])
    quat_b = quaternion_from_matrix(pose_b[:3, :3])
    poses = []
    for t in np.linspace(0, 1, steps, endpoint=False):
        q = quaternion_slerp(quat_a, quat_b, float(t))
        pose = quaternion_matrix(q)
        pose[:3, 3] = (1.0 - t) * pose_a[:3, 3] + t * pose_b[:3, 3]
        poses.append(pose)
    return poses


def get_interpolated_poses_many(poses, steps_per_transition: int = 10):
    """pose_utils.py:193-281 (uniform variant): chain interpolation."""
    out = []
    for i in range(len(poses) - 1):
        out.extend(get_interpolated_poses(poses[i], poses[i + 1], steps_per_transition))
    out.append(np.asarray(poses[-1], np.float64))
    return out


def focus_of_attention(poses: np.ndarray, initial_focus: np.ndarray) -> np.ndarray:
    """Closest point to the cameras' optical axes (pose_utils.py:478-513)."""
    poses = np.asarray(poses, np.float64)
    active_directions = -poses[:, :3, 2:3]
    active_origins = poses[:, :3, 3:4]
    focus_pt = np.asarray(initial_focus, np.float64)
    active = np.sum(
        active_directions[..., 0] * (focus_pt - active_origins[..., 0]), axis=-1
    ) > 0
    done = False
    while active.sum() > 1 and not done:
        dirs = active_directions[active]
        origs = active_origins[active]
        m = np.eye(3) - dirs * np.transpose(dirs, (0, 2, 1))
        mt_m = np.transpose(m, (0, 2, 1)) @ m
        focus_pt = np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origs).mean(0)[:, 0]
        active = np.sum(
            active_directions[..., 0] * (focus_pt - active_origins[..., 0]), axis=-1
        ) > 0
        if active.all():
            done = True
    return focus_pt


def _rotation_between(a, b):
    """Rotation matrix taking unit vector a to unit vector b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:  # opposite: rotate around any orthogonal axis
        axis = np.cross(a, [1.0, 0, 0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0, 1.0, 0])
        axis /= np.linalg.norm(axis)
        return 2 * np.outer(axis, axis) - np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1 + c)


def auto_orient_and_center_poses(poses, method: str = "up",
                                 center_method: str = "poses"):
    """Orient and center c2w poses (pose_utils.py:517-623, numpy port).

    methods: "pca" | "up" | "none"; center: "poses" | "focus" | "none".
    Returns (oriented [N,3,4], transform [3,4]).
    """
    poses = np.asarray(poses, np.float64)
    origins = poses[..., :3, 3]
    mean_origin = origins.mean(axis=0)

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center_method {center_method}")

    if method == "pca":
        diff = origins - mean_origin
        _, eigvec = np.linalg.eigh(diff.T @ diff)
        eigvec = np.flip(eigvec, axis=-1)
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate(
            [eigvec.T, eigvec.T @ -translation[:, None]], axis=-1
        )
        oriented = transform @ poses
        if oriented.mean(axis=0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
    elif method == "up":
        up = poses[:, :3, 1].mean(0)
        up /= np.linalg.norm(up)
        rotation = _rotation_between(up, np.array([0, 0, 1.0]))
        transform = np.concatenate([rotation, rotation @ -translation[:, None]], -1)
        oriented = transform @ poses
    elif method == "none":
        transform = np.concatenate([np.eye(3), -translation[:, None]], -1)
        oriented = transform @ poses
    else:
        raise ValueError(f"unknown method {method}")
    return oriented, transform


def get_distortion_params(k1=0.0, k2=0.0, k3=0.0, k4=0.0, p1=0.0, p2=0.0):
    """pose_utils.py:321-352: OpenCV-style radial/tangential params vector."""
    return np.array([k1, k2, k3, k4, p1, p2], np.float64)


def radial_and_tangential_undistort(coords, distortion_params, eps: float = 1e-3,
                                    max_iterations: int = 10):
    """Iterative Newton undistortion (pose_utils.py:354-449, numpy port).

    coords: [N, 2] distorted normalized camera coords -> undistorted coords.
    """
    coords = np.asarray(coords, np.float64)
    k1, k2, k3, k4, p1, p2 = distortion_params

    def distort(x, y):
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        fx = d * x + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - coords[:, 0]
        fy = d * y + 2 * p2 * x * y + p1 * (r2 + 2 * y * y) - coords[:, 1]
        # analytic Jacobian
        d_r2 = k1 + r2 * (2 * k2 + r2 * (3 * k3 + r2 * 4 * k4))
        fx_x = d + 2 * x * x * d_r2 + 2 * p1 * y + 6 * p2 * x
        fx_y = 2 * x * y * d_r2 + 2 * p1 * x + 2 * p2 * y
        fy_x = fx_y
        fy_y = d + 2 * y * y * d_r2 + 2 * p2 * x + 6 * p1 * y
        return fx, fy, fx_x, fx_y, fy_x, fy_y

    x = coords[:, 0].copy()
    y = coords[:, 1].copy()
    for _ in range(max_iterations):
        fx, fy, a, b, c, d = distort(x, y)
        det = a * d - b * c
        det = np.where(np.abs(det) > 1e-12, det, 1.0)
        dx = (d * fx - b * fy) / det
        dy = (-c * fx + a * fy) / det
        step = np.abs(fx) + np.abs(fy) > eps
        x = x - np.where(step, dx, 0.0)
        y = y - np.where(step, dy, 0.0)
    return np.stack([x, y], -1)
