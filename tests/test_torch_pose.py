"""gaustudio_torch.utils.pose against gaustudio_tpu.utils.pose: every function
on the cases of tests/test_utils_pose_depth.py and on seeded random proper
rotations, within 1e-12."""

import numpy as np
import pytest

from gaustudio_torch.utils import pose as tp
from gaustudio_tpu.utils import pose as jp

TOL = 1e-12


def _rotations(n: int, seed: int) -> list:
    """Seeded random proper rotations (QR of a Gaussian matrix, det +1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        assert abs(np.linalg.det(Q) - 1.0) < 1e-12
        out.append(Q)
    return out


def _poses(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = _rotations(n, seed)
    poses[:, :3, 3] = rng.normal(size=(n, 3))
    return poses


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [1, 7])
def test_quaternions_match_jax(seed):
    for R in _rotations(8, seed) + [np.eye(3)]:
        q = tp.quaternion_from_matrix(R)
        _close(q, jp.quaternion_from_matrix(R))
        _close(tp.quaternion_matrix(q), jp.quaternion_matrix(q))
        np.testing.assert_allclose(tp.quaternion_matrix(q)[:3, :3], R, atol=1e-8)
    _close(tp.quaternion_matrix(np.zeros(4)), jp.quaternion_matrix(np.zeros(4)))


@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5, 1.0])
def test_slerp_matches_jax(fraction):
    q0 = tp.quaternion_from_matrix(np.eye(3))
    q1 = tp.quaternion_from_matrix(tp.quaternion_matrix(
        np.array([np.cos(0.5), 0, 0, np.sin(0.5)]))[:3, :3])
    qs = [tp.quaternion_from_matrix(R) for R in _rotations(4, 3)]
    for a, b in [(q0, q1), (qs[0], qs[1]), (qs[2], -qs[3]), (qs[0], qs[0])]:
        for spin, shortest in [(0, True), (1, False)]:
            _close(tp.quaternion_slerp(a, b, fraction, spin, shortest),
                   jp.quaternion_slerp(a, b, fraction, spin, shortest))


def test_interpolated_poses_match_jax():
    a, b = np.eye(4), np.eye(4)
    b[:3, 3] = [2, 0, 0]
    got = tp.get_interpolated_poses(a, b, steps=4)
    assert len(got) == 4
    for g, w in zip(got, jp.get_interpolated_poses(a, b, steps=4)):
        _close(g, w)
    poses = _poses(5, 11)
    for steps in (1, 3, 7):
        for g, w in zip(tp.get_interpolated_poses(poses[0], poses[1], steps),
                        jp.get_interpolated_poses(poses[0], poses[1], steps)):
            _close(g, w)
        got = tp.get_interpolated_poses_many(poses, steps)
        want = jp.get_interpolated_poses_many(poses, steps)
        assert len(got) == len(want) == 4 * steps + 1
        for g, w in zip(got, want):
            _close(g, w)


def _ring(n: int = 8) -> np.ndarray:
    """c2w poses of cameras on a ring, each looking (along -z) at the
    ring's centre: every camera's axis passes near the focus."""
    ring = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        c2w = np.eye(4)
        pos = np.array([3 * np.cos(ang), 0.5, 3 * np.sin(ang)])
        back = pos / np.linalg.norm(pos)
        right = np.cross([0, 1.0, 0], back)
        right /= np.linalg.norm(right)
        c2w[:3, :3] = np.stack([right, np.cross(back, right), back], 1)
        c2w[:3, 3] = pos
        ring.append(c2w)
    return np.stack(ring)


@pytest.mark.parametrize("method", ["pca", "up", "none"])
@pytest.mark.parametrize("center", ["poses", "focus", "none"])
def test_auto_orient_and_center_matches_jax(method, center):
    rng = np.random.default_rng(2)
    tilt = jp.quaternion_matrix(np.array([np.cos(0.2), np.sin(0.2), 0, 0]))[:3, :3]
    tilted = np.tile(np.eye(4), (6, 1, 1))
    tilted[:, :3, :3] = tilt
    tilted[:, :3, 3] = rng.normal(size=(6, 3))
    # focus_of_attention iterates until every camera faces the focus, which
    # some poses never reach (both packages loop forever on them): the focus
    # is taken of the ring, whose cameras all face its centre
    cases = (_ring(),) if center == "focus" else (tilted, _ring(), _poses(7, 5))
    for poses in cases:
        got, got_tf = tp.auto_orient_and_center_poses(poses, method, center)
        want, want_tf = jp.auto_orient_and_center_poses(poses, method, center)
        _close(got, want)
        _close(got_tf, want_tf)
    if method == "up" and center == "poses":
        up = got[:, :3, 1].mean(0)
        np.testing.assert_allclose(up / np.linalg.norm(up), [0, 0, 1], atol=1e-6)


def test_focus_and_rotation_between_match_jax():
    for poses, start in ((_ring(), np.zeros(3)), (_ring(6), np.ones(3)),
                         (_poses(7, 5), _poses(7, 5)[:, :3, 3].mean(0))):
        _close(tp.focus_of_attention(poses, start), jp.focus_of_attention(poses, start))
    rng = np.random.default_rng(9)
    for a, b in [(rng.normal(size=3), rng.normal(size=3)), (np.array([0, 0, 1.0]),) * 2,
                 (np.array([0, 0, 1.0]), np.array([0, 0, -1.0])),
                 (np.array([1.0, 0, 0]), np.array([-1.0, 0, 0]))]:
        _close(tp._rotation_between(a, b), jp._rotation_between(a, b))


def test_undistort_matches_jax():
    rng = np.random.default_rng(3)
    params = tp.get_distortion_params(k1=0.1, k2=-0.02, p1=0.001, p2=-0.002)
    _close(params, jp.get_distortion_params(k1=0.1, k2=-0.02, p1=0.001, p2=-0.002))
    coords = rng.uniform(-0.4, 0.4, (50, 2))
    for kw in ({}, {"eps": 1e-9, "max_iterations": 20}):
        _close(tp.radial_and_tangential_undistort(coords, params, **kw),
               jp.radial_and_tangential_undistort(coords, params, **kw))
