"""gaustudio_torch.cameras.camera_paths against gaustudio_tpu's: each path
function on the same camera lists, built by both packages from the same
cameras.json entries (R and T): frame counts and names equal, extrinsics
within 1e-6; and the flythrough path of chip_smoke.py's phase 15, whose
proper rotations both chains keep as 77 / 40 / 40 / 78 cameras."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from gaustudio_torch.cameras import camera_paths as tcp
from gaustudio_torch.datasets.utils import JSON_to_camera as t_json_to_camera
from gaustudio_tpu.cameras import camera_paths as jcp
from gaustudio_tpu.datasets.utils import JSON_to_camera as j_json_to_camera

CPU = torch.device("cpu")
EXTR_TOL = 1e-6


def _both(entries):
    return ([t_json_to_camera(cj, device=CPU) for cj in entries],
            [j_json_to_camera(cj) for cj in entries])


def _same(got, want):
    assert len(got) == len(want)
    assert [c.image_name for c in got] == [c.image_name for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.extrinsics.numpy(), np.asarray(w.extrinsics), rtol=0,
                                   atol=EXTR_TOL)
        np.testing.assert_allclose(g.full_proj_transform.numpy(), w.full_proj_transform,
                                   rtol=0, atol=EXTR_TOL)
        assert (g.image_width, g.image_height) == (w.image_width, w.image_height)


def _path(n=24, arc_deg=40.0, lifts=(9,), seed=3):
    return chip_smoke.flythrough_cameras(n=n, W=64, H=48, arc_deg=arc_deg, lifts=lifts, seed=seed)


def test_flythrough_path_keeps_the_jax_counts_with_proper_rotations(tmp_path):
    """Phase 15's path at full width through both chains: 77 / 40 / 40 / 78
    cameras, the same frames."""
    entries = chip_smoke.flythrough_cameras()
    assert len(entries) == chip_smoke.FLY_N
    for cj in entries:
        assert abs(np.linalg.det(np.asarray(cj["rotation"])) - 1.0) < 1e-12
    middle = np.asarray(entries[chip_smoke.FLY_N // 2]["rotation"])
    assert np.degrees(np.arccos((np.trace(middle) - 1) / 2)) < 1.0  # near the identity view
    path_json = str(tmp_path / "path.json")
    with open(path_json, "w") as f:
        json.dump(entries, f)
    port = chip_smoke.flythrough_chain(path_json, CPU)
    assert tuple(port["counts"]) == chip_smoke.FLY_COUNTS
    cams = jcp.get_path_from_json(path_json)
    counts = []
    for stage in chip_smoke.FLY_CHAIN:
        cams = getattr(jcp, stage)(cams)
        counts.append(len(cams))
    assert tuple(counts) == chip_smoke.FLY_COUNTS
    _same(port["cameras"], cams)
    assert port["names"] == [f"{i:08d}" for i in range(chip_smoke.FLY_COUNTS[-1])]


def test_path_from_json_and_cubemap_match_jax(tmp_path):
    entries = _path()
    path_json = str(tmp_path / "cams.json")
    with open(path_json, "w") as f:
        json.dump(entries, f)
    _same(tcp.get_path_from_json(path_json, device=CPU), jcp.get_path_from_json(path_json))
    for centre, radius, size in (((0, 0, 0), 2.0, 32), ((0.3, -0.2, 1.5), 4.5, 48)):
        got = tcp.get_path_from_cubemap(centre, radius, image_size=size, device=CPU)
        _same(got, jcp.get_path_from_cubemap(centre, radius, image_size=size))
        assert [c.image_name for c in got] == ["front", "back", "left", "right", "top", "bottom"]


@pytest.mark.parametrize("discard,ret", [(False, False), (True, False), (False, True)])
def test_validate_paths_matches_jax(discard, ret):
    t_cams, j_cams = _both(_path(lifts=(5, 9, 17)))
    got = tcp.validate_paths(t_cams, discard_outliers=discard, return_invalid=ret)
    want = jcp.validate_paths(j_cams, discard_outliers=discard, return_invalid=ret)
    if ret:
        _same(got[0], want[0])
        _same(got[1], want[1])
        assert len(got[1]) > 0
    else:
        _same(got, want)
        assert len(got) < len(t_cams)


@pytest.mark.parametrize("n,kw", [(24, {}), (8, {}), (24, {"rotation_threshold": 1.0}),
                                  (24, {"translation_threshold": 0.5, "min_samples": 3})])
def test_downsample_cameras_matches_jax(n, kw):
    t_cams, j_cams = _both(_path(n=n, lifts=()))
    got = tcp.downsample_cameras(t_cams, **kw)
    _same(got, jcp.downsample_cameras(j_cams, **kw))
    assert all(any(g is c for c in t_cams) for g in got)  # keyframes are the input's


@pytest.mark.parametrize("ratio,order", [(0.1, 2), (0.3, 2), (0.3, 3)])
def test_smoothen_cameras_matches_jax(ratio, order):
    t_cams, j_cams = _both(_path(lifts=(9,)))
    _same(tcp.smoothen_cameras(t_cams, ratio, order), jcp.smoothen_cameras(j_cams, ratio, order))


def test_unwrap_quaternions_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(tcp.unwrap_quaternions(q), jcp.unwrap_quaternions(q))


@pytest.mark.parametrize("kw", [{}, {"meters_per_frame": 0.05}, {"angles_per_frame": 0.5}])
def test_upsample_cameras_velocity_matches_jax(kw):
    t_cams, j_cams = _both(_path(n=8, arc_deg=20.0, lifts=()))
    got = tcp.upsample_cameras_velocity(t_cams, **kw)
    want = jcp.upsample_cameras_velocity(j_cams, **kw)
    _same(got, want)
    assert [c.image_name for c in got] == [f"{i:08d}" for i in range(len(got))]


def test_new_poses_share_pixels_and_leave_the_input_as_it_was():
    """A resampled or smoothed camera is a shallow copy at its own pose: its
    image and mask are the original's tensors, and the original keeps its
    pose and name."""
    t_cams, _ = _both(_path(n=6, arc_deg=10.0, lifts=()))
    for cam in t_cams:
        cam.image = torch.rand(48, 64, 3)
        cam.mask = torch.ones(48, 64)
    before = [(c.image_name, c.world_view_transform.clone()) for c in t_cams]
    for out in (tcp.upsample_cameras_velocity(t_cams), tcp.smoothen_cameras(t_cams)):
        assert out[0].image is t_cams[0].image and out[0].mask is t_cams[0].mask
    for cam, (name, wv) in zip(t_cams, before):
        assert cam.image_name == name
        assert torch.equal(cam.world_view_transform, wv)
