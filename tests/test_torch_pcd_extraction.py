"""gs-extract-pcd through the port on the CPU against the JAX package: the
masked bilateral filter (the JAX function reaches OpenCV), the normal
fusion and the outlier cleaning on seeded inputs, the surface points of
mini_scene (4 views at downsample 2), the CLI's files, and the JAX package's
invalid-normal marker, kept as it is.

The JAX ``extract_surface_points`` cannot run as written under this numpy:
it writes the -1 marker into ``np.asarray`` of a jax array, which is
read-only. ``_jax_surface_points`` spells it out line by line with a
writable copy, and the port is held to that."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustudio_torch import models as t_models
from gaustudio_torch import renderers as t_renderers
from gaustudio_torch.cameras import Camera as TCamera
from gaustudio_torch.datasets.utils import JSON_to_camera as t_json_to_camera
from gaustudio_torch.pipelines import pcd_extraction as TP
from gaustudio_torch.scripts import extract_pcd as t_cli
from gaustudio_torch.utils.image import load_grey8, load_rgb8
from gaustudio_torch.utils.mesh import load_mesh, mesh_f1_score
from gaustudio_torch.utils.ply import fetch_ply
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.cameras import Camera as JCamera
from gaustudio_tpu.datasets.utils import JSON_to_camera as j_json_to_camera
from gaustudio_tpu.datasets.utils import getNerfppNorm as j_nerfpp_norm
from gaustudio_tpu.ops.sh import SH2RGB as j_sh2rgb
from gaustudio_tpu.pipelines import pcd_extraction as JP

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_scene")
PLY = os.path.join(FIXTURE, "gaussians.ply")
VIEWS, DOWNSAMPLE = 4, 2
NORMAL_TOL = 1e-4


@pytest.fixture(scope="module")
def cameras_json():
    with open(os.path.join(FIXTURE, "cameras.json")) as f:
        return json.load(f)[:VIEWS]


def _jax_surface_points(pcd, renderer, cameras, downsample):
    """gaustudio_tpu.pipelines.pcd_extraction.extract_surface_points, with
    the marker written into a copy. Returns (ids, fused normals, cleaned)."""
    cams = [c.downsample_scale(downsample) for c in cameras]
    scene_radius = j_nerfpp_norm(cams)["radius"]
    all_ids, all_normals, all_conf = [], [], []
    for camera in cams:
        out = renderer.render(camera, pcd)
        opacity = np.asarray(out["rendered_final_opacity"][0])
        depth = np.asarray(out["rendered_depth"][0])
        filtered, fg = JP.masked_bilateral_filter(depth, opacity > 0.1)
        cam_normals = np.array(camera.depth2normal(jnp.asarray(filtered), coordinate="camera"))
        cam_normals[~fg] = -1
        normals = np.asarray(camera.normal2worldnormal(jnp.asarray(cam_normals)))
        med_depth = np.asarray(out["rendered_median_depth"][0])
        med_ids = np.asarray(out["rendered_median_id"][0])
        valid = (med_depth < scene_radius * 0.8) & (opacity > 0.5)
        valid &= normals.sum(-1) > -3
        all_ids.append(med_ids[valid])
        all_normals.append(-normals[valid])
        all_conf.append(opacity[valid])
    ids, fused = JP.normal_fusion(pcd, all_ids, all_normals, all_conf, cams)
    xyz = np.asarray(pcd._xyz)[ids]
    color = np.clip(np.asarray(j_sh2rgb(np.asarray(pcd._f_dc).reshape(len(pcd._xyz), -1)[:, :3]))[
        ids], 0, 1)
    return ids, fused, JP.clean_point_cloud(xyz, color, fused)


@pytest.fixture(scope="module")
def jax_run(cameras_json):
    pcd = j_models.make({"name": "vanilla_pcd"})
    pcd.load(PLY)
    pcd.active_sh_degree = 0
    return _jax_surface_points(pcd, j_renderers.make({"name": "vanilla_renderer"}),
                               [j_json_to_camera(cj) for cj in cameras_json], DOWNSAMPLE)


def _bilateral_case(name):
    rng = np.random.default_rng(7)
    depth = (2.0 + rng.normal(size=(20, 24)) * 0.05).astype(np.float32)
    depth[5:9, 3:7] += 1.0  # a step edge
    mask = np.ones((20, 24), bool)
    if name == "holes_and_edges":
        mask[10:13, 10:14] = False
        mask[0, :5] = False
        mask[-1, -1] = False
    elif name == "invalid_border":
        mask[:, 0] = False
        mask[:3] = False
        depth[0, 0] = np.inf
    elif name == "no_valid_pixel":
        mask[:] = False
    return depth, mask


@pytest.mark.parametrize("case", ["holes_and_edges", "invalid_border", "full", "no_valid_pixel"])
def test_bilateral_filter_matches_jax_opencv(case):
    depth, mask = _bilateral_case(case)
    want, want_mask = JP.masked_bilateral_filter(depth, mask)
    got, got_mask = TP.masked_bilateral_filter(torch.from_numpy(depth), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    finite = np.isfinite(depth)
    span = depth[finite].max() - depth[finite].min()
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    assert np.abs(got.numpy()[finite] - want[finite]).max() <= 1e-5 * span


def _cameras(n=3):
    cams = []
    for i in range(n):
        a = 0.4 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        kw = dict(R=R, T=np.array([0.1 * i, 0.0, 3.0]), FoVx=1.0, FoVy=1.0, image_width=16,
                  image_height=16)
        cams.append((JCamera(**kw), TCamera(device="cpu", **kw)))
    return cams


def _fusion_inputs(seed=3):
    """Per view: surface ids (with repeats across views), normals with
    outliers for the re-vote, confidences."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    ids, normals, conf = [], [], []
    for v in range(3):
        i = rng.choice(40, 25, replace=True)
        n = xyz[i] / np.linalg.norm(xyz[i], axis=1, keepdims=True) + rng.normal(size=(25, 3)) * 0.1
        n[:3] *= -1  # inconsistent samples
        ids.append(i.astype(np.int32))
        normals.append(n.astype(np.float32))
        conf.append(rng.uniform(0.5, 1.0, 25).astype(np.float32))
    return xyz, ids, normals, conf


def test_normal_fusion_matches_jax():
    xyz, ids, normals, conf = _fusion_inputs()
    cams = _cameras()

    class JPcd:
        _xyz = xyz

    class TPcd:
        _xyz = torch.from_numpy(xyz)

    j_ids, j_n = JP.normal_fusion(JPcd(), ids, normals, conf, [c[0] for c in cams], knn=4)
    t_ids, t_n = TP.normal_fusion(TPcd(), [torch.from_numpy(i).long() for i in ids],
                                  [torch.from_numpy(n) for n in normals],
                                  [torch.from_numpy(c) for c in conf], [c[1] for c in cams],
                                  knn=4)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_n, j_n, atol=1e-6)


def test_clean_point_cloud_matches_jax():
    rng = np.random.default_rng(4)
    d = rng.normal(size=(600, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xyz = np.concatenate([d, rng.uniform(-3, 3, (20, 3))]).astype(np.float32)
    normals = np.concatenate([d, rng.normal(size=(20, 3))]).astype(np.float32)
    normals[:30] = rng.normal(size=(30, 3))  # off the surface's orientation
    colors = rng.uniform(size=(620, 3)).astype(np.float32)
    got = TP.clean_point_cloud(xyz, colors, normals)
    want = JP.clean_point_cloud(xyz, colors, normals)
    assert 500 < len(got[0]) < 620
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _t_scene(cameras_json):
    pcd = t_models.make({"name": "vanilla_pcd"}, device="cpu")
    pcd.load(PLY)
    pcd.active_sh_degree = 0
    return (pcd, t_renderers.make({"name": "vanilla_renderer"}, device="cpu"),
            [t_json_to_camera(cj, device="cpu") for cj in cameras_json])


def _hold_to_jax(xyz, colors, normals, want):
    assert len(xyz) > 1000
    np.testing.assert_array_equal(xyz, want[0])
    np.testing.assert_array_equal(colors, want[1])
    assert np.abs(normals - want[2]).max() <= NORMAL_TOL


def test_extract_surface_points_matches_jax(cameras_json, jax_run):
    """The same surface Gaussians (ids, hence points and colours, equal) and
    fused normals within 1e-4."""
    _hold_to_jax(*TP.extract_surface_points(*_t_scene(cameras_json), downsample=DOWNSAMPLE),
                 jax_run[2])


def test_cli_writes_the_fused_cloud_the_views_and_the_sap_mesh(cameras_json, jax_run, tmp_path):
    """gs-extract-pcd --device cpu on a PLY model: <model>_fused.ply (the
    JAX surface points), images/, normals/, masks/ and .cam files for each
    view, and a SAP mesh within F1 0.999 at half a SAP voxel of the JAX
    package's mesh_sap of the JAX points (or the same faces, where the two
    DPSR grids agree in sign)."""
    model = tmp_path / "scene.ply"
    shutil.copy(PLY, model)
    cams = tmp_path / "cameras.json"
    cams.write_text(json.dumps(cameras_json))
    out = tmp_path / "out"
    fused, mesh = t_cli.main(["-m", str(model), "-c", str(cams), "-o", str(out), "--resolution",
                              str(DOWNSAMPLE), "--device", "cpu"])
    assert fused == str(tmp_path / "scene_fused.ply") and mesh == str(out / "fused_mesh.ply")
    xyz, rgb, normals = fetch_ply(fused)
    j_xyz, j_rgb, j_normals = jax_run[2]
    _hold_to_jax(xyz, np.round(rgb * 255), normals,
                 (j_xyz, (j_rgb * 255).astype(np.uint8), j_normals))
    names = [cj["img_name"] for cj in cameras_json]
    for sub in ("images", "normals", "masks"):
        assert sorted(n for n in os.listdir(out / sub) if n.endswith(".png")) == sorted(
            f"{n}.png" for n in names)
    assert sorted(n for n in os.listdir(out / "images") if n.endswith(".cam")) == sorted(
        f"{n}.cam" for n in names)
    assert load_rgb8(str(out / "normals" / f"{names[0]}.png")).shape == (64, 64, 3)
    assert set(np.unique(load_grey8(str(out / "masks" / f"{names[0]}.png")))) <= {0, 255}

    jv, jf = JP.mesh_sap(jax_run[2][0], jax_run[2][2])
    tv, tf = load_mesh(mesh)
    assert len(tf) > 1000
    voxel = (float(np.max(xyz.max(0) - xyz.min(0))) * 1.2 + 1e-6) / 128
    if len(tf) == len(jf) and np.array_equal(tf, jf):  # the grids agree in sign
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-3 * voxel)
    else:
        f1 = mesh_f1_score(tv, tf, jv, jf, tau=0.5 * voxel, n_samples=400_000)
        assert f1["f1"] >= 0.999, f1


def test_cli_with_surfels_writes_a_cloud_and_no_mesh(cameras_json, tmp_path):
    """--config 2dgs --meshing None on three views: the surfel renderer's
    median ids."""
    cams = tmp_path / "cameras.json"
    cams.write_text(json.dumps(cameras_json[:3]))
    model = tmp_path / "scene.ply"
    shutil.copy(PLY, model)
    fused, mesh = t_cli.main(["-m", str(model), "-c", str(cams), "-o", str(tmp_path / "out"),
                              "--config", "2dgs", "--resolution", str(DOWNSAMPLE), "--meshing",
                              "None", "--device", "cpu"])
    xyz, _, normals = fetch_ply(fused)
    assert mesh is None and len(xyz) > 300
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("rotated", [True, False], ids=["rotated", "axis_aligned"])
def test_invalid_normal_marker_passes_the_validity_test_off_the_axes(rotated):
    """The JAX order is kept: the -1 marker is set on camera normals, which
    are rotated to world space before the sum > -3 test. A view whose
    filtered depth is invalid everywhere marks every pixel; for a rotated
    camera every marker passes the test (in both packages), for an
    axis-aligned one none does."""
    a = 0.7 if rotated else 0.0
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    kw = dict(R=R, T=np.array([0.0, 0.0, 3.0]), FoVx=1.0, FoVy=1.0, image_width=12,
              image_height=10)
    out = {"rendered_final_opacity": torch.full((1, 10, 12), 0.6),
           "rendered_depth": torch.zeros((1, 10, 12)),
           "rendered_median_depth": torch.ones((1, 10, 12)),
           "rendered_median_id": torch.arange(120, dtype=torch.int32).reshape(1, 10, 12)}
    s = TP.surface_samples(out, TCamera(device="cpu", **kw), scene_radius=2.0)
    assert bool((s["cam_normals"] == -1).all())
    marker_world = np.asarray(JCamera(**kw).normal2worldnormal(-jnp.ones((10, 12, 3))))
    jax_valid = marker_world.sum(-1) > -3
    np.testing.assert_array_equal(s["valid"].numpy(), jax_valid)
    assert bool(s["valid"].all()) is rotated and bool(s["valid"].any()) is rotated
    assert len(s["ids"]) == (120 if rotated else 0)


@pytest.mark.parametrize("backend", ["nksr", "poisson", "pymeshlab"])
def test_external_meshing_backends_name_their_package(backend, tmp_path):
    pts = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    calls = {"nksr": lambda: TP.mesh_nksr(pts, pts, device="cpu"),
             "poisson": lambda: TP.mesh_poisson(pts, pts, pts),
             "pymeshlab": lambda: TP.mesh_pymeshlab_poisson(str(tmp_path / "none.ply"))}
    with pytest.raises(ImportError, match=f"install {'open3d' if backend == 'poisson' else backend}"):
        calls[backend]()
