"""The mesh rasterizer and the mesh CLIs through the port on the CPU against
the JAX package: one triangle, occlusion and attribute interpolation (after
tests/test_mesh_raster.py), a seeded mesh at a size with partial tiles, the
JAX package's entry capacity (which drops triangles, where the port keeps
them), the viridis table against matplotlib, and gs-render-mesh and
gs-texture-mesh against the JAX CLIs.

The JAX rasterizer scans its whole entry buffer (1 << 20 entries by default)
in chunks; the JAX CLIs are run with a buffer of 1 << 14, which holds every
entry of the test's mesh, to stay fast on the CPU."""

import functools
import json
import os
import sys

import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from gaustudio_torch.ops import mesh_raster as T
from gaustudio_torch.scripts import render_mesh as t_render_mesh
from gaustudio_torch.scripts import texture_mesh as t_texture_mesh
from gaustudio_torch.utils import depth as t_depth
from gaustudio_torch.utils.image import load_rgb8, save_image
from gaustudio_torch.utils.ply import read_ply
from gaustudio_tpu.cameras import Camera as JCamera
from gaustudio_tpu.cameras import camera_paths
from gaustudio_tpu.datasets.utils import camera_to_JSON
from gaustudio_tpu.ops import mcubes as j_mcubes
from gaustudio_tpu.ops import mesh_raster as J
from gaustudio_tpu.scripts import render_mesh as j_render_mesh
from gaustudio_tpu.scripts import texture_mesh as j_texture_mesh
from gaustudio_tpu.utils import depth as j_depth
from gaustudio_tpu.utils.mesh import save_mesh

JAX_ENTRIES = dict(num_entries=1 << 14, chunk=1024)


def _cam(w=64, h=48, R=np.eye(3)):
    return JCamera(R=R, T=np.array([0.0, 0.0, 3.0]), FoVx=1.0, FoVy=0.8 * h / w * 1.25,
                   image_width=w, image_height=h)


def _both(verts, faces, cam, **jax_kw):
    """(JAX fragments as numpy, port fragments as numpy) of one camera."""
    w, h = cam.image_width, cam.image_height
    j = J.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces),
                         jnp.asarray(cam.world_view_transform),
                         jnp.asarray(cam.full_proj_transform), w, h, **(jax_kw or JAX_ENTRIES))
    t = T.rasterize_mesh(torch.from_numpy(verts), torch.from_numpy(faces),
                         torch.from_numpy(np.array(cam.world_view_transform)),
                         torch.from_numpy(np.array(cam.full_proj_transform)), w, h)
    return ({k: np.asarray(getattr(j, k)) for k in j._fields},
            {k: getattr(t, k).numpy() for k in t._fields})


TRIANGLE = np.array([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.6, 0.0]], np.float32)
FAR_TRIANGLE = np.array([[-0.7, -0.7, 1.0], [0.7, -0.7, 1.0], [0.0, 0.8, 1.0]], np.float32)


def _assert_same(j, t):
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_array_equal(t["tri_id"], j["tri_id"])
    np.testing.assert_allclose(t["depth"], j["depth"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(t["bary"], j["bary"], atol=1e-4)


def test_single_triangle():
    j, t = _both(TRIANGLE, np.array([[0, 1, 2]], np.int32), _cam())
    _assert_same(j, t)
    mask = t["mask"]
    assert mask.sum() > 50 and mask[20, 32] and t["tri_id"][20, 32] == 0
    np.testing.assert_allclose(t["depth"][mask], 3.0, atol=1e-3)
    np.testing.assert_allclose(t["bary"][mask].sum(-1), 1.0, atol=1e-4)
    assert (t["bary"][mask] > -1e-4).all()
    assert (t["tri_id"][~mask] == -1).all() and (t["depth"][~mask] == 0).all()


def test_occlusion_order():
    verts = np.concatenate([TRIANGLE, FAR_TRIANGLE])
    j, t = _both(verts, np.array([[0, 1, 2], [3, 4, 5]], np.int32), _cam())
    _assert_same(j, t)
    assert t["tri_id"][20, 32] == 0 and (t["tri_id"] == 1).sum() > 10
    np.testing.assert_allclose(t["depth"][t["tri_id"] == 1], 4.0, atol=2e-3)


def test_attribute_interpolation_and_face_normals():
    faces = np.array([[0, 1, 2]], np.int32)
    colors = np.eye(3, dtype=np.float32)
    cam = _cam()
    jf = J.rasterize_mesh(jnp.asarray(TRIANGLE), jnp.asarray(faces),
                          jnp.asarray(cam.world_view_transform),
                          jnp.asarray(cam.full_proj_transform), 64, 48, **JAX_ENTRIES)
    tf = T.rasterize_mesh(torch.from_numpy(TRIANGLE), torch.from_numpy(faces),
                          torch.from_numpy(np.array(cam.world_view_transform)),
                          torch.from_numpy(np.array(cam.full_proj_transform)), 64, 48)
    want = np.asarray(J.interpolate_attribute(jf, jnp.asarray(faces), jnp.asarray(colors)))
    got = T.interpolate_attribute(tf, torch.from_numpy(faces), torch.from_numpy(colors)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got[tf.mask.numpy()].sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        T.face_normals(torch.from_numpy(TRIANGLE), torch.from_numpy(faces)).numpy(),
        np.asarray(J.face_normals(jnp.asarray(TRIANGLE), jnp.asarray(faces))), atol=1e-7)


def _seeded_mesh(n_faces=300, seed=0):
    """Random triangles in front of the camera, overlapping in depth."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1, 1, (n_faces, 1, 3)) * [1.0, 0.8, 0.8]
    verts = (centres + rng.normal(size=(n_faces, 3, 3)) * 0.15).reshape(-1, 3)
    return verts.astype(np.float32), np.arange(3 * n_faces).reshape(-1, 3).astype(np.int32)


def _screen(verts, cam):
    """float64 screen positions [V, 2] and view z [V]."""
    v = np.concatenate([verts.astype(np.float64), np.ones((len(verts), 1))], 1)
    hom = v @ np.asarray(cam.full_proj_transform, np.float64)
    ndc = hom[:, :2] / (hom[:, 3:4] + 1e-9)
    size = np.array([cam.image_width, cam.image_height])
    return ((ndc + 1) * size - 1) / 2, (v @ np.asarray(cam.world_view_transform, np.float64))[:, 2]


def _is_tie(verts, faces, cam, y, x, tris):
    """The pixel centre lies within 1e-3 px of an edge of one of ``tris``,
    where float rounding decides the inside test."""
    s, _ = _screen(verts, cam)
    p = np.array([x, y], np.float64)
    for t in (t for t in tris if t >= 0):
        c = s[faces[t]]
        for a, b in ((0, 1), (1, 2), (2, 0)):
            d = c[b] - c[a]
            u = np.clip(np.dot(p - c[a], d) / np.dot(d, d), 0, 1)
            if np.linalg.norm(c[a] + u * d - p) < 1e-3:
                return True
    return False


@pytest.mark.parametrize("size", [(100, 75), (37, 53)])
def test_seeded_mesh_matches_jax(size):
    """Partial tiles at both packages' tile sizes: coverage and depth within
    1e-5 relative, the same triangle ids except at ties."""
    verts, faces = _seeded_mesh()
    cam = _cam(*size, R=np.array([[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1.0]]))
    j, t = _both(verts, faces, cam)
    differ = np.argwhere((t["mask"] != j["mask"]) | (t["tri_id"] != j["tri_id"]))
    for y, x in differ:
        assert _is_tie(verts, faces, cam, y, x, (t["tri_id"][y, x], j["tri_id"][y, x])), (y, x)
    assert len(differ) <= 2 and t["mask"].sum() > 0.15 * size[0] * size[1]
    same = (t["tri_id"] == j["tri_id"]) & t["mask"]
    np.testing.assert_allclose(t["depth"][same], j["depth"][same], rtol=1e-5, atol=0)
    np.testing.assert_allclose(t["bary"][same], j["bary"][same], atol=1e-4)


def test_port_keeps_the_triangles_past_the_jax_capacity():
    """The JAX rasterizer keeps the first ``num_entries`` (triangle, tile)
    entries and drops the rest, triangles and all; the port sizes its
    candidates from the count. Here a buffer of 1024 entries loses the last
    triangles of the mesh (tens of them visible) in the JAX package, while the
    port matches the JAX output with room for every entry."""
    verts, faces = _seeded_mesh(600, seed=1)
    cam = _cam(96, 72)
    short, t = _both(verts, faces, cam, num_entries=1024, chunk=256)
    full, _ = _both(verts, faces, cam)
    assert short["mask"].sum() < full["mask"].sum()
    lost = np.setdiff1d(np.unique(full["tri_id"]), np.unique(short["tri_id"]))
    assert len(lost) > 50
    np.testing.assert_array_equal(t["mask"], full["mask"])
    assert np.isin(lost, t["tri_id"]).all()


def test_viridis_matches_matplotlib_and_the_jax_colormap():
    x = np.linspace(0, 1, 100_001, dtype=np.float32)[None]
    np.testing.assert_array_equal(t_depth.apply_depth_colormap(x, 0.0, 1.0),
                                  plt.cm.viridis(np.clip(x / (1 + 1e-10), 0, 1))[..., :3])
    depth = np.random.default_rng(5).uniform(1, 5, (33, 41)).astype(np.float32)
    got = t_depth.apply_depth_colormap(torch.from_numpy(depth))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, j_depth.apply_depth_colormap(depth))


def test_least_squares_scale_and_shift_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.uniform(0.5, 2, (16, 20))
    target = 2.5 * pred - 0.3 + rng.normal(size=pred.shape) * 0.01
    mask = rng.uniform(size=pred.shape) > 0.3
    got = t_depth.compute_scale_and_shift_ls(torch.from_numpy(pred), target, mask)
    np.testing.assert_allclose(got, j_depth.compute_scale_and_shift_ls(pred, target, mask),
                               rtol=1e-12)
    assert abs(got[0] - 2.5) < 0.01
    assert t_depth.compute_scale_and_shift_ls(pred, target, np.zeros_like(mask)) == (0.0, 0.0)


@pytest.fixture(scope="module")
def mesh_scene(tmp_path_factory):
    """A coloured sphere mesh, six orbit cameras 20 degrees above its
    equator at 64x48 (off the axes: no pixel centre sits on an edge), and a
    seeded image for each."""
    root = tmp_path_factory.mktemp("mesh_scene")
    lin = np.linspace(-1, 1, 24, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    verts, faces = j_mcubes.marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - 0.45, 0.0,
                                                origin=np.full(3, -1.0),
                                                voxel_size=lin[1] - lin[0])
    mesh = str(root / "sphere.ply")
    save_mesh(mesh, verts, faces, vertex_colors=np.abs(verts) / np.abs(verts).max())
    cams = camera_paths.get_path_from_orbit(np.zeros(3), 1.8, elevation=20, num_cam=6,
                                            image_size=64, fov_deg=60)
    entries = []
    for i, c in enumerate(cams):
        cj = camera_to_JSON(i, c)
        entries.append(dict(cj, height=48, fy=cj["fx"], cy=24))
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    for cj in entries:
        save_image(str(root / "images" / f"{cj['img_name']}.png"), rng.uniform(size=(48, 64, 3)))
    (root / "cameras.json").write_text(json.dumps(entries))
    return root, mesh, str(root / "cameras.json"), len(verts)


def _run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(J, "rasterize_mesh", functools.partial(J.rasterize_mesh, **JAX_ENTRIES))
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def test_render_mesh_cli_matches_jax(mesh_scene, tmp_path, monkeypatch):
    """Every PNG within 1/255 of the JAX CLI's, the .cam files byte for byte."""
    _, mesh, cams, _ = mesh_scene
    t_out, j_out = tmp_path / "port", tmp_path / "jax"
    assert t_render_mesh.main(["-m", mesh, "-c", cams, "-o", str(t_out), "--color", "--device",
                               "cpu"]) == str(t_out)
    _run_jax_cli(j_render_mesh, ["-m", mesh, "-c", cams, "-o", str(j_out), "--color"], monkeypatch)
    for sub in ("color", "depth", "normal"):
        names = sorted(os.listdir(t_out / sub))
        assert names == sorted(os.listdir(j_out / sub))
        assert len([n for n in names if n.endswith(".png")]) == 6
        for name in names:
            if name.endswith(".cam"):
                assert (t_out / sub / name).read_bytes() == (j_out / sub / name).read_bytes()
                continue
            got = load_rgb8(str(t_out / sub / name)).astype(int)
            want = load_rgb8(str(j_out / sub / name)).astype(int)
            assert np.abs(got - want).max() <= 1, (sub, name)


def test_texture_mesh_cli_matches_jax(mesh_scene, tmp_path, monkeypatch):
    """The baked vertex colours within 1/255 of the JAX CLI's, with the
    same covered share."""
    _, mesh, cams, n_verts = mesh_scene
    path, covered = t_texture_mesh.main(["-m", mesh, "-c", cams, "-o", str(tmp_path / "t.ply"),
                                         "--device", "cpu"])
    _run_jax_cli(j_texture_mesh, ["-m", mesh, "-c", cams, "-o", str(tmp_path / "j.ply")],
                 monkeypatch)
    got, want = read_ply(path)["vertex"], read_ply(str(tmp_path / "j.ply"))["vertex"]
    assert len(got["x"]) == n_verts and 0.5 < covered < 1.0
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("red", "green", "blue"):
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k
