"""The mesh initializers and gs-from-mesh through the port on the CPU
against the JAX package: normal2rotation, SuGaR placement at 1, 3, 4 and 6
Gaussians a triangle, surface voxels, TSDF fusion of a dataset's depth maps,
the CLI's PLY property by property, and a render of it by both packages."""

import sys

import numpy as np
import pytest
import torch

from gaustudio_torch import models as t_models
from gaustudio_torch import renderers as t_renderers
from gaustudio_torch.cameras import Camera as TCamera
from gaustudio_torch.ops import mesh_raster as t_mesh_raster
from gaustudio_torch.pipelines import initializers as t_init
from gaustudio_torch.pipelines.initializers import base as t_base
from gaustudio_torch.scripts import mesh2gs as t_cli
from gaustudio_torch.utils.ply import read_ply
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.cameras import Camera as JCamera
from gaustudio_tpu.ops import mcubes as j_mcubes
from gaustudio_tpu.pipelines import initializers as j_init
from gaustudio_tpu.pipelines.initializers import base as j_base
from gaustudio_tpu.scripts import mesh2gs as j_cli
from gaustudio_tpu.utils.mesh import save_mesh
from tests.test_torch_variants import render_both

ATTRS = ("xyz", "f_dc", "f_rest", "scale", "rot", "opacity")


def _sphere_mesh(radius=0.5, n=20):
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return j_mcubes.marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - radius, 0.0,
                                        origin=np.full(3, -1.0), voxel_size=lin[1] - lin[0])


def _assert_models_equal(t, j, atol=1e-6, attrs=ATTRS):
    assert t.num_points == j.num_points
    for attr in attrs:
        np.testing.assert_allclose(getattr(t, "_" + attr).numpy(), np.asarray(getattr(j, "_" + attr)),
                                   rtol=1e-6, atol=atol, err_msg=attr)


def test_normal2rotation_matches_jax():
    rng = np.random.default_rng(0)
    n = np.concatenate([rng.normal(size=(50, 3)), np.eye(3), -np.eye(3)])
    got = t_base.normal2rotation(n)
    np.testing.assert_array_equal(got, j_base.normal2rotation(n))
    R = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0])])
    np.testing.assert_array_equal(t_base.rotmat2quaternion(R, normalize=True),
                                  j_base.rotmat2quaternion(R, normalize=True))
    assert np.asarray(t_base.inverse_sigmoid_np(np.float32(0.25))) == np.log(1 / 3, dtype=np.float32)


@pytest.mark.parametrize("npg", [1, 3, 4, 6])
def test_mesh_initializer_matches_jax(npg):
    verts, faces = _sphere_mesh()
    colors = np.abs(verts) / np.abs(verts).max()
    cfg = {"name": "mesh", "n_gaussians_per_triangle": npg}
    t = t_init.make(cfg)(t_models.make({"name": "vanilla_pcd"}, device="cpu"),
                         mesh=(verts, faces, colors))
    j = j_init.make(cfg)(j_models.make({"name": "vanilla_pcd"}), mesh=(verts, faces, colors))
    _assert_models_equal(t, j)
    assert t.num_points == npg * len(faces)
    assert (t._scale[:, 2] < -10).all()  # flat along the normal


def test_mesh_initializer_refuses_other_counts():
    with pytest.raises(ValueError, match="n_gaussians_per_triangle"):
        t_init.make({"name": "mesh", "n_gaussians_per_triangle": 2})


def test_voxel_initializer_matches_jax():
    verts, faces = _sphere_mesh()
    cfg = {"name": "voxel", "voxel_size": 0.1}
    t = t_init.make(cfg)(t_models.make({"name": "vanilla_pcd"}, device="cpu"), mesh=(verts, faces))
    j = j_init.make(cfg)(j_models.make({"name": "vanilla_pcd"}), mesh=(verts, faces))
    _assert_models_equal(t, j)
    assert t.num_points > 100


def test_tsdf_initializer_matches_jax():
    """Four views of a sphere's depth (rasterized by the port) fused by both
    packages: the same faces, vertices within 1e-5 (marching's tolerance in
    tests/test_torch_extract_mesh.py), and Gaussians at the same places. The
    discs' sizes and orientations follow from the mesh as
    test_mesh_initializer_matches_jax holds them; a sliver triangle's
    shortest edge and normal magnify its vertices' rounding."""
    verts, faces = _sphere_mesh()
    t_cams, j_cams = [], []
    for a in np.linspace(0, 2 * np.pi, 4, endpoint=False) + 0.3:
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        kw = dict(R=R, T=np.array([0.0, 0.0, 2.5]), FoVx=1.0, FoVy=1.0, image_width=40,
                  image_height=40)
        tc, jc = TCamera(device="cpu", **kw), JCamera(**kw)
        tc.depth = t_mesh_raster.rasterize_mesh(
            torch.from_numpy(verts), torch.from_numpy(faces), tc.world_view_transform,
            tc.full_proj_transform, 40, 40).depth
        jc.depth = tc.depth.numpy()
        t_cams.append(tc)
        j_cams.append(jc)
    cfg = {"name": "tsdf", "voxel_length": 0.05, "sdf_trunc": 0.2}
    t_tsdf, j_tsdf = t_init.make(cfg, device="cpu"), j_init.make(cfg)
    t = t_tsdf(t_models.make({"name": "vanilla_pcd"}, device="cpu"), t_cams)
    j = j_tsdf(j_models.make({"name": "vanilla_pcd"}), j_cams)
    assert len(t_tsdf.mesh[1]) > 200
    np.testing.assert_array_equal(t_tsdf.mesh[1], j_tsdf.mesh[1])
    np.testing.assert_allclose(t_tsdf.mesh[0], j_tsdf.mesh[0], rtol=0, atol=1e-5)
    _assert_models_equal(t, j, atol=1e-5, attrs=("xyz", "f_dc", "f_rest", "opacity"))


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh2gs")
    verts, faces = _sphere_mesh(0.6, 16)
    plain, coloured = str(root / "plain.ply"), str(root / "coloured.ply")
    save_mesh(plain, verts, faces)
    save_mesh(coloured, verts, faces, vertex_colors=np.abs(verts) / np.abs(verts).max())
    return {"plain": plain, "coloured": coloured, "faces": len(faces)}


@pytest.mark.parametrize("colours", ["plain", "coloured"])
def test_mesh2gs_ply_matches_the_jax_cli(colours, mesh_file, tmp_path, monkeypatch):
    """Every property of gs-from-mesh -n 3's PLY within 1e-6 of the JAX
    CLI's, SH degree 1 (9 f_rest columns)."""
    out = t_cli.main(["-m", mesh_file[colours], "-o", str(tmp_path / "t.ply"), "-n", "3",
                      "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["gs-from-mesh", "-m", mesh_file[colours], "-o",
                                      str(tmp_path / "j.ply"), "-n", "3"])
    j_cli.main()
    got, want = read_ply(out)["vertex"], read_ply(str(tmp_path / "j.ply"))["vertex"]
    assert list(got) == list(want)
    assert len(got["x"]) == 3 * mesh_file["faces"] and "f_rest_8" in got and "f_rest_9" not in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_both_packages_render_the_mesh2gs_ply_alike(mesh_file, tmp_path):
    """The flat Gaussians (log scale z = log(1e-7)) through both renderers:
    the float maps within 1e-5, radii exact.

    The JAX preprocess evaluates SH at degree 3 whatever the model's degree,
    so it cannot take the PLY's 4 coefficients a channel: the JAX model gets
    them padded with zero bands 2 and 3, which its active degree 1 masks."""
    path = t_cli.main(["-m", mesh_file["coloured"], "-o", str(tmp_path / "gs.ply"), "-n", "3",
                       "--device", "cpu"])
    t_pcd = t_models.make({"name": "vanilla_pcd", "sh_degree": 1}, device="cpu")
    j_pcd = j_models.make({"name": "vanilla_pcd"})
    for pcd in (t_pcd, j_pcd):
        pcd.load(path)
        pcd.active_sh_degree = 1
    rest = np.asarray(j_pcd._f_rest).reshape(-1, 3, 3)  # channel-major, bands 1 only
    j_pcd._f_rest = np.concatenate([rest, np.zeros((len(rest), 3, 12), np.float32)],
                                   axis=2).reshape(-1, 45)
    a = 0.4
    kw = dict(R=np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]]),
              T=np.array([0.0, 0.1, 2.2]), FoVx=1.0, FoVy=0.8, image_width=48, image_height=40)
    _, t_out = render_both(j_renderers.make({"name": "vanilla_renderer"}),
                           t_renderers.make({"name": "vanilla_renderer"}, device="cpu"),
                           JCamera(**kw), TCamera(device="cpu", **kw), j_pcd, t_pcd)
    assert torch.isfinite(t_out["render"]).all()
    assert float((t_out["rendered_final_opacity"] > 0.5).float().mean()) > 0.3
