"""DPSR (Shape-As-Points) through the port on the CPU against the JAX
package on the same seeded inputs: the frequency grid and spectral filter,
the trilinear scatter and gather (and their adjointness), the Poisson solve
within 1e-5 x max|phi|, the PSR2Mesh backward against jax.grad, marching
the indicator, and ShapeAsPoints from a point cloud and from a mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustudio_torch import models as t_models
from gaustudio_torch.models.sap import ShapeAsPoints as TSap
from gaustudio_torch.ops import dpsr as T
from gaustudio_torch.utils.mesh import mesh_f1_score
from gaustudio_tpu.models.sap import ShapeAsPoints as JSap
from gaustudio_tpu.ops import dpsr as J
from gaustudio_tpu.ops import mcubes as j_mcubes

RESOLUTIONS = [(32, 32, 32), (64, 64, 64), (24, 40, 32)]


def _oriented_sphere(n=3000, r=0.3, noise=0.01, seed=0):
    """Noisy points on a sphere off the grid's centre, with radial normals."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = np.array([0.48, 0.52, 0.5]) + d * r + rng.normal(size=d.shape) * noise
    return pts.astype(np.float32), d.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("res", RESOLUTIONS[:1] + RESOLUTIONS[2:])
def test_frequencies_and_spectral_filter_match_jax(res):
    np.testing.assert_array_equal(T.fftfreqs(res).numpy(), np.asarray(J.fftfreqs(res)))
    np.testing.assert_allclose(T.spec_gaussian_filter(res, 2.0).numpy(),
                               np.asarray(J.spec_gaussian_filter(res, 2.0)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_point_rasterize_and_grid_interp_match_jax_and_are_adjoint(weighted):
    rng = np.random.default_rng(1)
    size = (16, 12, 20)
    pts = rng.uniform(0.02, 0.98, (200, 3)).astype(np.float32)
    vals = rng.normal(size=(200, 2)).astype(np.float32)
    grid = rng.normal(size=size + (2,)).astype(np.float32)
    ras = T.point_rasterize(_t(pts), _t(vals), size, weighted=weighted).numpy()
    np.testing.assert_allclose(
        ras, np.asarray(J.point_rasterize(jnp.asarray(pts), jnp.asarray(vals), size,
                                          weighted=weighted)), rtol=1e-5, atol=1e-6)
    interp = T.grid_interp(_t(grid), _t(pts)).numpy()
    np.testing.assert_allclose(interp, np.asarray(J.grid_interp(jnp.asarray(grid),
                                                                jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-6)
    if not weighted:  # <rasterize(p, v), g> == <v, interp(g, p)>
        np.testing.assert_allclose(float(np.sum(np.moveaxis(ras, 0, -1) * grid)),
                                   float(np.sum(interp * vals)), rtol=1e-4)


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_dpsr_solve_matches_jax(res):
    pts, normals = _oriented_sphere()
    want = np.asarray(J.dpsr_solve(jnp.asarray(pts), jnp.asarray(normals), res, sig=2.0))
    got = T.dpsr_solve(_t(pts), _t(normals), res, sig=2.0).numpy()
    assert got.shape == res
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    centre = tuple(int(0.5 * r) for r in res)
    assert got[centre] < 0 < got[0, 0, 0]  # negative inside


def test_psr2mesh_backward_matches_jax_grad():
    """The grid gradient of a loss on the vertices is the normal-weighted
    scatter of the vertex gradient; the identity in the forward."""
    rng = np.random.default_rng(2)
    grid = rng.normal(size=(16, 16, 16)).astype(np.float32)
    verts = rng.uniform(0.05, 0.95, (60, 3)).astype(np.float32)
    normals = rng.normal(size=(60, 3)).astype(np.float32)
    target = rng.normal(size=(60, 3)).astype(np.float32)

    def j_loss(g):
        v = J.psr_to_mesh_grid_grad(g, jnp.asarray(verts), jnp.asarray(normals))
        return jnp.sum((v - target) ** 2)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(grid)))
    g = _t(grid).requires_grad_()
    v = T.psr_to_mesh_grid_grad(g, _t(verts), _t(normals))
    np.testing.assert_array_equal(v.detach().numpy(), verts)
    ((v - _t(target)) ** 2).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).max() > 0


def test_mc_from_psr_matches_jax():
    pts, normals = _oriented_sphere()
    phi = np.asarray(J.dpsr_solve(jnp.asarray(pts), jnp.asarray(normals), (32, 32, 32), sig=2.0))
    jv, jf, jn = J.mc_from_psr(np.tanh(phi))
    tv, tf, tn = T.mc_from_psr(torch.tanh(_t(phi)))
    assert len(jf) > 1000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    np.testing.assert_allclose(tn, jn, atol=1e-5)


def _sphere_mesh():
    lin = np.linspace(-1, 1, 24, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return j_mcubes.marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - 0.5, 0.0,
                                        origin=np.full(3, -1.0), voxel_size=lin[1] - lin[0])


def _same_mesh(t_mesh, j_mesh, voxel):
    """Faces equal (with vertices within 1e-5 of the extent) where the grids
    agree in sign, else F1 >= 0.999 at half a voxel."""
    (tv, tf), (jv, jf) = t_mesh, j_mesh
    assert len(tf) > 1000
    if len(tf) == len(jf) and np.array_equal(tf, jf):
        np.testing.assert_allclose(tv, jv, atol=1e-5 * voxel * 128)
    else:
        f1 = mesh_f1_score(tv, tf, jv, jf, tau=0.5 * voxel, n_samples=200_000)
        assert f1["f1"] >= 0.999, f1


def test_sap_from_pointcloud_matches_jax():
    pts, normals = _oriented_sphere(2000)
    world = (pts - 0.5) * 4.0 + np.array([1.0, 2.0, 3.0], np.float32)
    cfg = {"grid_res": 64, "psr_sigma": 2.0}
    jsap = JSap.from_pointcloud(world, normals, cfg)
    tsap = TSap.from_pointcloud(world, normals, cfg, device="cpu")
    np.testing.assert_allclose(tsap._xyz.numpy(), np.asarray(jsap._xyz), atol=1e-6)
    np.testing.assert_allclose(tsap.unit_points.numpy(), jsap.unit_points, atol=1e-6)
    np.testing.assert_allclose(tsap._center, jsap._center)
    assert tsap._scale_factor == jsap._scale_factor
    _same_mesh(tsap.generate_mesh(), jsap.generate_mesh(), tsap._scale_factor / 64)


def test_sap_from_mesh_matches_jax(tmp_path):
    verts, faces = _sphere_mesh()
    cfg = {"grid_res": 48}
    jsap = JSap.from_mesh(verts, faces, 5000, cfg, seed=3)
    tsap = t_models.make(dict(cfg, name="sap_pcd"), device="cpu").from_mesh(
        verts, faces, 5000, cfg, seed=3, device="cpu")
    np.testing.assert_allclose(tsap._xyz.numpy(), np.asarray(jsap._xyz), atol=1e-6)
    np.testing.assert_array_equal(tsap._normal.numpy(), np.asarray(jsap._normal))
    _same_mesh(tsap.generate_mesh(), jsap.generate_mesh(), tsap._scale_factor / 48)
    tsap.export(str(tmp_path / "sap.ply"))
    assert (tmp_path / "sap.ply").stat().st_size > 1000
