"""Port parity of the mesh path's modules on the CPU: the camera additions,
the orbit path, the TSDF volume and its fusion, marching tetrahedra and the
mesh helpers (gaustudio_torch against gaustudio_tpu on the same inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustudio_torch.cameras import Camera as TCamera
from gaustudio_torch.cameras import camera_paths as t_paths
from gaustudio_torch.ops import mcubes as t_mcubes
from gaustudio_torch.ops import tsdf as t_tsdf
from gaustudio_torch.utils import mesh as t_mesh
from gaustudio_tpu.cameras import Camera as JCamera
from gaustudio_tpu.cameras import camera_paths as j_paths
from gaustudio_tpu.ops import mcubes as j_mcubes
from gaustudio_tpu.ops import tsdf as j_tsdf
from gaustudio_tpu.utils import mesh as j_mesh

CPU = torch.device("cpu")


def _pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q, rng.normal(size=3)


def _camera_pair(seed, W=20, H=14):
    rng = np.random.default_rng(seed)
    R, T = _pose(rng)
    kw = dict(R=R, T=T, FoVx=0.9 + 0.1 * seed, FoVy=0.7, image_width=W, image_height=H,
              principal_point_ndc=(0.45, 0.55))
    return JCamera(**kw), TCamera(**kw, device="cpu")


def _depth(seed, W=20, H=14):
    rng = np.random.default_rng(100 + seed)
    d = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    d[rng.uniform(size=(H, W)) < 0.1] = 0.0
    return d


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


CAMERA_CHECKS = ("fx_fy_extrinsics", "extrinsics_setter", "update_intrinsics", "insideView",
                 "depth2point", "depth2normal", "normal_transforms")


@pytest.mark.parametrize("what", CAMERA_CHECKS)
@pytest.mark.parametrize("seed", [0, 1])
def test_camera_additions_match_jax(what, seed):
    jc, tc = _camera_pair(seed)
    depth = _depth(seed)
    if what == "fx_fy_extrinsics":
        assert tc.extrinsics.dtype == torch.float32
        np.testing.assert_array_equal(_np(tc.extrinsics), np.asarray(jc.extrinsics))
        np.testing.assert_array_equal(_np(tc.fx), np.asarray(jc.fx))
        np.testing.assert_array_equal(_np(tc.fy), np.asarray(jc.fy))
    elif what == "extrinsics_setter":
        E = np.asarray(_camera_pair(seed + 7)[0].extrinsics)
        jc.extrinsics = E
        tc.extrinsics = torch.from_numpy(E)
        np.testing.assert_array_equal(_np(tc.extrinsics), np.asarray(jc.extrinsics))
        np.testing.assert_array_equal(_np(tc.full_proj_transform), jc.full_proj_transform)
    elif what == "update_intrinsics":
        K = np.array([[30.0, 0, 12], [0, 25.0, 8], [0, 0, 1]], np.float32)
        jc.update_intrinsics(K, 24, 16)
        tc.update_intrinsics(torch.from_numpy(K), 24, 16)
        assert (tc.image_width, tc.image_height) == (jc.image_width, jc.image_height)
        assert tc.FoVx == pytest.approx(float(jc.FoVx), abs=1e-12)
        np.testing.assert_array_equal(_np(tc.intrinsics), np.asarray(jc.intrinsics))
    elif what == "insideView":
        rng = np.random.default_rng(seed)
        center = np.asarray(jc.camera_center, np.float64)
        fwd = np.asarray(jc.extrinsics)[2, :3]
        pts = (center + 2.0 * fwd + rng.normal(size=(400, 3))).astype(np.float32)
        mask = (rng.uniform(size=(14, 20)) > 0.3).astype(np.float32)
        want = np.asarray(jc.insideView(pts, mask))
        got = _np(tc.insideView(pts, mask))
        assert 50 < want.sum() < 400
        np.testing.assert_array_equal(got, want)
    elif what == "depth2point":
        for coord in ("ndc", "camera", "world"):
            np.testing.assert_allclose(_np(tc.depth2point(depth, coord)),
                                       np.asarray(jc.depth2point(depth, coord)),
                                       atol=1e-5, rtol=1e-5, err_msg=coord)
    elif what == "depth2normal":
        for coord in ("camera", "world"):
            want = np.asarray(jc.depth2normal(depth, coordinate=coord))
            got = _np(tc.depth2normal(depth, coordinate=coord))
            assert (want == -1).all(-1).sum() > 0  # the holes' neighbours are invalid
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=coord)
    else:
        n = np.random.default_rng(seed).normal(size=(14, 20, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(tc.normal2worldnormal(n)),
                                   np.asarray(jc.normal2worldnormal(n)), atol=1e-5)
        np.testing.assert_allclose(_np(tc.worldnormal2normal(n)),
                                   np.asarray(jc.worldnormal2normal(n)), atol=1e-5)


def test_downsample_resizes_background_normal_and_depth_as_jax():
    rng = np.random.default_rng(3)
    jc, tc = _camera_pair(0, W=40, H=28)
    img = rng.uniform(size=(28, 40, 3)).astype(np.float32)
    nrm = rng.uniform(size=(28, 40, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, size=(28, 40)).astype(np.float32)
    jc.bg_image, jc.normal, jc.depth = img, nrm, depth
    tc.bg_image, tc.normal, tc.depth = (torch.from_numpy(a) for a in (img, nrm, depth))
    jc.downsample_scale(3)
    tc.downsample_scale(3)
    np.testing.assert_allclose(_np(tc.bg_image), jc.bg_image, atol=1 / 255 + 1e-6)
    np.testing.assert_allclose(_np(tc.normal), jc.normal, atol=1 / 255 + 1e-6)
    np.testing.assert_array_equal(_np(tc.depth), jc.depth)


def test_get_path_from_orbit_matches_jax():
    want = j_paths.get_path_from_orbit(np.array([0.1, -0.2, 0.3]), 2.5, num_cam=12,
                                       image_size=48, fov_deg=60)
    got = t_paths.get_path_from_orbit(np.array([0.1, -0.2, 0.3]), 2.5, num_cam=12,
                                      image_size=48, fov_deg=60, device="cpu")
    assert len(got) == len(want) == 12
    for j, t in zip(want, got):
        assert t.image_name == j.image_name and t.FoVx == j.FoVx
        np.testing.assert_array_equal(t.R, j.R)
        np.testing.assert_array_equal(t.T, j.T)
        for field in ("world_view_transform", "full_proj_transform", "camera_center"):
            np.testing.assert_allclose(_np(getattr(t, field)), np.asarray(getattr(j, field)),
                                       atol=1e-6)
        np.testing.assert_array_equal(_np(t.extrinsics), np.asarray(j.extrinsics))


@pytest.mark.parametrize("extent", [1.4, 9.0], ids=["plain", "coarsened"])
def test_volume_from_bounds_matches_jax(extent):
    lo, hi = [-0.7, -0.3, -0.5], [-0.7 + extent, 0.6, 0.4]
    want = j_tsdf.volume_from_bounds(lo, hi, 0.025, 0.1, max_dim=96)
    got = t_tsdf.volume_from_bounds(lo, hi, 0.025, 0.1, max_dim=96, device="cpu")
    assert tuple(got.tsdf.shape) == want.tsdf.shape
    assert (max(want.tsdf.shape) == 96) == (extent > 2)
    for field in ("tsdf", "weight", "origin", "voxel_size", "sdf_trunc"):
        np.testing.assert_array_equal(_np(getattr(got, field)), np.asarray(getattr(want, field)))


def test_integrate_points_bounds_matches_jax():
    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    pts[7] = np.nan
    want = j_tsdf.integrate_points_bounds(pts)
    got = t_tsdf.integrate_points_bounds(torch.from_numpy(pts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _fusion_views():
    """Three seeded 40x30 views, 30 degrees apart, of a noisy sphere, 10% of
    the pixels holes."""
    cams = j_paths.get_path_from_orbit(np.zeros(3), 2.0, num_cam=12, image_size=40,
                                       fov_deg=60)[:3]
    views = []
    for i, cam in enumerate(cams):
        cam = cam.downsample((40, 30))
        rng = np.random.default_rng(i)
        K = cam.intrinsics
        ii, jj = np.meshgrid(np.arange(30), np.arange(40), indexing="ij")
        dirs = np.stack([(jj - K[0, 2]) / K[0, 0], (ii - K[1, 2]) / K[1, 1],
                         np.ones_like(ii, np.float64)], -1)
        E = np.asarray(cam.extrinsics, np.float64)
        Rcw = E[:3, :3].T
        o = -Rcw @ E[:3, 3]
        d = dirs @ Rcw.T
        b, a = (d * o).sum(-1), (d * d).sum(-1)
        disc = b * b - a * ((o * o).sum() - 0.6 ** 2)
        depth = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / a, 0.0)
        depth = (depth + rng.normal(size=depth.shape) * 0.005 * (depth > 0)).astype(np.float32)
        depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
        views.append((depth, np.asarray(cam.intrinsics), np.asarray(cam.extrinsics)))
    return views


@pytest.mark.parametrize("slab_voxels", [t_tsdf.SLAB_VOXELS, 48 * 48 * 5],
                         ids=["one_slab", "x_slabs"])
def test_integrate_three_views_matches_jax(slab_voxels, monkeypatch):
    monkeypatch.setattr(t_tsdf, "SLAB_VOXELS", slab_voxels)
    views = _fusion_views()
    jvol = j_tsdf.create_volume(np.full(3, -0.94), (48, 48, 48), 0.04, 0.12)
    tvol = t_tsdf.create_volume(np.full(3, -0.94), (48, 48, 48), 0.04, 0.12, device="cpu")
    for depth, K, E in views:
        jvol = j_tsdf.integrate(jvol, jnp.asarray(depth), jnp.asarray(K), jnp.asarray(E))
        tvol = t_tsdf.integrate(tvol, torch.from_numpy(depth), torch.from_numpy(K),
                                torch.from_numpy(E))
    w = np.asarray(jvol.weight)
    assert (w == 3).sum() > 500 and (w == 0).sum() > 1000
    np.testing.assert_array_equal(tvol.weight.numpy(), w)
    np.testing.assert_allclose(tvol.tsdf.numpy(), np.asarray(jvol.tsdf), atol=1e-5, rtol=0)


def test_jax_volume_continues_in_the_port():
    views = _fusion_views()
    jvol = j_tsdf.create_volume(np.full(3, -0.94), (48, 48, 48), 0.04, 0.12)
    for depth, K, E in views[:2]:
        jvol = j_tsdf.integrate(jvol, jnp.asarray(depth), jnp.asarray(K), jnp.asarray(E))
    tvol = t_tsdf.TSDFVolume.from_numpy(*(np.asarray(getattr(jvol, f)) for f in (
        "tsdf", "weight", "origin", "voxel_size", "sdf_trunc")), device="cpu")
    depth, K, E = views[2]
    jvol = j_tsdf.integrate(jvol, jnp.asarray(depth), jnp.asarray(K), jnp.asarray(E))
    t_tsdf.integrate(tvol, depth, K, E)
    np.testing.assert_array_equal(tvol.weight.numpy(), np.asarray(jvol.weight))
    np.testing.assert_allclose(tvol.tsdf.numpy(), np.asarray(jvol.tsdf), atol=1e-5, rtol=0)


def _noisy_field(n=36, seed=0):
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = np.sqrt(x * x + y * y + z * z) - 0.5 + 0.05 * rng.normal(size=x.shape)
    w = rng.uniform(size=x.shape) * 3
    return sdf.astype(np.float32), w.astype(np.float32), float(lin[1] - lin[0])


@pytest.mark.parametrize("weighted", [False, True], ids=["no_weight", "weight_mask"])
@pytest.mark.parametrize("slab", [4, 8])
def test_marching_tetrahedra_matches_jax(weighted, slab):
    sdf, w, h = _noisy_field()
    kw = dict(iso=0.0, origin=np.full(3, -1.0, np.float32), voxel_size=h, slab=slab)
    if weighted:
        kw.update(min_weight=0.5)
    vj, fj = j_mcubes.marching_tetrahedra(sdf, weight=w if weighted else None, **kw)
    vt, ft = t_mcubes.marching_tetrahedra(torch.from_numpy(sdf), weight=torch.from_numpy(
        w) if weighted else None, **kw)
    assert len(fj) > 1000
    assert vt.dtype == np.float32 and ft.dtype == np.int32
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, atol=1e-5, rtol=0)


def test_marching_tetrahedra_isosurface_accuracy():
    """The analytic-sphere check of tests/test_golden_e2e.py, on the port:
    vertices within a fraction of a voxel of the true surface, a complete
    and watertight surface, and F1 against an icosphere."""
    from scipy.spatial import cKDTree

    from test_golden_e2e import _icosphere_mesh

    n, r = 48, 0.62
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = np.sqrt(x * x + y * y + z * z) - r
    voxel = float(lin[1] - lin[0])
    verts, faces = t_mcubes.marching_tetrahedra(
        torch.from_numpy(sdf), 0.0, origin=np.full(3, -1.0, np.float32), voxel_size=voxel)
    assert len(verts) > 500 and len(faces) > 500
    rad_err = np.abs(np.linalg.norm(verts, axis=1) - r)
    assert float(rad_err.max()) < 0.25 * voxel
    assert float(rad_err.mean()) < 0.05 * voxel

    d = np.random.default_rng(0).normal(size=(20000, 3))
    sphere_pts = (d / np.linalg.norm(d, axis=1, keepdims=True) * r).astype(np.float32)
    surf = t_mesh.sample_mesh_surface(verts, faces, 120000, seed=1)
    assert float((cKDTree(surf).query(sphere_pts, k=1)[0] < 0.5 * voxel).mean()) > 0.999

    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                    axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()

    # outward winding, as tests/test_tsdf_mesh.py checks the JAX package's
    n_f = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]])
    assert ((n_f * verts[faces].mean(1)).sum(-1) > 0).mean() > 0.99

    ico_v, ico_f = _icosphere_mesh(r)
    assert t_mesh.mesh_f1_score(verts, faces, ico_v, ico_f, tau=0.5 * voxel)["f1"] > 0.995


def test_marching_tetrahedra_weight_mask():
    """tests/test_tsdf_mesh.py's weight-mask case on the port: nothing comes
    from the masked half of the grid."""
    lin = np.linspace(-1, 1, 32, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = np.sqrt(x * x + y * y + z * z) - 0.35
    h = float(lin[1] - lin[0])
    w = np.ones_like(sdf)
    w[:16] = 0.0
    verts, faces = t_mcubes.marching_tetrahedra(
        torch.from_numpy(sdf), 0.0, weight=torch.from_numpy(w), min_weight=0.5,
        origin=np.array([-1.0, -1.0, -1.0]), voxel_size=h)
    assert len(verts) > 0 and len(faces) > 0
    assert (verts[:, 0] > -h * 17).all()


def _components_mesh():
    """A marched sphere plus two small floating triangles and a quad."""
    lin = np.linspace(-1, 1, 20, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = j_mcubes.marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - 0.5, 0.0,
                                        origin=np.full(3, -1.0), voxel_size=lin[1] - lin[0])
    n = len(v)
    extra_v = np.array([[2, 2, 2], [2.1, 2, 2], [2, 2.1, 2], [3, 3, 3], [3.1, 3, 3], [3, 3.1, 3],
                        [3.1, 3.1, 3]], np.float32)
    extra_f = np.array([[n, n + 1, n + 2], [n + 3, n + 4, n + 5], [n + 4, n + 6, n + 5]])
    return np.concatenate([v, extra_v]), np.concatenate([f, extra_f]).astype(np.int32)


@pytest.mark.parametrize("ratio", [0.5, 0.0])
def test_mesh_helpers_match_jax(ratio, tmp_path):
    verts, faces = _components_mesh()
    # the same partition of the faces into components
    lj = j_mesh.connected_components(faces, len(verts))
    lt = t_mesh.connected_components(faces, len(verts))
    assert len(np.unique(lt)) == len(np.unique(lj)) == 3
    assert len({(a, b) for a, b in zip(lj, lt)}) == 3
    cj = j_mesh.clean_mesh_components(verts, faces, ratio_threshold=ratio)
    ct = t_mesh.clean_mesh_components(verts, faces, ratio_threshold=ratio)
    for g, w in zip(ct, cj):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(ct[1]) == (len(faces) - 3 if ratio else len(faces))

    j_mesh.save_mesh(str(tmp_path / "j.ply"), *cj)
    t_mesh.save_mesh(str(tmp_path / "t.ply"), *ct)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    lv, lf = t_mesh.load_mesh(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(lv, cj[0])
    np.testing.assert_array_equal(lf, cj[1])
    np.testing.assert_array_equal(t_mesh.sample_mesh_surface(verts, faces, 500, seed=2),
                                  j_mesh.sample_mesh_surface(verts, faces, 500, seed=2))
    shifted = verts + np.float32(0.01)
    assert t_mesh.mesh_f1_score(verts, faces, shifted, faces, 0.02, n_samples=3000) == \
        j_mesh.mesh_f1_score(verts, faces, shifted, faces, 0.02, n_samples=3000)


def test_save_mesh_with_colours_matches_jax(tmp_path):
    verts, faces = _components_mesh()
    colours = np.random.default_rng(0).uniform(size=(len(verts), 3)).astype(np.float32)
    j_mesh.save_mesh(str(tmp_path / "j.ply"), verts, faces, vertex_colors=colours)
    t_mesh.save_mesh(str(tmp_path / "t.ply"), verts, faces, vertex_colors=colours)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
