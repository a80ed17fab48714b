"""The initializers gs-init and gs-process-data reach, through the port on
the CPU against the JAX package on the same seeded inputs: the registry;
pcd, gaussiansky and multigaussiansky; depth (fused.ply, scales.bin and the
model; a depth map smaller than its image); VisualHull (the mesh and the
model; an empty hull); the SfM pair lists; the colmap cache's COLMAP
binaries byte for byte and its build; the hloc, loftr and colmap gates; and
dust3r's view preparation, selection, fusion and a mocked model."""

import os

import numpy as np
import pytest
import torch

from gaustudio_torch import models as t_models
from gaustudio_torch.cameras import Camera as TCamera
from gaustudio_torch.cameras.camera_paths import get_path_from_orbit as t_orbit
from gaustudio_torch.ops import mesh_raster as t_mesh_raster
from gaustudio_torch.pipelines import initializers as t_init
from gaustudio_torch.pipelines.initializers import dust3r as t_dust3r
from gaustudio_torch.pipelines.initializers import sfm_pairs as t_pairs
from gaustudio_torch.utils.ply import read_ply
from gaustudio_tpu import models as j_models
from gaustudio_tpu.cameras.camera_paths import get_path_from_orbit as j_orbit
from gaustudio_tpu.datasets import utils as j_dsu
from gaustudio_tpu.ops import mcubes as j_mcubes
from gaustudio_tpu.pipelines import initializers as j_init
from gaustudio_tpu.pipelines.initializers import dust3r as j_dust3r
from gaustudio_tpu.pipelines.initializers import sfm_pairs as j_pairs
from gaustudio_tpu.utils.ply import store_ply as j_store_ply

ATTRS = ("xyz", "f_dc", "f_rest", "scale", "rot", "opacity")


def _assert_models_equal(t, j, atol=1e-6, attrs=ATTRS):
    assert t.num_points == j.num_points
    for attr in attrs:
        np.testing.assert_allclose(getattr(t, "_" + attr).numpy(),
                                   np.asarray(getattr(j, "_" + attr)), rtol=0, atol=atol,
                                   err_msg=attr)


def _vanilla_pair():
    return t_models.make({"name": "vanilla_pcd"}, device="cpu"), j_models.make({"name": "vanilla_pcd"})


def _ply_columns(path):
    v = read_ply(path)["vertex"]
    return {k: np.asarray(a) for k, a in v.items()}


def test_registry_has_the_jax_packages_names():
    assert sorted(t_init.keys()) == sorted(j_init.keys())
    assert len(t_init.keys()) == 12


def test_pcd_initializer_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    rgb = (rng.uniform(size=(200, 3)) * 255).astype(np.uint8)
    normals = rng.normal(size=(200, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.ply")
    j_store_ply(path, xyz, rgb, normals)
    cfg = {"name": "pcd", "model_path": path}
    t, j = _vanilla_pair()
    _assert_models_equal(t_init.make(cfg)(t), j_init.make(cfg)(j))
    with pytest.raises(FileNotFoundError, match="model_path"):
        t_init.make({"name": "pcd"})(t)


@pytest.mark.parametrize("cfg", [
    {"name": "gaussiansky", "resolution": 20, "radius": 50.0},
    {"name": "gaussiansky"},
    {"name": "multigaussiansky", "resolution": 10, "radii": [10.0, 20.0]},
], ids=["gaussiansky", "gaussiansky-defaults", "multigaussiansky"])
def test_sky_initializers_match_jax(cfg):
    t, j = _vanilla_pair()
    t, j = t_init.make(cfg)(t), j_init.make(cfg)(j)
    _assert_models_equal(t, j)
    shells = len(cfg.get("radii", [None]))
    assert t.num_points == shells * cfg.get("resolution", 100) ** 2


# --- a sphere seen from an orbit: depth maps, masks and images --------------

def _sphere_mesh(radius=0.5, n=20):
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return j_mcubes.marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - radius, 0.0,
                                        origin=np.full(3, -1.0), voxel_size=lin[1] - lin[0])


def _orbit_views(n=6, size=40, radius=2.5, fov=50, depth_size=None, seed=0):
    """Both packages' orbit cameras of the sphere, each with a seeded image,
    the port's rasterized depth (at ``depth_size``, default the image's) and
    the silhouette as its mask."""
    verts, faces = _sphere_mesh()
    rng = np.random.default_rng(seed)
    t_cams = t_orbit(np.zeros(3), radius, num_cam=n, image_size=size, fov_deg=fov, device="cpu")
    j_cams = j_orbit(np.zeros(3), radius, num_cam=n, image_size=size, fov_deg=fov)
    ds = depth_size or size
    d_cams = t_orbit(np.zeros(3), radius, num_cam=n, image_size=ds, fov_deg=fov, device="cpu")
    for tc, jc, dc in zip(t_cams, j_cams, d_cams):
        depth = t_mesh_raster.rasterize_mesh(
            torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
            dc.world_view_transform, dc.full_proj_transform, ds, ds).depth.numpy()
        image = rng.uniform(size=(size, size, 3)).astype(np.float32)
        mask = (t_mesh_raster.rasterize_mesh(
            torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
            tc.world_view_transform, tc.full_proj_transform, size, size).depth > 0).float().numpy()
        jc.image, jc.depth, jc.mask = image, depth, mask
        tc.image, tc.depth, tc.mask = (torch.from_numpy(a) for a in (image, depth, mask))
    return t_cams, j_cams


@pytest.mark.parametrize("downsample", [1, 4])
def test_depth_initializer_matches_jax(downsample, tmp_path):
    """fused.ply's points within 1e-6, its colours equal (the JAX colour
    resize is PIL's bicubic, the port's torch's antialiased bicubic: at
    downsample 4 they may land one uint8 step apart, on at most 30% of the
    points), scales.bin equal, and the model built from each package's
    files equal within 1e-6."""
    t_cams, j_cams = _orbit_views(size=64)
    t_ws, j_ws = str(tmp_path / "t"), str(tmp_path / "j")
    t_depth = t_init.make({"name": "depth", "workspace_dir": t_ws, "downsample": downsample},
                          device="cpu")
    j_depth = j_init.make({"name": "depth", "workspace_dir": j_ws, "downsample": downsample})
    t, j = _vanilla_pair()
    t, j = t_depth(t, t_cams), j_depth(j, j_cams)

    tp, jp = (_ply_columns(os.path.join(ws, "fused.ply")) for ws in (t_ws, j_ws))
    valid = sum(int((_copy(c).downsample_scale(downsample).depth > 0).sum()) for c in t_cams)
    assert len(tp["x"]) == len(jp["x"]) == valid > 100
    for k in "xyz":
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-6, err_msg=k)
    rgb_t, rgb_j = (np.stack([p[k] for k in ("red", "green", "blue")], 1).astype(int)
                    for p in (tp, jp))
    if downsample == 1:
        np.testing.assert_array_equal(rgb_t, rgb_j)
    else:
        assert np.abs(rgb_t - rgb_j).max() <= 1
        assert (rgb_t != rgb_j).any(1).mean() <= 0.3
    scales_t, scales_j = (np.fromfile(os.path.join(ws, "scales.bin"), np.float16)
                          for ws in (t_ws, j_ws))
    np.testing.assert_array_equal(scales_t, scales_j)
    if downsample == 1:
        _assert_models_equal(t, j)
    else:
        _assert_models_equal(t, j, attrs=("xyz", "scale", "rot", "opacity", "f_rest"))
        np.testing.assert_allclose(t._f_dc.numpy(), np.asarray(j._f_dc), rtol=0,
                                   atol=1 / 255 / 0.28209479177387814 + 1e-6)
    # the log-scale of every axis is the point's, opacity inverse_sigmoid(0.5)
    assert (t._scale[:, 0] == t._scale[:, 2]).all() and (t._opacity == 0).all()


def _copy(cam):
    import copy

    return copy.deepcopy(cam)


def test_depth_initializer_reuses_its_fused_ply_unless_overwrite(tmp_path):
    t_cams, _ = _orbit_views(n=2)
    init = t_init.make({"name": "depth", "workspace_dir": str(tmp_path)}, device="cpu")
    calls = []
    cache = init.cache_dataset
    init.cache_dataset = lambda ds: (calls.append(1), cache(ds))
    for overwrite in (False, False, True):
        init(t_models.make({"name": "vanilla_pcd"}, device="cpu"), t_cams, overwrite=overwrite)
    assert len(calls) == 2


def test_depth_initializer_lines_up_a_depth_map_smaller_than_its_image(tmp_path):
    """ScanNet's depth maps are smaller than its colour images; downsampling
    resamples depth to the image's size, so every point takes the colour of
    its own pixel in both packages."""
    t_cams, j_cams = _orbit_views(n=3, size=48, depth_size=24)
    assert t_cams[0].depth.shape == (24, 24) and t_cams[0].image.shape == (48, 48, 3)
    t_ws, j_ws = str(tmp_path / "t"), str(tmp_path / "j")
    t_init.make({"name": "depth", "workspace_dir": t_ws, "downsample": 1}, device="cpu")(
        t_models.make({"name": "vanilla_pcd"}, device="cpu"), t_cams)
    j_init.make({"name": "depth", "workspace_dir": j_ws, "downsample": 1})(
        j_models.make({"name": "vanilla_pcd"}), j_cams)
    tp, jp = (_ply_columns(os.path.join(ws, "fused.ply")) for ws in (t_ws, j_ws))
    for k in ("x", "y", "z", "red", "green", "blue"):
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-6, err_msg=k)
    # the colours are those of the pixels whose depth is positive
    cam = _copy(t_cams[0]).downsample_scale(1)
    assert cam.depth.shape == cam.image.shape[:2] == (48, 48)
    valid = cam.depth.reshape(-1) > 0
    want = (cam.image.reshape(-1, 3)[valid].numpy() * 255).astype(np.uint8)
    np.testing.assert_array_equal(tp["red"][:len(want)], want[:, 0])


@pytest.mark.parametrize("resolution", [24, 32])
def test_visual_hull_matches_jax(resolution):
    t_cams, j_cams = _orbit_views(n=8, size=48)
    cfg = {"name": "VisualHull", "resolution": resolution, "radius_scale": 0.4}
    t_vh, j_vh = t_init.make(cfg, device="cpu"), j_init.make(cfg)
    t, j = _vanilla_pair()
    t, j = t_vh(t, t_cams), j_vh(j, j_cams)
    assert len(t_vh.mesh[1]) > 50
    np.testing.assert_array_equal(t_vh.mesh[1], j_vh.mesh[1])
    np.testing.assert_allclose(t_vh.mesh[0], j_vh.mesh[0], rtol=0, atol=1e-5)
    _assert_models_equal(t, j)
    assert t.num_points == len(t_vh.mesh[1])  # one Gaussian a triangle by default
    # the hull of a 0.5 sphere: no vertex more than a tetrahedron's edge
    # (sqrt(3) voxels) inside it; the grid spans +-0.4 x 1.5 x 2.5 (the
    # cameras' min_radius)
    voxel = 2 * 0.4 * 1.5 * 2.5 / (resolution - 1)
    assert np.linalg.norm(t_vh.mesh[0], axis=1).min() > 0.5 - np.sqrt(3) * voxel
    # the dataset's cameras keep their host tensors
    assert t_cams[0].mask.device.type == "cpu" and t_cams[0].device.type == "cpu"


def test_visual_hull_of_empty_masks_raises_as_jax():
    t_cams, j_cams = _orbit_views(n=3)
    for tc, jc in zip(t_cams, j_cams):
        tc.mask = torch.zeros_like(tc.mask)
        jc.mask = np.zeros_like(jc.mask)
    cfg = {"name": "VisualHull", "resolution": 16}
    with pytest.raises(ValueError, match="empty surface"):
        t_init.make(cfg, device="cpu")(t_models.make("vanilla_pcd", device="cpu"), t_cams)
    with pytest.raises(ValueError, match="empty surface"):
        j_init.make(cfg)(j_models.make("vanilla_pcd"), j_cams)


# --- SfM pairs ---------------------------------------------------------------

def _images_of(cams, dsu):
    return {i + 1: dsu.ColmapImage(i + 1, dsu.rotmat2qvec(np.asarray(c.extrinsics)[:3, :3]),
                                   np.asarray(c.extrinsics)[:3, 3], i + 1, f"r_{i}.png",
                                   np.zeros((0, 2)), np.zeros(0, np.int64))
            for i, c in enumerate(cams)}


def _pair_cases():
    eye_q = np.array([1.0, 0.0, 0.0, 0.0])
    mk = lambda i, t, q=eye_q: j_dsu.ColmapImage(  # noqa: E731
        i, q, np.asarray(t, float), i, f"im{i}.png", np.zeros((0, 2)), np.zeros(0, np.int64))
    orbit = _images_of(j_orbit(np.zeros(3), 2.0, num_cam=12, image_size=32, fov_deg=50), j_dsu)
    near_duplicate = {1: mk(1, [0, 0, 0]), 2: mk(2, [0, 0, 0]), 3: mk(3, [1, 0, 0])}
    # loop candidates at equal distances (ties in dt broken by dR, then by id)
    turned = np.array([np.cos(np.radians(5)), 0.0, np.sin(np.radians(5)), 0.0])
    ties = {1: mk(1, [0, 0, 0])}
    ties.update({i: mk(i, [0, 0, 3.0 + 0.01 * i]) for i in range(2, 6)})
    ties.update({6: mk(6, [0.5, 0, 0]), 7: mk(7, [-0.5, 0, 0]), 8: mk(8, [0, 0.5, 0], turned),
                 9: mk(9, [0, -0.5, 0]), 10: mk(10, [0, 0, -0.5])})
    return {"orbit": (orbit, 3), "near_duplicate": (near_duplicate, 2), "ties": (ties, 4)}


@pytest.mark.parametrize("case", list(_pair_cases()))
def test_pairs_from_poses_match_jax(case, tmp_path):
    images, overlap = _pair_cases()[case]
    got = t_pairs.pairs_from_poses(images, overlap=overlap)
    want = j_pairs.pairs_from_poses(images, overlap=overlap)
    assert got == want and len(got) == len(set(got)) > 0
    t_pairs.write_pairs(got, tmp_path / "t.txt")
    j_pairs.write_pairs(want, tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    if case == "ties":  # the loop closures of image 1 beyond its window, in lexsort order
        loops = [b for a, b in got if a == "im1.png"][overlap:]
        assert loops == ["im6.png", "im7.png", "im9.png", "im10.png", "im8.png"], loops


# --- colmap / hloc / loftr ----------------------------------------------------

def _colmap_views(names=None):
    t_cams = t_orbit(np.zeros(3), 2.0, num_cam=4, image_size=16, fov_deg=50, device="cpu")
    j_cams = j_orbit(np.zeros(3), 2.0, num_cam=4, image_size=16, fov_deg=50)
    rng = np.random.default_rng(3)
    for i, (tc, jc) in enumerate(zip(t_cams, j_cams)):
        img = rng.uniform(size=(16, 16, 3)).astype(np.float32)
        jc.image, tc.image = img, torch.from_numpy(img)
        if names is not None:
            jc.image_name = tc.image_name = names[i]
    return t_cams, j_cams


@pytest.mark.parametrize("names", [None, ["a.png", "b", "c.jpeg", "d.JPG"]],
                         ids=["orbit-names", "mixed-names"])
def test_colmap_cache_writes_the_jax_binaries_byte_for_byte(names, tmp_path):
    from PIL import Image

    t_cams, j_cams = _colmap_views(names)
    t_ws, j_ws = tmp_path / "t", tmp_path / "j"
    t_init.make({"name": "colmap", "workspace_dir": str(t_ws)}).cache_dataset(t_cams)
    j_init.make({"name": "colmap", "workspace_dir": str(j_ws)}).cache_dataset(j_cams)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (t_ws / "model" / name).read_bytes() == (j_ws / "model" / name).read_bytes(), name
    written = sorted(os.listdir(t_ws / "images"))
    assert written == sorted(os.listdir(j_ws / "images")) and len(written) == 4
    for name in written:
        assert (np.asarray(Image.open(t_ws / "images" / name))
                == np.asarray(Image.open(j_ws / "images" / name))).all()


def _points3d(ws, n=50, seed=4):
    rng = np.random.default_rng(seed)
    os.makedirs(ws / "sparse" / "0", exist_ok=True)
    j_dsu.write_points3D_binary(rng.normal(size=(n, 3)), rng.integers(0, 256, size=(n, 3)),
                                ws / "sparse" / "0" / "points3D.bin")


@pytest.mark.parametrize("name", ["colmap", "hloc", "loftr"])
def test_pose_initializers_build_from_points3d_as_jax(name, tmp_path):
    """With sparse/0/points3D.bin in the workspace, should_skip holds and
    the model is built from it (the path gs-init takes on a capture that
    holds its points)."""
    t_cams, j_cams = _colmap_views()
    _points3d(tmp_path)
    t_pose = t_init.make({"name": name, "workspace_dir": str(tmp_path)})
    j_pose = j_init.make({"name": name, "workspace_dir": str(tmp_path)})
    assert t_pose.should_skip() and j_pose.should_skip()
    t = t_pose(t_models.make("general_pcd", device="cpu"), t_cams)
    j = j_pose(j_models.make("general_pcd"), j_cams)
    _assert_models_equal(t, j, attrs=("xyz", "rgb"))
    assert t.num_points == 50 and not (tmp_path / "model" / "images.bin").exists()


def test_colmap_build_falls_back_to_the_empty_model_and_raises_as_jax(tmp_path):
    t_cams, j_cams = _colmap_views()
    for init, cams, model, ws in (
            (t_init, t_cams, t_models.make("general_pcd", device="cpu"), tmp_path / "t"),
            (j_init, j_cams, j_models.make("general_pcd"), tmp_path / "j")):
        pose = init.make({"name": "colmap", "workspace_dir": str(ws)})
        pose.cache_dataset(cams)
        with pytest.raises(ValueError, match="no 3D points"):
            pose.build_model(model)


@pytest.mark.parametrize("name", ["hloc", "loftr", "colmap"])
def test_sfm_steps_write_pairs_then_raise_the_jax_import_error(name, tmp_path):
    t_cams, j_cams = _colmap_views()
    errors = []
    for init, cams, ws in ((t_init, t_cams, tmp_path / "t"), (j_init, j_cams, tmp_path / "j")):
        pose = init.make({"name": name, "workspace_dir": str(ws)})
        pose.cache_dataset(cams)
        with pytest.raises(ImportError) as e:
            pose.process_dataset()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    if name != "colmap":
        t_txt, j_txt = (ws / "pairs-sfm.txt" for ws in (tmp_path / "t", tmp_path / "j"))
        assert t_txt.read_bytes() == j_txt.read_bytes() and len(t_txt.read_text().splitlines()) >= 3


# --- dust3r ---------------------------------------------------------------------

@pytest.mark.parametrize("image_size", [512, 224])
@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("shape, K", [
    ((100, 160), [[120.0, 0, 70.3], [0, 118.0, 46.7], [0, 0, 1.0]]),
    ((64, 64), [[60.0, 0, 32.0], [0, 60.0, 32.0], [0, 0, 1.0]]),
], ids=["off-centre", "square"])
def test_dust3r_prepare_view_matches_jax(shape, K, with_mask, image_size):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=shape + (3,)).astype(np.float32)
    mask = rng.uniform(size=shape).astype(np.float32) if with_mask else None
    K = np.asarray(K)
    got = t_dust3r.prepare_view(img, K, mask=mask, image_size=image_size)
    want = j_dust3r.prepare_view(img, K, mask=mask, image_size=image_size)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == (not with_mask)
    if with_mask:
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape[0] % 16 == 0 and got[0].shape[1] % 16 == 0


def test_dust3r_select_and_fuse_match_jax():
    for n, m in ((10, 20), (100, 20), (41, 20), (7, 3)):
        assert t_dust3r.select_view_indices(n, m) == j_dust3r.select_view_indices(n, m)
    rng = np.random.default_rng(1)
    pts = [rng.normal(size=(6, 5, 3)).astype(np.float32) for _ in range(4)]
    cols = [rng.integers(0, 256, size=(6, 5, 3)).astype(np.uint8) for _ in range(4)]
    masks = [rng.uniform(size=(6, 5)) > 0.3 for _ in range(4)]
    masks[2][:] = False
    fg = [rng.uniform(size=(6, 5)) > 0.5 for _ in range(4)]
    for kw in ({}, {"max_points": 25}, {"fg_masks": fg, "prune_background": True}):
        for g, w in zip(t_dust3r.fuse_point_clouds(pts, cols, masks, **kw),
                        j_dust3r.fuse_point_clouds(pts, cols, masks, **kw)):
            np.testing.assert_array_equal(g, w)


def test_dust3r_initializer_with_a_mocked_model_writes_the_jax_cloud(tmp_path):
    t_cams = t_orbit(np.zeros(3), 2.0, num_cam=5, image_size=64, fov_deg=50, device="cpu")
    j_cams = j_orbit(np.zeros(3), 2.0, num_cam=5, image_size=64, fov_deg=50)
    img = np.random.default_rng(1).uniform(size=(64, 64, 3)).astype(np.float32)
    for tc, jc in zip(t_cams, j_cams):
        jc.image, tc.image = img, torch.from_numpy(img)
    seen = []

    def fake_run(views, poses, intrinsics):
        seen.append((views, poses, intrinsics))
        rng = np.random.default_rng(2)
        return ([rng.normal(size=v["img_u8"].shape).astype(np.float32) for v in views],
                [np.ones(v["img_u8"].shape[:2], bool) for v in views])

    t = t_dust3r.Dust3rInitializer({"workspace_dir": str(tmp_path / "t")}, run_dust3r=fake_run,
                                   device="cpu")(t_models.make("vanilla_pcd", device="cpu"), t_cams)
    j = j_dust3r.Dust3rInitializer({"workspace_dir": str(tmp_path / "j")},
                                   run_dust3r=fake_run)(j_models.make("vanilla_pcd"), j_cams)
    (tv, tpo, tk), (jv, jpo, jk) = seen
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a["img_u8"], b["img_u8"])
    np.testing.assert_allclose(np.stack(tpo), np.stack(jpo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(tk), np.stack(jk), rtol=0, atol=1e-4)
    assert (tmp_path / "t" / "fused.ply").read_bytes() == (tmp_path / "j" / "fused.ply").read_bytes()
    _assert_models_equal(t, j)


def test_dust3r_model_is_gated_with_the_jax_message(tmp_path):
    t_cams = t_orbit(np.zeros(3), 2.0, num_cam=3, image_size=32, fov_deg=50, device="cpu")
    j_cams = j_orbit(np.zeros(3), 2.0, num_cam=3, image_size=32, fov_deg=50)
    for tc, jc in zip(t_cams, j_cams):
        jc.image = np.zeros((32, 32, 3), np.float32)
        tc.image = torch.zeros((32, 32, 3))
    errors = []
    for init, cams, model in (
            (t_init.make({"name": "dust3r", "workspace_dir": str(tmp_path / "t")}, device="cpu"),
             t_cams, t_models.make("vanilla_pcd", device="cpu")),
            (j_init.make({"name": "dust3r", "workspace_dir": str(tmp_path / "j")}), j_cams,
             j_models.make("vanilla_pcd"))):
        with pytest.raises(ImportError) as e:
            init(model, cams)
        assert len(init._views) == 3  # the views were prepared before the model's import
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_camera_to_moves_a_shallow_copy_and_leaves_the_original():
    import copy

    cam = TCamera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), FoVx=1.0, FoVy=1.0, image_width=8,
                  image_height=6, device="cpu")
    cam.depth = torch.ones(6, 8)
    moved = copy.copy(cam).to("meta")
    assert moved.depth.device.type == "meta" and moved.world_view_transform.device.type == "meta"
    assert cam.depth.device.type == "cpu" and cam.world_view_transform.device.type == "cpu"
