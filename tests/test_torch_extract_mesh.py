"""gs-extract-mesh through the port on the CPU, against GOLDEN.json and the
JAX package: the mini_scene mesh F1, the TSDF and marching tetrahedra fed the
JAX package's depth maps, the mvs-texturing work-dir layout, a surfel run
and the CLI through a cameras.json and through a COLMAP scene."""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustudio_torch import models as t_models
from gaustudio_torch import renderers as t_renderers
from gaustudio_torch.datasets.utils import JSON_to_camera as t_json_to_camera
from gaustudio_torch.ops import mcubes as t_mcubes
from gaustudio_torch.ops import tsdf as t_tsdf
from gaustudio_torch.pipelines import mesh_extraction as t_me
from gaustudio_torch.scripts import extract_mesh as t_cli
from gaustudio_torch.utils.image import load_grey8, load_rgb8
from gaustudio_torch.utils.mesh import load_mesh, mesh_f1_score
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.datasets import utils as j_dsu
from gaustudio_tpu.ops import mcubes as j_mcubes
from gaustudio_tpu.ops import tsdf as j_tsdf
from gaustudio_tpu.pipelines import mesh_extraction as j_me

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_scene")
PLY = os.path.join(FIXTURE, "gaussians.ply")
CAMS = os.path.join(FIXTURE, "cameras.json")
# surface samples of a mesh F1 at half a voxel: enough that two equal meshes
# score 0.99998 (20000, the default, gives 0.85 on the fixture's mesh)
F1_SAMPLES = 200_000


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(FIXTURE, "GOLDEN.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cameras_json():
    with open(CAMS) as f:
        return json.load(f)


def _t_scene(cameras_json, renderer="vanilla_renderer"):
    pcd = t_models.make({"name": "vanilla_pcd"}, device="cpu")
    pcd.load(PLY)
    pcd.active_sh_degree = 0  # the fixture was fitted at SH degree 0
    cams = [t_json_to_camera(cj, device="cpu") for cj in cameras_json]
    return pcd, t_renderers.make({"name": renderer}, device="cpu"), cams


@pytest.fixture(scope="module")
def j_vanilla_renderer():
    """One JAX vanilla renderer for the module: it compiles once a resolution."""
    return j_renderers.make({"name": "vanilla_renderer"})


def _j_scene(cameras_json, renderer):
    pcd = j_models.make({"name": "vanilla_pcd"})
    pcd.load(PLY)
    pcd.active_sh_degree = 0
    return pcd, renderer, [j_dsu.JSON_to_camera(cj) for cj in cameras_json]


def test_extract_mesh_f1_matches_golden(golden, cameras_json):
    """tests/test_golden_e2e.py's mesh-quality gate, through the port."""
    pcd, renderer, cams = _t_scene(cameras_json)
    verts, faces = t_me.extract_mesh(pcd, renderer, cams, device="cpu", **golden["extract_kw"])
    assert len(verts) > 100 and len(faces) > 100
    gt_v, gt_f = load_mesh(os.path.join(FIXTURE, "gt_mesh.ply"))
    f1 = mesh_f1_score(verts, faces, gt_v, gt_f, golden["f1_tau"])
    assert f1["f1"] >= golden["mesh_f1"] - 0.03
    assert f1["chamfer"] <= golden["mesh_chamfer"] * 1.25 + 1e-4


def test_fusion_of_jax_depth_maps_matches_jax(golden, cameras_json, j_vanilla_renderer):
    """The JAX package's masked median depths of every fourth view, fused and
    meshed by both packages: equal weights, the same faces, vertices within
    1e-5."""
    pcd, renderer, cams = _j_scene(cameras_json[::4], j_vanilla_renderer)
    kw = golden["extract_kw"]
    lo, hi = j_tsdf.integrate_points_bounds(np.asarray(pcd.get_attribute("xyz")))
    jvol = j_tsdf.volume_from_bounds(lo, hi, kw["voxel_size"], kw["sdf_trunc"], kw["max_dim"])
    tvol = t_tsdf.volume_from_bounds(lo, hi, kw["voxel_size"], kw["sdf_trunc"], kw["max_dim"],
                                     device="cpu")
    for cam, depth in j_me.iter_fused_depths(renderer, pcd, cams):
        K, E = np.asarray(cam.intrinsics), np.asarray(cam.extrinsics)
        jvol = j_tsdf.integrate(jvol, depth, jnp.asarray(K), jnp.asarray(E))
        t_tsdf.integrate(tvol, np.asarray(depth), K, E)
    np.testing.assert_array_equal(tvol.weight.numpy(), np.asarray(jvol.weight))
    np.testing.assert_allclose(tvol.tsdf.numpy(), np.asarray(jvol.tsdf), atol=1e-5, rtol=0)

    jv, jf = j_mcubes.marching_tetrahedra(
        np.asarray(jvol.tsdf), 0.0, weight=np.asarray(jvol.weight),
        min_weight=kw["min_weight"], origin=np.asarray(jvol.origin),
        voxel_size=float(jvol.voxel_size), slab=4)
    tv, tf = t_mcubes.marching_tetrahedra(
        tvol.tsdf, 0.0, weight=tvol.weight, min_weight=kw["min_weight"],
        origin=tvol.origin.numpy(), voxel_size=float(tvol.voxel_size), slab=4)
    assert len(jf) > 1000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)


def test_work_dir_layout_matches_jax(golden, cameras_json, j_vanilla_renderer, tmp_path):
    """Every fifth view: the .cam files byte for byte, the renders and masks
    pixel for pixel but at most 0.1% of the pixels (those whose final
    opacity sits at 0.5, where the two renders may fall either side), the
    same file names, and a fused_mesh.ply of the same size."""
    kw = dict(golden["extract_kw"], stride=5)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    j_me.extract_mesh(*_j_scene(cameras_json, j_vanilla_renderer), work_dir=jd, **kw)
    t_me.extract_mesh(*_t_scene(cameras_json), work_dir=td, device="cpu", **kw)
    for sub in ("images", "masks"):
        assert sorted(os.listdir(os.path.join(td, sub))) == sorted(
            os.listdir(os.path.join(jd, sub)))
    names = sorted(f for f in os.listdir(os.path.join(td, "images")) if f.endswith(".cam"))
    assert names == ["00000.png.cam", "00005.png.cam"]
    for name in names:
        with open(os.path.join(td, "images", name), "rb") as a, \
                open(os.path.join(jd, "images", name), "rb") as b:
            assert a.read() == b.read(), name
    bad = total = 0
    for name in (n[:-4] + ".png" for n in names):
        for sub, load in (("images", load_rgb8), ("masks", load_grey8)):
            got = load(os.path.join(td, sub, name))
            want = load(os.path.join(jd, sub, name))
            assert got.shape == want.shape
            diff = got != want
            bad += int((diff.any(-1) if diff.ndim == 3 else diff).sum())
            total += got.shape[0] * got.shape[1]
        assert load_grey8(os.path.join(td, "masks", name)).max() == 255
    assert bad <= 0.001 * total, (bad, total)
    jm = load_mesh(os.path.join(jd, "fused_mesh.ply"))
    tm = load_mesh(os.path.join(td, "fused_mesh.ply"))
    assert len(tm[1]) == len(jm[1]) and len(tm[0]) == len(jm[0])


def test_surfel_renderer_extracts_a_mesh(golden, cameras_json, tmp_path):
    """The mini_scene model read as surfels (its first two scale columns):
    the surfel renderer's median depth and alpha fuse into the JAX surfel
    renderer's mesh.

    The JAX surfel renderer sizes its entry buffer with the vanilla
    renderer's culled count of the flattened Gaussians, which is short of the
    surfels' entries here (20480 for 23087 in the first view), and drops the
    rest; the port sizes its buffers from the count itself. So the JAX
    renderer is given room for every entry, and its single-device path of
    extract_mesh is spelled out (on the test's eight virtual devices
    extract_mesh would take the camera-parallel path, which probes its own
    capacity)."""
    kw = dict(golden["extract_kw"], stride=4)
    tv, tf = t_me.extract_mesh(*_t_scene(cameras_json, "surfel_renderer"),
                               work_dir=str(tmp_path), device="cpu", **kw)
    jpcd, jrenderer, jcams = _j_scene(cameras_json[::4],
                                      j_renderers.make({"name": "surfel_renderer"}))
    jrenderer._capacity_cache[(128, 128)] = 1 << 16
    lo, hi = j_tsdf.integrate_points_bounds(np.asarray(jpcd.get_attribute("xyz")))
    vol = j_tsdf.volume_from_bounds(lo, hi, kw["voxel_size"], kw["sdf_trunc"], kw["max_dim"])
    for cam, depth in j_me.iter_fused_depths(jrenderer, jpcd, jcams,
                                             settings_overrides={"with_median_id": False}):
        vol = j_tsdf.integrate(vol, depth, jnp.asarray(cam.intrinsics),
                               jnp.asarray(cam.extrinsics))
    jv, jf = j_mcubes.marching_tetrahedra(
        np.asarray(vol.tsdf), 0.0, weight=np.asarray(vol.weight), min_weight=kw["min_weight"],
        origin=np.asarray(vol.origin), voxel_size=float(vol.voxel_size), slab=4)
    assert len(tf) > 1000
    assert os.path.exists(tmp_path / "fused_mesh.ply")
    f1 = mesh_f1_score(tv, tf, jv, jf, tau=0.5 * kw["voxel_size"], n_samples=F1_SAMPLES)
    assert f1["f1"] >= 0.999, f1


def _run_jax_cli(argv):
    from gaustudio_tpu.scripts import extract_mesh as j_cli

    old = sys.argv
    sys.argv = ["gs-extract-mesh"] + argv
    try:
        j_cli.main()
    finally:
        sys.argv = old


def _write_colmap_scene(root, cameras_json):
    """mini_scene as a COLMAP scene (PINHOLE cameras, binary model) written
    by the JAX package's writers."""
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    shutil.copytree(os.path.join(FIXTURE, "images"), root / "images")
    cams, ims = {}, {}
    for i, cj in enumerate(cameras_json):
        cam = j_dsu.JSON_to_camera(cj)
        cams[i + 1] = j_dsu.ColmapCamera(i + 1, "PINHOLE", cj["width"], cj["height"], np.array(
            [cj["fx"], cj["fy"], cj["cx"], cj["cy"]]))
        ims[i + 1] = j_dsu.ColmapImage(i + 1, j_dsu.rotmat2qvec(np.asarray(cam.R).T),
                                       np.asarray(cam.T), i + 1, cj["img_name"],
                                       np.zeros((0, 2)), np.zeros(0, np.int64))
    j_dsu.write_intrinsics_binary(cams, sparse / "cameras.bin")
    j_dsu.write_extrinsics_binary(ims, sparse / "images.bin")
    return str(root)


@pytest.mark.parametrize("route", ["cameras_json", "colmap"])
def test_cli_writes_the_jax_layout(route, golden, cameras_json, tmp_path):
    """gs-extract-mesh --device cpu through -s cameras.json and -s <COLMAP
    dir> (after tests/test_scripts.py): the same files as the JAX CLI, the
    .cam files byte for byte, and a mesh close to the JAX CLI's."""
    kw = golden["extract_kw"]
    src = CAMS if route == "cameras_json" else _write_colmap_scene(tmp_path / "scene",
                                                                    cameras_json)
    flags = ["-m", PLY, "-s", src, "--sh", "0", "--stride", "4", "--resolution", "1",
             "--voxel_size", str(kw["voxel_size"]), "--sdf_trunc", str(kw["sdf_trunc"]),
             "--min_weight", str(kw["min_weight"])]
    td, jd = tmp_path / "port", tmp_path / "jax"
    mesh_path = t_cli.main(flags + ["-o", str(td), "--device", "cpu"])
    _run_jax_cli(flags + ["-o", str(jd)])
    assert mesh_path == str(td / "fused_mesh.ply")
    for sub in ("images", "masks"):
        names = sorted(os.listdir(td / sub))
        assert names == sorted(os.listdir(jd / sub))
        assert len([n for n in names if n.endswith(".png")]) == 3
    # COLMAP image names keep their extension, as the JAX package's do
    assert "00000.png.png" in os.listdir(td / "images")
    for name in (n for n in os.listdir(td / "images") if n.endswith(".cam")):
        assert (td / "images" / name).read_bytes() == (jd / "images" / name).read_bytes()
    tv, tf = load_mesh(str(td / "fused_mesh.ply"))
    jv, jf = load_mesh(str(jd / "fused_mesh.ply"))
    assert len(tf) > 1000
    f1 = mesh_f1_score(tv, tf, jv, jf, tau=0.5 * kw["voxel_size"], n_samples=F1_SAMPLES)
    assert f1["f1"] >= 0.999, f1


def test_cli_without_a_card_raises_unless_given_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_cli.main(["-m", PLY, "-s", CAMS, "-o", str(tmp_path)])
