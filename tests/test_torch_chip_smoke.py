"""What chip_smoke.py builds on the host, checked on the CPU: its copy of
bench.make_scene, its imports, the hard cases of phase 3 (through the plain
versions, which the kernels are held to on the card), K2's cases, phase
11's scene and cameras against bench_all.py's, phase 13's pure helpers,
phase 15's host steps (its points3D.bin writer, the native readers and the
COLMAP database on a small path), phase 16's one-process references and
cameras, and the kernels line's launch sum."""

import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from gaustudio_torch.ops import binning, composite, composite_surfel, rasterize_surfel

CPU = torch.device("cpu")


@pytest.mark.parametrize("n, seed", [(2000, 0), (500, 3)])
def test_make_scene_is_bench_make_scene(n, seed):
    for got, want in zip(chip_smoke.make_scene(n, seed=seed), bench.make_scene(n, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package_nor_its_benchmarks():
    with open(os.path.join(os.path.dirname(chip_smoke.__file__), "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names.isdisjoint({"jax", "jaxlib", "gaustudio_tpu", "bench", "bench_all"}), names


@pytest.mark.parametrize("surfel", [False, True], ids=["vanilla", "surfel"])
@pytest.mark.parametrize("case", chip_smoke.HARD_CASES)
def test_hard_case_stresses_what_it_is_for(case, surfel):
    pre, W, H = chip_smoke.hard_case(case, CPU, surfel=surfel)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    if surfel:
        b = binning.bin_gaussians(rasterize_surfel.binning_input(pre), gx, gy, cull=False)
        out = composite_surfel.render_surfel_tiles(
            b.ranges, b.point_list, pre.M, pre.Dk, pre.mean2d, pre.opacities, pre.colors,
            pre.normal_view, gx, gy, W, H)
    else:
        b = binning.bin_gaussians(pre, gx, gy)
        out = composite.render_tiles(b.ranges, b.point_list, pre.means2d, pre.conic,
                                     pre.opacities, pre.colors, pre.depths, gx, gy, W, H)
    chip_smoke.check_hard_case(case, b.ranges, b.point_list, out.n_contrib, W, H)


@pytest.mark.parametrize("case", list(chip_smoke.k2_cases(CPU)))
def test_k2_case_ranges(case):
    keys, num_tiles = chip_smoke.k2_cases(CPU)[case]
    tiles = (keys >> 32).tolist()
    want = [[0, 0] for _ in range(num_tiles)]
    for i, tile in enumerate(tiles):
        if i == 0 or tiles[i - 1] != tile:
            want[tile][0] = i
        want[tile][1] = i + 1
    got = binning.identify_tile_ranges(keys, num_tiles)
    assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.parametrize("case", chip_smoke.K1_CASES)
def test_k1_case_stresses_what_it_is_for(case):
    """K1's cases at the card's 1920x1080, through the plain version."""
    pre, W, H = chip_smoke.k1_case(case, CPU)
    gx = (W + 15) // 16
    _, gids = binning.duplicate_with_keys(pre, gx)
    keys, _ = binning.duplicate_with_keys(pre, gx, cull=False)
    assert keys.shape[0] == int(pre.tiles_touched.sum())
    chip_smoke.check_k1_case(case, pre, W, H, gids, keys.shape[0])


class _Captured(Exception):
    pass


def test_sphere_scene_is_bench_all_extract_mesh_scene(monkeypatch):
    """Phase 11's scene and cameras are those of bench_all.py
    bench_extract_mesh: its model and orbit cameras, caught as they reach
    extract_mesh, equal the port's."""
    import bench_all
    from gaustudio_tpu.pipelines import mesh_extraction as j_me

    seen = {}

    def capture(pcd, renderer, cams, **kw):
        seen.update(pcd=pcd, cams=cams, kw=kw)
        raise _Captured

    monkeypatch.setattr(j_me, "extract_mesh", capture)
    with pytest.raises(_Captured):
        bench_all.bench_extract_mesh()
    assert seen["kw"] == dict(chip_smoke.MESH_KW, stride=1, downsample=1)
    xyz, rgb = chip_smoke.sphere_points()
    np.testing.assert_array_equal(xyz, np.asarray(seen["pcd"]._xyz))
    pcd = chip_smoke.sphere_model(chip_smoke.MESH_N, CPU)
    for name in ("_xyz", "_f_dc", "_f_rest", "_rot", "_opacity"):
        np.testing.assert_array_equal(getattr(pcd, name).numpy(), np.asarray(getattr(
            seen["pcd"], name)).reshape(getattr(pcd, name).shape), err_msg=name)
    np.testing.assert_allclose(pcd._scale.numpy(), np.asarray(seen["pcd"]._scale), rtol=1e-6)
    assert pcd.active_sh_degree == seen["pcd"].active_sh_degree == 0
    cams = chip_smoke.orbit_cameras(chip_smoke.MESH_VIEWS, chip_smoke.MESH_SIZE, CPU)
    assert len(cams) == len(seen["cams"]) == 12
    for got, want in zip(cams, seen["cams"]):
        assert (got.image_width, got.image_height, got.FoVx) == (
            want.image_width, want.image_height, want.FoVx)
        np.testing.assert_array_equal(got.extrinsics.numpy(), np.asarray(want.extrinsics))


def test_full_width_orbit_cameras_keep_the_focal_length(tmp_path):
    """Phase 11's 1920x1080 cameras: FoVx 60 degrees, one focal length for
    both axes, the orbit's poses."""
    from gaustudio_torch.datasets.utils import JSON_to_camera

    path = chip_smoke.write_orbit_cameras(str(tmp_path / "c.json"), 36, 1920, 1080)
    with open(path) as f:
        cams = [JSON_to_camera(cj, device="cpu") for cj in json.load(f)]
    orbit = chip_smoke.orbit_cameras(36, 1920, CPU)
    assert len(cams) == 36
    for cam, ref in zip(cams, orbit):
        assert (cam.image_width, cam.image_height) == (1920, 1080)
        assert cam.FoVx == pytest.approx(np.radians(60), abs=1e-12)
        K = cam.intrinsics.numpy()
        assert K[0, 0] == K[1, 1] and (K[0, 2], K[1, 2]) == (960, 540)
        np.testing.assert_allclose(cam.extrinsics.numpy(), ref.extrinsics.numpy(), atol=1e-6)


def test_phase12_scaffold_generator_holds_its_widths_and_seeds():
    """Phase 12's Scaffold model at the config's widths: make_scene(30000)'s
    means voxelized at 0.001 (about 30k anchors, 300k decoded Gaussians), 10
    offsets and a 32-wide feature of N(0, 1) draws from the seed, the two
    scale columns, and heads drawn by the seeded generator."""
    xyz = chip_smoke.make_scene(chip_smoke.SCAFFOLD_SCENE_N, seed=chip_smoke.SCAFFOLD_SEED)[0]
    pcd = chip_smoke.scaffold_model(xyz, CPU)
    n = pcd.num_points
    assert (pcd.n_offsets, pcd.feat_dim, pcd.voxel_size) == (10, 32, 0.001)
    assert 29_000 <= n <= 30_000 and n * pcd.n_offsets >= 290_000
    assert n == len(np.unique(np.round(xyz / 0.001).astype(np.int64), axis=0))
    rng = np.random.default_rng(chip_smoke.SCAFFOLD_SEED)
    np.testing.assert_array_equal(pcd._offset.numpy(), rng.normal(size=(n, 30)).astype(np.float32))
    np.testing.assert_array_equal(pcd._anchor_feat.numpy(),
                                  rng.normal(size=(n, 32)).astype(np.float32))
    np.testing.assert_allclose(np.exp(pcd._scale.numpy()[:, :3]), 0.05, rtol=1e-6)
    np.testing.assert_allclose(np.exp(pcd._scale.numpy()[:, 3:]), 0.016, rtol=1e-6)
    again = chip_smoke.scaffold_model(xyz[:100], CPU)
    for (name, a), b in zip(pcd.mlp.named_parameters(), again.mlp.parameters()):
        assert torch.equal(a, b), name
    assert set(pcd.mlp) == {"opacity", "cov", "color"}
    assert chip_smoke.SCAFFOLD_FIXTURE_GATE_DB == pytest.approx(
        chip_smoke.SCAFFOLD_JAX_GAIN_DB - 1.0)


def test_phase13_texture_cameras_are_the_views_gs_extract_mesh_wrote(tmp_path):
    """The cameras.json phase 13 writes beside phase 11's images/ names
    every view the extraction rendered (its CLI's default stride and
    downsample) at the size of its PNG, with its pose and focal length."""
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.scripts import extract_mesh
    from gaustudio_torch.utils.image import read_png

    ply = str(tmp_path / "sphere.ply")
    chip_smoke.sphere_model(2000, CPU).export(ply)
    cams_path = chip_smoke.write_orbit_cameras(str(tmp_path / "cams.json"), 9, 64, 36)
    work = tmp_path / "mesh"
    extract_mesh.main(["-m", ply, "-s", cams_path, "-o", str(work), "--voxel_size", "0.1",
                       "--device", "cpu"])
    path = chip_smoke.write_texture_cameras(str(work), cams_path)
    assert path == str(work / "cameras.json")
    with open(path) as f:
        entries = json.load(f)
    pngs = sorted(n for n in os.listdir(work / "images") if n.endswith(".png"))
    assert sorted(f"{cj['img_name']}.png" for cj in entries) == pngs and len(pngs) == 3
    with open(cams_path) as f:
        full = [JSON_to_camera(cj, device="cpu") for cj in json.load(f)]
    for cj, ref in zip(entries, full[::chip_smoke.MESH_FULL_STRIDE]):
        assert read_png(str(work / "images" / f"{cj['img_name']}.png")).shape[:2] == (
            cj["height"], cj["width"]) == (18, 32)
        cam = JSON_to_camera(cj, device="cpu")
        np.testing.assert_allclose(cam.extrinsics.numpy(), ref.extrinsics.numpy(), atol=1e-6)
        np.testing.assert_allclose(cam.intrinsics.numpy()[:2, :2],
                                   ref.intrinsics.numpy()[:2, :2] / 2, rtol=1e-6)


def test_phase13_sap_f1_reuses_phase11s_f1_at_half_a_sap_voxel(monkeypatch):
    from gaustudio_torch.models.sap import ShapeAsPoints
    from gaustudio_torch.utils import mesh as meshu

    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    sap = ShapeAsPoints.from_pointcloud(xyz, xyz, device="cpu")
    assert chip_smoke.sap_voxel(xyz) == pytest.approx(sap._scale_factor / chip_smoke.PCD_GRID)
    seen = {}

    def f1(*args, tau, n_samples):
        seen.update(tau=tau, n_samples=n_samples)
        return {"f1": 1.0}

    monkeypatch.setattr(meshu, "mesh_f1_score", f1)
    mesh = (xyz[:3], np.array([[0, 1, 2]]))
    assert chip_smoke.sap_f1(mesh, mesh, xyz)["f1"] == 1.0
    assert seen == {"tau": 0.5 * chip_smoke.sap_voxel(xyz),
                    "n_samples": chip_smoke.MESH_F1_SAMPLES}


def test_phase13_raster_reference_holds_the_rasterizer():
    """raster_reference agrees with rasterize_mesh on a seeded mesh, and
    check_raster fails a fragment whose depth moved by 1e-4."""
    from gaustudio_torch.cameras import Camera
    from gaustudio_torch.ops import mesh_raster

    rng = np.random.default_rng(1)
    verts = torch.from_numpy(((rng.uniform(-1, 1, (150, 1, 3)) * [1, 0.8, 0.8])
                              + rng.normal(size=(150, 3, 3)) * 0.2).reshape(-1, 3).astype(np.float32))
    faces = torch.arange(450).reshape(-1, 3)
    cam = Camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), FoVx=1.0, FoVy=0.7, image_width=50,
                 image_height=30, device="cpu")
    frag = mesh_raster.rasterize_mesh(verts, faces, cam.world_view_transform,
                                      cam.full_proj_transform, 50, 30)
    assert "0 ties" in chip_smoke.check_raster(frag, verts, faces, cam, n=120)
    depth, ids, _ = chip_smoke.raster_reference(verts, faces, cam, [(25.0, 15.0), (0.0, 0.0)])
    assert ids[0] == int(frag.tri_id[15, 25]) and depth[0] == pytest.approx(
        float(frag.depth[15, 25]), rel=1e-5)
    with pytest.raises(RuntimeError, match="relative"):
        chip_smoke.check_raster(frag._replace(depth=frag.depth * (1 + 1e-4)), verts, faces, cam,
                                n=120)


@pytest.mark.parametrize("moved", ["swapped", "shifted"])
def test_phase13_check_raster_holds_the_barycentrics(moved):
    """check_raster fails barycentrics that are swapped or shifted by 1e-3,
    which their float32 bound on a 64x48 view does not cover."""
    from gaustudio_torch.cameras import Camera
    from gaustudio_torch.ops import mesh_raster

    rng = np.random.default_rng(2)
    verts = torch.from_numpy(((rng.uniform(-1, 1, (60, 1, 3)) * [1, 0.8, 0.8])
                              + rng.normal(size=(60, 3, 3)) * 0.4).reshape(-1, 3).astype(np.float32))
    faces = torch.arange(180).reshape(-1, 3)
    cam = Camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), FoVx=1.0, FoVy=0.8, image_width=64,
                 image_height=48, device="cpu")
    frag = mesh_raster.rasterize_mesh(verts, faces, cam.world_view_transform,
                                      cam.full_proj_transform, 64, 48)
    lam, bound = chip_smoke.bary_bound(verts, faces, cam, np.array([int(frag.tri_id[24, 32])]),
                                       np.array([[32, 24]]))
    assert np.abs(frag.bary[24, 32].double().numpy() - lam[0]).max() <= 2 * bound.max() < 1e-3
    bary = frag.bary[..., [1, 0, 2]] if moved == "swapped" else frag.bary + 1e-3
    with pytest.raises(RuntimeError, match="barycentrics"):
        chip_smoke.check_raster(frag._replace(bary=bary), verts, faces, cam, n=120)


def test_phase13_revote_ties_name_the_samples_at_the_threshold(monkeypatch):
    """A sample that the re-vote keeps on one path and drops on the other
    marks its Gaussian, with its distances from the threshold on both paths;
    a sample on the same side on both paths marks nothing."""
    from gaustudio_torch.cameras import Camera

    class Pcd:
        _xyz = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])

    cam = Camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), FoVx=1.0, FoVy=1.0, image_width=2,
                 image_height=2, device="cpu")
    up = [0.0, 0.0, 1.0]

    def path(tilt):
        return [{"valid": torch.tensor([[True, True], [True, False]]), "ids": torch.tensor([0, 1, 1]),
                 "normals": torch.tensor([up, up, up]), "conf": torch.ones(3)},
                {"valid": torch.tensor([[False, False], [False, True]]), "ids": torch.tensor([1]),
                 "normals": torch.tensor([tilt]), "conf": torch.ones(1)}]

    kern, plain = path([0.8, 0.0, 1.0]), path([0.8 + 1e-3, 0.0, 1.0])
    d_k = float(chip_smoke.revote_distances(Pcd, kern, [cam, cam])[-1])
    d_p = float(chip_smoke.revote_distances(Pcd, plain, [cam, cam])[-1])
    assert d_k < d_p
    monkeypatch.setattr(chip_smoke, "REVOTE_THRESHOLD", 0.5 * (d_k + d_p))
    ids, rows, noise, dn = chip_smoke.revote_ties(Pcd, kern, plain, [cam, cam])
    assert ids == {1} and len(rows) == 1 and rows[0][0] == 1
    assert rows[0][1] < 0 < rows[0][2] and noise == pytest.approx(d_p - d_k)
    assert dn == pytest.approx(1e-3, rel=1e-3)
    monkeypatch.setattr(chip_smoke, "REVOTE_THRESHOLD", d_p + 1e-3)
    assert chip_smoke.revote_ties(Pcd, kern, plain, [cam, cam])[:2] == (set(), [])


def test_phase13_raster_pixels_lie_mostly_on_the_coverage():
    """All but RASTER_EMPTY_PIXELS of the checked pixels lie within
    RASTER_GROW_PX of a covered pixel."""
    from gaustudio_torch.ops.mesh_raster import MeshFragments

    mask = torch.zeros(90, 160, dtype=torch.bool)
    mask[40:50, 70:80] = True
    frag = MeshFragments(depth=mask.float(), tri_id=torch.where(mask, 0, -1),
                         bary=torch.zeros(90, 160, 3), mask=mask)
    pix = chip_smoke.raster_pixels(frag, 100, seed=0)
    assert pix.shape == (100, 2)
    g = chip_smoke.RASTER_GROW_PX
    near = (pix[:, 0] >= 70 - g) & (pix[:, 0] < 80 + g) & (pix[:, 1] >= 40 - g) & (pix[:, 1] < 50 + g)
    assert near[:100 - chip_smoke.RASTER_EMPTY_PIXELS].all()


def test_kernels_line_sums_every_paths_launches_phase13s_too():
    names = list(chip_smoke.KERNELS)
    counts = [{k: 1 for k in names}, {k: 10 for k in names}, {k: 100 for k in names}]
    report = chip_smoke.kernels_report(
        counts, {k: 0.0 for k in names}, {k: (1.0, 2.0) for k in names},
        {k: (0.5, "bytes") for k in names})
    assert [k["name"] for k in report["kernels"]] == names and len(names) == 8
    assert all(k["launches"] == 111 for k in report["kernels"])
    assert all(k["library_ms"] is None for k in report["kernels"])
    source = inspect.getsource(chip_smoke.main)
    phase13 = ("path_counts.extend(pcd_fixture(", "path_counts.append(pcd_full(",
               "path_counts.extend(mesh_tools(")
    assert all(call in source for call in phase13)
    assert max(source.index(c) for c in phase13) < source.index("kernels_report(path_counts")


def test_phase14_capture_reads_back_through_the_jax_nerfstudio_loader(tmp_path):
    """Phase 14's capture writer on 3 views at 64x48 of a small sphere model
    rendered on the CPU: the JAX nerfstudio loader reads back the cameras
    (pose, field of view, principal point), the images, the 16-bit depths
    in millimetres and the masks as written."""
    from gaustudio_torch import renderers
    from gaustudio_tpu import datasets as j_datasets

    cams = chip_smoke.capture_cameras(64, 48, CPU, rings=(0.0,), per_ring=3)
    pcd = chip_smoke.sphere_model(2000, CPU)
    pcd._opacity = torch.full_like(pcd._opacity, 3.0)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=CPU)
    views = list(chip_smoke.capture_views(renderer, pcd, cams))
    root = str(tmp_path / "capture")
    xyz, rgb = chip_smoke.sphere_points(50)
    depths = chip_smoke.write_capture(root, cams, views, xyz, (rgb * 255).astype(np.uint8))
    assert all((d > 0).mean() > 0.05 for d in depths)

    ds = j_datasets.make({"name": "nerfstudio", "source_path": root, "w_mask": True})
    assert [c.image_name for c in ds] == [f"images/frame_{i:05d}.png" for i in range(3)]
    for jc, cam, (image, depth, alpha), d in zip(ds, cams, views, depths):
        assert (jc.image_width, jc.image_height) == (64, 48)
        np.testing.assert_allclose(jc.world_view_transform, cam.world_view_transform.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(jc.full_proj_transform, cam.full_proj_transform.numpy(),
                                   rtol=0, atol=1e-6)
        assert abs(jc.FoVx - cam.FoVx) < 1e-9 and abs(jc.FoVy - cam.FoVy) < 1e-9
        np.testing.assert_allclose(jc.principal_point_ndc, (0.5, 0.5), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(jc.image, np.round(np.clip(image, 0, 1) * 255) / 255)
        np.testing.assert_array_equal(jc.depth, d.astype(np.float32) / 1000.0)
        np.testing.assert_array_equal(jc.mask, (alpha > 0.5).astype(np.float32))
        np.testing.assert_allclose(jc.depth[alpha > 0.5], depth[alpha > 0.5], rtol=0,
                                   atol=5e-4 + 1e-6)  # rounded to the millimetre
    # the depth initializer's count: the JAX camera's 4x downsample (PIL NEAREST)
    assert chip_smoke.downsampled_valid(depths, 4) == sum(
        int((jc.downsample_scale(4).depth > 0).sum()) for jc in ds)


def test_kernels_line_counts_phase14s_launches():
    source = inspect.getsource(chip_smoke.main)
    assert source.index("path_counts.append(mesh_full(") < source.index(
        "path_counts.append(init_full(") < source.index("kernels_report(path_counts")


def test_phase15_path_w2c_is_the_cameras_extrinsics():
    """The world -> camera matrices phase 15 writes into images.bin and the
    known-pose model are those of the cameras gs-render builds of the path."""
    from gaustudio_torch.datasets.utils import JSON_to_camera

    for cj in chip_smoke.flythrough_cameras(n=5, W=64, H=48, arc_deg=30.0, lifts=(2,)):
        np.testing.assert_allclose(chip_smoke.path_w2c(cj),
                                   JSON_to_camera(cj, device=CPU).extrinsics.numpy(), atol=1e-6)


def test_phase15_points3d_with_tracks_reads_back_through_both_packages(tmp_path):
    """write_points3d_tracks (COLMAP's layout with tracks of 4, written in
    one numpy pass) reads back through the JAX reader and the port's."""
    from gaustudio_torch.datasets import utils as t_dsu
    from gaustudio_tpu.datasets import utils as j_dsu

    rng = np.random.default_rng(0)
    xyz, rgb = rng.normal(size=(40, 3)), rng.integers(0, 256, (40, 3))
    path = str(tmp_path / "points3D.bin")
    chip_smoke.write_points3d_tracks(path, xyz, rgb, chip_smoke.NATIVE_TRACK, seed=1)
    assert os.path.getsize(path) == 8 + 40 * (43 + 8 + 8 * chip_smoke.NATIVE_TRACK)
    for reader in (t_dsu.read_points3D_binary, t_dsu.read_points3D_binary_python,
                   j_dsu.read_points3D_binary):
        got_xyz, got_rgb, err = reader(path)
        np.testing.assert_array_equal(got_xyz, xyz)
        np.testing.assert_array_equal(got_rgb, rgb)
        assert err.shape == (40, 1) and (err > 0).all()


def test_phase15_native_readers_and_database_run_on_a_small_path(tmp_path):
    """Phase 15 (e) and (f), host code, on 4 cameras and 500 points."""
    path = chip_smoke.flythrough_cameras(n=4, W=64, H=48, arc_deg=30.0, lifts=())
    xyz = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    chip_smoke.native_readers(str(tmp_path), xyz, path, "CPU")
    chip_smoke.colmap_database(str(tmp_path), path, "CPU")
    assert {"points3D.bin", "images.bin", "database.db", "known_pose"} <= set(os.listdir(tmp_path))


def test_png_size_reads_the_header(tmp_path):
    from gaustudio_torch.utils.image import write_png

    write_png(str(tmp_path / "a.png"), np.zeros((5, 7, 3), np.uint8))
    assert chip_smoke.png_size(str(tmp_path / "a.png")) == (7, 5)


def test_kernels_line_counts_phase15s_launches():
    source = inspect.getsource(chip_smoke.main)
    assert source.index("path_counts.append(init_full(") < source.index(
        "path_counts.append(flythrough_full(") < source.index("kernels_report(path_counts")


def test_kernels_line_counts_phase16s_launches():
    source = inspect.getsource(chip_smoke.main)
    assert source.index("path_counts.append(flythrough_full(") < source.index(
        "path_counts.extend(multi_device(") < source.index("kernels_report(path_counts")


def test_phase16_render_cameras_extend_the_scenes_three_views():
    four = chip_smoke.scene_cameras(64, 48, chip_smoke.DP_RENDER_VIEWS)
    assert four[:3] == chip_smoke.scene_cameras(64, 48) and len(four) == 4


def test_phase16_one_process_dp_reference_at_dp_1_is_the_trainer(tmp_path, monkeypatch):
    """Phase 16 (b) holds dp = 2 to a one-process reference of the DP step;
    at dp = 1 that reference must be the Trainer itself: same camera draws,
    statistics, Adam and densify (a short schedule on a small scene)."""
    from gaustudio_torch.pipelines import train as T

    monkeypatch.setattr(chip_smoke, "DP_STEPS", 6)
    monkeypatch.setattr(chip_smoke, "DP_DENSIFY_AT", 5)
    ply, cams = chip_smoke.write_full_scene(str(tmp_path), n=400, W=32, H=24)
    pcd, views = chip_smoke.dp_scene(ply, cams, CPU)
    ref, _ = chip_smoke.dp_reference_train(pcd, views, chip_smoke.dp_config(), 1, CPU)
    single = chip_smoke.with_sh3(T.Trainer(pcd, views, chip_smoke.dp_config(), seed=0,
                                           device=CPU))
    single.train(iterations=6, log_every=6)
    assert ref.num_points == single.state.num_points > 400  # the densify fired
    for k, v in single.state.params.items():
        torch.testing.assert_close(ref.params[k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_phase16_scaled_grad_error_is_one_at_the_tolerance():
    want = torch.tensor([1.0, -0.5, 0.0])
    at = want + torch.tensor([chip_smoke.K4_ATOL + chip_smoke.K4_RTOL, 0.0, 0.0])
    assert chip_smoke.scaled_grad_error(want, want) == 0.0
    assert chip_smoke.scaled_grad_error(at, want) == pytest.approx(1.0, rel=1e-4)


def test_kernels_line_counts_phase17s_launches():
    source = inspect.getsource(chip_smoke.main)
    assert source.index("path_counts.extend(multi_device(") < source.index(
        "path_counts.extend(tools(") < source.index("kernels_report(path_counts")


def test_phase17_drives_the_tools_own_entry_points_and_bars():
    """Phase 17's captures, trainings and gates are the tools' own: each
    step runs a tool's run() (train_at_scale's train_and_evaluate, which
    run() wraps) and its bar."""
    from gaustudio_torch.tools import train_at_scale

    calls = {chip_smoke.tools_fixture: ("make_fixture.run(",),
             chip_smoke.tools_at_scale: ("tas.train_and_evaluate(", "tas.check_bars("),
             chip_smoke.tools_scaffold: ("train_scaffold.run(", "train_scaffold.check_bars("),
             chip_smoke.tools_demo: ("demo_e2e.run(",)}
    for fn, needles in calls.items():
        source = inspect.getsource(fn)
        assert all(n in source for n in needles), fn.__name__
    assert "train_and_evaluate(args)[0]" in inspect.getsource(train_at_scale.run)


def test_phase17_edge_pixels_mark_both_sides_of_an_edge():
    ids = np.full((5, 6), -1)
    ids[1:4, 1:3] = 7
    edge = chip_smoke.edge_pixels(ids)
    assert edge[1:4, 1:3].all() and edge[0, 0] and not edge[4, 5] and not edge[0, 5]
    assert not chip_smoke.edge_pixels(np.zeros((4, 4), int)).any()


def test_phase17_fixture_images_are_the_committed_ones_on_the_cpu(tmp_path):
    """(a)'s image check on the CPU: make_fixture's capture through the
    port's mesh rasterizer, written as the tool writes it, reproduces the
    committed PNGs; a changed pixel inside a face counts off the edges."""
    from gaustudio_torch.tools import make_fixture
    from gaustudio_torch.utils.image import load_rgb8, save_rgb8

    os.makedirs(tmp_path / "images")
    verts, faces = make_fixture.scene_mesh()
    cams = make_fixture.fixture_cameras(10, 128, CPU)
    for cam, img in zip(cams, make_fixture.render_mesh_views(verts, faces, cams, CPU)):
        save_rgb8(str(tmp_path / "images" / cam.image_name), (img * 255).astype(np.uint8))
    diff = chip_smoke.fixture_image_diff(str(tmp_path), CPU)
    assert diff == {"pixels": 10 * 128 * 128, "differ": 0, "at_edges": 0, "off_edge_max": 0}
    from gaustudio_torch.ops import mesh_raster

    frag = mesh_raster.rasterize_mesh(torch.from_numpy(verts), torch.from_numpy(faces.astype(
        np.int64)), cams[0].world_view_transform, cams[0].full_proj_transform, 128, 128)
    y, x = np.argwhere(~chip_smoke.edge_pixels(frag.tri_id.numpy()) & frag.mask.numpy())[0]
    path = str(tmp_path / "images" / "00000.png")
    img = load_rgb8(path).copy()
    img[y, x] = img[y, x] // 2 + 1
    save_rgb8(path, img)
    diff = chip_smoke.fixture_image_diff(str(tmp_path), CPU)
    assert diff["differ"] == 1 and diff["off_edge_max"] > 1


def test_phase17_takes_b_from_its_own_process_and_stops_it(tmp_path, monkeypatch):
    """(b) runs as ``chip_smoke.py --tools-at-scale`` beside (a), (c), (d):
    its counts are its output's last line, its failure fails the phase, and
    a failure of (a)-(d) stops it."""
    import subprocess
    import sys

    popen = subprocess.Popen
    started = []

    def child(code):
        def fake(cmd, **kw):
            assert cmd[1:] == [os.path.abspath(chip_smoke.__file__), "--tools-at-scale",
                               "--out", str(tmp_path)]
            started.append(popen([sys.executable, "-c", code], **kw))
            return started[-1]
        return fake

    step = {"render_tiles": 1}
    for name in ("tools_fixture", "tools_scaffold", "tools_demo"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: step)
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", child(
        "import json; print('[tools] (b) line'); print(json.dumps({'render_tiles': 7}))"))
    assert chip_smoke.tools(str(tmp_path), CPU, "CPU") == [step, step, step, {"render_tiles": 7}]

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", child("raise SystemExit(3)"))
    with pytest.raises(RuntimeError, match=r"phase 17 \(b\) failed"):
        chip_smoke.tools(str(tmp_path), CPU, "CPU")

    def fails(*a, **k):
        raise RuntimeError("(a) failed")

    monkeypatch.setattr(chip_smoke, "tools_fixture", fails)
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", child("import time; time.sleep(60)"))
    with pytest.raises(RuntimeError, match=r"\(a\) failed"):
        chip_smoke.tools(str(tmp_path), CPU, "CPU")
    assert started[-1].poll() is not None
