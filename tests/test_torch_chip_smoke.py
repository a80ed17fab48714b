"""What chip_smoke.py builds on the host, checked on the CPU: its copy of
bench.make_scene, its imports, the hard cases of phase 3 (through the plain
versions, which the kernels are held to on the card), K2's cases, and phase
11's scene and cameras against bench_all.py's."""

import ast
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
