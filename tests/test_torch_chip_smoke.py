"""What chip_smoke.py builds on the host, checked on the CPU: its copy of
bench.make_scene, its imports, the hard cases of phase 3 (through the plain
versions, which the kernels are held to on the card) and K2's cases."""

import ast
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
