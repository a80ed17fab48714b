"""Port parity: gaustudio_torch.ops.binning (plain versions of K1 and K2)
against the JAX binning. The JAX Pallas binning runs in interpret mode, as
tests/test_pallas.py runs it; both packages bin the same JAX-preprocessed
Gaussians."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gaustudio_torch.ops import binning as t_binning
from gaustudio_torch.ops.gaussian import Preprocessed as TPre
from gaustudio_tpu.ops import binning as j_binning
from gaustudio_tpu.ops import binning_fast, gaussian as j_gaussian
from tests.test_rasterize import _make_scene

import chip_smoke


def jax_preprocess(scene):
    st = scene["settings"]
    return j_gaussian.preprocess(
        jnp.asarray(scene["means"]), jnp.asarray(scene["opac"]),
        st.viewmatrix, st.projmatrix, st.campos, st.image_width, st.image_height,
        st.tanfovx, st.tanfovy, colors_precomp=jnp.asarray(scene["colors"]),
        scales=jnp.asarray(scene["scales"]), rotations=jnp.asarray(scene["quats"]))


def to_torch(pre) -> TPre:
    return TPre(*(torch.tensor(np.asarray(x)) for x in pre))


def tile_lists(point_list, ranges):
    pl = point_list.numpy()
    return [list(pl[s:e]) for s, e in ranges.numpy()]


@pytest.fixture(scope="module", params=[(4, 60, 48, 32), (1, 200, 80, 48)],
                ids=["48x32", "80x48"])
def binned(request):
    seed, n, w, h = request.param
    scene = _make_scene(n=n, seed=seed, w=w, h=h)
    pre = jax_preprocess(scene)
    gx, gy = (w + 15) // 16, (h + 15) // 16
    return pre, gx, gy, t_binning.bin_gaussians(to_torch(pre), gx, gy)


@pytest.mark.parametrize("num_tiles", [100, 1024, 2048])
def test_tile_ranges_match_searchsorted(num_tiles):
    rng = np.random.default_rng(0)
    tiles = np.sort(rng.integers(0, num_tiles, size=4096))
    keys = torch.from_numpy(tiles.astype(np.int64) << 32)
    got = t_binning.identify_tile_ranges(keys, num_tiles).numpy()
    start = np.searchsorted(tiles, np.arange(num_tiles))
    end = np.searchsorted(tiles, np.arange(num_tiles) + 1)
    empty = start == end
    np.testing.assert_array_equal(got[~empty, 0], start[~empty])
    np.testing.assert_array_equal(got[~empty, 1], end[~empty])
    assert (got[empty] == 0).all()


def fast_tile_lists(pre, gx, gy):
    """Per-tile Gaussian lists and entry count of the JAX fast binning."""
    with pltpu.force_tpu_interpret_mode():
        fast = jax.jit(lambda p: binning_fast.bin_gaussians_fast(p, gx, gy, 4096))(pre)
    flat = np.asarray(fast.flat_entries).T
    start = np.asarray(fast.tile_start)
    count = np.asarray(fast.tile_count)
    return [list(flat[s:s + c, 10].astype(np.int32)) for s, c in zip(start, count)], int(count.sum())


def test_tile_lists_equal_jax_fast_binning(binned):
    pre, gx, gy, tb = binned
    want, total = fast_tile_lists(pre, gx, gy)
    assert tile_lists(tb.point_list, tb.ranges) == want
    assert tb.num_rendered == total


@pytest.mark.parametrize("case", ["full_screen", "n33", "zero_tile_rows", "all_culled"])
def test_k1_case_tile_lists_equal_jax_fast_binning(case):
    """The plain K1 + sort + K2 against the JAX fast binning on the cases that
    stress the kernel's warp walk (chip_smoke.k1_case_arrays), at 64x64: a
    rect over the whole view among small ones, a ragged last warp, rows with
    no tiles (their rects garbage), and a view the cull empties."""
    arrays = chip_smoke.k1_case_arrays(case, 64, 64)
    pre = j_gaussian.Preprocessed(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = t_binning.bin_gaussians(to_torch(pre), 4, 4)
    want, total = fast_tile_lists(pre, 4, 4)
    assert tile_lists(tb.point_list, tb.ranges) == want
    assert tb.num_rendered == total
    assert (total == 0) == (case == "all_culled")


def test_tile_lists_are_subsequences_of_jax_golden(binned):
    pre, gx, gy, tb = binned
    ref = j_binning.bin_gaussians(pre, gx, gy, 4096)
    ref_gid = np.asarray(ref.gauss_id)
    ref_start = np.asarray(ref.tile_start)
    ref_count = np.asarray(ref.tile_count)
    got_lists = tile_lists(tb.point_list, tb.ranges)
    assert 0 < tb.num_rendered <= int(ref.num_rendered)
    for t, got in enumerate(got_lists):
        want = iter(ref_gid[ref_start[t]:ref_start[t] + ref_count[t]])
        assert all(g in want for g in got), f"tile {t}: not an ordered subsequence"


def test_keys_are_tile_then_depth(binned):
    pre, gx, _, _ = binned
    keys, gids = t_binning.duplicate_with_keys(to_torch(pre), gx)
    depths = np.asarray(pre.depths)[gids.numpy()]
    np.testing.assert_array_equal((keys.numpy() & 0xFFFFFFFF).astype(np.uint32).view(np.float32),
                                  depths)
    sk, order = torch.sort(keys, stable=True)
    tiles = (sk >> 32).numpy()
    assert (np.diff(tiles) >= 0).all()
    d = depths[order.numpy()]
    same = tiles[1:] == tiles[:-1]
    assert (d[1:][same] >= d[:-1][same]).all()
