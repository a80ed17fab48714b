"""The three CUDA kernels of gaustudio_torch against their plain PyTorch
versions, on the card. Skipped where torch sees no CUDA device.

This file imports no jax. tests/conftest.py does, though, and the machine
with the card has no jax, so pytest cannot collect this file there:
``python3 chip_smoke.py`` runs the same comparisons on the card, at the
mini_scene and 1080p/300k shapes. The tests stay here for a machine that has
both a card and jax.
"""

import numpy as np
import pytest
import torch

from gaustudio_torch.ops import binning, composite, gaussian

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def pre():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these comparisons on the card")
    rng = np.random.default_rng(0)
    n, w, h = 4000, 200, 120
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.0, 6.0, n)], 1).astype(np.float32)
    scales = (np.exp(rng.normal(size=(n, 3)) * 0.3) * 0.03).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    tan = 0.7
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1 / tan
    P[2, 2] = 100 / (100 - 0.01)
    P[2, 3] = -(100 * 0.01) / (100 - 0.01)
    P[3, 2] = 1.0
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    p = gaussian.preprocess(
        t(means), t(rng.uniform(0.1, 0.95, n).astype(np.float32)), t(np.eye(4, dtype=np.float32)),
        t(P.T), torch.zeros(3, device=dev), w, h, tan, tan,
        colors_precomp=t(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
        scales=t(scales), rotations=t(quats))
    return p, (w + 15) // 16, (h + 15) // 16, w, h


def test_duplicate_with_keys_matches_plain(pre):
    p, gx, _, _, _ = pre
    keys, gids = binning.duplicate_with_keys(p, gx)
    want_keys, want_gids = binning.duplicate_with_keys_plain(p, gx)
    torch.cuda.synchronize()
    assert keys.shape[0] > 0
    assert torch.equal(keys, want_keys)
    assert torch.equal(gids, want_gids)


def test_identify_tile_ranges_matches_plain(pre):
    p, gx, gy, _, _ = pre
    keys, _ = binning.duplicate_with_keys_plain(p, gx)
    sorted_keys, _ = torch.sort(keys, stable=True)
    got = binning.identify_tile_ranges(sorted_keys, gx * gy)
    want = binning.identify_tile_ranges_plain(sorted_keys, gx * gy)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_render_tiles_matches_plain(pre):
    p, gx, gy, w, h = pre
    b = binning.bin_gaussians(p, gx, gy, plain=True)
    args = (b.ranges, b.point_list, p.means2d, p.conic, p.opacities, p.colors, p.depths,
            gx, gy, w, h)
    got = composite.render_tiles(*args)
    want = composite.render_tiles_plain(*args)
    torch.cuda.synchronize()
    for name, g, r in zip(got._fields, got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g, r), name
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=name)
