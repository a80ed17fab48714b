"""The CUDA kernels of gaustudio_torch (K1-K3 forward, K4 backward; K1
without the cull, K5 surfel forward, K6 surfel backward; K7 preprocess
forward, K8 preprocess backward) against their plain PyTorch versions, on
the card (K8 also against torch autograd). Skipped where torch sees no CUDA
device.

The hard cases of K1-K6 (chip_smoke.py hard_case, k1_case and k2_cases: a
Gaussian or surfel in every tile, warps that end far apart, more than 256
entries a pixel, a ragged image whose bottom tiles hold an odd number of
rows; a full-screen primitive among thousands of small ones, 1, 31 and 33
primitives, rows with no tiles inside a warp, a view the cull empties;
empty and single-entry tiles) run here too, and K7 and K8 on every branch
of gaussian.preprocess and its hard rows (chip_smoke.k7_case), K7 inside the
vanilla, mip, gsplat and Scaffold renders, and K7 and K8 at 300k Gaussians
and inside one training step.

This file imports no jax. tests/conftest.py does, and the machine with the
card has no jax, so there pytest runs it without the conftest
(``python3 -m pytest --noconftest tests/test_torch_kernels_cuda.py``);
``python3 chip_smoke.py`` runs the same comparisons, at the mini_scene,
1080p/300k and 1080p/200k-surfel shapes and on the hard cases.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from gaustudio_torch.ops import binning, composite, composite_surfel, gaussian, rasterize_surfel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these comparisons on the card")
    return torch.device("cuda", torch.cuda.current_device())


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


def test_render_tiles_backward_matches_plain(pre):
    """K4 sums each warp's gradients with atomicAdd, in an order that changes
    from run to run: each gradient, scaled by the plain version's max
    |value|, agrees within the tolerance of tests/test_pallas_bwd.py."""
    p, gx, gy, w, h = pre
    b = binning.bin_gaussians(p, gx, gy, plain=True)
    fwd = composite.render_tiles_plain(b.ranges, b.point_list, p.means2d, p.conic, p.opacities,
                                       p.colors, p.depths, gx, gy, w, h)
    gen = torch.Generator(device=p.depths.device).manual_seed(0)
    cts = [torch.randn(shape, generator=gen, device=p.depths.device)
           for shape in ((3, h, w), (h, w), (h, w), (h, w))]
    args = (b.ranges, b.point_list, p.means2d, p.conic, p.opacities, p.colors, p.depths,
            torch.tensor([0.2, 0.4, 0.1], device=p.depths.device), fwd.final_T, fwd.n_contrib,
            *cts, gx, gy, w, h)
    got = composite.render_tiles_backward(*args)
    want = composite.render_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    for name, g, r in zip(got._fields, got, want):
        scale = float(r.abs().max()) + 1e-6
        torch.testing.assert_close(g / scale, r / scale, rtol=2e-3, atol=2e-5, msg=name)


@pytest.fixture(scope="module")
def surfels():
    """A 2000-surfel view at 200x120 and its binning (K1 without the cull)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these comparisons on the card")
    rng = np.random.default_rng(1)
    n, w, h = 2000, 200, 120
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.0, 6.0, n)], 1)
    quats = rng.normal(size=(n, 4))
    tan = 0.7
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1 / tan
    P[2, 2] = 100 / (100 - 0.01)
    P[2, 3] = -(100 * 0.01) / (100 - 0.01)
    P[3, 2] = 1.0
    pre = rasterize_surfel.preprocess_surfel(
        t(means), t(rng.uniform(0.1, 0.95, n)), t(np.eye(4)), t(P.T), torch.zeros(3, device=dev),
        w, h, scales=t(np.exp(rng.normal(size=(n, 2)) * 0.3) * 0.04),
        rotations=t(quats / np.linalg.norm(quats, axis=-1, keepdims=True)),
        colors_precomp=t(rng.uniform(0, 1, (n, 3))))
    bin_in = gaussian.Preprocessed(
        valid=pre.valid, depths=pre.depths, means2d=pre.mean2d,
        conic=torch.zeros((n, 3), device=dev), opacities=pre.opacities, colors=pre.colors,
        radii=pre.radii, rect_min=pre.rect_min, rect_max=pre.rect_max,
        tiles_touched=pre.tiles_touched)
    gx, gy = (w + 15) // 16, (h + 15) // 16
    args = (pre.M, pre.Dk, pre.mean2d, pre.opacities, pre.colors, pre.normal_view)
    return bin_in, binning.bin_gaussians(bin_in, gx, gy, plain=True, cull=False), args, (
        gx, gy, w, h)


def test_duplicate_with_keys_without_cull_matches_plain(surfels):
    bin_in, _, _, (gx, _, _, _) = surfels
    keys, gids = binning.duplicate_with_keys(bin_in, gx, cull=False)
    want_keys, want_gids = binning.duplicate_with_keys_plain(bin_in, gx, cull=False)
    torch.cuda.synchronize()
    assert keys.shape[0] == int(bin_in.tiles_touched.sum()) > 0
    assert torch.equal(keys, want_keys) and torch.equal(gids, want_gids)


def test_render_surfel_tiles_matches_plain(surfels):
    """K5 is held to K3's tolerance: floats within abs 1e-5 + rel 1e-5, the
    median id and n_contrib exactly."""
    _, b, args, grid = surfels
    got = composite_surfel.render_surfel_tiles(b.ranges, b.point_list, *args, *grid)
    want = composite_surfel.render_surfel_tiles_plain(b.ranges, b.point_list, *args, *grid)
    torch.cuda.synchronize()
    for name, g, r in zip(got._fields, got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g, r), name
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=name)


def test_render_surfel_tiles_backward_matches_plain(surfels):
    """K6 sums with atomicAdd, as K4 does: each gradient, scaled by the plain
    version's max |value|, within K4's tolerance."""
    _, b, args, grid = surfels
    _, _, w, h = grid
    fwd = composite_surfel.render_surfel_tiles_plain(b.ranges, b.point_list, *args, *grid)
    gen = torch.Generator(device=args[0].device).manual_seed(0)
    cts = [torch.randn(shape, generator=gen, device=args[0].device)
           for shape in ((3, h, w), (h, w), (h, w), (3, h, w), (h, w), (h, w))]
    full = (b.ranges, b.point_list, *args, fwd.final_T, fwd.n_contrib, *cts, *grid)
    got = composite_surfel.render_surfel_tiles_backward(*full)
    want = composite_surfel.render_surfel_tiles_backward_plain(*full)
    torch.cuda.synchronize()
    for name, g, r in zip(got._fields, got, want):
        scale = float(r.abs().max()) + 1e-6
        torch.testing.assert_close(g / scale, r / scale, rtol=2e-3, atol=2e-5, msg=name)


@pytest.mark.parametrize("case", chip_smoke.HARD_CASES)
def test_render_tiles_hard_case_matches_plain(case, cuda):
    """K1-K3 on a hard case: K3's floats within abs 1e-5 + rel 1e-5, its
    median id and n_contrib exactly (compare_kernels raises)."""
    pre, w, h = chip_smoke.hard_case(case, cuda)
    chip_smoke.compare_kernels(pre, w, h)


@pytest.mark.parametrize("case", chip_smoke.HARD_CASES)
def test_render_tiles_backward_hard_case_matches_plain(case, cuda):
    """K4 on a hard case within the tolerance of
    test_render_tiles_backward_matches_plain (compare_backward raises)."""
    pre, w, h = chip_smoke.hard_case(case, cuda)
    _, args = chip_smoke.compare_backward(pre, w, h, seed=4)
    chip_smoke.check_hard_case(case, args[0], args[1], args[9], w, h)


@pytest.mark.parametrize("case", chip_smoke.HARD_CASES)
def test_render_surfel_tiles_backward_hard_case_matches_plain(case, cuda):
    """K6 (and K1 without the cull and K5) on a hard case within their
    tolerances (compare_surfel_kernels raises)."""
    pre, w, h = chip_smoke.hard_case(case, cuda, surfel=True)
    _, _, args = chip_smoke.compare_surfel_kernels(pre, w, h, seed=5)
    chip_smoke.check_hard_case(case, args[0], args[1], args[9], w, h)


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no_cull"])
@pytest.mark.parametrize("case", chip_smoke.K1_CASES)
def test_duplicate_with_keys_case_matches_plain(case, cull, cuda):
    """K1 on a case of chip_smoke.k1_case at 1920x1080: keys and indices equal
    to the plain version's element for element (compare_k1 raises)."""
    pre, w, h = chip_smoke.k1_case(case, cuda)
    _, keys, gids = chip_smoke.compare_k1(pre, (w + 15) // 16, cull, case)
    torch.cuda.synchronize()
    if cull:
        no_cull = binning.duplicate_with_keys(pre, (w + 15) // 16, cull=False)[0].shape[0]
        chip_smoke.check_k1_case(case, pre, w, h, gids, no_cull)


@pytest.mark.parametrize("case", list(chip_smoke.k2_cases(torch.device("cpu"))))
def test_identify_tile_ranges_case_matches_plain(case, cuda):
    keys, num_tiles = chip_smoke.k2_cases(cuda)[case]
    got = binning.identify_tile_ranges(keys, num_tiles)
    want = binning.identify_tile_ranges_plain(keys, num_tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", chip_smoke.K7_CASES)
def test_preprocess_forward_case_matches_plain(case, cuda):
    """K7 on a case of chip_smoke.k7_case: valid and the integer outputs
    equal to gaussian.preprocess's, depth, mean, conic and opacity bit for
    bit, the colour (another order of the SH sum) within abs 1e-5 + rel 1e-5
    (compare_k7 raises)."""
    kw, _, _ = chip_smoke.k7_case(case, cuda)
    chip_smoke.compare_k7(kw, case)


@pytest.mark.parametrize("case", chip_smoke.K7_CASES)
def test_preprocess_backward_case_matches_plain(case, cuda):
    """K8 on a case of chip_smoke.k7_case, on upstream gradients in K4's
    layout with a third of the rows zero: within chip_smoke.K8_ATOL of
    gaussian.preprocess_backward_plain and of torch autograd through
    gaussian.preprocess, scaled, exact zeros on the zero rows (compare_k8
    raises)."""
    kw, _, _ = chip_smoke.k7_case(case, cuda)
    chip_smoke.compare_k8(kw, case, seed=len(case))


def test_preprocess_backward_at_300k_matches_plain(cuda):
    """K8 at 300k SH-3 Gaussians on a 1920x1080 view, held as in
    test_preprocess_backward_case_matches_plain."""
    chip_smoke.compare_k8(chip_smoke.k7_scene(300_000, 1920, 1080, cuda), "300k at 1920x1080",
                          seed=3)


def test_train_step_takes_k7_and_k8(cuda):
    """One training step on the fixture launches K7 once and K8 once, and its
    counters read gs.preprocess.calls / .kernel / .kernel_bwd 1 / 1 / 1; a
    render under inference_mode launches K7 alone, and .kernel_bwd reads 0."""
    from torch.profiler import ProfilerActivity, profile

    from gaustudio_torch import datasets
    from gaustudio_torch.pipelines import train as T
    from gaustudio_torch.utils import observability as obs

    ds = datasets.make({"name": "vanilla", "source_path": chip_smoke.FIXTURE})
    pcd = chip_smoke.load_model(os.path.join(chip_smoke.FIXTURE, "gaussians.ply"), 3, cuda)
    cfg = T.TrainConfig(iterations=1)
    trainer = T.Trainer(pcd, ds, cfg, device=cuda)
    batch = trainer.batch(trainer.cameras[0])
    settings = trainer.settings()
    state = T.init_state(pcd, cuda)
    launches = {k: f.launches for k, f in (("k7", gaussian.preprocess_forward),
                                           ("k8", gaussian.preprocess_backward))}
    obs.report()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        T.train_step(state, batch, settings, cfg)
        torch.cuda.synchronize()
        rep = obs.report()
    assert gaussian.preprocess_forward.launches - launches["k7"] == 1
    assert gaussian.preprocess_backward.launches - launches["k8"] == 1
    c = rep["counters"]
    assert (c["gs.preprocess.calls"], c["gs.preprocess.kernel"],
            c["gs.preprocess.kernel_bwd"]) == (1, 1, 1)
    assert rep["spans"]["gs.preprocess_bwd"]["device_ms"] > 0.0
    obs.report()  # outside a profiler: the next window starts a record of its own
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.inference_mode():
            s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                                  campos=batch.campos, bg=torch.zeros(3, device=cuda))
            T.render_from_params(state.params, state.active_sh_degree, s)
        torch.cuda.synchronize()
        rep = obs.report()
    assert gaussian.preprocess_backward.launches - launches["k8"] == 1
    assert rep["counters"]["gs.preprocess.kernel"] == 1
    assert rep["counters"].get("gs.preprocess.kernel_bwd", 0) == 0


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """A 3000-Gaussian SH-3 scene and its three 200x120 cameras."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these comparisons on the card")
    return chip_smoke.write_full_scene(str(tmp_path_factory.mktemp("k7")), n=3000, W=200, H=120)


@pytest.mark.parametrize("config", ["vanilla", "mip", "gsplat", "scaffold"])
def test_render_through_preprocess_forward_matches_the_torch_preprocess(config, small_scene,
                                                                        cuda):
    """Each view's rasterize() with K7 against the same call through
    gaussian.preprocess, both through K1-K3: int outputs equal, floats within
    K3's tolerance, one K7 launch a render (compare_k7_render raises)."""
    from gaustudio_torch import models, renderers
    from gaustudio_torch.config import builtin_config_path, load_config

    ply, cams_path = small_scene
    conf = load_config(builtin_config_path(config))
    if config == "scaffold":
        xyz = chip_smoke.make_scene(300, seed=chip_smoke.SCAFFOLD_SEED)[0]
        pcd = chip_smoke.scaffold_model(xyz, cuda)
    else:
        pcd = models.make(conf["model"]["pointcloud"], device=cuda)
        pcd.load(ply)
        pcd.active_sh_degree = 3
    renderer = renderers.make(conf["renderer"], device=cuda)
    for cam in chip_smoke.load_cameras(cams_path, cuda):
        chip_smoke.compare_k7_render(renderer, cam, pcd, f"{config} {cam.image_name}")
