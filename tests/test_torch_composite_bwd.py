"""Port parity of the compositor's backward and of its training forward.

``render_tiles_backward_plain`` (K4's plain version) against the JAX golden
reverse walk ``rasterize_ref._composite_bwd`` and against the Pallas B4 + B5
pair (``composite_backward_pallas`` + ``reduce_entry_grads``, interpret
mode): per-Gaussian gradients only, since the port's per-tile lists are
culled and the golden's are not. Scaled tolerance of tests/test_pallas_bwd.py.

The autograd Function's forward against the inference forward and against
the Pallas compositor on realigned blocks (``bin_gaussians_fast(...,
realign=True)``): the port reads each tile's run in place, which is what
makes the realign pass (B6) unneeded.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gaustudio_torch.ops import binning as t_binning
from gaustudio_torch.ops import composite as t_composite
from gaustudio_torch.ops.gaussian import Preprocessed as TPre
from gaustudio_tpu.ops import binning as j_binning
from gaustudio_tpu.ops import binning_fast, rasterize_pallas, rasterize_ref
from gaustudio_tpu.ops import gaussian as j_gaussian
from gaustudio_tpu.ops import rasterize_pallas_bwd as BW
from tests.test_rasterize import _make_scene

BG = np.asarray([0.2, 0.4, 0.1], np.float32)
NAMES = ("means2d", "conic", "opacity", "colors", "depths")


def _assert_grads_close(got, want):
    """tests/test_pallas_bwd.py:94-99: scaled by the reference's max |value|."""
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b).reshape(np.shape(a))
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, rtol=2e-3, atol=2e-5, err_msg=name)


@pytest.fixture(scope="module")
def scene():
    w, h = 48, 32
    s = _make_scene(n=60, seed=4, w=w, h=h)
    st = s["settings"]
    gx, gy = (w + 15) // 16, (h + 15) // 16
    pre = j_gaussian.preprocess(
        jnp.asarray(s["means"]), jnp.asarray(s["opac"]),
        st.viewmatrix, st.projmatrix, st.campos, w, h, st.tanfovx, st.tanfovy,
        colors_precomp=jnp.asarray(s["colors"]),
        scales=jnp.asarray(s["scales"]), rotations=jnp.asarray(s["quats"]))
    rng = np.random.default_rng(0)
    ct = {  # cotangent images
        "color": rng.normal(size=(3, h, w)).astype(np.float32),
        "depth": rng.normal(size=(h, w)).astype(np.float32),
        "final_T": rng.normal(size=(h, w)).astype(np.float32),
        "median": rng.normal(size=(h, w)).astype(np.float32),
    }
    tp = TPre(*(torch.tensor(np.asarray(x)) for x in pre))
    binned = t_binning.bin_gaussians(tp, gx, gy)
    fwd = t_composite.render_tiles_plain(binned.ranges, binned.point_list, tp.means2d, tp.conic,
                                         tp.opacities, tp.colors, tp.depths, gx, gy, w, h)
    got = t_composite.render_tiles_backward_plain(
        binned.ranges, binned.point_list, tp.means2d, tp.conic, tp.opacities, tp.colors,
        tp.depths, torch.from_numpy(BG), fwd.final_T, fwd.n_contrib,
        *(torch.from_numpy(ct[k]) for k in ("color", "depth", "final_T", "median")),
        gx, gy, w, h)
    return dict(pre=pre, tp=tp, binned=binned, fwd=fwd, ct=ct, got=got, gx=gx, gy=gy, w=w, h=h)


def _tile_major(img, gx, gy):
    """[H, W, ...] numpy image -> golden [T + 1, 256, ...] layout, zero padded."""
    return np.asarray(t_composite.image_to_tiles(torch.from_numpy(img), gx, gy).numpy())


def test_backward_plain_matches_golden_reverse_walk(scene):
    pre, gx, gy, ct = scene["pre"], scene["gx"], scene["gy"], scene["ct"]
    ref_bin = j_binning.bin_gaussians(pre, gx, gy, 4096)
    fwd, _ = rasterize_ref._composite_fwd_impl(
        gx, gy, 256, pre.means2d, pre.conic, pre.colors, pre.depths, pre.opacities,
        ref_bin.gauss_id, ref_bin.tile_id, ref_bin.entry_valid, ref_bin.tile_start)
    pad = lambda x: jnp.asarray(np.concatenate([x, np.zeros((1,) + x.shape[1:], x.dtype)]))
    tm = lambda img: pad(_tile_major(img, gx, gy))
    cot = rasterize_ref.CompositeOut(
        color=tm(np.moveaxis(ct["color"], 0, -1)), depth=tm(ct["depth"]),
        median_depth=tm(ct["median"]), median_weight=jnp.zeros_like(fwd.depth),
        median_id=jnp.zeros_like(fwd.depth), final_T=tm(ct["final_T"]),
        n_contrib=jnp.zeros_like(fwd.n_contrib))
    res = (pre.means2d, pre.conic, pre.colors, pre.depths, pre.opacities, jnp.asarray(BG),
           ref_bin.gauss_id, ref_bin.tile_id, ref_bin.entry_valid, ref_bin.tile_start,
           fwd.final_T, fwd.n_contrib)
    d_m, d_c, d_col, d_dep, d_op = rasterize_ref._composite_bwd(gx, gy, 256, res, cot)[:5]
    got = scene["got"]
    _assert_grads_close(got, (d_m, d_c, d_op, d_col, d_dep))
    assert float(got.opacity.abs().max()) > 0.0 and float(got.depths.abs().max()) > 0.0


def test_backward_plain_matches_pallas_b4_b5(scene):
    """B4 (_backward_kernel) + B5 (_segreduce_kernel): the port does both
    jobs in one reverse walk whose per-warp sums land by atomics (K4)."""
    pre, gx, gy, ct = scene["pre"], scene["gx"], scene["gy"], scene["ct"]
    with pltpu.force_tpu_interpret_mode():
        binned = jax.jit(lambda p: binning_fast.bin_gaussians_fast(p, gx, gy, 4096))(pre)
        packed = jax.jit(lambda b: rasterize_pallas.composite_pallas(b, gx, gy))(binned)
    tiles = lambda img: jnp.asarray(_tile_major(img, gx, gy))  # [T, 256]
    ct_tiles = jnp.concatenate([
        tiles(np.moveaxis(ct["color"], 0, -1)).transpose(0, 2, 1),
        tiles(ct["depth"])[:, None, :],
        -tiles(ct["final_T"])[:, None, :],  # dO = -dT
        tiles(ct["median"])[:, None, :],
        packed[:, 7:8, :],
        packed[:, 8:9, :],
    ], axis=1)
    with pltpu.force_tpu_interpret_mode():
        blocks = jax.jit(lambda b, c: BW.composite_backward_pallas(b, c, jnp.asarray(BG),
                                                                   gx, gy))(binned, ct_tiles)
        d_m, d_c, d_col, d_dep, d_op = BW.reduce_entry_grads(blocks, binned,
                                                             pre.means2d.shape[0])
    _assert_grads_close(scene["got"], (d_m, d_c, d_op, d_col, d_dep))


def test_training_forward_matches_inference_and_realigned_pallas(scene):
    tp, binned, gx, gy, w, h = (scene[k] for k in ("tp", "binned", "gx", "gy", "w", "h"))
    leaves = [x.clone().requires_grad_(True) for x in
              (tp.means2d, tp.conic, tp.opacities, tp.colors, tp.depths)]
    train = t_composite.composite(*leaves, torch.from_numpy(BG), binned.ranges,
                                  binned.point_list, gx, gy, w, h)
    assert train.color.requires_grad
    infer = scene["fwd"]
    for name, a, b in zip(t_composite.CompositeOut._fields, train, infer):
        assert torch.equal(a.detach(), b), name

    with pltpu.force_tpu_interpret_mode():
        blocks = jax.jit(lambda p: binning_fast.bin_gaussians_fast(
            p, gx, gy, 4096, realign=True))(scene["pre"])
        packed = jax.jit(lambda b: rasterize_pallas.composite_pallas(b, gx, gy))(blocks)
    packed = np.asarray(packed)  # [T, 16, 256]
    tiles = lambda x: t_composite.image_to_tiles(x.detach(), gx, gy).numpy()
    np.testing.assert_allclose(tiles(train.color.permute(1, 2, 0)),
                               packed[:, 0:3].transpose(0, 2, 1), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tiles(train.depth[0]), packed[:, 3], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tiles(train.median_depth[0]), packed[:, 4], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tiles(train.median_weight[0]), packed[:, 5], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(tiles(train.median_id[0]), packed[:, 6].astype(np.int32))
    np.testing.assert_allclose(tiles(train.final_T), packed[:, 7], rtol=2e-4, atol=2e-5)
    nc, ref_nc = tiles(train.n_contrib), packed[:, 8].astype(np.int32)
    assert (nc <= ref_nc).all()
    np.testing.assert_array_equal(nc == 0, ref_nc == 0)


def test_autograd_function_routes_cotangents_to_the_backward(scene):
    """torch.autograd through composite() gives render_tiles_backward_plain's
    gradients for the loss whose cotangents are the scene's; the median
    weight's cotangent is ignored."""
    tp, binned, gx, gy, w, h, ct = (scene[k] for k in ("tp", "binned", "gx", "gy", "w", "h", "ct"))
    leaves = [x.clone().requires_grad_(True) for x in
              (tp.means2d, tp.conic, tp.opacities, tp.colors, tp.depths)]
    out = t_composite.composite(*leaves, torch.from_numpy(BG), binned.ranges,
                                binned.point_list, gx, gy, w, h)
    t = lambda k: torch.from_numpy(ct[k])
    loss = ((out.color * t("color")).sum() + (out.depth[0] * t("depth")).sum()
            + (out.final_T * t("final_T")).sum() + (out.median_depth[0] * t("median")).sum()
            + 123.0 * out.median_weight.sum())
    grads = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(NAMES, grads, scene["got"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
