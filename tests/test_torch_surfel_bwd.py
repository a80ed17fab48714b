"""Port parity of the 2DGS surfel backward.

``render_surfel_tiles_backward_plain`` (K6's plain version) against the
Pallas B8 reverse walk + ``reduce_surfel_entry_grads`` (B5) in interpret
mode, per-Gaussian gradients scaled by the reference's max |value| as in
tests/test_pallas_bwd.py; whole-``rasterize_surfels`` gradients against
``jax.grad`` of the XLA golden at tests/test_surfel.py's scaled atol 2e-4
(opacities <= 0.9, so the golden's 0.99-clamp gate never closes); and the
autograd Function's routing of the cotangents.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gaustudio_torch.ops import binning as t_binning
from gaustudio_torch.ops import composite_surfel as t_cs
from gaustudio_torch.ops import rasterize_surfel as t_surfel
from gaustudio_torch.ops.composite import image_to_tiles
from gaustudio_tpu.ops import rasterize_surfel as j_surfel
from gaustudio_tpu.ops import rasterize_surfel_pallas as SP
from gaustudio_tpu.ops import rasterize_surfel_pallas_bwd as SB
from tests.test_torch_surfel_preprocess import (
    jax_preprocess,
    settings,
    surfel_scene,
    torch_preprocess,
)

CT_SHAPES = {"color": (3,), "depth_sum": (), "m2": (), "normal": (3,), "final_T": (),
             "median": ()}


def _cotangents(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s + (h, w)).astype(np.float32) for k, s in CT_SHAPES.items()}


def _binned(scene):
    pre = torch_preprocess(scene)
    gx, gy = (scene["w"] + 15) // 16, (scene["h"] + 15) // 16
    return pre, t_binning.bin_gaussians(t_surfel.binning_input(pre), gx, gy, cull=False), gx, gy


def test_backward_plain_matches_pallas_b8_b5():
    scene = surfel_scene(n=40, seed=7, w=48, h=32)
    w, h = scene["w"], scene["h"]
    pre, b, gx, gy = _binned(scene)
    fwd = t_cs.render_surfel_tiles_plain(b.ranges, b.point_list, pre.M, pre.Dk, pre.mean2d,
                                         pre.opacities, pre.colors, pre.normal_view,
                                         gx, gy, w, h)
    ct = _cotangents(h, w)
    t = torch.from_numpy
    got = t_cs.render_surfel_tiles_backward_plain(
        b.ranges, b.point_list, pre.M, pre.Dk, pre.mean2d, pre.opacities, pre.colors,
        pre.normal_view, fwd.final_T, fwd.n_contrib, t(ct["color"]), t(ct["depth_sum"]),
        t(ct["m2"]), t(ct["normal"]), t(ct["final_T"]), t(ct["median"]), gx, gy, w, h)

    jpre = jax_preprocess(scene)
    tiles = lambda img: jnp.asarray(image_to_tiles(t(img), gx, gy).numpy())  # noqa: E731
    rows = lambda img: tiles(np.moveaxis(img, 0, -1)).transpose(0, 2, 1)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        sb = jax.jit(lambda p: SP.bin_surfels_fast(p, gx, gy, 1 << 13))(jpre)
        packed = jax.jit(lambda x: SP.composite_surfel_pallas(x, gx, gy))(sb)
        ct_tiles = jnp.concatenate([
            rows(ct["color"]), tiles(ct["depth_sum"])[:, None], tiles(ct["m2"])[:, None],
            rows(ct["normal"]), -tiles(ct["final_T"])[:, None], tiles(ct["median"])[:, None],
            packed[:, 10:11], packed[:, 12:13]], axis=1)
        flat = jax.jit(lambda x, c: SB.composite_surfel_backward_pallas(x, c, gx, gy))(
            sb, ct_tiles)
        dM, dDk, dop, dcol, dnrm, dmean2d = SB.reduce_surfel_entry_grads(flat, sb, 40)
    want = t_cs.SurfelGrads(M=dM, Dk=dDk, mean2d=dmean2d, opacity=dop, colors=dcol,
                            normal=dnrm)
    for name, a, ref in zip(got._fields, got, want):
        a, ref = a.numpy(), np.asarray(ref)
        scale = np.abs(ref).max() + 1e-6
        np.testing.assert_allclose(a / scale, ref / scale, rtol=2e-3, atol=2e-5, err_msg=name)
        assert np.abs(a).max() > 0.0, name


def _loss_terms(seed, h, w):
    rng = np.random.default_rng(seed)
    shapes = {"render": 3, "rendered_depth_sum": 1, "rendered_alpha": 1,
              "rendered_normal_view": 3, "rendered_dist_m2": 1, "rendered_dist_m1": 1,
              "rendered_median_depth": 1}
    return {k: rng.normal(size=(c, h, w)).astype(np.float32) for k, c in shapes.items()}


@pytest.mark.parametrize("sh_degree", [None, 3], ids=["precomp", "sh3"])
def test_rasterize_surfels_gradients_match_jax_grad(sh_degree):
    """tests/test_surfel.py:322-369's loss, with the median depth and SH
    colours: every cotangent path of the surfel buffers."""
    scene = surfel_scene(n=60, seed=11, sh_degree=sh_degree)
    h, w = scene["h"], scene["w"]
    js, ts = settings(scene)
    terms = _loss_terms(1, h, w)
    color_key = "shs" if sh_degree is not None else "colors"
    color_kw = "shs" if sh_degree is not None else "colors_precomp"
    args = [scene["xyz"], scene["opac"], scene["scales"], scene["quats"], scene[color_key],
            np.zeros((60, 2), np.float32)]

    def jloss(xyz, opac, scales, quats, colors, off):
        out = j_surfel.rasterize_surfels(xyz, opac, js, scales=scales, rotations=quats,
                                         means2D_offset=off, **{color_kw: colors})
        return sum(jnp.sum(out[k] * v) for k, v in terms.items())

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = t_surfel.rasterize_surfels(leaves[0], leaves[1], ts, scales=leaves[2],
                                     rotations=leaves[3], means2D_offset=leaves[5],
                                     **{color_kw: leaves[4]})
    loss = sum((out[k] * torch.from_numpy(v)).sum() for k, v in terms.items())
    got = torch.autograd.grad(loss, leaves)
    for name, a, ref in zip(("xyz", "opacity", "scales", "quats", color_key, "offset"),
                            got, want):
        a, ref = a.numpy(), np.asarray(ref)
        scale = np.abs(ref).max() + 1e-8
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a / scale, ref / scale, atol=2e-4, err_msg=name)
        assert np.abs(a).max() > 0.0, name


def test_autograd_function_routes_cotangents_to_the_backward():
    """composite_surfel()'s backward is render_surfel_tiles_backward_plain
    with the depth-sum and m1 cotangents added and dA = -dT_final; the median
    weight and id and n_contrib are not differentiable."""
    scene = surfel_scene(n=50, seed=2)
    w, h = scene["w"], scene["h"]
    pre, b, gx, gy = _binned(scene)
    leaves = [x.detach().clone().requires_grad_(True) for x in
              (pre.M, pre.Dk, pre.mean2d, pre.opacities, pre.colors, pre.normal_view)]
    out = t_cs.composite_surfel(*leaves, b.ranges, b.point_list, gx, gy, w, h)
    assert not (out.median_weight.requires_grad or out.median_id.requires_grad
                or out.n_contrib.requires_grad)
    ct = {k: torch.from_numpy(v) for k, v in _cotangents(h, w, seed=3).items()}
    m1 = torch.from_numpy(np.random.default_rng(4).normal(size=(h, w)).astype(np.float32))
    loss = ((out.color * ct["color"]).sum() + (out.depth_sum[0] * ct["depth_sum"]).sum()
            + (out.depth_sum[0] * m1).sum() + (out.dist_m2[0] * ct["m2"]).sum()
            + (out.normal * ct["normal"]).sum() + (out.final_T * ct["final_T"]).sum()
            + (out.median_depth[0] * ct["median"]).sum())
    grads = torch.autograd.grad(loss, leaves)
    want = t_cs.render_surfel_tiles_backward_plain(
        b.ranges, b.point_list, *(x.detach() for x in leaves), out.final_T.detach(),
        out.n_contrib, ct["color"], ct["depth_sum"] + m1, ct["m2"], ct["normal"],
        ct["final_T"], ct["median"], gx, gy, w, h)
    for name, a, ref in zip(("M", "Dk", "mean2d", "opacity", "colors", "normal"), grads,
                            (want.M, want.Dk, want.mean2d, want.opacity, want.colors,
                             want.normal)):
        torch.testing.assert_close(a, ref, rtol=0, atol=0, msg=name)
