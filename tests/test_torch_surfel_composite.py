"""Port parity of the 2DGS surfel forward: ``rasterize_surfels`` (K5's plain
version ``render_surfel_tiles_plain`` on the CPU) against the JAX golden
``backend="xla"`` at tests/test_surfel.py's tolerance, and against the Pallas
B7 compositor in train mode (realigned blocks) in interpret mode; an empty
and a saturated scene; the SurfelRenderer against the JAX one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gaustudio_torch import models as t_models
from gaustudio_torch import renderers as t_renderers
from gaustudio_torch.cameras import Camera as TCamera
from gaustudio_torch.ops import binning as t_binning
from gaustudio_torch.ops import composite_surfel as t_cs
from gaustudio_torch.ops import rasterize_surfel as t_surfel
from gaustudio_torch.ops.composite import image_to_tiles
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.ops import rasterize_surfel as j_surfel
from gaustudio_tpu.ops import rasterize_surfel_pallas as SP
from tests.test_torch_surfel_preprocess import (
    SURFEL_ATTRS,
    jax_preprocess,
    settings,
    surfel_scene,
    torch_preprocess,
)

FLOAT_KEYS = ("render", "rendered_alpha", "rendered_normal_view", "rendered_depth_sum",
              "rendered_median_depth", "rendered_median_weight", "rendered_dist_m1",
              "rendered_dist_m2")


def _both(scene):
    js, ts = settings(scene)
    t = torch.from_numpy
    if "shs" in scene:
        jc, tc = dict(shs=jnp.asarray(scene["shs"])), dict(shs=t(scene["shs"]))
    else:
        jc = dict(colors_precomp=jnp.asarray(scene["colors"]))
        tc = dict(colors_precomp=t(scene["colors"]))
    ref = j_surfel.rasterize_surfels(
        jnp.asarray(scene["xyz"]), jnp.asarray(scene["opac"]), js,
        scales=jnp.asarray(scene["scales"]), rotations=jnp.asarray(scene["quats"]), **jc)
    got = t_surfel.rasterize_surfels(
        t(scene["xyz"]), t(scene["opac"]), ts, scales=t(scene["scales"]),
        rotations=t(scene["quats"]), **tc)
    return got, ref


@pytest.mark.parametrize("kw", [dict(n=60, seed=11), dict(n=150, seed=4, w=80, h=48, sh_degree=3)],
                         ids=["64x48", "80x48-sh3"])
def test_rasterize_surfels_matches_jax_xla(kw):
    got, ref = _both(surfel_scene(**kw))
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["rendered_median_id"].numpy(),
                                  np.asarray(ref["rendered_median_id"]))
    np.testing.assert_array_equal(got["radii"].numpy(), np.asarray(ref["radii"]))
    assert got["num_rendered"] == int(ref["num_rendered"])
    assert got["rendered_dist_m1"] is got["rendered_depth_sum"]  # one output
    assert float(got["rendered_alpha"].max()) > 0.5


def test_render_surfel_tiles_plain_matches_pallas_b7():
    """B7 (_surfel_kernel) in train mode, on 256-aligned blocks: the port
    reads each tile's run in place and needs no realign pass (B6)."""
    scene = surfel_scene(n=40, seed=7, w=48, h=32)
    gx, gy, w, h = 3, 2, 48, 32
    jpre = jax_preprocess(scene)
    with pltpu.force_tpu_interpret_mode():
        sb = jax.jit(lambda p: SP.bin_surfels_fast(p, gx, gy, 1 << 13))(jpre)
        packed = np.asarray(jax.jit(lambda b: SP.composite_surfel_pallas(b, gx, gy))(sb))
    pre = torch_preprocess(scene)
    b = t_binning.bin_gaussians(t_surfel.binning_input(pre), gx, gy, cull=False)
    out = t_cs.render_surfel_tiles_plain(b.ranges, b.point_list, pre.M, pre.Dk, pre.mean2d,
                                         pre.opacities, pre.colors, pre.normal_view,
                                         gx, gy, w, h)
    tiles = lambda x: image_to_tiles(x, gx, gy).numpy()  # noqa: E731
    chw = lambda x: tiles(x.permute(1, 2, 0)).transpose(0, 2, 1)  # noqa: E731
    close = lambda a, b, atol=1e-5: np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)  # noqa: E731
    close(chw(out.color), packed[:, 0:3])
    close(tiles(out.depth_sum[0]), packed[:, 3], atol=1e-4)
    close(chw(out.normal), packed[:, 4:7])
    close(tiles(out.median_depth[0]), packed[:, 7], atol=1e-4)
    close(tiles(out.median_weight[0]), packed[:, 8])
    np.testing.assert_array_equal(tiles(out.median_id[0]), packed[:, 9].astype(np.int32))
    close(tiles(out.final_T), packed[:, 10])
    close(tiles(out.dist_m2[0]), packed[:, 11], atol=1e-3)
    np.testing.assert_array_equal(tiles(out.n_contrib), packed[:, 12].astype(np.int32))
    assert out.n_contrib.max() > 1


def test_empty_and_saturated_scenes():
    """tests/test_surfel.py:279-320: every surfel behind the camera, and a
    stack of 200 opaque surfels that terminates every centre pixel."""
    n = 16
    empty = surfel_scene(n=n, seed=0)
    empty["xyz"] = np.zeros((n, 3), np.float32)
    empty["xyz"][:, 2] = -5.0
    got, ref = _both(empty)
    assert float(got["rendered_alpha"].max()) == 0.0 and got["num_rendered"] == 0
    assert torch.isfinite(got["render"]).all()

    n = 200
    sat = surfel_scene(n=n, seed=0)
    sat["xyz"] = np.zeros((n, 3), np.float32)
    sat["xyz"][:, 2] = np.linspace(1.0, 2.0, n, dtype=np.float32)
    sat["scales"] = np.full((n, 2), 0.1, np.float32)
    sat["quats"] = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    sat["opac"] = np.full(n, 0.95, np.float32)
    sat["colors"] = np.full((n, 3), 0.5, np.float32)
    got, ref = _both(sat)
    for k in FLOAT_KEYS:
        assert torch.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(got["rendered_alpha"][0, 24, 32]) > 0.99
    assert int(got["n_contrib"][24, 32]) < n  # the walk stopped early


def test_surfel_renderer_matches_jax():
    """The SurfelRenderer's decode (expected depth, world normals) on an SH-1
    model of 2-column scales, against the JAX renderer."""
    rng = np.random.default_rng(1)
    n = 50
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    attrs = dict(xyz=xyz, rgb=rng.uniform(size=(n, 3)).astype(np.float32),
                 scale=np.log(rng.uniform(0.05, 0.2, (n, 2))).astype(np.float32), rot=quats)
    conf = {"name": "vanilla_pcd", "attributes": SURFEL_ATTRS}
    jp, tp = j_models.make(conf), t_models.make(conf, device="cpu")
    jp.create_from_attribute(**attrs)
    tp.create_from_attribute(**attrs)
    f_rest = (rng.normal(size=(n, 45)) * 0.1).astype(np.float32)
    jp._f_rest, tp._f_rest = f_rest, torch.from_numpy(f_rest)
    jp.active_sh_degree = tp.active_sh_degree = 1
    cam = dict(R=np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]),
               T=np.array([0.1, -0.2, 3.0]), FoVx=1.0, FoVy=0.8, image_width=64,
               image_height=48)
    from gaustudio_tpu.cameras import Camera as JCamera

    ref = j_renderers.make({"name": "surfel_renderer"}).render(JCamera(**cam), jp)
    got = t_renderers.make({"name": "surfel_renderer"}, device="cpu").render(
        TCamera(**cam, device="cpu"), tp)
    for k in ("render", "rendered_normal", "rendered_depth", "rendered_final_opacity",
              "rendered_median_depth", "rendered_dist_m2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["radii"].numpy(), np.asarray(ref["radii"]))
    assert float(got["rendered_final_opacity"].max()) > 0.5
