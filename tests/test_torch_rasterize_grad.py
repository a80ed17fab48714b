"""Gradients of the port's whole rasterize() against jax.grad of the JAX
rasterize(backend="xla"), and the port's guards of the training-only traps:
NaN gradients from culled rows (ROADMAP C.2), the zero quaternion (C.3) and
the (0.5 W, 0.5 H) scale of the viewspace gradient (C.5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaustudio_torch.ops import binning as t_binning
from gaustudio_torch.ops import composite as t_composite
from gaustudio_torch.ops import gaussian as t_gaussian
from gaustudio_torch.ops import rasterize as t_rasterize
from gaustudio_torch.pipelines import train as t_train
from gaustudio_tpu.ops import rasterize as j_rasterize
from tests.test_rasterize import _make_scene

NAMES = ("xyz", "opacity", "scales", "rotations", "shs", "means2D_offset")


def _settings(scene):
    st = scene["settings"]
    t = lambda a: torch.tensor(np.asarray(a))
    ts = t_rasterize.RasterizeSettings(
        image_height=st.image_height, image_width=st.image_width, tanfovx=st.tanfovx,
        tanfovy=st.tanfovy, bg=torch.zeros(3), viewmatrix=t(st.viewmatrix),
        projmatrix=t(st.projmatrix), sh_degree=3, campos=t(st.campos))
    return st._replace(backend="xla", sh_degree=3), ts


def _weighted(out, w_rgb, w_d, w_o, xp):
    """The loss of tests/test_rasterize.py:220-238."""
    return (xp.sum(out["render"] * w_rgb) + xp.sum(out["rendered_depth"][0] * w_d)
            + xp.sum(out["rendered_final_opacity"][0] * w_o))


@pytest.mark.parametrize("seed,n,w,h", [(4, 60, 48, 32), (1, 200, 80, 48)],
                         ids=["48x32", "80x48"])
def test_rasterize_gradients_match_jax(seed, n, w, h):
    scene = _make_scene(n=n, seed=seed, w=w, h=h)
    js, ts = _settings(scene)
    rng = np.random.default_rng(seed + 7)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    w_rgb = rng.normal(size=(3, h, w)).astype(np.float32)
    w_d = rng.normal(size=(h, w)).astype(np.float32)
    w_o = rng.normal(size=(h, w)).astype(np.float32)
    inputs = (scene["means"], scene["opac"], scene["scales"], scene["quats"], shs,
              np.zeros((n, 2), np.float32))

    def j_loss(xyz, opac, scales, quats, sh, offset):
        out = j_rasterize.rasterize(xyz, opac, js, shs=sh, scales=scales, rotations=quats,
                                    means2D_offset=offset)
        return _weighted(out, w_rgb, w_d, w_o, jnp)

    want = jax.grad(j_loss, argnums=tuple(range(6)))(*map(jnp.asarray, inputs))
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    xyz, opac, scales, quats, sh, offset = leaves
    out = t_rasterize.rasterize(xyz, opac, ts, shs=sh, scales=scales, rotations=quats,
                                means2D_offset=offset, active_sh_degree=3)
    got = torch.autograd.grad(
        _weighted(out, *(torch.from_numpy(x) for x in (w_rgb, w_d, w_o)), torch), leaves)
    for name, a, b in zip(NAMES, got, want):
        a, b = a.numpy(), np.asarray(b)
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, rtol=2e-3, atol=2e-5, err_msg=name)
        assert np.abs(b).max() > 0.0, name


def test_gradients_finite_with_degenerate_points():
    """Port of tests/test_rasterize.py:325-358 (C.2): culled rows (z ~ 0,
    behind the camera, at the camera, boundary opacity) keep finite gradients."""
    s = _make_scene(n=12, seed=7, w=32, h=32)
    _, ts = _settings(s)
    xyz = np.asarray(s["means"]).copy()
    opac = np.asarray(s["opac"]).copy()
    xyz[0] = [0.0, 0.0, 1e-8]
    xyz[1] = [0.1, 0.1, -0.5]
    xyz[2] = [0.0, 0.1, 0.2]
    xyz[3] = np.asarray(s["settings"].campos)
    opac[4] = 1.0 / 255.0
    xyz[5] = [0.0, 0.0, -1e-9]
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (xyz, s["scales"], s["quats"], opac, s["colors"])]
    xyz_t, scales, quats, op, colors = leaves
    out = t_rasterize.rasterize(xyz_t, op, ts, colors_precomp=colors, scales=scales,
                                rotations=quats)
    loss = (out["render"].sum() + out["rendered_depth"].sum()
            + out["rendered_final_opacity"].sum())
    grads = torch.autograd.grad(loss, leaves)
    for name, g in zip(["xyz", "scales", "quats", "opac", "colors"], grads):
        assert torch.isfinite(g).all(), f"non-finite grad: {name}"
    assert float(grads[0].abs().max()) > 0.0


def test_means2d_offset_gradient_is_scaled_by_half_the_image():
    """C.5: d loss / d means2D_offset is the pixel-space mean gradient times
    (0.5 W, 0.5 H), the reference's viewspace convention that the densify
    threshold is tuned for."""
    s = _make_scene(n=60, seed=4, w=48, h=32)
    _, ts = _settings(s)
    W, H = ts.image_width, ts.image_height
    gx, gy = (W + 15) // 16, (H + 15) // 16
    args = [torch.from_numpy(s[k]) for k in ("means", "opac", "colors", "scales", "quats")]
    w_rgb = torch.from_numpy(np.random.default_rng(2).normal(size=(3, H, W)).astype(np.float32))

    offset = torch.zeros((60, 2), requires_grad=True)
    out = t_rasterize.rasterize(args[0], args[1], ts, colors_precomp=args[2], scales=args[3],
                                rotations=args[4], means2D_offset=offset)
    (g_offset,) = torch.autograd.grad((out["render"] * w_rgb).sum(), offset)

    pix = torch.zeros((60, 2), requires_grad=True)  # the same offset, in pixels
    pre = t_gaussian.preprocess(args[0], args[1], ts.viewmatrix, ts.projmatrix, ts.campos, W, H,
                                ts.tanfovx, ts.tanfovy, colors_precomp=args[2], scales=args[3],
                                rotations=args[4], means2d_offset=pix)
    b = t_binning.bin_gaussians(t_gaussian.Preprocessed(*(x.detach() for x in pre)), gx, gy)
    c = t_composite.composite(pre.means2d, pre.conic, pre.opacities, pre.colors, pre.depths,
                              torch.zeros(3), b.ranges, b.point_list, gx, gy, W, H)
    (g_pix,) = torch.autograd.grad((c.color * w_rgb).sum(), pix)

    assert float(g_pix.abs().max()) > 0.0
    torch.testing.assert_close(g_offset, g_pix * torch.tensor([0.5 * W, 0.5 * H]),
                               rtol=1e-6, atol=1e-9)


def test_zero_quaternion_row_has_a_finite_gradient():
    """C.3: the trainer normalises rotations as x rsqrt(|x|^2 + 1e-18), so an
    all-zero quaternion renders and keeps a finite gradient."""
    s = _make_scene(n=30, seed=5, w=32, h=32)
    _, ts = _settings(s)
    n = 30
    rot = s["quats"].copy()
    rot[3] = 0.0
    params = {
        "xyz": torch.from_numpy(s["means"]),
        "f_dc": torch.from_numpy(((s["colors"] - 0.5) / 0.28209479177387814).astype(np.float32)),
        "f_rest": torch.zeros((n, 45)),
        "opacity": torch.from_numpy(np.log(s["opac"] / (1 - s["opac"]))[:, None]),
        "scale": torch.from_numpy(np.log(s["scales"])),
        "rot": torch.from_numpy(rot),
    }
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = t_train.render_from_params(params, 0, ts)
    grads = torch.autograd.grad(out["render"].sum() + out["rendered_depth"].sum(),
                                list(params.values()))
    for name, g in zip(params, grads):
        assert torch.isfinite(g).all(), name
    assert float(grads[-1].abs().max()) > 0.0
