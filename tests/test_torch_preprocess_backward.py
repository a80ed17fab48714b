"""K8's plain version (gaussian.preprocess_backward_plain) and the autograd
Function around K7 and K8 (gaussian.preprocess_with_grad), on the CPU.

The yardstick is torch autograd through gaussian.preprocess, which stays
rasterize()'s path with ``backend="plain"``. The cases are
chip_smoke.k7_case's: every variant K7 takes (1, 4, 9, 16 and 25 SH
coefficients at active degrees 0-3, colors_precomp, cov3d_precomp,
scale_modifier, intrinsics, antialias, means2d_offset, 0-33 Gaussians) and
the hard rows (behind the near plane, w about 0, det <= 0, fov-clamped,
opacity at and below 1/255, off-screen rects). The states are anisotropic
(random scales and quaternions). The kernel itself runs on the card only:
tests/test_torch_kernels_cuda.py holds it to this plain version there.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gaustudio_torch.ops import gaussian
from gaustudio_torch.ops import rasterize as rast
from gaustudio_torch.utils import kernels
from gaustudio_torch.utils import observability as obs

CPU = torch.device("cpu")
INPUTS = ("means3d", "opacities", "shs", "colors_precomp", "scales", "rotations",
          "cov3d_precomp", "means2d_offset")
OUTPUTS = ("depths", "means2d", "conic", "opacities", "colors")
# Gradients scaled by each tensor's largest: float64 agrees with autograd to
# rounding (~1e-14); float32 differs from autograd by float32 rounding in the
# covariance chain's cancellations, where autograd itself sits up to ~1e-4 of
# the largest gradient from the float64 result on these cases.
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _case(name, dtype, n=300):
    """k7_case's first n Gaussians (its hard rows come first) in ``dtype``."""
    kw, _, _ = chip_smoke.k7_case(name, CPU)
    rows = kw["means3d"].shape[0]
    return {k: (v[:n] if v.dim() and v.shape[0] == rows else v).to(dtype)
            if isinstance(v, torch.Tensor) else v for k, v in kw.items()}


def _cotangents(kw, seed, zero_share=0.3):
    """Random gradients of preprocess's differentiable outputs, all zero on
    about ``zero_share`` of the rows (as K4 leaves the rows no tile touched);
    returns them and the zeroed rows."""
    pre = gaussian.preprocess(**kw)
    gen = torch.Generator().manual_seed(seed)
    n = kw["means3d"].shape[0]
    zero = torch.rand(n, generator=gen) < zero_share
    cot = {}
    for name in OUTPUTS:
        t = torch.randn(getattr(pre, name).shape, generator=gen, dtype=kw["means3d"].dtype)
        t[zero] = 0.0
        cot[name] = t
    return cot, zero


def _autograd(kw, cot):
    leaves = {k: kw[k].clone().requires_grad_(True) for k in INPUTS if kw.get(k) is not None}
    pre = gaussian.preprocess(**{**kw, **leaves})
    loss = sum((getattr(pre, k) * cot[k]).sum() for k in OUTPUTS)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(leaves, got)}


def _rows(t, n):
    """t as [n, values a row] (n may be 0)."""
    return t.reshape(n, t.numel() // n if n else 0)


def _close(got, want, tol, what):
    scale = float(want.abs().max()) if want.numel() else 0.0
    scale = scale if scale > 0.0 else 1.0
    torch.testing.assert_close(got / scale, want / scale, rtol=0.0, atol=tol, msg=what)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", chip_smoke.K7_CASES)
def test_preprocess_backward_plain_matches_autograd(case, dtype):
    """Every input's gradient as torch autograd through preprocess gives it,
    with exact zeros (both ways) on the rows whose upstream gradients are
    all zero."""
    kw = _case(case, dtype)
    cot, zero = _cotangents(kw, seed=len(case))
    want = _autograd(kw, cot)
    got = gaussian.preprocess_backward_plain(**kw, **{"d_" + k: v for k, v in cot.items()})
    for name in INPUTS:
        g = getattr(got, name)
        if kw.get(name) is None:
            assert g is None, name
            continue
        assert g.shape == kw[name].shape and g.dtype == dtype, name
        assert torch.isfinite(g).all(), name
        _close(g, want[name], TOL[dtype], f"{case} {name}")
        n = kw["means3d"].shape[0]
        assert not _rows(g, n)[zero].any(), f"{case} {name}: untouched rows not zero"
        assert not _rows(want[name], n)[zero].any(), name


def test_preprocess_backward_plain_takes_none_for_zeros():
    """An output with no gradient (None) reads as zeros."""
    kw = _case("sh16_deg1", torch.float64)
    cot, _ = _cotangents(kw, seed=1)
    cot["colors"] = torch.zeros_like(cot["colors"])
    cot["depths"] = torch.zeros_like(cot["depths"])
    want = gaussian.preprocess_backward_plain(**kw, **{"d_" + k: v for k, v in cot.items()})
    got = gaussian.preprocess_backward_plain(
        **kw, d_means2d=cot["means2d"], d_conic=cot["conic"], d_opacities=cot["opacities"])
    for name, g, w in zip(want._fields, got, want):
        if w is not None:
            assert torch.equal(g, w), name
    assert not got.shs.any()


def _small(case, n=80):
    """k7_case's first n Gaussians in float32 (the plain compositor is slow on
    the CPU)."""
    return _case(case, torch.float32, n)


def _rasterize(kw, backend, leaves):
    st = rast.RasterizeSettings(
        image_height=kw["image_height"], image_width=kw["image_width"],
        tanfovx=kw["tan_fovx"], tanfovy=kw["tan_fovy"], bg=torch.tensor([0.1, 0.4, 0.7]),
        scale_modifier=kw.get("scale_modifier", 1.0), viewmatrix=kw["viewmatrix"],
        projmatrix=kw["projmatrix"], sh_degree=kw.get("sh_degree", 3), campos=kw["campos"],
        backend=backend, antialias=kw.get("antialias", False),
        intrinsics=kw.get("intrinsics"))
    return rast.rasterize(
        leaves["means3d"], leaves["opacities"], st, shs=leaves.get("shs"),
        colors_precomp=leaves.get("colors_precomp"), scales=leaves.get("scales"),
        rotations=leaves.get("rotations"), cov3D_precomp=leaves.get("cov3d_precomp"),
        means2D_offset=leaves["means2d_offset"])


@pytest.mark.parametrize("case", ["sh16", "sh16_deg1", "colors", "cov3d",
                                  "intrinsics_antialias", "edges"])
def test_rasterize_auto_gradients_match_plain_backend(case):
    """rasterize()'s gradients through gaussian.preprocess_with_grad (the
    ``auto`` backend; on the CPU its plain forward and backward) against
    torch autograd through the preprocess's ops (``backend="plain"``), the
    compositor the same plain version on both sides; the rows no tile
    touched get exact zeros on both."""
    kw = _small(case)
    n = kw["means3d"].shape[0]
    gen = torch.Generator().manual_seed(7)
    H, W = kw["image_height"], kw["image_width"]
    w_rgb, w_d, w_o = (torch.randn(s, generator=gen) for s in ((3, H, W), (H, W), (H, W)))
    grads = {}
    for backend in ("auto", "plain"):
        leaves = {k: kw[k].clone().requires_grad_(True) for k in INPUTS if kw.get(k) is not None}
        leaves["means2d_offset"] = torch.zeros((n, 2), requires_grad=True)
        out = _rasterize(kw, backend, leaves)
        loss = ((out["render"] * w_rgb).sum() + (out["rendered_depth"][0] * w_d).sum()
                + (out["rendered_final_opacity"][0] * w_o).sum())
        grads[backend] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        grads[backend]["radii"] = out["radii"]
    assert torch.equal(grads["auto"].pop("radii"), grads["plain"].pop("radii"))
    with torch.no_grad():
        untouched = gaussian.preprocess(**kw).tiles_touched == 0
    assert untouched.any() and not untouched.all()
    for name, want in grads["plain"].items():
        got = grads["auto"][name]
        _close(got, want, TOL[torch.float32], f"{case} {name}")
        assert not got.reshape(n, -1)[untouched].any(), f"{case} {name}"
        assert not want.reshape(n, -1)[untouched].any(), f"{case} {name}"
    assert grads["auto"]["means3d"].abs().max() > 0.0


def test_preprocess_with_grad_counts_and_spans_on_the_cpu(monkeypatch):
    """Under a profiler, one rasterize() with gradients and its backward on
    CPU tensors: one preprocess call, none through K7, the Function's
    backward under its span ``gs.preprocess_bwd`` and ``gs.preprocess.kernel_bwd``
    0 (K8 runs on the card only); no kernel is loaded."""
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("a kernel was loaded"))
    kw = _small("sh16", 60)
    leaves = {k: kw[k].clone().requires_grad_(True) for k in INPUTS if kw.get(k) is not None}
    leaves["means2d_offset"] = torch.zeros((60, 2), requires_grad=True)
    obs.report()
    with profile(activities=[ProfilerActivity.CPU]):
        out = _rasterize(kw, "auto", leaves)
        torch.autograd.grad(out["render"].sum(), list(leaves.values()))
        rep = obs.report()
    counters = rep["counters"]
    assert counters["gs.preprocess.calls"] == 1 and counters["gs.preprocess.kernel"] == 0
    assert counters["gs.preprocess.kernel_bwd"] == 0
    assert rep["spans"]["gs.preprocess_bwd"]["calls"] == 1


def test_preprocess_with_grad_refuses_a_camera_gradient():
    """K8 computes no camera gradient: a camera tensor that requires one
    raises (rasterize with backend="plain" differentiates the camera)."""
    kw = _small("sh16", 50)
    means = kw["means3d"].clone().requires_grad_(True)
    view = kw["viewmatrix"].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="viewmatrix"):
        gaussian.preprocess_with_grad(**{**kw, "means3d": means, "viewmatrix": view})


def test_preprocess_with_grad_saves_no_intermediates():
    """The Function keeps the inputs it was given and nothing else: every
    tensor autograd saves for it is one of them."""
    kw = _small("sh16", 50)
    leaves = {k: kw[k].clone().requires_grad_(True) for k in INPUTS if kw.get(k) is not None}
    pre = gaussian.preprocess_with_grad(**{**kw, **leaves})
    saved = [t for t in pre.depths.grad_fn.saved_tensors if t is not None]
    given = [v for v in list(leaves.values()) + [kw["viewmatrix"], kw["projmatrix"],
                                                  kw["campos"]]]
    assert saved and all(any(s is g or torch.equal(s, g) and s.data_ptr() == g.data_ptr()
                             for g in given) for s in saved)
