"""K7 (gaussian.preprocess_forward) around its launch, on the CPU: which
preprocess rasterize() takes, its gs.preprocess.* counters, and the
wrapper's checks, which raise before any launch. The kernel runs on the card
only; tests/test_torch_kernels_cuda.py holds it to gaussian.preprocess
there."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gaustudio_torch.ops import gaussian
from gaustudio_torch.ops import rasterize as rast
from gaustudio_torch.utils import kernels
from gaustudio_torch.utils import observability as obs

CPU = torch.device("cpu")


def _refuse(*args, **kwargs):
    raise AssertionError("K7 was reached")


@pytest.fixture(scope="module")
def case():
    kw, _, _ = chip_smoke.k7_case("n31", CPU)
    return kw


def _rasterize(kw, backend, **extra):
    st = rast.RasterizeSettings(
        image_height=kw["image_height"], image_width=kw["image_width"],
        tanfovx=kw["tan_fovx"], tanfovy=kw["tan_fovy"], bg=torch.zeros(3),
        viewmatrix=kw["viewmatrix"], projmatrix=kw["projmatrix"], campos=kw["campos"],
        sh_degree=kw["sh_degree"], backend=backend)
    return rast.rasterize(extra.get("means3D", kw["means3d"]), kw["opacities"], st,
                          shs=kw["shs"], scales=kw["scales"], rotations=kw["rotations"])


@pytest.mark.parametrize("mode", ["inference", "grad"])
@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_rasterize_preprocesses_in_torch_ops_on_the_cpu(case, backend, mode, monkeypatch):
    """On CPU tensors (with either backend, with or without autograd) the
    plain preprocess runs, and the counters say so: one call, none of them
    through K7."""
    monkeypatch.setattr(gaussian, "preprocess_forward", _refuse)
    monkeypatch.setattr(kernels, "load", _refuse)
    means = case["means3d"].clone().requires_grad_(mode == "grad")
    obs.report()
    with profile(activities=[ProfilerActivity.CPU]):
        if mode == "inference":
            with torch.inference_mode():
                out = _rasterize(case, backend)
        else:
            out = _rasterize(case, backend, means3D=means)
        counters = obs.report()["counters"]
    assert counters["gs.preprocess.calls"] == 1 and counters["gs.preprocess.kernel"] == 0
    with torch.inference_mode():
        want = gaussian.preprocess(**case)
    assert torch.equal(out["radii"], want.radii) and int(want.valid.sum()) > 0
    assert out["render"].requires_grad == (mode == "grad")


@pytest.mark.parametrize("backend,cuda,grad,requires,want,runs", [
    ("auto", True, "inference", False, True, "preprocess_forward"),
    ("auto", True, "no_grad", True, True, "preprocess_forward"),
    ("auto", True, "enabled", False, True, "preprocess_forward"),
    ("auto", True, "enabled", True, True, "preprocess_with_grad"),
    ("plain", True, "inference", False, False, "preprocess"),
    ("auto", False, "inference", False, False, "preprocess"),
    ("plain", True, "enabled", True, False, "preprocess"),
    ("auto", False, "enabled", True, False, "preprocess_with_grad"),
], ids=["inference_mode", "no_grad", "no_input_requires_grad", "autograd", "plain",
        "cpu", "plain_autograd", "cpu_autograd"])
def test_preprocess_takes_kernel(backend, cuda, grad, requires, want, runs):
    """K7 is taken exactly where the kernels are asked for and the inputs lie
    on a card, with or without autograd: where a gradient is wanted (the
    train step) rasterize() runs gaussian.preprocess_with_grad, K7 forward
    and K8 backward (their plain versions on the CPU). ``backend="plain"``
    keeps the torch ops, under autograd too."""
    tensors = (torch.zeros(4, 3, requires_grad=requires), None, torch.zeros(4))
    if grad == "inference":
        with torch.inference_mode():
            got = rast.preprocess_takes_kernel(backend, cuda)
            fn = rast.select_preprocess(backend, cuda, (torch.zeros(4, 3), None))
    elif grad == "no_grad":
        with torch.no_grad():
            got = rast.preprocess_takes_kernel(backend, cuda)
            fn = rast.select_preprocess(backend, cuda, tensors)
    else:
        got = rast.preprocess_takes_kernel(backend, cuda)
        fn = rast.select_preprocess(backend, cuda, tensors)
    assert got == want
    assert fn is getattr(gaussian, runs)


def _bad(kw, what):
    n = kw["means3d"].shape[0]
    if what == "cpu":
        return kw, "CUDA"
    if what == "means3d_float64":
        return {**kw, "means3d": kw["means3d"].double()}, "float32"
    if what == "shs_float16":
        return {**kw, "shs": kw["shs"].half()}, "float32"
    if what == "viewmatrix_float64":
        return {**kw, "viewmatrix": kw["viewmatrix"].double()}, "float32"
    if what == "means3d_shape":
        return {**kw, "means3d": torch.zeros(n, 4)}, "shape"
    if what == "shs_shape":
        return {**kw, "shs": torch.zeros(n, 16, 4)}, "shape"
    if what == "viewmatrix_shape":
        return {**kw, "viewmatrix": torch.zeros(3, 4)}, "shape"
    if what == "opacities_count":
        return {**kw, "opacities": torch.zeros(n + 1)}, "shape"
    if what == "rotations_shape":
        return {**kw, "rotations": torch.zeros(n, 3)}, "shape"
    if what == "no_whole_band":
        return {**kw, "shs": torch.zeros(n, 3, 3)}, "whole SH band"
    if what == "two_colours":
        return {**kw, "colors_precomp": torch.zeros(n, 3)}, "exactly one"
    if what == "no_covariance":
        return {**kw, "scales": None}, "scales and rotations"
    raise ValueError(what)


@pytest.mark.parametrize("what", [
    "cpu", "means3d_float64", "shs_float16", "viewmatrix_float64", "means3d_shape",
    "shs_shape", "viewmatrix_shape", "opacities_count", "rotations_shape", "no_whole_band",
    "two_colours", "no_covariance"])
def test_preprocess_forward_raises_before_any_launch(case, what, monkeypatch):
    monkeypatch.setattr(kernels, "load", _refuse)
    kw, match = _bad(case, what)
    launches = gaussian.preprocess_forward.launches
    with pytest.raises(ValueError, match=match):
        gaussian.preprocess_forward(**kw)
    assert gaussian.preprocess_forward.launches == launches
