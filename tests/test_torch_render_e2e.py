"""The port end to end on the CPU: the vanilla renderer on the mini_scene
fixture reproduces GOLDEN.json, the gs-render CLI writes one PNG per camera,
and importing the port never imports jax or gaustudio_tpu."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gaustudio_torch import models, renderers
from gaustudio_torch.datasets.utils import JSON_to_camera
from gaustudio_torch.scripts import render as render_cli
from gaustudio_torch.utils.image import load_image, read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_scene")


def _psnr(pred, gt):
    mse = float(np.mean((pred - gt) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def test_renderer_reproduces_golden_psnr():
    with open(os.path.join(FIXTURE, "GOLDEN.json")) as f:
        golden = json.load(f)
    with open(os.path.join(FIXTURE, "cameras.json")) as f:
        cameras = [JSON_to_camera(cj, device="cpu") for cj in json.load(f)]
    pcd = models.make({"name": "vanilla_pcd"}, device="cpu")
    pcd.load(os.path.join(FIXTURE, "gaussians.ply"))
    pcd.active_sh_degree = 0  # the fixture was fitted at SH degree 0
    renderer = renderers.make({"name": "vanilla_renderer"}, device="cpu")
    got = []
    for cam in cameras:
        out = renderer.render(cam, pcd)
        assert out["render"].shape == (3, golden["size"], golden["size"])
        assert out["num_rendered"] > 0
        gt, _ = load_image(os.path.join(FIXTURE, "images", cam.image_name))
        got.append(_psnr(out["render"].permute(1, 2, 0).numpy(), gt))
    assert len(got) == golden["views"]
    assert np.mean(got) == pytest.approx(golden["psnr_mean"], abs=0.15)
    for g, ref in zip(got, golden["psnr_per_view"]):
        assert g == pytest.approx(ref, abs=0.3)


@pytest.mark.parametrize("option", ["convert_SHs_python", "compute_cov3D_python"])
def test_renderer_python_side_options_match_default(option):
    """SH colours or 3D covariances computed in the renderer (the reference's
    two config switches) give the image of the default path."""
    with open(os.path.join(FIXTURE, "cameras.json")) as f:
        cam = JSON_to_camera(json.load(f)[3], device="cpu")
    pcd = models.make({"name": "vanilla_pcd"}, device="cpu")
    pcd.load(os.path.join(FIXTURE, "gaussians.ply"))
    pcd.active_sh_degree = 0
    want = renderers.make({"name": "vanilla_renderer"}, device="cpu").render(cam, pcd)
    got = renderers.make({"name": "vanilla_renderer", option: True}, device="cpu").render(cam, pcd)
    for key in ("render", "rendered_depth", "rendered_final_opacity"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-4, err_msg=key)


def test_gs_render_cli_writes_one_png_per_camera(tmp_path):
    out_dir = str(tmp_path / "out")
    path = render_cli.main([
        "-m", os.path.join(FIXTURE, "gaussians.ply"),
        "-s", os.path.join(FIXTURE, "cameras.json"),
        "-o", out_dir, "--device", "cpu",
    ])
    with open(os.path.join(FIXTURE, "cameras.json")) as f:
        names = sorted(os.path.splitext(cj["img_name"])[0] + ".png" for cj in json.load(f))
    assert path == os.path.join(out_dir, "images")
    assert sorted(os.listdir(path)) == names
    img = read_png(os.path.join(path, names[0]))
    assert img.shape == (128, 128, 3)
    assert img.std() > 5  # a real render, not a blank frame


@pytest.mark.parametrize("argv,match", [
    (["--flythrough"], "later slice"),
], ids=["flythrough"])
def test_gs_render_cli_refuses_deferred_inputs(argv, match):
    base = ["-m", os.path.join(FIXTURE, "gaussians.ply"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=match):
        render_cli.main(base + argv)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import gaustudio_torch\n"
        "for m in pkgutil.walk_packages(gaustudio_torch.__path__, 'gaustudio_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'gaustudio_tpu'))\n"
        "print(' '.join(sorted(k for k in sys.modules if k.startswith('gaustudio_torch.'))), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    *names, bad = proc.stdout.strip().split(" ")
    assert bad == "[]"
    for module in ("ops.composite", "ops.ssim", "models.vanilla", "datasets.base",
                   "datasets.vanilla", "datasets.nerf", "pipelines.train",
                   "pipelines.dataloader", "pipelines.optimizers.general",
                   "utils.observability", "scripts.train"):
        assert "gaustudio_torch." + module in names, module
    assert len(names) >= 27
