"""The port end to end on the CPU: the vanilla renderer on the mini_scene
fixture reproduces GOLDEN.json, the gs-render CLI writes one PNG per camera
(and, with --flythrough, the JAX CLI's frames), and importing the port
never imports jax or gaustudio_tpu."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from gaustudio_torch import models, renderers
from gaustudio_torch.datasets.utils import JSON_to_camera
from gaustudio_torch.models.vanilla import VanillaPointCloud
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


def _ball_scene(out_dir, n=800, W=48, H=36, cameras=12, lifts=(6,), seed=0):
    """A PLY of ``n`` Gaussians in a ball of radius 1 about the centre of
    chip_smoke's flythrough arc (SH degree 0), and a cameras.json of a short
    arc of that path at WxH, by default with one speed outlier."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    xyz = (d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0, 1, (n, 1)) ** (1 / 3)
           + [0.0, 0.0, chip_smoke.FLY_RADIUS]).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    params = {"xyz": xyz, "opacity": np.full((n, 1), 1.0, np.float32),
              "f_dc": rng.normal(size=(n, 3)).astype(np.float32),
              "f_rest": np.zeros((n, 45), np.float32),
              "scale": np.log(rng.uniform(0.04, 0.12, (n, 3))).astype(np.float32),
              "rot": quats / np.linalg.norm(quats, axis=1, keepdims=True)}
    ply = os.path.join(out_dir, "ball.ply")
    VanillaPointCloud.from_jax_params(params, device="cpu").export(ply)
    cams = os.path.join(out_dir, "path.json")
    with open(cams, "w") as f:
        json.dump(chip_smoke.flythrough_cameras(n=cameras, W=W, H=H, arc_deg=12.0, lifts=lifts), f)
    return ply, cams


def test_gs_render_flythrough_matches_the_jax_cli(tmp_path, monkeypatch):
    """gs-render --flythrough on the CPU against the JAX CLI on the same model
    and cameras.json: the same frame names (upsample's 8-digit indices), and
    every frame within one PNG level (the two renders agree within rtol 2e-4
    / atol 2e-5)."""
    from gaustudio_tpu.scripts import render as j_render_cli

    ply, cams = _ball_scene(str(tmp_path))
    path = render_cli.main(["-m", ply, "-s", cams, "--flythrough", "-o", str(tmp_path / "port"),
                            "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["gs-render", "-m", ply, "-s", cams, "--flythrough", "-o",
                                      str(tmp_path / "jax")])
    j_render_cli.main()
    names = sorted(os.listdir(path))
    assert names == sorted(os.listdir(tmp_path / "jax" / "images"))
    assert 10 <= len(names) <= 20
    assert names == [f"{i:08d}.png" for i in range(len(names))]
    lit = []
    for name in names:
        got = read_png(os.path.join(path, name)).astype(int)
        want = read_png(str(tmp_path / "jax" / "images" / name)).astype(int)
        assert got.shape == (36, 48, 3)
        assert np.abs(got - want).max() <= 1, name
        lit.append((got.sum(-1) > 0).mean())
    assert min(lit) > 0.1  # the ball is in every frame


def test_gs_render_tries_the_video_and_says_why_it_skips(tmp_path, monkeypatch, capsys):
    """Where imageio imports, gs-render hands it every frame for render.mp4
    at --fps, as the JAX CLI does; where it has no backend or does not
    import, it prints the same "Skipping video export" line."""
    import types

    written = []
    fake = types.ModuleType("imageio.v2")
    fake.mimwrite = lambda path, frames, fps: written.append((path, len(frames), fps,
                                                              frames[0].dtype, frames[0].shape))
    monkeypatch.setitem(sys.modules, "imageio", types.ModuleType("imageio"))
    monkeypatch.setitem(sys.modules, "imageio.v2", fake)
    ply, cams = _ball_scene(str(tmp_path), n=100, W=16, H=12, cameras=2, lifts=())
    base = ["-m", ply, "-s", cams, "--device", "cpu", "--fps", "12"]
    render_cli.main(base + ["-o", str(tmp_path / "a")])
    assert written == [(str(tmp_path / "a" / "render.mp4"), 2, 12, np.uint8, (12, 16, 3))]

    def no_backend(path, frames, fps):
        raise ValueError("Could not find a backend")

    fake.mimwrite = no_backend
    render_cli.main(base + ["-o", str(tmp_path / "b")])
    assert "Skipping video export: Could not find a backend" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "imageio.v2", None)  # import fails
    render_cli.main(base + ["-o", str(tmp_path / "c")])
    assert "Skipping video export: " in capsys.readouterr().out


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
