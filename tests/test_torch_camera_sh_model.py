"""Port parity: cameras, SH, config, PNG/PLY IO and the vanilla model
(gaustudio_torch against gaustudio_tpu, both on the CPU)."""

import json
import os

import numpy as np
import pytest
import torch

from gaustudio_torch import models as t_models
from gaustudio_torch.config import builtin_config_path as t_config_path
from gaustudio_torch.config import load_config as t_load_config
from gaustudio_torch.datasets.utils import JSON_to_camera as t_json_to_camera
from gaustudio_torch.datasets.utils import camera_to_JSON as t_camera_to_json
from gaustudio_torch.models.vanilla import VanillaPointCloud
from gaustudio_torch.ops import sh as t_sh
from gaustudio_torch.utils import image as t_image

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_scene")
ELEMS = ("xyz", "opacity", "f_dc", "f_rest", "scale", "rot")


@pytest.fixture(scope="module")
def cameras_json():
    with open(os.path.join(FIXTURE, "cameras.json")) as f:
        return json.load(f)


def test_camera_matrices_match_jax(cameras_json):
    from gaustudio_tpu.datasets.utils import JSON_to_camera as j_json_to_camera

    for cj in cameras_json:
        jc = j_json_to_camera(cj)
        tc = t_json_to_camera(cj, device="cpu")
        for field in ("world_view_transform", "projection_matrix",
                      "full_proj_transform", "camera_center"):
            np.testing.assert_allclose(getattr(tc, field).numpy(),
                                       np.asarray(getattr(jc, field)), atol=1e-6)
        np.testing.assert_allclose(tc.intrinsics.numpy(), np.asarray(jc.intrinsics), atol=1e-6)
        assert tc.tanfovx == pytest.approx(jc.tanfovx, abs=1e-12)
        assert tc.tanfovy == pytest.approx(jc.tanfovy, abs=1e-12)
        back = t_camera_to_json(cj["id"], tc)
        for k in ("width", "height", "img_name", "id"):
            assert back[k] == cj[k]
        for k in ("position", "rotation", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(back[k], cj[k], atol=1e-9)


def test_camera_downsample_scale_matches_jax(cameras_json):
    from gaustudio_tpu.datasets.utils import JSON_to_camera as j_json_to_camera

    jc = j_json_to_camera(cameras_json[0]).downsample_scale(2)
    tc = t_json_to_camera(cameras_json[0], device="cpu").downsample_scale(2)
    assert (tc.image_width, tc.image_height) == (jc.image_width, jc.image_height)
    np.testing.assert_allclose(tc.full_proj_transform.numpy(),
                               np.asarray(jc.full_proj_transform), atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    import jax.numpy as jnp

    from gaustudio_tpu.ops import sh as j_sh

    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(64, 3, 16)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = np.asarray(j_sh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    got = t_sh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    means = rng.normal(size=(64, 3)).astype(np.float32)
    campos = rng.normal(size=3).astype(np.float32)
    shs = np.swapaxes(sh, 1, 2)  # [N, K, 3]
    want_rgb, want_cl = j_sh.sh_to_rgb_clamped(deg, jnp.asarray(shs), jnp.asarray(means),
                                               jnp.asarray(campos))
    got_rgb, got_cl = t_sh.sh_to_rgb_clamped(deg, torch.from_numpy(shs),
                                             torch.from_numpy(means), torch.from_numpy(campos))
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_cl.numpy(), np.asarray(want_cl))


def test_rgb_sh_roundtrip():
    rgb = torch.rand(10, 3)
    torch.testing.assert_close(t_sh.SH2RGB(t_sh.RGB2SH(rgb)), rgb)


def test_vanilla_json_config_matches_yaml():
    from gaustudio_tpu.config import builtin_config_path, load_config

    want = load_config(builtin_config_path("vanilla"))
    got = t_load_config(t_config_path("vanilla"), cli_args=["renderer.white_background=true"])
    assert got.renderer.white_background is True
    got["renderer"]["white_background"] = False
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_png_codec_matches_pil(tmp_path):
    from PIL import Image

    path = os.path.join(FIXTURE, "images", "00000.png")
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = t_image.read_png(path)
    np.testing.assert_array_equal(got, want)

    rng = np.random.default_rng(0)
    for c in (3, 4):
        px = rng.integers(0, 256, size=(7, 5, c), dtype=np.uint8)
        out = str(tmp_path / f"rt{c}.png")
        t_image.write_png(out, px)
        np.testing.assert_array_equal(t_image.read_png(out), px)
        with Image.open(out) as im:
            np.testing.assert_array_equal(np.asarray(im), px)


def _jax_pcd():
    from gaustudio_tpu import models as j_models

    m = j_models.make({"name": "vanilla_pcd"})
    m.load(os.path.join(FIXTURE, "gaussians.ply"))
    m.active_sh_degree = 0
    return m


def _assert_same_model(tm, jm):
    assert tm.num_points == jm.num_points
    for elem in ELEMS:
        np.testing.assert_array_equal(getattr(tm, "_" + elem).numpy(),
                                      np.asarray(getattr(jm, "_" + elem)))
        np.testing.assert_allclose(tm.get_attribute(elem).numpy(),
                                   np.asarray(jm.get_attribute(elem)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tm.get_features.numpy(), np.asarray(jm.get_features))
    np.testing.assert_allclose(tm.get_covariance().numpy(), np.asarray(jm.get_covariance()),
                               rtol=1e-5, atol=1e-9)


def test_model_load_and_from_jax_params_match_jax():
    jm = _jax_pcd()
    tm = t_models.make({"name": "vanilla_pcd"}, device="cpu")
    tm.load(os.path.join(FIXTURE, "gaussians.ply"))
    _assert_same_model(tm, jm)

    params = {e: np.asarray(getattr(jm, "_" + e)) for e in ELEMS}
    params["active_sh_degree"] = jm.active_sh_degree
    tj = VanillaPointCloud.from_jax_params(params, device="cpu")
    _assert_same_model(tj, jm)
    assert tj.active_sh_degree == 0


def test_model_export_roundtrips_through_jax_loader(tmp_path):
    from gaustudio_tpu import models as j_models

    tm = t_models.make({"name": "vanilla_pcd"}, device="cpu")
    tm.load(os.path.join(FIXTURE, "gaussians.ply"))
    out = str(tmp_path / "pc.ply")
    tm.export(out)
    jm = j_models.make({"name": "vanilla_pcd"})
    jm.load(out)
    _assert_same_model(tm, jm)
