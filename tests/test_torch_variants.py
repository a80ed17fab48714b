"""Port parity of the model and renderer variants: the activations, SH degree
4, the antialias and intrinsics branches of preprocess, the Mip-Splatting
filter and renderer, the gsplat renderer, the plain point cloud and its
renderer, and the shipped configs, each against the JAX package on the same
seeded inputs. The JAX renderers run as their own tests run them on the CPU
(rasterize with the XLA backend)."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaustudio_torch import models as t_models
from gaustudio_torch import renderers as t_renderers
from gaustudio_torch.cameras import Camera as TCamera
from gaustudio_torch.cameras.camera_paths import get_path_from_orbit as t_orbit
from gaustudio_torch.config import builtin_config_path as t_config_path
from gaustudio_torch.models.utils import get_activation as t_activation
from gaustudio_torch.ops import gaussian as t_gaussian
from gaustudio_torch.ops import sh as t_sh
from gaustudio_torch.scripts import render as t_render_cli
from gaustudio_torch.utils import ply as t_ply
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.cameras import Camera as JCamera
from gaustudio_tpu.cameras.camera_paths import get_path_from_orbit as j_orbit
from gaustudio_tpu.config import builtin_config_path as j_config_path
from gaustudio_tpu.config import load_config as j_load_config
from gaustudio_tpu.models.utils import get_activation as j_activation
from gaustudio_tpu.ops import gaussian as j_gaussian
from gaustudio_tpu.ops import sh as j_sh
from gaustudio_tpu.utils import ply as j_ply
from tests.test_torch_preprocess import EXACT_FIELDS, FLOAT_FIELDS, _t
from tests.test_rasterize import _make_scene

ACTIVATIONS = ("none", "scale2.5", "clamp0.6", "mul3", "exp", "lin2srgb", "+0.5", "-1.5",
               "sigmoid", "tanh", "normalize", "softplus", "relu")
RENDER_KEYS = ("render", "rendered_depth", "rendered_final_opacity")
SIZE = 48


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_get_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32) * 2.0
    x[:4] = [[0.001, 0.003, 0.004], [0.0, 1.0, -1.0], [5.0, -5.0, 0.5], [2.4, 0.6, 0.0031308]]
    want = np.asarray(j_activation(name)(jnp.asarray(x)))
    got = t_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_get_activation_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown activation"):
        t_activation("swish")


@pytest.mark.parametrize("deg", range(5))
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sh = rng.normal(size=(50, 3, 25)).astype(np.float32)
    want = np.asarray(j_sh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    got = t_sh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


PREPROCESS_CASES = {
    "antialias": dict(antialias=True),
    "intrinsics_centred": dict(pp=(0.5, 0.5)),
    "intrinsics_off_centre": dict(pp=(0.62, 0.41)),
    "antialias_intrinsics": dict(antialias=True, pp=(0.55, 0.47)),
}


@pytest.mark.parametrize("case", list(PREPROCESS_CASES))
def test_preprocess_branches_match_jax(case):
    """Every field of the antialiased and the intrinsics preprocess at the
    tolerances of tests/test_torch_preprocess.py; the intrinsics are those
    of the scene's tanfov camera with the principal point moved."""
    kw = PREPROCESS_CASES[case]
    scene = _make_scene(n=60, seed=4)
    st = scene["settings"]
    W, H = st.image_width, st.image_height
    extra = {"antialias": kw.get("antialias", False)}
    intr = None
    if "pp" in kw:
        intr = np.array([W / (2 * st.tanfovx), H / (2 * st.tanfovy), W * kw["pp"][0],
                         H * kw["pp"][1]], np.float32)
    args = (st.viewmatrix, st.projmatrix, st.campos, W, H, st.tanfovx, st.tanfovy)
    j = j_gaussian.preprocess(
        jnp.asarray(scene["means"]), jnp.asarray(scene["opac"]), *args,
        colors_precomp=jnp.asarray(scene["colors"]), scales=jnp.asarray(scene["scales"]),
        rotations=jnp.asarray(scene["quats"]),
        intrinsics=None if intr is None else jnp.asarray(intr), **extra)
    t = t_gaussian.preprocess(
        torch.from_numpy(scene["means"]), torch.from_numpy(scene["opac"]),
        *(_t(a) for a in args[:3]), *args[3:],
        colors_precomp=torch.from_numpy(scene["colors"]),
        scales=torch.from_numpy(scene["scales"]), rotations=torch.from_numpy(scene["quats"]),
        intrinsics=None if intr is None else torch.from_numpy(intr), **extra)
    assert int(t.valid.sum()) > 30
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    if kw.get("antialias"):  # the compensation dims every splat
        assert (t.opacities < torch.from_numpy(scene["opac"])).all()


def _points(n=70, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32) * 0.3,
            rng.uniform(0.2, 1.0, size=(n, 3)).astype(np.float32))


def _vanilla_pair(name="vanilla_pcd", n=70, seed=1, log_scale=None):
    """The same seeded SH-degree-1 model in both packages."""
    xyz, rgb = _points(n, seed)
    rng = np.random.default_rng(seed + 10)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    attrs = dict(xyz=xyz, rgb=rgb, rot=quats / np.linalg.norm(quats, axis=1, keepdims=True),
                 scale=(np.log(rng.uniform(0.02, 0.1, (n, 3))) if log_scale is None
                        else np.full((n, 3), log_scale)).astype(np.float32),
                 opacity=rng.normal(size=(n, 1)).astype(np.float32))
    j = j_models.make({"name": name})
    j.create_from_attribute(**attrs)
    j._f_rest = (rng.normal(size=(n, 45)) * 0.1).astype(np.float32)
    t = t_models.make({"name": name}, device="cpu")
    t.create_from_attribute(**attrs)
    t._f_rest = torch.from_numpy(np.asarray(j._f_rest))
    j.active_sh_degree = t.active_sh_degree = 1
    return j, t


def _cams(pp=(0.5, 0.5)):
    kw = dict(R=np.eye(3), T=np.array([0.1, -0.05, 3.0]), FoVx=1.0, FoVy=0.9,
              image_width=SIZE, image_height=SIZE, principal_point_ndc=pp)
    return JCamera(**kw), TCamera(**kw, device="cpu")


def _entries_before_the_cull(renderer, cam, pcd) -> int:
    """The port's (Gaussian, tile) entries of a view before K1's max-alpha
    tile cull: the count the JAX XLA binning reports as num_rendered."""
    xyz, shs, colors, opacity, scales, rots, _ = renderer.get_gaussians_properties(cam, pcd)
    st = renderer.make_settings(cam, pcd, xyz.device)
    pre = t_gaussian.preprocess(
        xyz, opacity.reshape(-1), st.viewmatrix, st.projmatrix, st.campos, st.image_width,
        st.image_height, st.tanfovx, st.tanfovy, shs=shs, sh_degree=getattr(pcd, "active_sh_degree", 0),
        colors_precomp=colors, scales=scales, rotations=rots, antialias=st.antialias,
        intrinsics=st.intrinsics)
    return int(pre.tiles_touched.sum())


def render_both(j_renderer, t_renderer, jc, tc, j_pcd, t_pcd):
    """Both renders of a view, held to each other: the float maps within
    1e-5, radii exact, and the entry count (the port's before its tile cull,
    which the JAX XLA binning does not make; n_contrib counts entries of the
    tile lists, so it differs with the cull as well)."""
    j_out, t_out = j_renderer.render(jc, j_pcd), t_renderer.render(tc, t_pcd)
    for key in RENDER_KEYS:
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(t_out["radii"].numpy(), np.asarray(j_out["radii"]))
    assert _entries_before_the_cull(t_renderer, tc, t_pcd) == int(j_out["num_rendered"])
    assert 0 < int(t_out["num_rendered"]) <= int(j_out["num_rendered"])
    assert float(t_out["render"].sum()) > 1.0
    return j_out, t_out


def _far_points(xyz):
    """``xyz`` and two points no orbit camera sees (far above and below the
    orbit, out of every frame)."""
    return np.concatenate([xyz, np.array([[0.0, 40.0, 0.0], [0.0, -40.0, 0.3]], np.float32)])


def test_mip_filter_matches_jax():
    """compute_3D_filter over four orbit cameras (with points no camera
    sees), and the filtered scale and opacity."""
    xyz, rgb = _points()
    xyz = _far_points(xyz)
    j = j_models.make({"name": "mip_pcd"})
    j.create_from_attribute(xyz=xyz, rgb=np.resize(rgb, xyz.shape))
    t = t_models.make({"name": "mip_pcd"}, device="cpu")
    t.create_from_attribute(xyz=xyz, rgb=np.resize(rgb, xyz.shape))
    jc = j_orbit(np.zeros(3), 2.5, num_cam=4, image_size=SIZE, fov_deg=50)
    tc = t_orbit(np.zeros(3), 2.5, num_cam=4, image_size=SIZE, fov_deg=50, device="cpu")
    want = np.asarray(j.compute_3D_filter(jc))
    got = t.compute_3D_filter(tc)
    assert got.shape == (len(xyz), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the unseen points take the largest seen depth
    assert got[-1, 0] == got[-2, 0] == got[:-2].max()
    for attr in ("get_scaling_with_3D_filter", "get_opacity_with_3D_filter"):
        np.testing.assert_allclose(getattr(t, attr).numpy(), np.asarray(getattr(j, attr)),
                                   rtol=1e-6, atol=1e-7, err_msg=attr)
    assert (t.get_opacity_with_3D_filter <= t.get_attribute("opacity")).all()


@pytest.mark.parametrize("name,model", [("mip_renderer", "mip_pcd"),
                                        ("gsplat_renderer", "vanilla_pcd")])
def test_variant_renderer_matches_jax(name, model):
    """Two views of one renderer: mip keeps the filter of the first view for
    the second, and gsplat projects an off-centre principal point."""
    j_pcd, t_pcd = _vanilla_pair(model)
    j_r, t_r = j_renderers.make({"name": name}), t_renderers.make({"name": name}, device="cpu")
    for pp in ((0.5, 0.5), (0.6, 0.42)):
        jc, tc = _cams(pp)
        render_both(j_r, t_r, jc, tc, j_pcd, t_pcd)
    if model == "mip_pcd":
        np.testing.assert_allclose(t_pcd.filter_3D.numpy(), np.asarray(j_pcd.filter_3D),
                                   rtol=1e-6)


def _general_pair(rgb_scale=1.0):
    xyz, rgb = _points(90, seed=3)
    j = j_models.make({"name": "general_pcd"})
    j.create_from_attribute(xyz=xyz, rgb=rgb * rgb_scale)
    t = t_models.make({"name": "general_pcd"}, device="cpu")
    t.create_from_attribute(xyz=xyz, rgb=rgb * rgb_scale)
    return j, t


@pytest.mark.parametrize("rgb_scale", [1.0, 255.0], ids=["unit", "bytes"])
def test_pcd_renderer_matches_jax(rgb_scale):
    j_pcd, t_pcd = _general_pair(rgb_scale)
    jc, tc = _cams()
    render_both(j_renderers.make({"name": "pcd_renderer"}),
                t_renderers.make({"name": "pcd_renderer"}, device="cpu"), jc, tc, j_pcd, t_pcd)


def test_gsplat_dims_sub_pixel_splats():
    """tests/test_scaffold_mip.py's gsplat case, on the port: the
    compensation dims sub-pixel splats and leaves large ones nearly as the
    vanilla renderer draws them."""
    _, tc = _cams()
    van = t_renderers.make({"name": "vanilla_renderer"}, device="cpu")
    gs = t_renderers.make({"name": "gsplat_renderer"}, device="cpu")
    _, tiny = _vanilla_pair(n=80, seed=2, log_scale=np.log(2e-3))
    out = gs.render(tc, tiny)
    assert torch.isfinite(out["render"]).all() and "rendered_final_opacity" in out
    assert float(out["render"].sum()) < 0.6 * float(van.render(tc, tiny)["render"].sum())
    _, big = _vanilla_pair(n=80, seed=2, log_scale=np.log(0.3))
    diff = (gs.render(tc, big)["render"] - van.render(tc, big)["render"]).abs().max()
    assert float(diff) < 0.05


def test_general_pcd_files_cross_both_ways(tmp_path):
    """A cloud written by the JAX store_ply loads in the port with its colour
    (the rgb repair of BasePointCloud.load); the port's export loads in the
    JAX package."""
    xyz, rgb = _points(30, seed=5)
    normals = np.random.default_rng(6).normal(size=xyz.shape).astype(np.float32)
    rgb8 = (rgb * 255).astype(np.uint8)
    j_ply.store_ply(str(tmp_path / "j.ply"), xyz, rgb8, normals)
    t = t_models.make({"name": "general_pcd"}, device="cpu")
    t.load(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(t._xyz.numpy(), xyz)
    np.testing.assert_allclose(t._rgb.numpy(), rgb8 / 255.0, rtol=1e-6)

    t.export(str(tmp_path / "t.ply"))
    j = j_models.make({"name": "general_pcd"})
    j.load(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(np.asarray(j._xyz), xyz)
    np.testing.assert_allclose(np.asarray(j._rgb), rgb8 / 255.0, rtol=1e-6)

    t_ply.store_ply(str(tmp_path / "s.ply"), xyz, rgb8, normals)
    assert (tmp_path / "s.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("name", ["vanilla", "2dgs", "mip", "gsplat", "pcd", "scaffold"])
def test_shipped_config_is_the_jax_config(name):
    def plain(x):
        return {k: plain(v) for k, v in x.items()} if isinstance(x, dict) else x

    with open(t_config_path(name)) as f:
        assert json.load(f) == plain(j_load_config(j_config_path(name)))


@pytest.mark.parametrize("config", ["mip", "gsplat", "pcd"])
def test_gs_render_cli_renders_the_variant(tmp_path, config):
    """gs-render --config mip|gsplat|pcd on the CPU: one PNG per camera of a
    model written by the port, equal to the renderer's image."""
    from gaustudio_torch.utils.image import read_png

    if config == "pcd":
        _, pcd = _general_pair()
    else:
        _, pcd = _vanilla_pair("mip_pcd" if config == "mip" else "vanilla_pcd")
    ply = str(tmp_path / "model.ply")
    pcd.export(ply)
    cams = [{"id": i, "img_name": f"v{i}", "width": SIZE, "height": SIZE,
             "position": [0.1 * i, 0.0, -3.0], "rotation": np.eye(3).tolist(),
             "fx": 50.0, "fy": 50.0} for i in range(2)]
    with open(tmp_path / "cameras.json", "w") as f:
        json.dump(cams, f)
    images = t_render_cli.main(["-m", ply, "--config", config, "--device", "cpu", "--sh", "1",
                                "-o", str(tmp_path / "out")])
    assert sorted(os.listdir(images)) == ["v0.png", "v1.png"]
    assert read_png(os.path.join(images, "v0.png")).max() > 0


@pytest.mark.parametrize("config", ["mip", "gsplat"])
def test_gs_train_cli_trains_the_variant_with_the_vanilla_trainer(tmp_path, config,
                                                                   monkeypatch):
    """gs-train --config mip|gsplat goes to the vanilla Trainer, as the JAX CLI
    routes every config but scaffold and 2dgs, and exports the Inria layout."""
    from gaustudio_torch.pipelines import train as t_train
    from gaustudio_torch.scripts import train as t_train_cli
    from tests.test_torch_train import _write_nerf_scene

    steps = []
    step = t_train.Trainer.step
    monkeypatch.setattr(t_train.Trainer, "step",
                        lambda self, *a: steps.append(type(self)) or step(self, *a))
    src = _write_nerf_scene(tmp_path / "scene", size=24, num_cam=3)
    history = t_train_cli.main(["-s", str(src), "-o", str(tmp_path / "out"), "--dataset", "nerf",
                                "--config", config, "--iterations", "3", "--save_every", "3",
                                "--init_points", "200", "--device", "cpu"])
    assert steps == [t_train.Trainer] * 3 and np.isfinite(history[-1]["loss"])
    j = j_models.make({"name": "mip_pcd" if config == "mip" else "vanilla_pcd"})
    j.load(str(tmp_path / "out" / "point_cloud" / "iteration_3" / "point_cloud.ply"))
    assert j.num_points == 200
