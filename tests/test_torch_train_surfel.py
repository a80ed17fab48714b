"""Port parity of 2DGS training: train_step_surfel against
gaustudio_tpu/pipelines/train_surfel.py from the same carried state and
camera sequence; densify_and_prune and state_from_jax on 2-column surfel
scales; the port's gs-train and gs-render with ``--config 2dgs``."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaustudio_torch.pipelines import train as t_train
from gaustudio_torch.pipelines import train_surfel as t_ts
from gaustudio_torch.scripts import render as t_render_cli
from gaustudio_torch.scripts import train as t_train_cli
from gaustudio_torch.utils.ply import read_ply
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.cameras import camera_paths
from gaustudio_tpu.ops.rasterize import RasterizeSettings as JSettings
from gaustudio_tpu.pipelines import train as j_train
from gaustudio_tpu.pipelines import train_surfel as j_ts
from tests.test_torch_surfel_preprocess import SURFEL_ATTRS
from tests.test_torch_train import _assert_states_match, _write_nerf_scene

SIZE = 40
CAMERA_SEQUENCE = (2, 0, 4)
CFG = dict(lambda_normal=0.05, lambda_dist=0.01)


def _surfel_pcd(**attrs):
    pcd = j_models.make({"name": "vanilla_pcd", "attributes": SURFEL_ATTRS})
    pcd.create_from_attribute(**attrs)
    return pcd


@pytest.fixture(scope="module")
def carried():
    """A disk of surfels rendered by the JAX surfel renderer as ground truth,
    and a start perturbed in every attribute (anisotropic, rotated, SH 1):
    the JAX state, the port's state carried from it, both settings and the
    batches of one camera sequence."""
    rng = np.random.default_rng(0)
    n = 80
    xy = rng.normal(size=(n, 2)).astype(np.float32) * 0.35
    xyz = np.concatenate([xy, rng.normal(size=(n, 1)).astype(np.float32) * 0.02], 1)
    gt = _surfel_pcd(xyz=xyz, rgb=rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32),
                     scale=np.full((n, 2), -2.3, np.float32))
    gt._opacity = np.full((n, 1), 2.0, np.float32)
    gt.active_sh_degree = 0
    cams = camera_paths.get_path_from_orbit(np.zeros(3), 2.0, elevation=25, num_cam=5,
                                            image_size=SIZE, fov_deg=55)
    renderer = j_renderers.make({"name": "surfel_renderer"})
    for cam in cams:
        cam.image = np.moveaxis(np.asarray(renderer.render(cam, gt)["render"]), 0, -1)

    quats = rng.normal(size=(n, 4)).astype(np.float32)
    pcd = _surfel_pcd(
        xyz=xyz + rng.normal(size=(n, 3)).astype(np.float32) * 0.03,
        rgb=rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
        scale=np.log(rng.uniform(0.05, 0.15, (n, 2))).astype(np.float32),
        rot=quats / np.linalg.norm(quats, axis=1, keepdims=True),
        opacity=rng.normal(size=(n, 1)).astype(np.float32))
    pcd._f_rest = (rng.normal(size=(n, 45)) * 0.05).astype(np.float32)
    jstate = j_train.init_state(pcd, capacity=128)._replace(active_sh_degree=jnp.asarray(1))
    cam0 = cams[0]
    jset = JSettings(image_height=SIZE, image_width=SIZE, tanfovx=cam0.tanfovx,
                     tanfovy=cam0.tanfovy, bg=None, sh_degree=3, num_entries=1 << 13,
                     chunk=256)
    tset = t_train.RasterizeSettings(image_height=SIZE, image_width=SIZE, tanfovx=cam0.tanfovx,
                                     tanfovy=cam0.tanfovy, bg=None, sh_degree=3)
    jb, tb = [], []
    for i in CAMERA_SEQUENCE:
        cam = cams[i]
        arrs = (cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
                np.moveaxis(np.asarray(cam.image, np.float32), -1, 0))
        jb.append(j_train.CameraBatch(*(jnp.asarray(a) for a in arrs)))
        tb.append(t_train.CameraBatch(*(torch.tensor(np.asarray(a)) for a in arrs)))
    return dict(jstate=jstate, tstate=t_train.state_from_jax(jstate, device="cpu"), jset=jset, tset=tset,
                jb=jb, tb=tb, cfg=j_ts.SurfelTrainConfig(**CFG),
                tcfg=t_ts.SurfelTrainConfig(**CFG))


def test_state_from_jax_carries_a_surfel_state(carried):
    jstate, tstate = carried["jstate"], carried["tstate"]
    valid = np.asarray(jstate.valid)
    assert tstate.params["scale"].shape == (80, 2) and tstate.params["f_rest"].shape == (80, 45)
    assert tstate.active_sh_degree == 1 and tstate.num_points == int(valid.sum())
    for k, v in tstate.params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstate.params[k])[valid])
        for d in ("mu", "nu", "count"):
            np.testing.assert_array_equal(getattr(tstate.opt, d)[k].numpy(),
                                          np.asarray(getattr(jstate.opt, d)[k])[valid])


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_surfel_match_jax(carried, steps):
    jstate = jax.tree.map(lambda x: jnp.array(x, copy=True), carried["jstate"])
    tstate = carried["tstate"]
    for i in range(steps):
        jstate, jm = j_ts.train_step_surfel(jstate, carried["jb"][i], carried["jset"],
                                            carried["cfg"])
        tstate, tm = t_ts.train_step_surfel(tstate, carried["tb"][i], carried["tset"],
                                            carried["tcfg"])
        for k in ("loss", "photo", "normal_loss", "dist_loss", "psnr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        assert tm["num_rendered"] == int(jm["num_rendered"])
    _assert_states_match(tstate, jstate)
    assert float(tm["normal_loss"]) > 0.0 and float(tm["dist_loss"]) > 0.0
    assert float(tstate.xyz_grad_accum.max()) > 0.0


@pytest.mark.parametrize("prune_big", [False, True])
def test_densify_and_prune_on_surfels_matches_jax(prune_big):
    """2-column scales: the split offset has no component along the normal
    (a zero third column, gaustudio_tpu/pipelines/train.py:312-316)."""
    rng = np.random.default_rng(3)
    n = 8
    scale = np.full((n, 2), -3.0, np.float32)
    scale[1] = np.log([0.5, 0.3])  # large: split
    scale[0] = np.log(0.001)  # small: clone
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = np.full((n, 1), -2.197, np.float32)
    opacity[2] = -10.0  # transparent: prune
    pcd = _surfel_pcd(xyz=rng.normal(size=(n, 3)).astype(np.float32),
                      rgb=np.full((n, 3), 0.5, np.float32), scale=scale,
                      rot=quats / np.linalg.norm(quats, axis=1, keepdims=True), opacity=opacity)
    accum = np.zeros(32, np.float32)
    accum[[0, 1]] = 10.0
    radii = np.zeros(32, np.float32)
    radii[4] = 50.0  # big on screen
    jstate = j_train.init_state(pcd, capacity=32)._replace(
        xyz_grad_accum=jnp.asarray(accum), denom=jnp.ones(32, jnp.float32),
        max_radii2d=jnp.asarray(radii))
    cfg = j_train.TrainConfig(densify_grad_threshold=0.1, percent_dense=0.01)
    jnew, jinfo = j_train.densify_and_prune(jstate, jax.random.PRNGKey(0), jnp.asarray(1.0),
                                            cfg, jnp.asarray(prune_big))
    tstate = t_train.state_from_jax(jstate, device="cpu")
    tnew, tinfo = t_train.densify_and_prune(tstate, torch.Generator().manual_seed(0), 1.0,
                                            t_train.TrainConfig(**cfg._asdict()), prune_big)
    for k in ("n_clone", "n_split", "n_prune_opacity", "n_prune_big"):
        assert tinfo[k] == int(jinfo[k]), k
    assert (tinfo["n_clone"], tinfo["n_split"]) == (1, 1)
    assert tnew.num_points == int(np.asarray(jnew.valid).sum())
    assert tnew.params["scale"].shape[1] == 2
    children = tnew.params["scale"][-2:].numpy()
    np.testing.assert_allclose(children, np.tile(np.log(np.array([0.5, 0.3]) / 1.6), (2, 1)),
                               rtol=1e-6)
    jscale = np.asarray(jnew.params["scale"])[np.asarray(jnew.valid)]
    assert sorted(map(tuple, np.round(tnew.params["scale"].numpy(), 6))) == sorted(
        map(tuple, np.round(jscale, 6)))
    # the children move within the parent's tangent plane
    from gaustudio_torch.ops.gaussian import quat_to_rotmat

    normal = quat_to_rotmat(torch.from_numpy(pcd._rot[1]), normalize=True)[:, 2]
    moved = tnew.params["xyz"][-2:] - torch.from_numpy(pcd._xyz[1])
    assert float(moved.norm(dim=-1).min()) > 0.0
    torch.testing.assert_close(moved @ normal, torch.zeros(2), rtol=0, atol=1e-6)


def test_gs_train_and_render_cli_with_the_2dgs_config(tmp_path):
    src = _write_nerf_scene(tmp_path / "scene", size=32)
    out = tmp_path / "out"
    history = t_train_cli.main(["-s", str(src), "-o", str(out), "--dataset", "nerf",
                                "--config", "2dgs", "--iterations", "6", "--save_every", "6",
                                "--init_points", "300", "--device", "cpu"])
    last = history[-1]
    assert last["iter"] == 6 and np.isfinite(last["loss"])
    assert {"normal_loss", "dist_loss", "photo"} <= set(last)
    ply = out / "point_cloud" / "iteration_6" / "point_cloud.ply"
    props = read_ply(str(ply))["vertex"]
    assert sorted(k for k in props if k.startswith("scale")) == ["scale_0", "scale_1"]
    assert len(props["x"]) == 300
    with open(out / "cameras.json") as f:
        assert len(json.load(f)) == 4
    images = t_render_cli.main(["-m", str(out), "--config", "2dgs", "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / images).iterdir()) == [
        f"r_{i}.png" for i in range(4)]
