"""Port parity of Scaffold-GS: the model (voxelize_sample, from_jax_params,
the PLY and .mlps.npz sidecar both ways), the renderer, decode_scaffold,
three training steps, adjust_anchors and gs-train --config scaffold, each
against gaustudio_tpu at the JAX tests' size (300 points, k = 4, voxel
0.05, 48 px orbit cameras; tests/test_train_scaffold.py).

The JAX state is built with ``init_scaffold_state(pcd, capacity=n)``: the
port has no padded capacity, and its volume term is the mean over its n·k
rows, which the JAX mean over cap·k rows equals only where cap = n.

Run as a script, ``JAX_PLATFORMS=cpu python -m tests.test_torch_scaffold``
trains the JAX ScaffoldTrainer on tests/fixtures/mini_scene from its sparse
points, as gs-train --config scaffold does, and prints the exported model's
mean PSNR over the fixture's views against the first logged training PSNR:
the gate of chip_smoke.py's fixture run (the gain less 1 dB).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaustudio_torch import models as t_models
from gaustudio_torch import renderers as t_renderers
from gaustudio_torch.cameras.camera_paths import get_path_from_orbit as t_orbit
from gaustudio_torch.models.scaffold import ScaffoldPointCloud
from gaustudio_torch.ops import rasterize as t_rasterize
from gaustudio_torch.pipelines import train as t_train
from gaustudio_torch.pipelines import train_scaffold as t_sc
from gaustudio_torch.scripts import train as t_train_cli
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.cameras import camera_paths as j_paths
from gaustudio_tpu.ops.rasterize import RasterizeSettings as JSettings
from gaustudio_tpu.pipelines import train as j_train
from gaustudio_tpu.pipelines import train_scaffold as j_sc
from tests.test_torch_variants import render_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_scene")
K, VOXEL, SIZE = 4, 0.05, 48
CAMERA_SEQUENCE = (2, 0, 3)
HEADS = ("opacity", "cov", "color", "feature_bank")


def _jax_model(feat_bank=False, n_pts=300, seed=0):
    """tests/test_train_scaffold.py's model, with seeded anisotropic,
    rotated anchor scales (the decoded splats inherit them)."""
    rng = np.random.default_rng(seed)
    model = j_models.make({"name": "scaffold_pcd", "n_offsets": K, "voxel_size": VOXEL,
                           "use_feat_bank": feat_bank})
    model.create_from_attribute(xyz=rng.normal(size=(n_pts, 3)).astype(np.float32) * 0.4)
    model._offset = rng.normal(size=model._offset.shape).astype(np.float32) * 0.1
    model._anchor_feat = rng.normal(size=model._anchor_feat.shape).astype(np.float32)
    model._scale = (model._scale + rng.normal(size=model._scale.shape) * 0.3).astype(np.float32)
    rot = rng.normal(size=model._rot.shape).astype(np.float32)
    model._rot = rot / np.linalg.norm(rot, axis=1, keepdims=True)
    return model


def _jax_params(model) -> dict:
    params = {e: np.asarray(getattr(model, "_" + e))
              for e in ("anchor", "offset", "anchor_feat", "opacity", "scale", "rot")}
    params["mlps"] = jax.tree.map(np.asarray, model.mlp_params)
    return params


def _port_model(model) -> ScaffoldPointCloud:
    return ScaffoldPointCloud.from_jax_params(
        _jax_params(model), device="cpu",
        config={"n_offsets": K, "voxel_size": VOXEL, "use_feat_bank": model.use_feat_bank})


def _assert_heads_match(t_params, j_mlps, rtol=1e-6, atol=0.0):
    """Port MLP leaves (nn.Linear layout) against JAX layers ([n_in, n_out])."""
    for head, layers in j_mlps.items():
        for li, layer in enumerate(layers):
            for pname, tname in (("w", "weight"), ("b", "bias")):
                want = np.asarray(layer[pname])
                got = t_params(f"{head}.{2 * li}.{tname}").detach().cpu().numpy()
                got = got.T if pname == "w" else got
                scale = np.abs(want).max() + 1e-6
                np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                                           atol=atol, err_msg=f"{head}/{li}/{pname}")


def _assert_models_match(t_pcd, j_pcd, rtol=1e-6):
    for e in ("anchor", "offset", "anchor_feat", "opacity", "scale", "rot"):
        np.testing.assert_allclose(getattr(t_pcd, "_" + e).numpy(),
                                   np.asarray(getattr(j_pcd, "_" + e)).reshape(
                                       t_pcd.num_points, -1), rtol=rtol, err_msg=e)
    state = dict(t_pcd.mlp.named_parameters())
    _assert_heads_match(state.__getitem__, j_pcd.mlp_params, rtol=rtol)
    assert set(t_pcd.mlp) == set(j_pcd.mlp_params)


def test_voxelize_sample_keeps_the_jax_row_order():
    pts = np.random.default_rng(3).normal(size=(2000, 3)).astype(np.float32) * 0.4
    j = j_models.make({"name": "scaffold_pcd", "voxel_size": VOXEL})
    t = t_models.make({"name": "scaffold_pcd", "voxel_size": VOXEL}, device="cpu")
    want = j.voxelize_sample(pts)
    got = t.voxelize_sample(torch.from_numpy(pts))
    assert len(want) < len(pts)
    np.testing.assert_array_equal(got, want)
    j.create_from_attribute(xyz=pts)
    t.create_from_attribute(xyz=pts)
    for e in ("anchor", "offset", "anchor_feat", "opacity", "scale", "rot"):
        np.testing.assert_array_equal(getattr(t, "_" + e).numpy(), getattr(j, "_" + e), e)


@pytest.mark.parametrize("feat_bank", [False, True], ids=["heads", "feature_bank"])
def test_from_jax_params_carries_anchors_and_heads(feat_bank):
    j = _jax_model(feat_bank)
    t = _port_model(j)
    _assert_models_match(t, j)
    x = np.random.default_rng(4).normal(size=(20, 36)).astype(np.float32)
    for head in ("opacity", "cov", "color"):
        want = np.asarray(getattr(j, f"mlp_{head}")(jnp.asarray(x)))
        got = getattr(t, f"mlp_{head}")(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=head)
    if feat_bank:
        want = np.asarray(j.mlp_feature_bank(jnp.asarray(x[:, :4])))
        got = t.mlp_feature_bank(torch.from_numpy(x[:, :4])).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_and_load_cross_both_ways(tmp_path, writer):
    """The anchor PLY and the .mlps.npz sidecar of one package load in the
    other: the same anchors, the heads transposed back."""
    j = _jax_model(feat_bank=True)
    t = _port_model(j)
    path = str(tmp_path / "scaffold.ply")
    conf = {"name": "scaffold_pcd", "n_offsets": K, "voxel_size": VOXEL}
    if writer == "jax":
        j.export(path)
        got = t_models.make(conf, device="cpu")
        got.load(path)
        _assert_models_match(got, j)
    else:
        t.export(path)
        got = j_models.make(conf)
        got.load(path)
        _assert_models_match(t, got)
    assert sorted(np.load(path + ".mlps.npz").files) == sorted(
        f"{h}/{li}/{p}" for h in HEADS for li in (0, 1) for p in ("w", "b"))


def _cams():
    return (j_paths.get_path_from_orbit(np.zeros(3), 2.2, num_cam=4, image_size=SIZE, fov_deg=55),
            t_orbit(np.zeros(3), 2.2, num_cam=4, image_size=SIZE, fov_deg=55, device="cpu"))


@pytest.mark.parametrize("feat_bank", [False, True], ids=["heads", "feature_bank"])
def test_scaffold_renderer_matches_jax(feat_bank):
    j = _jax_model(feat_bank)
    t = _port_model(j)
    jc, tc = _cams()
    j_r = j_renderers.make({"name": "scaffold_renderer"})
    t_r = t_renderers.make({"name": "scaffold_renderer"}, device="cpu")
    render_both(j_r, t_r, jc[1], tc[1], j, t)
    props = t_r.get_gaussians_properties(tc[1], t)
    want = j_r.get_gaussians_properties(jc[1], j)
    for i, name in ((0, "xyz"), (2, "color"), (3, "opacity"), (4, "scales"), (5, "rotations")):
        np.testing.assert_allclose(props[i].detach().numpy(), np.asarray(want[i]).reshape(
            props[i].shape), rtol=1e-5, atol=1e-6, err_msg=name)


def test_decode_scaffold_matches_jax():
    j = _jax_model()
    t = _port_model(j)
    n = t.num_points
    jstate = j_sc.init_scaffold_state(j, capacity=n)
    tstate = t_sc.init_scaffold_state(t)
    _, tc = _cams()
    campos = tc[2].camera_center
    want = j_sc.decode_scaffold(jstate.params, jstate.valid, jnp.asarray(campos.numpy()), K)
    got = t_sc.decode_scaffold(tstate.params, t.mlp, campos, K)
    names = ("xyz", "color", "opacity", "scales", "rots", "neural_opacity")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert 0 < int((got[2] > 0).sum()) < n * K


@pytest.fixture(scope="module")
def stepped():
    """Three training steps of both trainers from one model (the JAX state
    at capacity n), one camera sequence; each step's (loss, state)."""
    j = _jax_model()
    t = _port_model(j)
    n = t.num_points
    jc, tc = _cams()
    rng = np.random.default_rng(8)
    jstate = j_sc.init_scaffold_state(j, capacity=n)
    tstate = t_sc.init_scaffold_state(t)
    jset = JSettings(image_height=SIZE, image_width=SIZE, tanfovx=jc[0].tanfovx,
                     tanfovy=jc[0].tanfovy, bg=None, sh_degree=0, num_entries=1 << 15,
                     chunk=512, with_median=False)
    tset = t_rasterize.RasterizeSettings(image_height=SIZE, image_width=SIZE,
                                         tanfovx=tc[0].tanfovx, tanfovy=tc[0].tanfovy, bg=None,
                                         sh_degree=0)
    cfg = j_sc.ScaffoldTrainConfig()
    tcfg = t_sc.ScaffoldTrainConfig()
    steps = []
    for i in CAMERA_SEQUENCE:
        gt = rng.uniform(0.0, 1.0, (3, SIZE, SIZE)).astype(np.float32)
        arrs = (tc[i].world_view_transform, tc[i].full_proj_transform, tc[i].camera_center)
        jb = j_train.CameraBatch(*(jnp.asarray(a.numpy()) for a in arrs), jnp.asarray(gt))
        tb = t_train.CameraBatch(*arrs, torch.from_numpy(gt))
        jstate, jm = j_sc.train_step_scaffold(jstate, jb, jset, cfg, K)
        tstate, tm = t_sc.train_step_scaffold(tstate, tb, tset, tcfg, t.mlp, K)
        steps.append((jm, tm, jax.tree.map(np.asarray, jstate), tstate))
    return steps


@pytest.mark.parametrize("step", range(len(CAMERA_SEQUENCE)))
def test_train_steps_match_jax(stepped, step):
    """Loss at rtol 1e-5; every parameter and MLP weight at the scaled
    tolerance of tests/test_torch_train.py; the statistics."""
    jm, tm, jstate, tstate = stepped[step]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
    assert tm["num_points"] == int(jm["num_points"])
    for k in t_sc.PARAMS:
        want = jstate.params[k]
        scale = np.abs(want).max() + 1e-6
        np.testing.assert_allclose(tstate.params[k].numpy() / scale, want / scale, rtol=0,
                                   atol=1e-5, err_msg=k)
    _assert_heads_match(lambda name: tstate.params[t_sc.MLP_PREFIX + name],
                        jstate.params["mlps"], rtol=0, atol=1e-5)
    assert tstate.opt_count == int(jstate.opt_count) == tstate.step == step + 1
    np.testing.assert_allclose(tstate.offset_grad_accum.numpy(), jstate.offset_grad_accum,
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(tstate.offset_denom.numpy(), jstate.offset_denom)
    np.testing.assert_allclose(tstate.opacity_accum.numpy(), jstate.opacity_accum,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tstate.anchor_denom.numpy(), jstate.anchor_denom)
    assert float(tstate.offset_grad_accum.max()) > 0.0
    # a live offset with opacity in (0, 1/255] has no entries but counts
    assert 0 < float(tstate.offset_denom.sum()) < tstate.offset_denom.numel() * (step + 1)


def _synthetic_stats(n, cap, cfg):
    """tests/test_train_scaffold.py:68-101's statistics over ``cap`` rows."""
    grad = np.zeros((cap, K), np.float32)
    denom = np.full((cap, K), cfg.update_interval, np.float32)
    grad[:50] = 0.01 * cfg.update_interval
    op_acc = np.full((cap,), 50.0, np.float32)
    op_acc[100:150] = 0.0
    an_den = np.full((cap,), float(cfg.update_interval), np.float32)
    return grad.reshape(-1), denom.reshape(-1), op_acc, an_den


def test_adjust_anchors_matches_jax():
    """The same anchors in the same order, survivors' moments carried in
    their new order, newborn moments zero, the step count kept."""
    j = _jax_model()
    t = _port_model(j)
    n = t.num_points
    cfg = j_sc.ScaffoldTrainConfig(grad_threshold=0.001, min_opacity=0.005)
    tcfg = t_sc.ScaffoldTrainConfig(grad_threshold=0.001, min_opacity=0.005)
    jstate = j_sc.init_scaffold_state(j)
    cap = jstate.valid.shape[0]
    rng = np.random.default_rng(9)
    moments = {k: rng.normal(size=np.asarray(v).shape).astype(np.float32)
               for k, v in jstate.params.items() if k != "mlps"}
    grad, denom, op_acc, an_den = _synthetic_stats(n, cap, cfg)
    jstate = jstate._replace(
        mu={**jstate.mu, **{k: jnp.asarray(v) for k, v in moments.items()}},
        nu={**jstate.nu, **{k: jnp.asarray(np.abs(v)) for k, v in moments.items()}},
        opt_count=jnp.asarray(7, jnp.int32), offset_grad_accum=jnp.asarray(grad),
        offset_denom=jnp.asarray(denom), opacity_accum=jnp.asarray(op_acc),
        anchor_denom=jnp.asarray(an_den))
    tstate = t_sc.init_scaffold_state(t)
    tstate = tstate._replace(
        mu={**tstate.mu, **{k: torch.from_numpy(v[:n]) for k, v in moments.items()}},
        nu={**tstate.nu, **{k: torch.from_numpy(np.abs(v[:n])) for k, v in moments.items()}},
        opt_count=7, offset_grad_accum=torch.from_numpy(grad[:n * K]),
        offset_denom=torch.from_numpy(denom[:n * K]), opacity_accum=torch.from_numpy(op_acc[:n]),
        anchor_denom=torch.from_numpy(an_den[:n]))

    want = j_sc.adjust_anchors(jstate, cfg, j)
    got = t_sc.adjust_anchors(tstate, tcfg, t)
    valid = np.asarray(want.valid)
    n_new = int(valid.sum())
    assert got.num_anchors == n_new and n_new != n and n_new >= n - 50
    for k in t_sc.PARAMS:
        np.testing.assert_array_equal(got.params[k].numpy(), np.asarray(want.params[k])[valid], k)
        for moment in ("mu", "nu"):
            np.testing.assert_array_equal(getattr(got, moment)[k].numpy(),
                                          np.asarray(getattr(want, moment)[k])[valid], k)
    assert float(got.mu["anchor"][-1].abs().sum()) == 0.0  # a newborn row
    assert got.opt_count == int(want.opt_count) == 7
    assert float(got.offset_grad_accum.sum()) == 0.0 and got.offset_denom.numel() == n_new * K
    for k, v in tstate.params.items():
        if k.startswith(t_sc.MLP_PREFIX):
            assert got.params[k] is v and got.mu[k] is tstate.mu[k]


def test_gs_train_cli_scaffold_export_loads_in_jax(tmp_path):
    """A short gs-train --config scaffold on the CPU: the JAX model reads its
    export, anchors and heads, as the port's trainer left them."""
    from tests.test_torch_train import _write_nerf_scene

    src = _write_nerf_scene(tmp_path / "scene", size=24, num_cam=3)
    out = tmp_path / "out"
    history = t_train_cli.main([
        "-s", str(src), "-o", str(out), "--dataset", "nerf", "--config", "scaffold",
        "--iterations", "4", "--save_every", "4", "--init_points", "200", "--device", "cpu",
        "model.pointcloud.n_offsets=2", "model.pointcloud.voxel_size=0.2"])
    assert history[-1]["iter"] == 4 and np.isfinite(history[-1]["loss"])
    ply = str(out / "point_cloud" / "iteration_4" / "point_cloud.ply")
    j = j_models.make({"name": "scaffold_pcd", "n_offsets": 2})
    j.load(ply)
    t = t_models.make({"name": "scaffold_pcd", "n_offsets": 2}, device="cpu")
    t.load(ply)
    assert j.num_points == t.num_points == int(history[-1]["num_points"])
    _assert_models_match(t, j)
    assert np.isfinite(np.asarray(j._offset)).all()
    assert [json.loads(x)["step"] for x in open(out / "metrics.jsonl")] == [4]
    with open(out / "cameras.json") as f:
        assert len(json.load(f)) == 3


def fixture_gain(iterations: int = 500, num_entries: int = 1 << 18) -> dict:
    """The JAX ScaffoldTrainer on mini_scene from its sparse points, as the
    JAX gs-train --config scaffold builds it (cameras drawn from seed 0): the
    training PSNR it logs first (iteration 100), the exported model's mean
    PSNR over the fixture's views, and the gain between them.

    ``num_entries`` sizes the XLA binning's entry buffer in place of the
    trainer's probe (8x the first view's count, which makes a CPU step take
    seconds); every step's count is checked to fit, so no entry is dropped.
    """
    from gaustudio_tpu import datasets
    from gaustudio_tpu.config import builtin_config_path, load_config
    from gaustudio_tpu.utils.ply import fetch_ply

    config = load_config(builtin_config_path("scaffold"))
    dataset = datasets.make({"name": "vanilla", "source_path": FIXTURE, "resolution": 1})
    pcd = j_models.make(config["model"]["pointcloud"])
    xyz, rgb, _ = fetch_ply(os.path.join(FIXTURE, "sparse_points.ply"))
    pcd.create_from_attribute(xyz=xyz, rgb=rgb)
    trainer = j_sc.ScaffoldTrainer(pcd, dataset, j_sc.ScaffoldTrainConfig(iterations=iterations),
                                   num_entries=num_entries)
    history = trainer.train(iterations=iterations, log_every=1)
    most = max(m["num_rendered"] for m in history)
    assert most <= num_entries, f"{most} entries overflow {num_entries}"
    j_sc.state_to_scaffold_model(trainer.state, pcd)
    renderer = j_renderers.make(config["renderer"])
    psnrs = []
    for cam in list(dataset):
        img = np.asarray(renderer.render(cam, pcd)["render"])
        mse = float(np.mean((np.moveaxis(img, 0, -1) - np.asarray(cam.image)) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
    first = history[99]  # gs-train logs every 100 iterations
    return {"iterations": iterations, "first_logged_iter": first["iter"],
            "first_logged_psnr": first["psnr"], "exported_psnr": float(np.mean(psnrs)),
            "gain_db": float(np.mean(psnrs)) - first["psnr"], "most_entries": most,
            "num_entries": num_entries}


if __name__ == "__main__":
    print(json.dumps(fixture_gain(*(int(a) for a in sys.argv[1:]))))
