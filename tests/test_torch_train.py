"""Port parity of vanilla training: train_step, densify_and_prune,
reset_opacity and oneup_sh_degree against gaustudio_tpu/pipelines/train.py
from the same carried state and camera sequence; the vanilla and nerf
datasets against the JAX loaders; the port's gs-train CLI; checkpoints,
metrics and the batch source."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaustudio_torch import datasets as t_datasets
from gaustudio_torch import models as t_models
from gaustudio_torch.ops import rasterize as t_rasterize
from gaustudio_torch.pipelines import dataloader as t_dataloader
from gaustudio_torch.pipelines import train as t_train
from gaustudio_torch.scripts import train as t_train_cli
from gaustudio_torch.utils import observability
from gaustudio_torch.utils.image import write_png
from gaustudio_tpu import datasets as j_datasets
from gaustudio_tpu import models as j_models
from gaustudio_tpu.cameras import camera_paths
from gaustudio_tpu.ops.rasterize import RasterizeSettings as JSettings
from gaustudio_tpu.pipelines import train as j_train
from tests.test_training import _make_gt_scene, _mini_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_scene")
CAMERA_SEQUENCE = (2, 0, 4)


@pytest.fixture(scope="module")
def carried():
    """The JAX trainer's initial state on the scene of tests/test_training.py,
    the port's state carried from it, and both trainers' settings and batches
    for one camera sequence.

    The start is perturbed in every attribute, anisotropic and rotated: an
    isotropic Gaussian's rotation gradient is 0 up to float noise, which
    Adam (eps 1e-15) turns into +-lr steps that no two implementations share.
    """
    gt_pcd, cams = _make_gt_scene(size=48)
    rng = np.random.default_rng(1)
    n = gt_pcd.num_points
    pcd = j_models.make({"name": "vanilla_pcd"})
    xyz0 = np.asarray(gt_pcd._xyz) + rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    pcd.create_from_attribute(
        xyz=xyz0, rgb=rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
        scale=np.log(rng.uniform(0.03, 0.12, (n, 3))).astype(np.float32),
        rot=quats / np.linalg.norm(quats, axis=1, keepdims=True),
        opacity=rng.normal(size=(n, 1)).astype(np.float32))
    jstate = j_train.init_state(pcd, capacity=256)
    cam0 = cams[0]
    jset = JSettings(image_height=48, image_width=48, tanfovx=cam0.tanfovx,
                     tanfovy=cam0.tanfovy, bg=None, sh_degree=3, num_entries=1 << 14,
                     chunk=512, with_median=False)
    tset = t_rasterize.RasterizeSettings(image_height=48, image_width=48,
                                         tanfovx=cam0.tanfovx, tanfovy=cam0.tanfovy, bg=None,
                                         sh_degree=3)
    jb, tb = [], []
    for i in CAMERA_SEQUENCE:
        cam = cams[i]
        arrs = (cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
                np.moveaxis(np.asarray(cam.image, np.float32), -1, 0))
        jb.append(j_train.CameraBatch(*(jnp.asarray(a) for a in arrs)))
        tb.append(t_train.CameraBatch(*(torch.tensor(np.asarray(a)) for a in arrs)))
    return dict(jstate=jstate, tstate=t_train.state_from_jax(jstate, device="cpu"), jset=jset, tset=tset,
                jb=jb, tb=tb, cfg=j_train.TrainConfig(), tcfg=t_train.TrainConfig())


def _assert_states_match(t_state, j_state, j_metrics=None, t_metrics=None):
    valid = np.asarray(j_state.valid)
    for k, v in t_state.params.items():
        want = np.asarray(j_state.params[k])[valid]
        scale = np.abs(want).max() + 1e-6
        np.testing.assert_allclose(v.numpy() / scale, want / scale, rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(t_state.opt.count[k].numpy(),
                                      np.asarray(j_state.opt.count[k])[valid])
    np.testing.assert_allclose(t_state.xyz_grad_accum.numpy(),
                               np.asarray(j_state.xyz_grad_accum)[valid], rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(t_state.denom.numpy(), np.asarray(j_state.denom)[valid])
    np.testing.assert_array_equal(t_state.max_radii2d.numpy(),
                                  np.asarray(j_state.max_radii2d)[valid])
    assert t_state.step == int(j_state.step)
    if j_metrics is not None:
        np.testing.assert_allclose(float(t_metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(t_metrics["psnr"]), float(j_metrics["psnr"]), rtol=1e-5)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(carried, steps):
    # the JAX step donates its state: step a copy
    jstate = jax.tree.map(lambda x: jnp.array(x, copy=True), carried["jstate"])
    tstate = carried["tstate"]
    for i in range(steps):
        jstate, jm = j_train.train_step(jstate, carried["jb"][i], carried["jset"], carried["cfg"])
        tstate, tm = t_train.train_step(tstate, carried["tb"][i], carried["tset"],
                                        carried["tcfg"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_states_match(tstate, jstate, jm, tm)
    assert float(tstate.xyz_grad_accum.max()) > 0.0
    assert tm["num_points"] == 120


def _densify_state():
    """The constructed state of tests/test_training.py:94-146 with one row of
    each kind: a clone, a split, a transparent row, a NaN row, an oversized
    row, and random Adam moments and counts."""
    state = _mini_state()
    rng = np.random.default_rng(5)
    params = {k: np.asarray(v).copy() for k, v in state.params.items()}
    params["scale"][1] = np.log(0.5)  # large: split
    params["scale"][0] = np.log(0.001)  # small: clone
    params["opacity"][2] = -10.0  # transparent: prune
    params["xyz"][3, 1] = np.nan  # non-finite: prune
    accum = np.zeros(32, np.float32)
    accum[[0, 1]] = 10.0
    radii = np.zeros(32, np.float32)
    radii[4] = 50.0  # big on screen: pruned only with prune_big_points
    opt = j_train.AdamState(
        mu={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in params.items()},
        nu={k: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32)) for k, v in params.items()},
        count={k: jnp.asarray(rng.integers(1, 9, size=32).astype(np.int32)) for k in params})
    return state._replace(params={k: jnp.asarray(v) for k, v in params.items()}, opt=opt,
                          xyz_grad_accum=jnp.asarray(accum), denom=jnp.ones(32, jnp.float32),
                          max_radii2d=jnp.asarray(radii))


def _rows(params, idx=None, skip=()):
    keys = [k for k in t_train.PARAMS if k not in skip]
    arr = np.concatenate([np.asarray(params[k]).reshape(len(np.asarray(params[k])), -1)
                          for k in keys], axis=1)
    arr = arr if idx is None else arr[idx]
    return sorted(map(tuple, np.round(arr.astype(np.float64), 6)))


@pytest.mark.parametrize("prune_big", [False, True])
def test_densify_and_prune_matches_jax(prune_big):
    cfg = j_train.TrainConfig(densify_grad_threshold=0.1, percent_dense=0.01)
    jstate = _densify_state()
    tstate = t_train.state_from_jax(jstate, device="cpu")
    jnew, jinfo = j_train.densify_and_prune(jstate, jax.random.PRNGKey(0), jnp.asarray(1.0), cfg,
                                            jnp.asarray(prune_big))
    tnew, tinfo = t_train.densify_and_prune(tstate, torch.Generator().manual_seed(0), 1.0,
                                            t_train.TrainConfig(**cfg._asdict()), prune_big)
    for k in ("n_clone", "n_split", "n_prune_opacity", "n_prune_big"):
        assert tinfo[k] == int(jinfo[k]), k
    assert (tinfo["n_clone"], tinfo["n_split"], tinfo["n_prune_opacity"]) == (1, 1, 1)
    assert tinfo["n_prune_big"] == 2 * int(prune_big)  # rows 4 (screen) and 1 (world)
    np.testing.assert_allclose(tinfo["grad_med"], float(jinfo["grad_med"]), rtol=1e-6)

    jvalid = np.asarray(jnew.valid)
    n = tnew.num_points
    assert n == int(jvalid.sum()) == 8 - 3 - int(prune_big) + 3
    n_keep = n - 3
    # survivors and the clone, as sets of rows; the NaN row is gone
    is_child = np.isclose(np.asarray(jnew.params["scale"])[:, 0], np.log(0.5 / 1.6))
    assert _rows(tnew.params, np.arange(n_keep + 1)) == _rows(
        jnew.params, np.flatnonzero(jvalid & ~is_child))
    assert np.isfinite(tnew.params["xyz"].numpy()).all()
    # the split's children: the parent's scale / 1.6, the rest copied
    children = tnew.params["scale"][n_keep + 1:].numpy()
    np.testing.assert_allclose(children, np.full((2, 3), np.log(0.5 / 1.6), np.float32),
                               rtol=1e-6)
    assert _rows(tnew.params, np.arange(n_keep + 1, n), skip=("xyz",)) == _rows(
        jnew.params, np.flatnonzero(jvalid & is_child), skip=("xyz",))
    # moments and counts: survivors keep theirs, every new row starts at 0
    for k in t_train.PARAMS:
        for d in ("mu", "nu", "count"):
            got = getattr(tnew.opt, d)[k].numpy()
            assert not got[n_keep:].any(), (d, k)
            keep = ~np.isin(np.arange(8), [1, 2, 3] + ([4] if prune_big else []))
            np.testing.assert_array_equal(got[:n_keep], getattr(tstate.opt, d)[k].numpy()[keep])
    for stat in (tnew.xyz_grad_accum, tnew.denom, tnew.max_radii2d):
        assert stat.shape == (n,) and not stat.any()
    assert not np.asarray(jnew.xyz_grad_accum).any()


def test_reset_opacity_and_oneup_sh_degree_match_jax():
    jstate = _densify_state()
    tstate = t_train.state_from_jax(jstate, device="cpu")
    jr, tr = j_train.reset_opacity(jstate), t_train.reset_opacity(tstate)
    valid = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.params["opacity"].numpy(),
                                  np.asarray(jr.params["opacity"])[valid])
    for d in ("mu", "nu", "count"):
        assert not getattr(tr.opt, d)["opacity"].any()
        torch.testing.assert_close(getattr(tr.opt, d)["xyz"], getattr(tstate.opt, d)["xyz"])
    assert float(torch.sigmoid(tr.params["opacity"]).max()) <= 0.0101
    t_deg, j_deg = tstate, jstate
    for _ in range(5):
        t_deg, j_deg = t_train.oneup_sh_degree(t_deg, 3), j_train.oneup_sh_degree(j_deg, 3)
        assert t_deg.active_sh_degree == int(j_deg.active_sh_degree)
    assert t_deg.active_sh_degree == 3


def test_vanilla_dataset_matches_jax():
    t_ds = t_datasets.make({"name": "vanilla", "source_path": FIXTURE})
    j_ds = j_datasets.make({"name": "vanilla", "source_path": FIXTURE})
    _assert_datasets_match(t_ds, j_ds, n=10)


def _write_nerf_scene(path, size=32, num_cam=4, seed=3):
    """A nerf-synthetic scene of RGBA PNGs written with the port's codec."""
    rng = np.random.default_rng(seed)
    (path / "train").mkdir(parents=True)
    cams = camera_paths.get_path_from_orbit(np.zeros(3), 2.0, num_cam=num_cam,
                                            image_size=size, fov_deg=50)
    frames = []
    for i, cam in enumerate(cams):
        write_png(str(path / "train" / f"r_{i}.png"),
                  (rng.uniform(size=(size, size, 4)) * 255).astype(np.uint8))
        c2w = np.linalg.inv(cam.extrinsics)
        c2w[:, 1:3] *= -1  # undo the loader's flip
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (path / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": float(cams[0].FoVx), "w": size, "h": size, "frames": frames}))
    return path


@pytest.mark.parametrize("white", [False, True], ids=["black", "white"])
def test_nerf_dataset_matches_jax(tmp_path, white):
    src = str(_write_nerf_scene(tmp_path / "scene"))
    conf = {"name": "nerf", "source_path": src, "white_background": white}
    _assert_datasets_match(t_datasets.make(conf), j_datasets.make(conf), n=4)


def _assert_datasets_match(t_ds, j_ds, n):
    assert len(t_ds) == len(j_ds) == n
    assert t_ds.cameras_extent == pytest.approx(j_ds.cameras_extent, rel=1e-12)
    np.testing.assert_allclose(t_ds.cameras_center, j_ds.cameras_center, rtol=1e-12)
    for tc, jc in zip(t_ds, j_ds):
        assert tc.image_name == jc.image_name
        assert (tc.image_width, tc.image_height) == (jc.image_width, jc.image_height)
        assert tc.FoVx == pytest.approx(jc.FoVx) and tc.FoVy == pytest.approx(jc.FoVy)
        np.testing.assert_allclose(tc.world_view_transform.numpy(),
                                   np.asarray(jc.world_view_transform), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tc.full_proj_transform.numpy(),
                                   np.asarray(jc.full_proj_transform), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tc.image.numpy(), np.asarray(jc.image), rtol=0, atol=1e-6)


def test_gs_train_cli_writes_the_inria_layout(tmp_path):
    src = _write_nerf_scene(tmp_path / "scene")
    out = tmp_path / "out"
    history = t_train_cli.main(["-s", str(src), "-o", str(out), "--dataset", "nerf",
                                "--iterations", "20", "--save_every", "20",
                                "--init_points", "500", "--device", "cpu"])
    assert np.isfinite(history[-1]["loss"]) and history[-1]["iter"] == 20
    ply = out / "point_cloud" / "iteration_20" / "point_cloud.ply"
    pcd = j_models.make({"name": "vanilla_pcd"})
    pcd.load(str(ply))
    assert pcd.num_points == 500
    assert np.isfinite(np.asarray(pcd._xyz)).all()
    with open(out / "cameras.json") as f:
        assert len(json.load(f)) == 4
    assert [json.loads(x)["step"] for x in open(out / "metrics.jsonl")] == [20]


@pytest.mark.parametrize("argv,match", [
    (["--dataset", "nerf", "--config", "2dgs", "--gs_shards", "2"], "slice 8"),
    (["--dataset", "nerf", "--gs_shards", "2"], "slice 8"),
], ids=["2dgs", "gs_shards"])
def test_gs_train_cli_refuses_deferred_inputs(tmp_path, argv, match):
    with pytest.raises(NotImplementedError, match=match):
        t_train_cli.main(["-s", str(tmp_path), "-o", str(tmp_path / "out"), "--device", "cpu"]
                         + argv)


def test_gs_train_cli_refuses_a_surfel_config(tmp_path):
    """2DGS trains (tests/test_torch_train_surfel.py); a surfel config whose
    model variant the port lacks is still refused."""
    conf = tmp_path / "surfel.json"
    conf.write_text(json.dumps({"model": {"pointcloud": {"name": "scaffold_pcd"}},
                                "renderer": {"name": "surfel_renderer"}}))
    with pytest.raises(NotImplementedError, match="slice 5"):
        t_train_cli.main(["-s", str(tmp_path), "-o", str(tmp_path / "out"), "--device", "cpu",
                          "--dataset", "nerf", "--config", str(conf)])


def test_trainer_densifies_and_checkpoints_roundtrip(tmp_path):
    gt_pcd, cams = _make_gt_scene(n=60, size=32)
    pcd = t_models.make({"name": "vanilla_pcd"}, device="cpu")
    pcd.create_from_attribute(xyz=np.asarray(gt_pcd._xyz), rgb=np.full((60, 3), 0.5, np.float32))
    for cam in cams:
        cam.image = torch.tensor(np.asarray(cam.image, np.float32))
        cam.world_view_transform, cam.full_proj_transform, cam.camera_center = (
            torch.tensor(np.asarray(a)) for a in (
                cam.world_view_transform, cam.full_proj_transform, cam.camera_center))

    class _Cams(list):
        cameras_extent = 2.0

    cfg = t_train.TrainConfig(densify_from_iter=2, densify_until_iter=100,
                              densification_interval=5, densify_grad_threshold=1e-7,
                              sh_increase_interval=4)
    trainer = t_train.Trainer(pcd, _Cams(cams), cfg, seed=0, device="cpu")
    history = trainer.train(iterations=10, log_every=5, metrics_path=str(tmp_path / "m.jsonl"),
                            checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=10)
    assert [m["iter"] for m in history] == [5, 10]
    assert history[0]["n_clone"] + history[0]["n_split"] > 0
    assert trainer.state.num_points > 60 and trainer.state.active_sh_degree == 2
    back = t_train.load_checkpoint(str(tmp_path / "ckpt" / "step_10.pt"), device="cpu")
    assert back.step == 10 and back.active_sh_degree == 2
    for k in t_train.PARAMS:
        torch.testing.assert_close(back.params[k], trainer.state.params[k], rtol=0, atol=0)
        torch.testing.assert_close(back.opt.count[k], trainer.state.opt.count[k], rtol=0, atol=0)
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert [x["step"] for x in lines] == [5, 10]

    out = t_train.state_to_model(trainer.state, t_models.make({"name": "vanilla_pcd"}, device="cpu"))
    assert out.num_points == trainer.state.num_points and out.active_sh_degree == 2


def test_snapshot_on_nonfinite(tmp_path):
    dump = str(tmp_path / "snap.pt")
    tree = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, float("nan")])}}
    assert observability.snapshot_on_nonfinite(tree, dump, "test")
    saved = torch.load(dump, weights_only=True)
    assert saved["bad_leaves"] == ["['b']['c']"] and saved["context"] == "test"
    assert not observability.snapshot_on_nonfinite({"a": torch.ones(2)}, str(tmp_path / "no.pt"))
    assert not os.path.exists(tmp_path / "no.pt")


@pytest.mark.parametrize("mode", ["cache", "thread"])
def test_batch_source_draws_the_jax_camera_sequence(mode, monkeypatch):
    """The port's batch source draws the JAX loader's camera sequence for a
    seed, from the device cache or from the prefetch thread."""
    from gaustudio_tpu.pipelines.dataloader import make_batch_source as j_source

    class _Cam:
        image_height = image_width = 4

        def __init__(self, i):
            self.i = i

    cams = [_Cam(i) for i in range(5)]
    j_fn = j_source(cams, lambda c: jnp.asarray([c.i]), seed=3)
    want = [int(j_fn()[0]) for _ in range(12)]
    if mode == "thread":  # a capture above the limit goes through the thread
        monkeypatch.setattr(t_dataloader, "CACHE_LIMIT_BYTES", 0)
    fn = t_dataloader.make_batch_source(cams, lambda c: torch.tensor([c.i]), seed=3)
    try:
        got = [int(fn()[0]) for _ in range(12)]
    finally:
        fn.close()
    assert got == want


def test_prefetch_loader_raises_the_batch_error_in_the_consumer():
    def make_batch(cam):
        raise ValueError(f"bad camera {cam}")

    loader = t_dataloader.PrefetchLoader([7], make_batch, seed=0)
    try:
        with pytest.raises(ValueError, match="bad camera 7"):
            next(loader)
    finally:
        loader.close()


def test_create_from_attribute_matches_jax():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.uniform(size=(50, 3)).astype(np.float32)
    t_pcd = t_models.make({"name": "vanilla_pcd"}, device="cpu")
    j_pcd = j_models.make({"name": "vanilla_pcd"})
    t_pcd.create_from_attribute(xyz=xyz, rgb=rgb)
    j_pcd.create_from_attribute(xyz=xyz, rgb=rgb)
    for k in t_train.PARAMS:
        np.testing.assert_allclose(getattr(t_pcd, "_" + k).numpy(),
                                   np.asarray(getattr(j_pcd, "_" + k)), rtol=1e-6, err_msg=k)
    t_pcd.oneupSHdegree()
    assert t_pcd.active_sh_degree == 1 and t_pcd.num_points == 50


def test_base_model_update_and_create_from_attribute_match_jax():
    from gaustudio_torch.models.base import BasePointCloud as TBase
    from gaustudio_tpu.models.base import BasePointCloud as JBase

    rng = np.random.default_rng(2)
    attrs = {"xyz": rng.normal(size=(6, 3)).astype(np.float32),
             "rgb": rng.uniform(size=(6, 3)).astype(np.float32), "normal": None}
    t_pcd, j_pcd = TBase(device="cpu"), JBase()
    t_pcd.create_from_attribute(**attrs)
    j_pcd.create_from_attribute(**attrs)
    assert list(t_pcd.config["attributes"]) == ["xyz", "rgb"] and t_pcd.num_points == 6
    for k in ("xyz", "rgb"):
        np.testing.assert_array_equal(getattr(t_pcd, "_" + k).numpy(), getattr(j_pcd, "_" + k))
    t_pcd.update(xyz=torch.zeros(4, 3), rgb=np.ones((4, 3), np.float32))
    assert t_pcd.num_points == 4 and float(t_pcd._rgb.sum()) == 12.0
