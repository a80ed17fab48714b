"""The training half of gaustudio_torch/tools against the JAX package's
tools/train_at_scale.py: the init cloud and the TrainConfig spelled out
there (:355-392), the held-out PSNR before training and the losses of the
first 20 steps from one capture; the summary, metrics and bars of run(),
the point count a densify call logs, and tiny runs of train_scaffold and
demo_e2e."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tools.make_fixture as j_fix
import tools.train_at_scale as j_tas
from gaustudio_torch.pipelines import train as t_train
from gaustudio_torch.tools import demo_e2e as t_demo
from gaustudio_torch.tools import train_at_scale as t_tas
from gaustudio_torch.tools import train_scaffold as t_scaffold
from gaustudio_tpu import models as j_models
from gaustudio_tpu.models.utils import inverse_sigmoid as j_inverse_sigmoid
from gaustudio_tpu.ops import ssim as j_ssim
from gaustudio_tpu.pipelines import train as j_train
from gaustudio_tpu.utils.mesh import sample_mesh_surface as j_sample
from tests.test_torch_train import _densify_state

SIZE, VIEWS, HOLDOUT, INIT, STEPS = 32, 8, 4, 300, 20
JAX_COLORS = {"large": j_fix.color_fn, "rich": j_tas.color_fn_rich,
              "bench": j_tas.color_fn_bench}
JAX_MESHES = {"large": j_tas.scene_mesh_large, "rich": j_tas.scene_mesh_rich,
              "bench": j_tas.scene_mesh_bench}
KIND_FLAGS = {"large": [], "rich": ["--rich"], "bench": ["--bench"]}


def _args(kind="large", *extra):
    return t_tas.parse_args(["--size", str(SIZE), "--views", str(VIEWS), "--holdout_every",
                             str(HOLDOUT), "--init_points", str(INIT), "--iters", str(STEPS),
                             "--device", "cpu", *KIND_FLAGS[kind], *extra])


def _jax_init(kind, n, verts, faces):
    """train_at_scale.py:626-636 and 638-664, spelled out."""
    col_fn = JAX_COLORS[kind]
    xyz = j_sample(verts, faces, n, seed=3)
    xyz = xyz + np.random.default_rng(5).normal(size=xyz.shape).astype(np.float32) * 0.01
    pcd = j_models.make({"name": "vanilla_pcd"})
    pcd.create_from_attribute(
        xyz=xyz, rgb=col_fn(xyz),
        opacity=j_inverse_sigmoid(np.full((n, 1), 0.1, np.float32)))
    pcd.active_sh_degree = 0
    extent = 1.1 * j_tas.ORBITS[kind]["radius"]
    textured = kind in ("rich", "bench")
    cfg = j_train.TrainConfig(
        iterations=STEPS,
        densify_from_iter=500,
        densify_until_iter=int(STEPS * 0.8),
        densification_interval=100,
        densify_grad_threshold=7e-5 if textured else 2e-4,
        opacity_reset_interval=3000,
        sh_increase_interval=1000,
        max_sh_degree=3,
        lr_xyz_init=0.00016 * extent,
        lr_xyz_final=0.0000016 * extent,
        lr_xyz_max_steps=STEPS,
    )
    return pcd, cfg, extent


@pytest.mark.parametrize("kind", ["large", "rich", "bench"])
def test_init_cloud_and_train_config_match_jax(kind):
    verts, faces = t_tas.MESHES[kind]()
    jpcd, jcfg, extent = _jax_init(kind, INIT, *JAX_MESHES[kind]())
    tpcd = t_tas.init_cloud(verts, faces, INIT, t_tas.COLORS[kind], device="cpu")
    for attr in ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot"):
        got, want = getattr(tpcd, "_" + attr).numpy(), np.asarray(getattr(jpcd, "_" + attr))
        np.testing.assert_allclose(got, want.reshape(got.shape), rtol=0, atol=1e-7, err_msg=attr)
    assert tpcd.active_sh_degree == jpcd.active_sh_degree == 0
    assert t_tas.scene_extent(kind) == extent
    assert tuple(t_tas.train_config(_args(kind), kind)) == tuple(jcfg)


def _jax_trainer(kind, cams):
    jpcd, jcfg, extent = _jax_init(kind, INIT, *JAX_MESHES[kind]())

    class _DS(list):  # train_at_scale.py:642-646
        cameras_extent = extent

    # a capacity of 512 rows in place of the tool's 1 << 17 and an entry
    # buffer of 1 << 14 in place of the probe's: padding rows are invalid,
    # a 32 px view of 300 points holds fewer entries, and 20 steps densify
    # nothing, so neither changes a result
    return j_train.Trainer(jpcd, _DS(cams), jcfg, capacity=512, num_entries=1 << 14)


def _jax_eval_holdout(trainer, cams):
    """train_at_scale.py:683-697."""
    settings = trainer._settings(trainer.num_entries)
    vals = []
    for cam in cams:
        batch = trainer._batch(cam)
        s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                              campos=batch.campos, bg=jnp.zeros(3))
        out = j_train.render_from_params(trainer.state.params, trainer.state.valid,
                                         trainer.state.active_sh_degree, s)
        vals.append(float(j_ssim.psnr(out["render"], batch.gt_image)))
    return float(np.mean(vals))


def test_heldout_psnr_and_first_steps_match_jax():
    """One capture (the port's render_gt) for both trainers: the held-out
    PSNR of the init within 1e-4 dB, and the loss of each of the first 20
    steps (one camera sequence) within rtol 1e-5, as
    tests/test_torch_train.py holds single steps."""
    args = _args()
    verts, faces, tcams = t_tas.capture(args, "large", torch.device("cpu"))
    jcams = j_tas.orbit_rings(SIZE, VIEWS, **j_tas.ORBITS["large"])
    for j, t in zip(jcams, tcams):
        j.image = t.image.numpy()
    t_train_cams, t_test = t_tas.holdout_split(tcams, HOLDOUT)
    j_train_cams, j_test = t_tas.holdout_split(jcams, HOLDOUT)
    assert (len(t_train_cams), len(t_test)) == (6, 2)
    tt = t_tas.make_trainer(args, "large", verts, faces, t_train_cams, torch.device("cpu"))
    jt = _jax_trainer("large", j_train_cams)

    got, _ = t_tas.eval_holdout(tt, t_test)
    want = _jax_eval_holdout(jt, j_test)
    assert abs(got - want) <= 1e-4, (got, want)

    t_hist = tt.train(iterations=STEPS, log_every=1)
    j_hist = jt.train(iterations=STEPS, log_every=1)
    assert max(m["num_rendered"] for m in j_hist) < 1 << 14
    np.testing.assert_allclose([m["loss"] for m in t_hist], [m["loss"] for m in j_hist],
                               rtol=1e-5)
    assert [m["iter"] for m in t_hist] == list(range(1, STEPS + 1))


def test_run_writes_the_summary_and_metrics(tmp_path):
    args = _args("large", "--out", str(tmp_path), "--iters", "6")
    summary = t_tas.run(args)
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == summary
    # the JAX summary's keys less its capacity machinery's three
    jax_keys = {"scene", "views_train", "views_heldout", "size", "iters", "init_points",
                "final_points", "psnr_heldout_before", "psnr_heldout_after",
                "psnr_heldout_per_view", "train_wall_s", "train_ms_per_iter", "platform"}
    assert jax_keys <= set(summary)
    assert summary["views_train"] == 6 and summary["final_points"] == INIT
    assert summary["nonfinite_rows"] == 0 and summary["platform"] == "cpu"
    assert summary["jax_dropped_entries"] == 0
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [m["step"] for m in lines] == [6]  # 50-iteration log, and the last step
    with pytest.raises(AssertionError, match="densification stalled"):
        t_tas.check_bars(summary, args)
    t_tas.check_bars({**summary, "final_points": 15_000, "psnr_heldout_after": 26.0}, args)
    with pytest.raises(AssertionError, match="held-out PSNR"):
        t_tas.check_bars({**summary, "final_points": 15_000, "psnr_heldout_after": 25.9}, args)
    with pytest.raises(AssertionError, match="non-finite"):
        t_tas.check_bars({**summary, "final_points": 15_000, "psnr_heldout_after": 30.0,
                          "nonfinite_rows": 1}, args)
    bench = _args("bench")
    t_tas.check_bars({**summary, "final_points": 100_000, "psnr_heldout_after": 24.0}, bench)
    with pytest.raises(AssertionError, match="rich bar"):
        t_tas.check_bars({**summary, "final_points": 99_999, "psnr_heldout_after": 30.0}, bench)


@pytest.mark.parametrize("prune_big", [False, True])
def test_densify_logs_the_point_count_after_it(prune_big):
    jstate = _densify_state()
    tstate = t_train.state_from_jax(jstate, device="cpu")
    jnew, _ = j_train.densify_and_prune(jstate, __import__("jax").random.PRNGKey(0),
                                        jnp.asarray(1.0), j_train.TrainConfig(),
                                        jnp.asarray(prune_big))
    tnew, info = t_train.densify_and_prune(tstate, torch.Generator().manual_seed(0), 1.0,
                                           t_train.TrainConfig(), prune_big)
    assert info["num_points_after"] == tnew.num_points == int(np.asarray(jnew.valid).sum())


def test_train_scaffold_runs_and_holds_its_bars(tmp_path):
    args = t_scaffold.parse_args(["--size", "24", "--views", "6", "--holdout_every", "3",
                                  "--iters", "4", "--anchors", "200", "--device", "cpu",
                                  "--out", str(tmp_path)])
    summary = t_scaffold.run(args)
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == summary
    assert summary["views_train"] == 4 and summary["views_heldout"] == 2
    assert summary["init_anchors"] == 200 and np.isfinite(summary["loss_last"])
    t_scaffold.check_bars({**summary, "loss_first": 0.2, "loss_last": 0.1,
                           "psnr_heldout_before": 10.0, "psnr_heldout_after": 10.01})
    with pytest.raises(AssertionError, match="did not fall"):
        t_scaffold.check_bars({**summary, "loss_first": 0.1, "loss_last": float("nan")})
    with pytest.raises(AssertionError, match="held-out"):
        t_scaffold.check_bars({**summary, "loss_first": 0.2, "loss_last": 0.1,
                               "psnr_heldout_before": 10.0, "psnr_heldout_after": 10.0})


def test_demo_e2e_capture_matches_jax_and_runs(tmp_path):
    from tools import demo_e2e as j_demo

    _, tcams = t_demo.make_capture(120, 16, num_cam=2, device="cpu")
    _, jcams = j_demo.make_capture(120, 16, num_cam=2)
    for t, j in zip(tcams, jcams):
        np.testing.assert_allclose(t.image.numpy(), np.asarray(j.image), rtol=0, atol=1e-5)
    args = t_demo.parse_args(["--size", "16", "--iters", "2", "--n", "120", "--device", "cpu",
                              "--out", str(tmp_path)])
    summary = t_demo.run(args)
    assert summary["views"] == 24 and summary["mesh_faces"] >= 0
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == summary
    assert os.path.exists(tmp_path / "summary.json")
