"""Port parity of the sharded training (gaustudio_torch/parallel/train_dp.py)
against gaustudio_tpu/parallel/train_dp.py, on tests/test_parallel.py's scene
(32 px, 64 Gaussians, 8 orbit cameras).

One gloo group of 4 CPU ranks runs every case of this file (the module
fixture), and the JAX sharded step compiles once, on a (2, 2) mesh over 4 of
conftest's 8 virtual devices. Each test then asserts one thing.

The start is perturbed in every attribute, anisotropic and rotated: an
isotropic Gaussian's rotation gradient is float noise, which Adam (eps
1e-15) turns into +-lr steps that no two implementations share.

The JAX step's parameter gradient is n_gs times the true one (the transpose
of its all_gather over gs sums the gs ranks' identical gradients), so its
Adam moments are n_gs and n_gs^2 times the port's; the port's reduced
gradient is the single-process gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gaustudio_torch.cameras import camera_paths as t_camera_paths
from gaustudio_torch.models.vanilla import VanillaPointCloud
from gaustudio_torch.ops import ssim as t_ssim
from gaustudio_torch.ops.rasterize import RasterizeSettings as TSettings
from gaustudio_torch.parallel import dryrun, make_mesh
from gaustudio_torch.parallel import train_dp as t_dp
from gaustudio_torch.parallel.mesh import Collectives
from gaustudio_torch.pipelines import train as t_train
from gaustudio_tpu import models as j_models
from gaustudio_tpu.cameras import camera_paths as j_camera_paths
from gaustudio_tpu.parallel import train_dp as j_dp
from gaustudio_tpu.pipelines import train as j_train

SIZE, N, N_CAMS = 32, 64, 8
ELEMS = ("xyz", "opacity", "f_dc", "f_rest", "scale", "rot")
DP_CAMS = (0, 1)  # the (2, 2) step's views: dp rank r renders DP_CAMS[r]
DENSIFY_CFG = dict(densify_from_iter=0, densify_until_iter=100, densification_interval=5,
                   densify_grad_threshold=1e-6, opacity_reset_interval=1000, iterations=12)


def _gt_params(n=N):
    """tests/test_parallel.py:_scene's model as raw attributes."""
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    pcd = j_models.make({"name": "vanilla_pcd"})
    pcd.create_from_attribute(xyz=xyz, rgb=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))
    return {k: np.asarray(getattr(pcd, "_" + k)) for k in ELEMS}


def _perturbed(params, seed=1):
    """An anisotropic, rotated, perturbed start of ``params``."""
    rng = np.random.default_rng(seed)
    n = params["xyz"].shape[0]
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    return {**params,
            "xyz": params["xyz"] + rng.normal(size=(n, 3)).astype(np.float32) * 0.05,
            "f_dc": params["f_dc"] + rng.normal(size=(n, 3)).astype(np.float32) * 0.3,
            "scale": np.log(rng.uniform(0.03, 0.12, (n, 3))).astype(np.float32),
            "rot": quats / np.linalg.norm(quats, axis=1, keepdims=True),
            "opacity": rng.normal(size=(n, 1)).astype(np.float32)}


def _port_cameras(images=None):
    cams = t_camera_paths.get_path_from_orbit(np.zeros(3), 2.0, num_cam=N_CAMS,
                                              image_size=SIZE, fov_deg=50, device="cpu")
    for cam, img in zip(cams, images or ()):
        cam.image = torch.from_numpy(img)
    return cams


def _gt_images(params):
    """The scene's views rendered by the port (SH 0), as numpy HWC."""
    from gaustudio_torch import renderers

    pcd = VanillaPointCloud.from_jax_params({**params, "active_sh_degree": 0}, device="cpu")
    renderer = renderers.make({"name": "vanilla_renderer"}, device="cpu")
    return [renderer.render(cam, pcd)["render"].permute(1, 2, 0).numpy().copy()
            for cam in _port_cameras()]


def _settings():
    cam = t_camera_paths.get_path_from_orbit(np.zeros(3), 2.0, num_cam=N_CAMS, image_size=SIZE,
                                             fov_deg=50, device="cpu")[0]
    return TSettings(image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
                     tanfovy=cam.tanfovy, bg=None, sh_degree=3)


def _batch(cam):
    return t_train.CameraBatch(cam.world_view_transform, cam.full_proj_transform,
                               cam.camera_center, cam.image.permute(2, 0, 1).contiguous())


def _numpy_state(state):
    return {"params": {k: v.numpy() for k, v in state.params.items()},
            "mu": {k: v.numpy() for k, v in state.opt.mu.items()},
            "nu": {k: v.numpy() for k, v in state.opt.nu.items()},
            "count": {k: v.numpy() for k, v in state.opt.count.items()},
            "xyz_grad_accum": state.xyz_grad_accum.numpy(), "denom": state.denom.numpy(),
            "max_radii2d": state.max_radii2d.numpy(), "step": state.step}


def _pair_mesh(device="cpu"):
    """A (1, 2) mesh of this rank and its neighbour ({0, 1} and {2, 3}):
    every rank makes every group, in one order, and keeps its own."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    rank, world = dist.get_rank(), dist.get_world_size()
    singles = [dist.new_group([r]) for r in range(world)]
    pairs = [dist.new_group([r, r + 1]) for r in range(0, world, 2)]
    first = rank - rank % 2
    return DeviceMesh.from_group([singles[rank], pairs[rank // 2]], "cpu",
                                 mesh=[[first, first + 1]], mesh_dim_names=("dp", "gs"))


def _dp_step(comm, state, images, cfg):
    """One sharded step on ``comm``'s mesh; the gathered new state and the
    gathered reduced gradient, as numpy."""
    cam = _port_cameras(images)[DP_CAMS[comm.dp_rank]]
    grads, stats, _ = t_dp.dp_gradients(comm, state, _batch(cam), _settings(), cfg)
    new = t_dp.DPState(t_dp.dp_optimise(state.shard, grads, stats, cfg, comm.dp),
                       state.num_points)
    buf, spec = t_dp.pack_rows([grads[k] for k in t_train.PARAMS])
    full_grads = t_dp.unpack_rows(comm.gather_rows(buf, state.num_points), spec)
    return {"state": _numpy_state(t_dp.replicate_state(comm, new)),
            "grads": {k: g.numpy() for k, g in zip(t_train.PARAMS, full_grads)},
            "rows": state.shard.num_points}


def _rank_cases(jax_start, images, uneven_start, uneven_images, trainer_params):
    """Every case of this file on one rank of the 4-rank group."""
    cfg = t_train.TrainConfig()
    comm = Collectives(make_mesh(dp=2, gs=2, device="cpu"))
    out = {"step": _dp_step(comm, t_train.state_from_jax(jax_start, "cpu", mesh=comm), images,
                            cfg)}
    start = t_train.init_state(VanillaPointCloud.from_jax_params(uneven_start, device="cpu"))
    out["uneven"] = _dp_step(comm, t_dp.shard_state(comm, start), uneven_images, cfg)

    pcd = VanillaPointCloud.from_jax_params(trainer_params, device="cpu")
    dpt = t_dp.DPTrainer(pcd, _port_cameras(images), t_train.TrainConfig(**DENSIFY_CFG),
                         mesh=_pair_mesh(), seed=0)
    hist = dpt.train(iterations=12, log_every=1)
    out["trainer"] = {"points": [m["num_points"] for m in hist],
                      "grown": [m.get("n_clone", 0) + m.get("n_split", 0) for m in hist],
                      "xyz": dpt.host_state().params["xyz"].numpy()}
    return out


def _single_reference(start, images, cfg):
    """The one-process DP step: each view's full gradient through the port's
    single-device render, meaned over DP_CAMS, then dp_optimise."""
    settings, cams = _settings(), _port_cameras(images)
    per_view = []
    for i in DP_CAMS:
        b = _batch(cams[i])
        s = settings._replace(viewmatrix=b.viewmatrix, projmatrix=b.projmatrix,
                              campos=b.campos, bg=torch.zeros(3))
        params = {k: v.detach().clone().requires_grad_(True) for k, v in start.params.items()}
        offset = torch.zeros((start.num_points, 2), requires_grad=True)
        out = t_train.render_from_params(params, start.active_sh_degree, s,
                                         means2d_offset=offset)
        loss = t_ssim.rgb_loss(out["render"], b.gt_image, cfg.lambda_dssim)
        grads = torch.autograd.grad(loss, [params[k] for k in t_train.PARAMS] + [offset])
        per_view.append((grads, out["radii"].float()))
    mean = [sum(g[j] for g, _ in per_view) / len(DP_CAMS) for j in range(len(t_train.PARAMS) + 1)]
    stats = {"vs_grad": mean[-1], "visible": sum((r > 0).float() for _, r in per_view),
             "radii": torch.maximum(*[r for _, r in per_view])}
    grads = dict(zip(t_train.PARAMS, mean[:-1]))
    new = t_dp.dp_optimise(start, grads, stats, cfg, len(DP_CAMS))
    return {"state": _numpy_state(new), "grads": {k: g.numpy() for k, g in grads.items()}}


@pytest.fixture(scope="module")
def runs():
    gt = _gt_params()
    images = _gt_images(gt)
    start = _perturbed(gt)

    # the JAX (2, 2) step, compiled once
    jpcd = j_models.make({"name": "vanilla_pcd"})
    jpcd.create_from_attribute(xyz=start["xyz"])
    for k in ELEMS:
        setattr(jpcd, "_" + k, start[k])
    jcams = j_camera_paths.get_path_from_orbit(np.zeros(3), 2.0, num_cam=N_CAMS,
                                               image_size=SIZE, fov_deg=50)
    for cam, img in zip(jcams, images):
        cam.image = img
    cfg = j_train.TrainConfig()
    trainer = j_train.Trainer(jpcd, jcams, cfg, num_entries=1 << 13, chunk=512, capacity=256)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "gs"))
    sharded = j_dp.shard_state(mesh, trainer.state)
    jax_start = jax.tree.map(np.asarray, j_dp.replicate_state(mesh, sharded))
    batches = [trainer._batch(jcams[i]) for i in DP_CAMS]
    step = j_dp.make_dp_train_step(mesh, trainer._settings(1 << 13), cfg)
    jax_new, _ = step(sharded, j_train.CameraBatch(*[jnp.stack(x) for x in zip(*batches)]))
    jax_new = jax.tree.map(np.asarray, j_dp.replicate_state(mesh, jax_new))

    uneven_gt = _gt_params(N + 1)
    uneven_images = _gt_images(uneven_gt)
    uneven_start = _perturbed(uneven_gt, seed=2)
    trainer_params = {**gt, "f_dc": np.zeros_like(gt["f_dc"])}

    ranks = dryrun.run_ranks(4, _rank_cases, jax_start, images, uneven_start, uneven_images,
                             trainer_params, device="cpu", threads=1, timeout=600)

    tcfg = t_train.TrainConfig()
    single = t_train.Trainer(VanillaPointCloud.from_jax_params(trainer_params, device="cpu"),
                             _port_cameras(images), t_train.TrainConfig(**DENSIFY_CFG),
                             seed=0, device="cpu")
    hist = single.train(iterations=12, log_every=1)
    return {
        "ranks": ranks, "jax": jax_new, "valid": np.asarray(jax_new.valid),
        "reference": _single_reference(t_train.state_from_jax(jax_start, "cpu"), images, tcfg),
        "uneven_reference": _single_reference(t_train.init_state(VanillaPointCloud.from_jax_params(
            uneven_start, device="cpu")), uneven_images, tcfg),
        "trainer": {"points": [m["num_points"] for m in hist],
                    "xyz": single.state.params["xyz"].numpy()},
    }


def _scaled_close(got, want, rtol, atol, what):
    """got within atol + rtol |want| of want, both scaled by max |want|."""
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol, err_msg=what)


def test_dp_step_parameters_match_jax(runs):
    jax_new, valid = runs["jax"], runs["valid"]
    for k, v in runs["ranks"][0]["step"]["state"]["params"].items():
        _scaled_close(v, np.asarray(jax_new.params[k])[valid], 2e-4, 2e-4, k)


def test_dp_step_densify_statistics_match_jax(runs):
    jax_new, valid = runs["jax"], runs["valid"]
    got = runs["ranks"][0]["step"]["state"]
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jax_new, k))[valid], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_dp_step_moments_are_the_jax_moments_over_n_gs(runs):
    """The JAX moments are n_gs = 2 times (mu) and n_gs^2 times (nu) the
    port's: the reference's gradient scale, recorded."""
    jax_new, valid = runs["jax"], runs["valid"]
    got = runs["ranks"][0]["step"]["state"]
    for name, power in (("mu", 1), ("nu", 2)):
        for k, v in got[name].items():
            want = np.asarray(getattr(jax_new.opt, name)[k])[valid] / 2 ** power
            _scaled_close(v, want, 1e-3, 1e-4, f"{name} {k}")


def test_dp_step_gradient_is_the_single_process_gradient(runs):
    want = runs["reference"]["grads"]
    for k, v in runs["ranks"][0]["step"]["grads"].items():
        _scaled_close(v, want[k], 1e-5, 1e-6, k)


def test_every_rank_gathers_the_same_state(runs):
    first = runs["ranks"][0]["step"]["state"]["params"]
    for r in runs["ranks"][1:]:
        for k, v in r["step"]["state"]["params"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


def test_uneven_rows_split_as_tensor_split(runs):
    """65 Gaussians on gs = 2: 33 rows on gs rank 0, 32 on gs rank 1."""
    assert [r["uneven"]["rows"] for r in runs["ranks"]] == [33, 32, 33, 32]


def test_uneven_rows_step_matches_the_single_process_step(runs):
    want = runs["uneven_reference"]["state"]
    got = runs["ranks"][0]["uneven"]["state"]
    for k, v in got["params"].items():
        _scaled_close(v, want["params"][k], 1e-5, 1e-6, k)
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-9, err_msg=k)


def test_dp_trainer_keeps_the_trainers_point_counts(runs):
    """DPTrainer on (1, 2) meshes against the port's Trainer over 12
    iterations of tests/test_parallel.py:96-125's schedule."""
    want = runs["trainer"]["points"]
    assert want[-1] > want[0]  # densification fired
    assert all(r["trainer"]["points"] == want for r in runs["ranks"])
    assert any(g > 0 for g in runs["ranks"][0]["trainer"]["grown"])


def test_dp_trainer_final_xyz_matches_the_trainer(runs):
    np.testing.assert_allclose(runs["ranks"][0]["trainer"]["xyz"], runs["trainer"]["xyz"],
                               rtol=5e-3, atol=1e-5)
