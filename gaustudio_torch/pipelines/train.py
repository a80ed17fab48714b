"""3DGS training with adaptive densification (port of
gaustudio_tpu/pipelines/train.py, single device).

The JAX trainer keeps the Gaussians in fixed-capacity padded arrays with a
validity mask so that its jitted steps never change shape. The port trains
on dynamic tensors instead, like the reference: every row is a live
Gaussian, densification concatenates and drops rows, and the rasterizer
sizes its buffers from the entry count of each call. So there is no
``valid`` mask, no capacity growth and no entry-capacity probe.

One step renders through rasterize() (kernels K1-K3 forward, K4 backward on
a CUDA device; their plain versions on the CPU), takes L1 + D-SSIM with the
background composited in the loss, accumulates the norm of the viewspace
gradient of visible rows, and applies a functional Adam with per-row step
counts. Densify clones, splits and prunes rows; the Adam moments and counts
of every new row start at zero.
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from gaustudio_torch.models.utils import inverse_sigmoid
from gaustudio_torch.ops import rasterize as rast
from gaustudio_torch.ops import ssim as ssim_ops
from gaustudio_torch.ops.gaussian import quat_to_rotmat
from gaustudio_torch.ops.rasterize import RasterizeSettings
from gaustudio_torch.pipelines.optimizers.general import (
    AdamState,
    adam_init,
    adam_update,
    exp_lr_schedule,
)
from gaustudio_torch.utils.misc import resolve_device

PARAMS = ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot")


class TrainConfig(NamedTuple):
    iterations: int = 30000
    lambda_dssim: float = 0.2
    # per-attribute learning rates (configs/vanilla.json + Inria defaults)
    lr_xyz_init: float = 0.00016
    lr_xyz_final: float = 0.0000016
    lr_xyz_max_steps: int = 30000
    lr_f_dc: float = 0.0025
    lr_f_rest: float = 0.000125
    lr_opacity: float = 0.05
    lr_scale: float = 0.005
    lr_rot: float = 0.001
    # densification (Inria defaults)
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densification_interval: int = 100
    densify_grad_threshold: float = 0.0002
    opacity_reset_interval: int = 3000
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    max_screen_size: int = 20
    sh_increase_interval: int = 1000
    max_sh_degree: int = 3
    white_background: bool = False


class TrainState(NamedTuple):
    """Training state: one row per live Gaussian in every per-row tensor."""

    params: Dict[str, torch.Tensor]  # xyz [N,3], f_dc [N,3], f_rest [N,45],
    # opacity [N,1], scale [N,3] (or [N,2] for 2DGS surfels), rot [N,4]
    opt: AdamState
    step: int
    xyz_grad_accum: torch.Tensor  # [N]
    denom: torch.Tensor  # [N]
    max_radii2d: torch.Tensor  # [N]
    active_sh_degree: int

    @property
    def num_points(self) -> int:
        return int(self.params["xyz"].shape[0])


class CameraBatch(NamedTuple):
    viewmatrix: torch.Tensor
    projmatrix: torch.Tensor
    campos: torch.Tensor
    gt_image: torch.Tensor  # [3, H, W]


def _new_state(params: Dict[str, torch.Tensor], opt: Optional[AdamState] = None, step: int = 0,
               active_sh_degree: int = 0) -> TrainState:
    n, device = params["xyz"].shape[0], params["xyz"].device
    zeros = lambda: torch.zeros(n, dtype=torch.float32, device=device)  # noqa: E731
    return TrainState(params=params, opt=opt or adam_init(params), step=step,
                      xyz_grad_accum=zeros(), denom=zeros(), max_radii2d=zeros(),
                      active_sh_degree=active_sh_degree)


def init_state(pcd, device=None) -> TrainState:
    """Training state of a VanillaPointCloud's raw attributes."""
    device = torch.device(device) if device is not None else pcd.device
    n = pcd.num_points
    params = {k: getattr(pcd, "_" + k).detach().to(device, torch.float32).reshape(n, -1).clone()
              for k in PARAMS}
    return _new_state(params)


def state_from_jax(jax_state, device=None, mesh=None):
    """The port's state from a JAX ``GaussianTrainState`` on ``device`` (None:
    the current CUDA device): its arrays are read with ``np.asarray``, and
    only its ``valid`` rows are kept.

    A sharded JAX state (gathered by the JAX ``train_dp.replicate_state``)
    reads the same way. With ``mesh`` (the port's ("dp", "gs") mesh) this
    returns this rank's rows as a ``parallel.train_dp.DPState``."""
    if mesh is not None:
        from gaustudio_torch.parallel.train_dp import shard_state

        return shard_state(mesh, state_from_jax(jax_state, device))
    device = resolve_device(device)
    valid = np.asarray(jax_state.valid)
    rows = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a)[valid])).to(device)  # noqa: E731
    opt = AdamState(mu={k: rows(v) for k, v in jax_state.opt.mu.items()},
                    nu={k: rows(v) for k, v in jax_state.opt.nu.items()},
                    count={k: rows(v) for k, v in jax_state.opt.count.items()})
    return TrainState(
        params={k: rows(v) for k, v in jax_state.params.items()}, opt=opt,
        step=int(np.asarray(jax_state.step)), xyz_grad_accum=rows(jax_state.xyz_grad_accum),
        denom=rows(jax_state.denom), max_radii2d=rows(jax_state.max_radii2d),
        active_sh_degree=int(np.asarray(jax_state.active_sh_degree)))


def finite_rows(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[N] bool: the rows whose every parameter is finite."""
    finite = None
    for v in params.values():
        ok = torch.isfinite(v).all(dim=-1)
        finite = ok if finite is None else finite & ok
    return finite


def state_to_model(state: TrainState, pcd):
    """Write the trained values into a VanillaPointCloud, dropping rows with
    a non-finite value (rows that diverged after the last densify)."""
    finite = finite_rows(state.params)
    n_bad = int((~finite).sum())
    if n_bad:
        print(f"state_to_model: dropping {n_bad} non-finite rows")
    pcd.update(**{k: v[finite] for k, v in state.params.items()})
    pcd.active_sh_degree = int(state.active_sh_degree)
    return pcd


def _features(params) -> torch.Tensor:
    """Band-major [N, 16, 3] SH coefficients from the stored layout."""
    n = params["f_dc"].shape[0]
    f_dc = params["f_dc"].reshape(n, 1, 3)
    f_rest = params["f_rest"].reshape(n, 3, -1).transpose(1, 2)
    return torch.cat([f_dc, f_rest], dim=1)


def render_from_params(params, active_sh_degree: int, settings: RasterizeSettings,
                       means2d_offset=None):
    """Differentiable render of the raw parameters."""
    rot = params["rot"]
    return rast.rasterize(
        params["xyz"], torch.sigmoid(params["opacity"][:, 0]), settings,
        shs=_features(params), scales=torch.exp(params["scale"]),
        # x rsqrt(|x|^2 + eps): a zero quaternion keeps a finite gradient
        rotations=rot * torch.rsqrt(torch.sum(rot * rot, dim=-1, keepdim=True) + 1e-18),
        means2D_offset=means2d_offset, active_sh_degree=active_sh_degree,
    )


def train_step(state: TrainState, batch: CameraBatch, settings: RasterizeSettings,
               cfg: TrainConfig):
    """One optimisation step: render -> L1 + D-SSIM -> Adam -> statistics.
    Returns (new state, metrics); the metrics are tensors or ints."""
    device = state.params["xyz"].device
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    offset = torch.zeros((state.num_points, 2), device=device, requires_grad=True)
    out = render_from_params(params, state.active_sh_degree, s, means2d_offset=offset)
    # the background is composited in the loss, pred = C + T_final bg: the
    # forward leaves it out and autograd gives the reference's bg term
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=device)
    pred = out["render"] + bg[:, None, None] * (1.0 - out["rendered_final_opacity"][0])
    loss = ssim_ops.rgb_loss(pred, batch.gt_image, cfg.lambda_dssim)
    metrics = {
        "loss": loss.detach(),
        "psnr": ssim_ops.psnr(out["render"].detach(), batch.gt_image),
        "num_points": state.num_points,
        "num_rendered": out["num_rendered"],
    }
    return optimise(state, params, offset, loss, out["radii"], cfg), metrics


def learning_rates(cfg: TrainConfig, step: int) -> Dict[str, float]:
    """Each attribute's learning rate at ``step``: xyz on Inria's decay."""
    return {
        "xyz": exp_lr_schedule(cfg.lr_xyz_init, cfg.lr_xyz_final, cfg.lr_xyz_max_steps)(step),
        "f_dc": cfg.lr_f_dc, "f_rest": cfg.lr_f_rest, "opacity": cfg.lr_opacity,
        "scale": cfg.lr_scale, "rot": cfg.lr_rot,
    }


def optimise(state: TrainState, params, offset, loss, radii, cfg: TrainConfig) -> TrainState:
    """The gradients of ``loss`` in ``params`` and ``offset`` (the viewspace
    points) -> the densification statistics of the visible rows and one Adam
    step; returns the next state."""
    leaves = [params[k] for k in PARAMS] + [offset]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    vs_grads = grads.pop()

    with torch.no_grad():
        visible = radii > 0
        xyz_grad_accum = state.xyz_grad_accum + torch.where(
            visible, torch.linalg.vector_norm(vs_grads, dim=-1), 0.0)
        denom = state.denom + visible.to(torch.float32)
        max_radii2d = torch.maximum(state.max_radii2d, radii.to(torch.float32))
        new_params, new_opt = adam_update(dict(zip(PARAMS, grads)), state.opt,
                                          state.params, learning_rates(cfg, state.step))
    return state._replace(params=new_params, opt=new_opt, step=state.step + 1,
                          xyz_grad_accum=xyz_grad_accum, denom=denom, max_radii2d=max_radii2d)


@torch.no_grad()
def densify_and_prune(state: TrainState, generator: torch.Generator, extent: float,
                      cfg: TrainConfig, prune_big_points: bool):
    """Adaptive density control: clone small and split large rows over the
    gradient threshold, prune transparent, oversized and non-finite rows.

    Rows come out as: survivors in order, then the clones, then the first
    child of every split, then the second. Split offsets are drawn from
    ``generator``. Every new row starts with zero Adam moments and counts;
    the densification statistics are reset. Returns (new state, info).
    """
    p = state.params
    device = p["xyz"].device
    grads = state.xyz_grad_accum / torch.clamp_min(state.denom, 1.0)
    scale_act = torch.exp(p["scale"])
    max_scale = scale_act.max(dim=-1).values
    opacity_act = torch.sigmoid(p["opacity"][:, 0])

    over_thr = grads >= cfg.densify_grad_threshold
    clone_mask = over_thr & (max_scale <= cfg.percent_dense * extent)
    split_mask = over_thr & (max_scale > cfg.percent_dense * extent)
    prune_opacity = opacity_act < cfg.min_opacity
    big = (state.max_radii2d > cfg.max_screen_size) | (max_scale > 0.1 * extent)
    prune_big = big & prune_big_points
    survive = ~(prune_opacity | prune_big | ~finite_rows(p)) & ~split_mask

    clone_src = torch.nonzero(clone_mask).squeeze(1)
    split_src = torch.nonzero(split_mask).squeeze(1).repeat(2)  # first children, then second
    # x_child = x + R (eps * scale), scale_child = scale / 1.6; a 2DGS surfel's
    # 2-column scale gets a zero third column
    sdim = p["scale"].shape[1]
    eps = torch.randn((split_src.shape[0], sdim), generator=generator, device=device)
    eps = eps * scale_act[split_src]
    if sdim < 3:
        eps = torch.cat([eps, eps.new_zeros((eps.shape[0], 3 - sdim))], dim=1)
    R = quat_to_rotmat(p["rot"][split_src], normalize=True)
    new_rows = {k: torch.cat([v[survive], v[clone_src], v[split_src]]) for k, v in p.items()}
    n_keep, n_clone = int(survive.sum()), clone_src.shape[0]
    new_rows["xyz"][n_keep + n_clone:] += (R * eps[:, None, :]).sum(-1)
    new_rows["scale"][n_keep + n_clone:] = torch.log(
        torch.clamp_min(scale_act[split_src] / (0.8 * 2.0), 1e-12))

    n_new = n_clone + split_src.shape[0]
    fresh = lambda t: torch.cat([t[survive], t.new_zeros((n_new,) + t.shape[1:])])  # noqa: E731
    opt = AdamState(mu={k: fresh(v) for k, v in state.opt.mu.items()},
                    nu={k: fresh(v) for k, v in state.opt.nu.items()},
                    count={k: fresh(v) for k, v in state.opt.count.items()})
    info = {
        "n_clone": n_clone,
        "n_split": split_src.shape[0] // 2,
        "n_prune_opacity": int(prune_opacity.sum()),
        "n_prune_big": int(prune_big.sum()),
        "grad_med": float(torch.nanquantile(grads, 0.5)) if grads.numel() else float("nan"),
        "num_points_after": n_keep + n_new,
    }
    return _new_state(new_rows, opt, state.step, state.active_sh_degree), info


@torch.no_grad()
def reset_opacity(state: TrainState) -> TrainState:
    """Inria opacity reset, opacity <- min(opacity, inverse_sigmoid(0.01)),
    with the opacity moments and counts restarted."""
    op = state.params["opacity"]
    params = {**state.params,
              "opacity": torch.minimum(op, inverse_sigmoid(0.01).to(op.device))}
    zero = lambda d: {**d, "opacity": torch.zeros_like(d["opacity"])}  # noqa: E731
    opt = AdamState(mu=zero(state.opt.mu), nu=zero(state.opt.nu), count=zero(state.opt.count))
    return state._replace(params=params, opt=opt)


def oneup_sh_degree(state: TrainState, max_degree: int = 3) -> TrainState:
    return state._replace(active_sh_degree=min(state.active_sh_degree + 1, max_degree))


class Trainer:
    """The training loop: camera sampling, schedules, logging, checkpoints.

    Trains on ``device`` (None: the current CUDA device), whatever device
    ``pcd`` and the dataset's cameras are on."""

    def __init__(self, pcd, dataset, cfg: TrainConfig = TrainConfig(), seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.cameras = list(dataset)
        self.extent = float(getattr(dataset, "cameras_extent", 1.0))
        self.device = resolve_device(device)
        self.state = init_state(pcd, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        cam0 = self.cameras[0]
        self.H, self.W = int(cam0.image_height), int(cam0.image_width)
        self._last_densify = None

    def settings(self) -> RasterizeSettings:
        cam0 = self.cameras[0]
        return RasterizeSettings(image_height=self.H, image_width=self.W,
                                 tanfovx=math.tan(cam0.FoVx * 0.5),
                                 tanfovy=math.tan(cam0.FoVy * 0.5), bg=None,
                                 sh_degree=self.cfg.max_sh_degree)

    def batch(self, camera) -> CameraBatch:
        to = lambda t: t.to(self.device, torch.float32)  # noqa: E731
        return CameraBatch(viewmatrix=to(camera.world_view_transform),
                           projmatrix=to(camera.full_proj_transform),
                           campos=to(camera.camera_center),
                           gt_image=to(camera.image).permute(2, 0, 1).contiguous())

    def step(self, batch: CameraBatch, settings: RasterizeSettings):
        """One optimisation step of the current state: (new state, metrics)."""
        return train_step(self.state, batch, settings, self.cfg)

    def restore(self, path: str) -> None:
        self.state = load_checkpoint(path, self.device)

    def train(self, iterations: Optional[int] = None, log_every: int = 100, callback=None,
              metrics_path: Optional[str] = None, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0):
        """Train up to ``iterations`` (an absolute step: a restored state
        continues its schedules); returns the logged metrics."""
        from gaustudio_torch.pipelines.dataloader import make_batch_source
        from gaustudio_torch.utils.observability import MetricsLogger, snapshot_on_nonfinite

        cfg = self.cfg
        iters = iterations or cfg.iterations
        settings = self.settings()
        logger = MetricsLogger(metrics_path, echo=False) if metrics_path else None
        next_batch = make_batch_source(self.cameras, self.batch)
        history = []
        try:
            for it in range(self.state.step + 1, iters + 1):
                self.state, metrics = self.step(next_batch(), settings)

                if it % cfg.sh_increase_interval == 0:
                    self.state = oneup_sh_degree(self.state, cfg.max_sh_degree)
                if cfg.densify_from_iter < it < cfg.densify_until_iter:
                    if it % cfg.densification_interval == 0:
                        self.state, self._last_densify = densify_and_prune(
                            self.state, self.generator, self.extent, cfg,
                            it > cfg.opacity_reset_interval)
                    if it % cfg.opacity_reset_interval == 0:
                        self.state = reset_opacity(self.state)

                if it % log_every == 0 or it == iters:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["iter"] = it
                    if self._last_densify:
                        m.update(self._last_densify)
                        self._last_densify = None
                    history.append(m)
                    if logger:
                        logger.log(it, **{k: v for k, v in m.items() if k != "iter"})
                    if not np.isfinite(m["loss"]):
                        snapshot_on_nonfinite(
                            {"params": self.state.params, "loss": metrics["loss"]},
                            (metrics_path or "train") + ".snapshot.pt", context=f"iter {it}")
                        raise FloatingPointError(f"non-finite loss at iter {it}")
                    if callback:
                        callback(m)
                if checkpoint_dir and checkpoint_every and it % checkpoint_every == 0:
                    save_checkpoint(os.path.join(checkpoint_dir, f"step_{it}.pt"), self.state)
        finally:
            next_batch.close()
            if logger:
                logger.close()
        return history


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the whole training state (params, Adam moments and counts,
    statistics, step) with ``torch.save``."""
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "params": cpu(state.params),
        "opt": {"mu": cpu(state.opt.mu), "nu": cpu(state.opt.nu), "count": cpu(state.opt.count)},
        "step": state.step, "active_sh_degree": state.active_sh_degree,
        "xyz_grad_accum": state.xyz_grad_accum.cpu(), "denom": state.denom.cpu(),
        "max_radii2d": state.max_radii2d.cpu(),
    }, path)


def load_checkpoint(path: str, device=None) -> TrainState:
    """Read a checkpoint written by :func:`save_checkpoint` onto ``device``
    (None: the current CUDA device)."""
    raw = torch.load(path, map_location=resolve_device(device), weights_only=True)
    return TrainState(params=raw["params"], opt=AdamState(**raw["opt"]), step=int(raw["step"]),
                      xyz_grad_accum=raw["xyz_grad_accum"], denom=raw["denom"],
                      max_radii2d=raw["max_radii2d"],
                      active_sh_degree=int(raw["active_sh_degree"]))
