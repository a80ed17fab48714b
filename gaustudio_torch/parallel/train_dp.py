"""Sharded training: camera-DP x Gaussian-axis sharding (port of
gaustudio_tpu/parallel/train_dp.py) on torch.distributed.

Every rank holds the rows of its gs index (``torch.tensor_split``'s split)
of every parameter, Adam moment and statistic. One step:

  * all-gathers the parameter rows over gs (one collective, the rows
    packed side by side);
  * renders the dp rank's camera through ``render_from_params`` (K1-K4 on
    the card) and takes the loss as the single-device step does;
  * keeps the gradient of its own rows and means it over dp;
  * updates the densify statistics as the JAX step does (``:109-124``):
    ``xyz_grad_accum += where(visible_any, |mean_dp(vs_grad)| n_dp, 0)``,
    ``denom += visible_any``, ``max_radii2d`` the max over dp;
  * runs Adam on its own rows.

**The true gradient.** The JAX step differentiates through
``all_gather(..., "gs", tiled=True)`` under ``shard_map(check_vma=False)``;
the transpose of that gather sums the identical full gradients that every
gs rank computes for the same camera, so its parameter gradient is n_gs
times the true one (its Adam ``mu`` n_gs and ``nu`` n_gs^2 times the
single-device moments; Adam with eps 1e-15 hides the scale in the
parameters). The port takes the gradient of the gathered rows and keeps
its own rows, which is the true gradient of the dp-mean loss.
``dp_gradients`` returns it before Adam, so it can be read and checked.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gaustudio_torch.ops import ssim as ssim_ops
from gaustudio_torch.ops.rasterize import RasterizeSettings
from gaustudio_torch.parallel.mesh import Collectives, collectives, make_mesh
from gaustudio_torch.pipelines.optimizers.general import AdamState, adam_update
from gaustudio_torch.pipelines.train import (
    PARAMS,
    CameraBatch,
    TrainConfig,
    TrainState,
    learning_rates,
    render_from_params,
)


class DPState(NamedTuple):
    """A gs-sharded training state: this rank's rows and the count over gs."""

    shard: TrainState  # this rank's rows (torch.tensor_split's split over gs)
    num_points: int  # rows over the gs axis

    @property
    def step(self) -> int:
        return self.shard.step

    @property
    def active_sh_degree(self) -> int:
        return self.shard.active_sh_degree


def _row_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every per-row tensor of ``state``, in a fixed order."""
    return ([state.params[k] for k in PARAMS] + [state.opt.mu[k] for k in PARAMS]
            + [state.opt.nu[k] for k in PARAMS] + [state.opt.count[k] for k in PARAMS]
            + [state.xyz_grad_accum, state.denom, state.max_radii2d])


def _with_row_tensors(state: TrainState, rows: List[torch.Tensor]) -> TrainState:
    k = len(PARAMS)
    per = [dict(zip(PARAMS, rows[i * k:(i + 1) * k])) for i in range(4)]
    accum, denom, radii = rows[4 * k:]
    return state._replace(params=per[0], opt=AdamState(mu=per[1], nu=per[2], count=per[3]),
                          xyz_grad_accum=accum, denom=denom, max_radii2d=radii)


def pack_rows(tensors: List[torch.Tensor]) -> Tuple[torch.Tensor, list]:
    """The per-row tensors side by side in one [rows, C] float32 buffer (an
    int32 tensor by its bits), and what unpack_rows needs to undo it."""
    rows = tensors[0].shape[0]
    cols = [(t if t.dtype == torch.float32 else t.view(torch.float32)).reshape(rows, -1)
            for t in tensors]
    return torch.cat(cols, dim=1), [(t.shape[1:], t.dtype, c.shape[1]) for t, c in zip(tensors, cols)]


def unpack_rows(buf: torch.Tensor, spec: list) -> List[torch.Tensor]:
    out, c0 = [], 0
    for shape, dtype, width in spec:
        col = buf[:, c0:c0 + width].contiguous()
        out.append((col if dtype == torch.float32 else col.view(dtype)).reshape((-1,) + shape))
        c0 += width
    return out


def shard_state(mesh, state: TrainState) -> DPState:
    """This rank's gs rows of a full (replicated) state."""
    comm = collectives(mesh)
    n = state.num_points
    lo, hi = comm.own_rows(n)
    return DPState(_with_row_tensors(state, [t[lo:hi].clone() for t in _row_tensors(state)]), n)


def replicate_state(mesh, state: DPState) -> TrainState:
    """The full state on every rank: one all-gather of every per-row tensor."""
    comm = collectives(mesh)
    buf, spec = pack_rows(_row_tensors(state.shard))
    return _with_row_tensors(state.shard, unpack_rows(comm.gather_rows(buf, state.num_points), spec))


def dp_gradients(comm: Collectives, state: DPState, batch: CameraBatch,
                 settings: RasterizeSettings, cfg: TrainConfig):
    """One DP step up to Adam: the loss of this rank's camera against the
    gathered rows, and the reduced values of this rank's rows.

    Returns (grads, stats, metrics): ``grads`` {name: rows} the dp-mean of
    each camera's gradient (the true gradient of the dp-mean loss);
    ``stats`` {"vs_grad": the dp-mean viewspace gradient [rows, 2],
    "visible": the views that see each row [rows], "radii": the largest
    radius over dp [rows]}; ``metrics`` loss and psnr meaned over dp, the
    row count over gs and the largest ``num_rendered`` over dp."""
    shard, n = state.shard, state.num_points
    device = comm.device
    lo, hi = comm.own_rows(n)
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    full = [shard.params[k].detach() for k in PARAMS]
    if comm.gs > 1:
        buf, spec = pack_rows(full)
        full = unpack_rows(comm.gather_rows(buf, n), spec)
    params = {k: v.requires_grad_(True) for k, v in zip(PARAMS, full)}
    offset = torch.zeros((n, 2), device=device, requires_grad=True)
    out = render_from_params(params, shard.active_sh_degree, s, means2d_offset=offset)
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=device)
    pred = out["render"] + bg[:, None, None] * (1.0 - out["rendered_final_opacity"][0])
    loss = ssim_ops.rgb_loss(pred, batch.gt_image, cfg.lambda_dssim)
    leaves = [params[k] for k in PARAMS] + [offset]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        radii = out["radii"][lo:hi].to(torch.float32)
        # sum over dp: the rows' gradients, viewspace gradients and visibility
        parts = [g[lo:hi] for g in grads] + [(radii > 0).to(torch.float32)]
        if comm.dp > 1:
            buf, spec = pack_rows(parts)
            parts = unpack_rows(comm.sum_dp(buf), spec)
        visible = parts.pop()
        vs_grad = parts.pop() / comm.dp
        grads = {k: g / comm.dp for k, g in zip(PARAMS, parts)}
        # max over dp: the radii and the entry count
        peak = comm.max_dp(torch.cat([radii, torch.tensor(
            [float(out["num_rendered"])], device=device)]))
        mean = comm.sum_dp(torch.stack([loss.detach(), ssim_ops.psnr(
            out["render"].detach(), batch.gt_image)])) / comm.dp
    stats = {"vs_grad": vs_grad, "visible": visible, "radii": peak[:-1]}
    metrics = {"loss": mean[0], "psnr": mean[1], "num_points": n, "num_rendered": peak[-1]}
    return grads, stats, metrics


@torch.no_grad()
def dp_optimise(shard: TrainState, grads: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
                cfg: TrainConfig, n_dp: int) -> TrainState:
    """The batched-view densify statistics and one Adam step of this rank's
    rows from the reduced gradients of ``dp_gradients``."""
    visible = stats["visible"]
    xyz_grad_accum = shard.xyz_grad_accum + torch.where(
        visible > 0, torch.linalg.vector_norm(stats["vs_grad"], dim=-1) * n_dp, 0.0)
    new_params, new_opt = adam_update(grads, shard.opt, shard.params,
                                      learning_rates(cfg, shard.step))
    return shard._replace(params=new_params, opt=new_opt, step=shard.step + 1,
                          xyz_grad_accum=xyz_grad_accum, denom=shard.denom + visible,
                          max_radii2d=torch.maximum(shard.max_radii2d, stats["radii"]))


def make_dp_train_step(mesh, settings: RasterizeSettings, cfg: TrainConfig):
    """The sharded step ``step(state: DPState, batch) -> (DPState, metrics)``
    of this rank (its dp index's camera in ``batch``). ``step.comm`` holds
    the mesh's collectives and the bytes handed to them."""
    comm = collectives(mesh)

    def step(state: DPState, batch: CameraBatch):
        grads, stats, metrics = dp_gradients(comm, state, batch, settings, cfg)
        return DPState(dp_optimise(state.shard, grads, stats, cfg, comm.dp),
                       state.num_points), metrics

    step.comm = comm
    return step


class DPTrainer:
    """The training loop of ``Trainer.train`` (SH warm-up, densify, opacity
    reset, the log and non-finite snapshot, checkpoints) through the
    sharded step, one process per rank.

    Densify runs on the replicated state: every rank gathers it, runs
    ``densify_and_prune`` with the same seeded ``torch.Generator`` and
    re-shards. Every rank draws the same camera sequence and takes the item
    of its dp index. Only rank 0 logs and writes files; ``host_state`` and
    the callback run on every rank (a gather is a collective)."""

    def __init__(self, pcd, dataset, cfg: TrainConfig = TrainConfig(), mesh=None, seed: int = 0,
                 device=None):
        from gaustudio_torch.pipelines.train import Trainer

        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.comm = Collectives(self.mesh)
        self.cfg = cfg
        self._inner = Trainer(pcd, dataset, cfg, seed=seed, device=self.comm.device)
        self.cameras = self._inner.cameras
        self.extent = self._inner.extent
        self.generator = self._inner.generator
        self.device = self._inner.device
        self.state = shard_state(self.comm, self._inner.state)
        self._inner.state = None  # one source of truth: self.state
        self._last_densify = None

    @property
    def is_writer(self) -> bool:
        return dist.get_rank() == 0

    def settings(self) -> RasterizeSettings:
        return self._inner.settings()

    def batch(self, camera) -> CameraBatch:
        return self._inner.batch(camera)

    def host_state(self) -> TrainState:
        """The gathered (replicated) state, for export; a collective."""
        return replicate_state(self.comm, self.state)

    def restore(self, path: str) -> None:
        """Resume from a Trainer or DPTrainer checkpoint: load, re-shard."""
        from gaustudio_torch.pipelines.train import load_checkpoint

        self.state = shard_state(self.comm, load_checkpoint(path, self.device))

    def train(self, iterations: Optional[int] = None, log_every: int = 100, callback=None,
              metrics_path: Optional[str] = None, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0):
        """Train up to ``iterations`` (an absolute step); returns the logged
        metrics (the same on every rank)."""
        from gaustudio_torch.pipelines.dataloader import make_batch_source
        from gaustudio_torch.pipelines.train import (
            densify_and_prune,
            oneup_sh_degree,
            reset_opacity,
            save_checkpoint,
        )
        from gaustudio_torch.utils.observability import MetricsLogger, snapshot_on_nonfinite

        cfg = self.cfg
        iters = iterations or cfg.iterations
        step = make_dp_train_step(self.comm, self.settings(), cfg)
        logger = (MetricsLogger(metrics_path, echo=False)
                  if metrics_path and self.is_writer else None)
        next_batch = make_batch_source(self.cameras, self.batch, batch_size=self.comm.dp)
        history = []
        try:
            for it in range(self.state.step + 1, iters + 1):
                self.state, metrics = step(self.state, next_batch()[self.comm.dp_rank])
                shard = self.state.shard

                if it % cfg.sh_increase_interval == 0:
                    shard = oneup_sh_degree(shard, cfg.max_sh_degree)
                if cfg.densify_from_iter < it < cfg.densify_until_iter:
                    if it % cfg.densification_interval == 0:
                        full = replicate_state(self.comm, self.state._replace(shard=shard))
                        full, self._last_densify = densify_and_prune(
                            full, self.generator, self.extent, cfg,
                            it > cfg.opacity_reset_interval)
                        self.state = shard_state(self.comm, full)
                        shard = self.state.shard
                    if it % cfg.opacity_reset_interval == 0:
                        shard = reset_opacity(shard)
                self.state = self.state._replace(shard=shard)

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
                        params = self.host_state().params
                        if self.is_writer:
                            snapshot_on_nonfinite(
                                {"params": params, "loss": metrics["loss"]},
                                (metrics_path or "train_dp") + ".snapshot.pt",
                                context=f"iter {it}")
                        raise FloatingPointError(f"non-finite loss at iter {it}")
                    if callback:
                        callback(m)
                if checkpoint_dir and checkpoint_every and it % checkpoint_every == 0:
                    full = self.host_state()
                    if self.is_writer:
                        save_checkpoint(os.path.join(checkpoint_dir, f"step_{it}.pt"), full)
        finally:
            next_batch.close()
            if logger:
                logger.close()
        return history
