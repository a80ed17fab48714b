"""Scaffold-GS training: the neural decode of anchors, L1 + D-SSIM + a volume
term, and anchor growing and pruning (port of
gaustudio_tpu/pipelines/train_scaffold.py, single device).

The JAX trainer keeps anchors in fixed-capacity padded arrays with a
``valid`` mask; the port trains on dynamic tensors, as its other trainers
do: every row is a live anchor, and ``adjust_anchors`` drops and appends
rows. So the volume term is the positive-opacity rows' volume over all n·k
decoded rows (the JAX mean runs over the padded capacity; Scaffold-GS's
over the masked rows of the visible anchors).

One step decodes every anchor's k Gaussians for the view (``decode_scaffold``:
no visibility mask and no feature bank), keeps the rows of positive decoded
opacity, as Scaffold-GS's renderer does (``mask = neural_opacity > 0``), and
renders those alone through rasterize() (kernels K1-K3 forward, K4 backward
on a CUDA device) with the background composited in the loss; then Adam over
the whole parameter set (the anchor attributes and every MLP weight) with one
shared step count. A dead row adds nothing to the render and gets no
gradient from it, so the compaction leaves the loss and the gradients as
rendering every row gives them. The statistics are per offset Gaussian for
growing (the viewspace gradient norm where ``radii > 0`` and the opacity is
positive) and per anchor for pruning (the mean decoded opacity over the
views where it had a live Gaussian); the rasterized rows' viewspace
gradients and radii are scattered back to the n·k rows for them. On a card
``ScaffoldTrainer`` replays the photometric loss's forward and backward as
CUDA graphs (``graphed_rgb_loss``): with the live rows alone, the step's
~2,100 kernel launches left the host, not the device, setting its pace.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from gaustudio_torch.ops import rasterize as rast
from gaustudio_torch.ops import ssim as ssim_ops
from gaustudio_torch.ops.rasterize import RasterizeSettings
from gaustudio_torch.pipelines import train as T
from gaustudio_torch.pipelines.optimizers.general import exp_lr_schedule
from gaustudio_torch.utils.misc import resolve_device
from gaustudio_torch.utils.observability import annotate, count

PARAMS = ("anchor", "offset", "anchor_feat", "scale", "rot")  # one row per anchor
MLP_PREFIX = "mlp."  # params[f"mlp.{head}.{layer}.{weight|bias}"]: nn.Linear layout


class ScaffoldTrainConfig(NamedTuple):
    iterations: int = 30000
    lambda_dssim: float = 0.2
    lambda_vol: float = 0.01  # volume term on the decoded scales
    # per-attribute learning rates (Scaffold-GS defaults)
    lr_anchor: float = 0.0
    lr_offset_init: float = 0.01
    lr_offset_final: float = 0.0001
    lr_offset_max_steps: int = 30000
    lr_feat: float = 0.0075
    lr_scale: float = 0.007
    lr_rot: float = 0.002
    lr_mlp_opacity: float = 0.002
    lr_mlp_cov: float = 0.004
    lr_mlp_color: float = 0.008
    # anchor adjustment
    update_from: int = 1500
    update_interval: int = 100
    update_until: int = 15000
    grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    success_threshold: float = 0.8  # share of an interval an offset must be seen
    white_background: bool = False


class ScaffoldTrainState(NamedTuple):
    """Training state: one row per anchor in every per-anchor tensor."""

    params: Dict[str, torch.Tensor]  # PARAMS and the MLP weights (MLP_PREFIX)
    mu: Dict[str, torch.Tensor]  # Adam moments, keyed as params
    nu: Dict[str, torch.Tensor]
    opt_count: int  # one Adam step count for every leaf
    step: int
    offset_grad_accum: torch.Tensor  # [N*k] growing statistics
    offset_denom: torch.Tensor  # [N*k]
    opacity_accum: torch.Tensor  # [N] pruning statistics
    anchor_denom: torch.Tensor  # [N]

    @property
    def num_anchors(self) -> int:
        return int(self.params["anchor"].shape[0])


def _zero_stats(n: int, k: int, device) -> dict:
    z = lambda m: torch.zeros(m, dtype=torch.float32, device=device)  # noqa: E731
    return dict(offset_grad_accum=z(n * k), offset_denom=z(n * k), opacity_accum=z(n),
                anchor_denom=z(n))


def init_scaffold_state(pcd, device=None) -> ScaffoldTrainState:
    """Training state of a ScaffoldPointCloud's anchors and heads on
    ``device`` (None: the model's)."""
    device = torch.device(device) if device is not None else pcd.device
    n = pcd.num_points
    params = {k: getattr(pcd, "_" + k).detach().to(device, torch.float32).reshape(n, -1).clone()
              for k in PARAMS}
    params.update({MLP_PREFIX + name: p.detach().to(device, torch.float32).clone()
                   for name, p in pcd.mlp.named_parameters()})
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
    return ScaffoldTrainState(params=params, mu=zeros(), nu=zeros(), opt_count=0, step=0,
                              **_zero_stats(n, pcd.n_offsets, device))


def state_to_scaffold_model(state: ScaffoldTrainState, pcd):
    """Write the trained anchors and heads into a ScaffoldPointCloud,
    dropping anchors with a non-finite value."""
    p = state.params
    finite = torch.ones(state.num_anchors, dtype=torch.bool, device=p["anchor"].device)
    for k in PARAMS:
        finite &= torch.isfinite(p[k]).all(dim=-1)
    for k in PARAMS:
        setattr(pcd, "_" + k, p[k][finite].detach().to(pcd.device).clone())
    pcd.num_points = int(finite.sum())
    pcd._opacity = torch.zeros((pcd.num_points, 1), device=pcd.device)
    with torch.no_grad():
        for name, param in pcd.mlp.named_parameters():
            param.copy_(p[MLP_PREFIX + name])
    return pcd


def _head(heads, params, name: str, x):
    prefix = f"{MLP_PREFIX}{name}."
    sub = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
    return functional_call(heads[name], sub, (x,))


def decode_scaffold(params, heads, campos, n_offsets: int):
    """The k Gaussians of every anchor seen from ``campos``: (xyz, colours,
    opacity, scales, rotations, neural opacity), [N*k] rows each.

    ``heads`` is the model's ``nn.ModuleDict`` of heads, run with the MLP
    weights of ``params``. Non-positive opacities keep their rows at 0.
    """
    anchor = params["anchor"]
    n, k = anchor.shape[0], n_offsets
    grid_scaling = torch.exp(params["scale"])  # [N, 6]
    ob_view = anchor - campos[None, :]
    ob_dist = torch.sqrt(torch.sum(ob_view * ob_view, dim=1, keepdim=True) + 1e-12)
    ob_view = ob_view / ob_dist
    cat_local = torch.cat([params["anchor_feat"], ob_view, ob_dist], dim=1)

    neural_opacity = _head(heads, params, "opacity", cat_local).reshape(-1)
    opacity = torch.where(neural_opacity > 0.0, neural_opacity, 0.0)
    color = _head(heads, params, "color", cat_local).reshape(n * k, 3)
    scale_rot = _head(heads, params, "cov", cat_local).reshape(n * k, 7)

    offsets = params["offset"].reshape(n * k, 3)
    scaling_rep = torch.repeat_interleave(grid_scaling, k, dim=0)
    anchor_rep = torch.repeat_interleave(anchor, k, dim=0)
    scales = scaling_rep[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = scale_rot[:, 3:7]
    rots = rot * torch.rsqrt(torch.sum(rot * rot, dim=-1, keepdim=True) + 1e-12)
    xyz = anchor_rep + offsets * scaling_rep[:, :3]
    return xyz, color, opacity, scales, rots, neural_opacity


def learning_rates(params, step: int, cfg: ScaffoldTrainConfig) -> Dict[str, float]:
    """Each leaf's rate: the offsets' log-linear decay from step 0; each MLP
    head's own rate (the feature bank takes the colour head's)."""
    head_lr = {"opacity": cfg.lr_mlp_opacity, "cov": cfg.lr_mlp_cov, "color": cfg.lr_mlp_color,
               "feature_bank": cfg.lr_mlp_color}
    lrs = {"anchor": cfg.lr_anchor,
           "offset": exp_lr_schedule(cfg.lr_offset_init, cfg.lr_offset_final,
                                     cfg.lr_offset_max_steps)(step),
           "anchor_feat": cfg.lr_feat, "scale": cfg.lr_scale, "rot": cfg.lr_rot}
    for k in params:
        if k.startswith(MLP_PREFIX):
            lrs[k] = head_lr[k[len(MLP_PREFIX):].split(".")[0]]
    return lrs


def shared_adam_update(grads, mu, nu, count: int, params, lrs, *, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-15):
    """Adam over every leaf with one shared step count (float32 bias
    correction) -> (params, mu, nu, count). Each operation runs over all
    leaves at once (``torch._foreach_*``: a few launches a step, not a few a
    leaf), in the order and rounding of ``p - lr (m / c1) / (sqrt(v / c2) +
    eps)`` taken leaf by leaf."""
    count += 1
    c1, c2 = (float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), float(count)))
              for b in (b1, b2))
    keys = list(params)
    g = [grads[k] for k in keys]
    m = torch._foreach_add(torch._foreach_mul([mu[k] for k in keys], b1),
                           torch._foreach_mul(g, 1 - b1))
    v = torch._foreach_add(torch._foreach_mul([nu[k] for k in keys], b2),
                           torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
    step = torch._foreach_mul(torch._foreach_div(m, c1), [lrs[k] for k in keys])
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, c2)), eps)
    new_p = torch._foreach_sub([params[k] for k in keys], torch._foreach_div(step, denom))
    return dict(zip(keys, new_p)), dict(zip(keys, m)), dict(zip(keys, v)), count


def graphed_rgb_loss(shape, lambda_dssim: float, device):
    """``ssim_ops.rgb_loss(pred, gt, lambda_dssim)`` for [3, H, W] images of
    ``shape`` on a card, its forward and its backward each captured once as
    a CUDA graph (``torch.cuda.make_graphed_callables``) and replayed: the
    same kernels in the same order, two launches a step for the host to
    issue in place of ~520. Capture while no other thread uses the card."""
    pred = torch.zeros(shape, device=device, requires_grad=True)
    return torch.cuda.make_graphed_callables(
        lambda p, g: ssim_ops.rgb_loss(p, g, lambda_dssim),
        (pred, torch.zeros(shape, device=device)))


def scaffold_loss(out, opacity, scales, gt, cfg: ScaffoldTrainConfig, rgb_loss=None):
    """L1 + D-SSIM of the render over the background (``rgb_loss(pred, gt)``,
    by default ``ssim_ops.rgb_loss`` with ``cfg.lambda_dssim``), plus
    ``lambda_vol`` times the volume (product of scales) of the
    positive-opacity rows summed and divided by the number of decoded rows."""
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=gt.device)
    pred = out["render"] + bg[:, None, None] * (1.0 - out["rendered_final_opacity"][0])
    photo = (rgb_loss(pred, gt) if rgb_loss is not None
             else ssim_ops.rgb_loss(pred, gt, cfg.lambda_dssim))
    # the product written out: prod()'s backward takes a cumulative-product
    # scan over the rows wherever a factor is zero, as every dead row's is
    s = torch.where(opacity[:, None] > 0.0, scales, 0.0)
    vol = torch.mean(s[:, 0] * s[:, 1] * s[:, 2])
    return photo + cfg.lambda_vol * vol


def train_step_scaffold(state: ScaffoldTrainState, batch: T.CameraBatch,
                        settings: RasterizeSettings, cfg: ScaffoldTrainConfig, heads,
                        n_offsets: int, rgb_loss=None):
    """One optimisation step: decode -> render the live rows -> loss -> Adam
    -> statistics. Returns (new state, metrics); the metrics are tensors or
    ints. ``rgb_loss`` is :func:`scaffold_loss`'s."""
    device = state.params["anchor"].device
    k, n = n_offsets, state.num_anchors
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3, device=device))
    params = {key: v.detach().requires_grad_(True) for key, v in state.params.items()}
    count("gs.scaffold.anchors", n)
    count("gs.scaffold.rows", n * k)
    with annotate("gs.scaffold.decode", params["anchor"]):
        xyz, color, opacity, scales, rots, neural_op = decode_scaffold(params, heads, s.campos, k)
        rows = torch.nonzero(opacity > 0.0).squeeze(1)  # ascending: the rows keep their order
        # index_select's backward is an index_add onto the n·k rows
        xyz_l, op_l, color_l, scales_l, rots_l = (torch.index_select(t, 0, rows)
                                                  for t in (xyz, opacity, color, scales, rots))
    count("gs.scaffold.live", rows.shape[0])
    offset2d = torch.zeros((rows.shape[0], 2), device=device, requires_grad=True)
    out = rast.rasterize(xyz_l, op_l, s, colors_precomp=color_l, scales=scales_l,
                         rotations=rots_l, means2D_offset=offset2d)
    with annotate("gs.loss", out["render"]):
        loss = scaffold_loss(out, opacity, scales, batch.gt_image, cfg, rgb_loss)
    leaves = list(params.values()) + [offset2d]
    with annotate("gs.backward", loss):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    vs_grads = grads.pop()

    with torch.no_grad(), annotate("gs.adam", loss):
        # the rasterized rows' viewspace gradients and radii, back on the n·k rows
        vs_grads = vs_grads.new_zeros((n * k, 2)).index_copy_(0, rows, vs_grads)
        radii = out["radii"].new_zeros(n * k).index_copy_(0, rows, out["radii"])
        live = (radii > 0) & (opacity > 0.0)
        vs_norm = torch.sqrt(torch.sum(vs_grads * vs_grads, dim=-1) + 1e-24)
        offset_grad_accum = state.offset_grad_accum + torch.where(live, vs_norm, 0.0)
        offset_denom = state.offset_denom + live.to(torch.float32)
        op_anchor = torch.sum(torch.clamp(neural_op, 0.0, 1.0).reshape(n, k), dim=1)
        seen = live.reshape(n, k).any(dim=1)
        opacity_accum = state.opacity_accum + torch.where(seen, op_anchor / k, 0.0)
        anchor_denom = state.anchor_denom + seen.to(torch.float32)
        new_p, mu, nu, opt_count = shared_adam_update(
            dict(zip(params, grads)), state.mu, state.nu, state.opt_count, state.params,
            learning_rates(state.params, state.step, cfg))
    metrics = {
        "loss": loss.detach(),
        "psnr": ssim_ops.psnr(out["render"].detach(), batch.gt_image),
        "num_points": n,
        "num_rendered": out["num_rendered"],
    }
    return state._replace(params=new_p, mu=mu, nu=nu, opt_count=opt_count, step=state.step + 1,
                          offset_grad_accum=offset_grad_accum, offset_denom=offset_denom,
                          opacity_accum=opacity_accum, anchor_denom=anchor_denom), metrics


def _rows_in(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each row of int array ``a``, whether it is a row of ``b``."""
    _, inv = np.unique(np.concatenate([b, a]), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    return np.isin(inv[len(b):], inv[:len(b)])


@torch.no_grad()
def adjust_anchors(state: ScaffoldTrainState, cfg: ScaffoldTrainConfig,
                   model) -> ScaffoldTrainState:
    """Anchor growing and pruning on the host, then the statistics reset.

    Growing: on level l of ``update_depth`` the offset Gaussians seen often
    enough whose mean viewspace gradient reaches grad_threshold *
    (update_hierachy_factor / 2)^l vote their positions onto a grid of
    voxel_size * update_init_factor / update_hierachy_factor^l; each voxel
    of that grid that no existing anchor occupies becomes an anchor, in
    ``np.unique``'s order, with zero offsets, the feature of the anchor of
    its first voter and scales log(voxel). Pruning: anchors observed in at
    least success_threshold * update_interval views whose mean decoded
    opacity is below min_opacity go. Surviving anchors keep their Adam
    moments in their new order; new anchors start at zero; the step count
    is kept.
    """
    k = model.n_offsets
    n = state.num_anchors
    if n == 0:
        return state
    device = state.params["anchor"].device
    host = {key: state.params[key].cpu().numpy() for key in PARAMS}
    anchor, offset, feat, scale = host["anchor"], host["offset"], host["anchor_feat"], host["scale"]

    grad_accum = state.offset_grad_accum.cpu().numpy().reshape(n, k)
    denom = state.offset_denom.cpu().numpy().reshape(n, k)
    avg_grad = grad_accum / np.maximum(denom, 1.0)
    enough = denom >= cfg.update_interval * cfg.success_threshold * 0.5
    all_xyz = anchor[:, None, :] + offset.reshape(n, k, 3) * np.exp(scale[:, :3])[:, None, :]

    new_anchors, new_feats, new_scales = [], [], []
    base_size = model.voxel_size * model.update_init_factor
    for level in range(model.update_depth):
        cur_size = base_size / (model.update_hierachy_factor ** level)
        thresh = cfg.grad_threshold * ((model.update_hierachy_factor / 2.0) ** level)
        cand = enough & (avg_grad >= thresh)
        if not cand.any():
            continue
        cand_parent = np.nonzero(cand)[0]  # anchor row of each candidate
        grid = np.round(all_xyz[cand] / cur_size).astype(np.int64)
        occupied = np.round(anchor / cur_size).astype(np.int64)
        uniq, first = np.unique(grid, axis=0, return_index=True)
        fresh = ~_rows_in(uniq, occupied)
        new_anchors.append((uniq[fresh].astype(np.float64) * cur_size).astype(np.float32))
        new_feats.append(feat[cand_parent[first[fresh]]])
        new_scales.append(np.full((int(fresh.sum()), 6), np.log(max(cur_size, 1e-6)),
                                  np.float32))

    op_avg = state.opacity_accum.cpu().numpy() / np.maximum(state.anchor_denom.cpu().numpy(), 1.0)
    observed = state.anchor_denom.cpu().numpy() >= cfg.update_interval * cfg.success_threshold
    keep = ~(observed & (op_avg < cfg.min_opacity))
    n_new = sum(len(a) for a in new_anchors)
    if n_new == 0 and keep.all():
        return state._replace(**_zero_stats(n, k, device))

    rot = np.zeros((n_new, 4), np.float32)
    rot[:, 0] = 1.0
    cat = lambda arrs, width: (np.concatenate(arrs) if arrs  # noqa: E731
                               else np.zeros((0, width), np.float32))
    born = {"anchor": cat(new_anchors, 3), "offset": np.zeros((n_new, 3 * k), np.float32),
            "anchor_feat": cat(new_feats, feat.shape[1]), "scale": cat(new_scales, 6),
            "rot": rot}
    keep_t = torch.from_numpy(keep).to(device)
    rows = lambda t, new: torch.cat([t[keep_t], new.to(device)])  # noqa: E731
    params, mu, nu = dict(state.params), dict(state.mu), dict(state.nu)
    for key in PARAMS:
        params[key] = rows(state.params[key], torch.from_numpy(born[key]))
        mu[key] = rows(state.mu[key], torch.zeros((n_new,) + state.mu[key].shape[1:]))
        nu[key] = rows(state.nu[key], torch.zeros((n_new,) + state.nu[key].shape[1:]))
    return state._replace(params=params, mu=mu, nu=nu,
                          **_zero_stats(int(keep.sum()) + n_new, k, device))


class ScaffoldTrainer:
    """The Scaffold-GS training loop: camera sampling, anchor adjustment,
    logging. Trains on ``device`` (None: the current CUDA device)."""

    def __init__(self, pcd, dataset, cfg: ScaffoldTrainConfig = ScaffoldTrainConfig(),
                 device=None):
        self.cfg = cfg
        self.pcd = pcd
        self.cameras = list(dataset)
        self.device = resolve_device(device)
        self.state = init_scaffold_state(pcd, self.device)
        cam0 = self.cameras[0]
        self.H, self.W = int(cam0.image_height), int(cam0.image_width)
        self._rgb_loss = None  # graphed_rgb_loss on a card, made by train()

    batch = T.Trainer.batch

    def settings(self) -> RasterizeSettings:
        cam0 = self.cameras[0]
        return RasterizeSettings(image_height=self.H, image_width=self.W,
                                 tanfovx=math.tan(cam0.FoVx * 0.5),
                                 tanfovy=math.tan(cam0.FoVy * 0.5), bg=None, sh_degree=0)

    def step(self, batch: T.CameraBatch, settings: RasterizeSettings):
        """One optimisation step of the current state: (new state, metrics)."""
        rgb_loss = self._rgb_loss if batch.gt_image.shape == (3, self.H, self.W) else None
        return train_step_scaffold(self.state, batch, settings, self.cfg, self.pcd.mlp,
                                   self.pcd.n_offsets, rgb_loss)

    def train(self, iterations: Optional[int] = None, log_every: int = 100, callback=None,
              metrics_path: Optional[str] = None):
        """Train ``iterations`` steps; returns the logged metrics."""
        from gaustudio_torch.pipelines.dataloader import make_batch_source
        from gaustudio_torch.utils.observability import MetricsLogger

        cfg = self.cfg
        iters = iterations or cfg.iterations
        settings = self.settings()
        if self._rgb_loss is None and self.device.type == "cuda":
            # captured before the loader's thread starts copying to the card
            self._rgb_loss = graphed_rgb_loss((3, self.H, self.W), cfg.lambda_dssim, self.device)
        logger = MetricsLogger(metrics_path, echo=False) if metrics_path else None
        next_batch = make_batch_source(self.cameras, self.batch)
        history = []
        try:
            for it in range(1, iters + 1):
                with annotate("gs.step"):
                    with annotate("gs.loader_wait"):
                        batch = next_batch()
                    self.state, metrics = self.step(batch, settings)
                    if (cfg.update_from < it < cfg.update_until
                            and it % cfg.update_interval == 0):
                        with annotate("gs.scaffold.adjust", self.state.params["anchor"]):
                            self.state = adjust_anchors(self.state, cfg, self.pcd)
                    if it % log_every == 0 or it == iters:
                        m = {key: float(v) for key, v in metrics.items()}
                        m["iter"] = it
                        history.append(m)
                        if logger:
                            logger.log(it, **{key: v for key, v in m.items() if key != "iter"})
                        if callback:
                            callback(m)
        finally:
            next_batch.close()
            if logger:
                logger.close()
        return history
