"""Plain float32 reference of a Scaffold-GS training step (Lu et al., CVPR
2024, arXiv:2312.00109): the neural decode of every anchor's k Gaussians for
the view, the render of the positive-opacity ones through ``raster``, the
loss with its volume term, the gradients of every leaf (the anchor
attributes and the heads' weights) and one Adam step with a step count
shared by every leaf.

It imports nothing of the program and sets TF32 off, so every matrix
product runs in float32. The decode is written out as matrix products of
the heads' weights (``nn.Linear``'s layout, weight [n_out, n_in], as
``generate_scaffold`` draws them):

* input, per anchor: the feature, the unit view direction and the view
  distance, [N, F + 4];
* each head: Linear(F + 4, F) -> ReLU -> Linear(F, out); opacity k outputs
  through tanh, cov 7k, colour 3k through sigmoid;
* row j of anchor a: position anchor + offset_j * exp(scale)[:3], scale
  exp(scale)[3:] * sigmoid(cov[:3]), rotation cov[3:7] normalised, colour,
  opacity; only rows of positive opacity are rendered (Scaffold-GS's
  ``mask = neural_opacity > 0``).

The render is ``raster``'s 3DGS projection and blend of those rows, with
the decoded colours and opacities in place of SH and sigmoid. The blend and
its gradients run in tile groups (``raster.render``, ``raster.pullback``),
so the render fits at millions of rows.

Departures from the paper, which the program shares:

* the volume term is lambda_vol times the sum of the rendered rows' volumes
  (products of scales) over all n·k decoded rows; Scaffold-GS takes the mean
  over the masked rows of the anchors in the view frustum;
* no view-frustum anchor mask: every anchor is decoded;
* the MLP heads' learning rates are constant; Scaffold-GS decays them;
* the loss is (1 - l) L1 + l D-SSIM with D-SSIM padded by replication
  (``train.loss_of``), the background composited in the loss;
* the 3DGS rect cut to the opacity bbox, as ``raster`` documents.
"""

from __future__ import annotations

import math

import torch

from gsbench.reference import raster
from gsbench.reference import train as R

PARAMS = ("anchor", "offset", "anchor_feat", "scale", "rot")


def head_input(anchor, feat, campos):
    """[N, F + 4]: the feature, the unit view direction, the view distance."""
    d = anchor - campos
    dist = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return torch.cat([feat, d / dist, dist], dim=1)


def mlp(p: dict, head: str, x):
    """Linear -> ReLU -> Linear of ``head``'s weights, as matrix products."""
    w0, b0 = p[f"mlp.{head}.0.weight"], p[f"mlp.{head}.0.bias"]
    w1, b1 = p[f"mlp.{head}.2.weight"], p[f"mlp.{head}.2.bias"]
    h = torch.clamp_min(x @ w0.T + b0, 0.0)
    return h @ w1.T + b1


def decode(p: dict, campos, k: int) -> dict:
    """The positive-opacity rows of every anchor's k Gaussians: their row
    numbers in the n·k layout ("rows"), "xyz", "colour", "opacity", "scales",
    "rots"."""
    anchor = p["anchor"]
    n = anchor.shape[0]
    x = head_input(anchor, p["anchor_feat"], campos)
    opacity = torch.tanh(mlp(p, "opacity", x)).reshape(n * k)
    rows = torch.nonzero(opacity > 0.0).squeeze(1)
    a = rows // k
    cov = mlp(p, "cov", x).reshape(n * k, 7)[rows]
    colour = torch.sigmoid(mlp(p, "color", x)).reshape(n * k, 3)[rows]
    scaling = torch.exp(p["scale"])[a]
    rot = cov[:, 3:7]
    return {"rows": rows,
            "xyz": anchor[a] + p["offset"].reshape(n * k, 3)[rows] * scaling[:, :3],
            "colour": colour, "opacity": opacity[rows],
            "scales": scaling[:, 3:] * torch.sigmoid(cov[:, :3]),
            "rots": rot / torch.linalg.vector_norm(rot, dim=1, keepdim=True)}


def raw(g: dict) -> dict:
    """Decoded rows as the raw attributes ``raster.project_3dgs`` takes: log
    scales, logit opacities (their sigmoid sizes the tile rect) and zero SH."""
    m = g["xyz"].shape[0]
    op = g["opacity"].detach().clamp(1e-7, 1.0 - 1e-7)
    zeros = g["xyz"].new_zeros
    return {"xyz": g["xyz"], "scale": torch.log(g["scales"]), "rot": g["rots"],
            "opacity": torch.log(op / (1.0 - op))[:, None], "f_dc": zeros((m, 3)),
            "f_rest": zeros((m, 45))}


def view_depth(xyz, v: raster.View):
    """View-space depth written out per component, x m02 + y m12 + z m22 +
    m32 summed left to right, as the published CUDA rasterizer's
    ``transformPoint4x3`` writes it. Depth orders the blend: a matrix product
    rounds some depths of millions an ulp apart from this, and two
    overlapping Gaussians that close then blend in the other order, which
    moves a few hundred pixels by up to 1e-2 (PERF.md, §6)."""
    m = v.viewmatrix
    return xyz[:, 0] * m[0, 2] + xyz[:, 1] * m[1, 2] + xyz[:, 2] * m[2, 2] + m[3, 2]


def project(g: dict, v: raster.View) -> raster.Splats:
    """``raster.project_3dgs`` of decoded rows, the decoded colour and
    opacity put in the place of its SH colour and sigmoid, and the blend
    ordered by :func:`view_depth`."""
    sp = raster.project_3dgs(raw(g), v)
    sp.attrs["opacity"] = g["opacity"]
    sp.attrs["colour"] = g["colour"]
    return sp._replace(depth=view_depth(g["xyz"].detach(), v))


def render(p: dict, cam: dict, k: int, device):
    """(image dict of ``raster.render``, splats, entries, decoded rows) of
    the state ``p`` seen by the cameras.json entry ``cam``."""
    v = raster.view(cam, device)
    g = decode(p, v.campos, k)
    sp = project(g, v)
    e = raster.bin_entries(sp, v.W, v.H)
    return raster.render("3dgs", sp, e, v.W, v.H), sp, e, g, v


def visible(sp: raster.Splats, v: raster.View):
    """The rows 3DGS counts as seen (its ``radii > 0``): in front of the near
    plane, an invertible 2D covariance, and a non-empty tile rect of the
    3-sigma circle. The covariance is read back from the conic."""
    A, B, C = sp.attrs["conic"].detach().unbind(-1)
    inv_det = A * C - B * B
    ok = inv_det > 0
    det = torch.where(ok, 1.0 / torch.where(ok, inv_det, 1.0), 0.0)
    a, c = C * det, A * det
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))))
    gx, gy = (v.W + raster.TILE - 1) // raster.TILE, (v.H + raster.TILE - 1) // raster.TILE
    lo, hi = raster._tile_rect(sp.attrs["mean2d"].detach(), radius, radius, gx, gy)
    wh = hi - lo
    return (sp.depth.detach() > raster.NEAR) & ok & (wh[:, 0] * wh[:, 1] > 0)


def statistics(g: dict, sp: raster.Splats, v: raster.View, mean2d_grad, n: int, k: int) -> dict:
    """One step's additions to the program's growing and pruning statistics
    over the n·k rows: per row, the norm of its viewspace gradient (the
    pixel-space mean gradient scaled by (W / 2, H / 2)) and 1 where it is
    seen, both on the seen rendered rows; per anchor, the mean clamped
    opacity of its k rows and 1, where one of its rows is seen. (Scaffold-GS
    adds the sum over k for every anchor in the view frustum.)"""
    seen = visible(sp, v)
    rows = g["rows"]
    scale = torch.tensor([0.5 * v.W, 0.5 * v.H], device=rows.device)
    norm = torch.linalg.vector_norm(mean2d_grad * scale, dim=-1)
    zeros = torch.zeros(n * k, device=rows.device)
    row_seen = zeros.index_copy(0, rows, seen.float())
    opacity = zeros.index_copy(0, rows, g["opacity"].detach()).reshape(n, k)
    anchor_seen = row_seen.reshape(n, k).amax(1)
    return {"offset_grad": zeros.index_copy(0, rows, torch.where(seen, norm, 0.0)),
            "offset_seen": row_seen, "opacity": anchor_seen * opacity.clamp(0, 1).sum(1) / k,
            "anchor_seen": anchor_seen}


def step(params: dict, opt: dict, cam: dict, gt, cfg: dict, t: int, k: int):
    """One reference step at global step ``t`` -> (loss, grads, new params,
    new Adam state, the step's additions to the statistics). ``params`` holds
    the anchor attributes and the heads' weights; ``opt`` "mu", "nu" (keyed
    as ``params``) and "count"; ``gt`` [H, W, 3]; ``cfg`` the
    configuration's "train" group."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = params["anchor"].device
    n = params["anchor"].shape[0]
    leaves = {key: p.detach().requires_grad_(True) for key, p in params.items()}
    img, sp, e, g, v = render(leaves, cam, k, device)
    chunks = img.pop("_chunks")
    imgs = {name: x.detach().requires_grad_(True) for name, x in img.items()}
    photo = R.loss_of(imgs, gt, cfg)
    cts = dict(zip(imgs, torch.autograd.grad(photo, list(imgs.values()), allow_unused=True)))
    cts = {name: (c if c.dim() == 3 else c[..., None]) for name, c in cts.items()
           if c is not None}
    attr_grads = raster.pullback("3dgs", sp, e, v.W, v.H, chunks, cts)
    volume = torch.sum(torch.prod(g["scales"], dim=1)) / (n * k)
    pairs = [(sp.attrs[a], gr) for a, gr in attr_grads.items() if sp.attrs[a].requires_grad]
    pairs.append((volume, torch.tensor(float(cfg["lambda_vol"]), device=device)))
    got = torch.autograd.grad([a for a, _ in pairs], list(leaves.values()),
                              grad_outputs=[gr for _, gr in pairs], allow_unused=True)
    grads = {key: torch.zeros_like(leaves[key]) if gr is None else gr
             for key, gr in zip(leaves, got)}
    loss = float(photo.detach()) + float(cfg["lambda_vol"]) * float(volume.detach())
    stats = statistics(g, sp, v, attr_grads["mean2d"], n, k)
    del sp, e, img, imgs, leaves, g, attr_grads
    new_params, new_opt = adam(params, grads, opt, learning_rates(params, cfg, t))
    return loss, grads, new_params, new_opt, stats


def learning_rates(params: dict, cfg: dict, t: int) -> dict:
    """Each leaf's rate at step ``t``: the offsets' log-linear decay, every
    other leaf's constant, each head's weights the head's own."""
    lr = cfg["lr"]
    u = min(max(t / lr["offset_max_steps"], 0.0), 1.0)
    rates = {"anchor": lr["anchor"], "anchor_feat": lr["anchor_feat"], "scale": lr["scale"],
             "rot": lr["rot"],
             "offset": math.exp((1 - u) * math.log(lr["offset_init"])
                                + u * math.log(lr["offset_final"]))}
    for key in params:
        if key.startswith("mlp."):
            rates[key] = lr["mlp_" + key.split(".")[1]]
    return rates


def adam_init(params: dict) -> dict:
    return {"mu": {key: torch.zeros_like(v) for key, v in params.items()},
            "nu": {key: torch.zeros_like(v) for key, v in params.items()}, "count": 0}


def adam(params, grads, opt, lrs, b1=0.9, b2=0.999, eps=1e-15):
    """Adam over every leaf with one step count."""
    count = opt["count"] + 1
    # the bias corrections in float32, as every other number of the step
    c1, c2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** count) for b in (b1, b2))
    new_p, mu, nu = {}, {}, {}
    for key, p in params.items():
        g = grads[key]
        mu[key] = b1 * opt["mu"][key] + (1 - b1) * g
        nu[key] = b2 * opt["nu"][key] + (1 - b2) * g * g
        new_p[key] = p - lrs[key] * (mu[key] / c1) / (torch.sqrt(nu[key] / c2) + eps)
    return new_p, {"mu": mu, "nu": nu, "count": count}
