"""Plain float32 reference of a 3DGS training step: the render of
``raster``, the loss, the gradients and a per-row Adam.

The loss is the one the configuration states: (1 - l) L1 + l D-SSIM,
l = 0.2, with an 11-tap Gaussian window (sigma 1.5) whose edge is padded by
replication, as the program's reference package pads it. The background
(black) is composited in the loss.

Adam: betas 0.9 / 0.999, eps 1e-15, a step count per row, Inria's learning
rates, xyz's on the log-linear decay over 30,000 steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gsbench.reference import raster

PARAMS = ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot")


def _window(size: int = 11, sigma: float = 1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return [float(v) for v in (g / g.sum()).astype(np.float32)]


def _blur(img, k):
    pad = len(k) // 2
    H, W = img.shape[-2:]
    x = F.pad(img[None], (0, 0, pad, pad), mode="replicate")[0]
    x = sum(k[i] * x[:, i:i + H, :] for i in range(len(k)))
    x = F.pad(x[None], (pad, pad, 0, 0), mode="replicate")[0]
    return sum(k[i] * x[:, :, i:i + W] for i in range(len(k)))


def ssim(a, b):
    k = _window()
    mu_a, mu_b = _blur(a, k), _blur(b, k)
    s_aa = _blur(a * a, k) - mu_a * mu_a
    s_bb = _blur(b * b, k) - mu_b * mu_b
    s_ab = _blur(a * b, k) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
                      / ((mu_a * mu_a + mu_b * mu_b + c1) * (s_aa + s_bb + c2)))


def photo_loss(pred, gt, lam: float):
    return (1.0 - lam) * torch.mean(torch.abs(pred - gt)) + lam * (1.0 - ssim(pred, gt))


def loss_of(out: dict, gt, cfg: dict):
    """The step's loss of rendered images ``out`` against ``gt`` [H, W, 3]."""
    pred = out["colour"].permute(2, 0, 1)  # black background: + 0 * T
    return photo_loss(pred, gt.permute(2, 0, 1), cfg["lambda_dssim"])


def xyz_lr(cfg: dict, step: int) -> float:
    t = min(max(step / cfg["lr"]["xyz_max_steps"], 0.0), 1.0)
    return math.exp((1 - t) * math.log(cfg["lr"]["xyz_init"]) + t * math.log(cfg["lr"]["xyz_final"]))


def step(params: dict, opt: dict, cam: dict, gt, cfg: dict, t: int, compute=torch.float32):
    """One reference step at global step ``t`` -> (loss, grads, new params,
    new Adam state). ``opt`` holds "mu", "nu" and "count" dicts. The
    rasterizer (projection, SH, blend and their gradients) computes in
    ``compute``; the loss, the parameters and Adam stay in float32 (with
    bfloat16 this is mixed-precision training, the control of the
    comparison)."""
    device = params["xyz"].device
    v = raster.view(cam, device, dtype=compute)
    leaves = {k: p.detach().to(compute).requires_grad_(True) for k, p in params.items()}
    sp = raster.project_3dgs(leaves, v)
    e = raster.bin_entries(sp, v.W, v.H)
    img = raster.render("3dgs", sp, e, v.W, v.H)
    chunks = img.pop("_chunks")
    imgs = {n: x.detach().float().requires_grad_(True) for n, x in img.items()}
    loss = loss_of(imgs, gt, cfg)
    cts = dict(zip(imgs, torch.autograd.grad(loss, list(imgs.values()), allow_unused=True)))
    cts = {n: (c if c.dim() == 3 else c[..., None]).to(compute) for n, c in cts.items()
           if c is not None}
    attr_grads = raster.pullback("3dgs", sp, e, v.W, v.H, chunks, cts)
    pairs = [(sp.attrs[k], g) for k, g in attr_grads.items() if sp.attrs[k].requires_grad]
    got = torch.autograd.grad([a for a, _ in pairs], [leaves[k] for k in PARAMS],
                              grad_outputs=[g for _, g in pairs], allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g).float()
             for k, g in zip(PARAMS, got)}
    del sp, e, img, imgs, leaves
    lrs = {"xyz": xyz_lr(cfg, t), **{k: cfg["lr"][k] for k in PARAMS if k != "xyz"}}
    new_params, new_opt = adam(params, grads, opt, lrs)
    return float(loss.detach()), grads, new_params, new_opt


def adam_init(params: dict) -> dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": {k: torch.zeros(v.shape[0], device=v.device) for k, v in params.items()}}


def adam(params, grads, opt, lrs, b1=0.9, b2=0.999, eps=1e-15):
    new_p, mu, nu, count = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = b1 * opt["mu"][k] + (1 - b1) * g
        nu[k] = b2 * opt["nu"][k] + (1 - b2) * g * g
        count[k] = opt["count"][k] + 1
        c = count[k].reshape((-1,) + (1,) * (p.dim() - 1))
        c1, c2 = 1.0 - b1 ** c, 1.0 - b2 ** c
        new_p[k] = p - lrs[k] * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
    return new_p, {"mu": mu, "nu": nu, "count": count}
