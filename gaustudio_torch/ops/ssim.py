"""SSIM / D-SSIM loss for 3DGS training (port of gaustudio_tpu/ops/ssim.py).

11-tap separable Gaussian window (sigma 1.5), per-channel SSIM, loss =
(1 - lambda) L1 + lambda (1 - SSIM). The image edge is padded by
replication (the JAX package's ``mode="edge"``), not with Inria's zeros.
The blur is written as 11 shifted multiply-adds in float32 rather than a
cuDNN convolution, which on the card would default to TF32
(``torch.backends.cudnn.allow_tf32``): the loss keeps full float32, as the
JAX version does at HIGHEST precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_C1 = 0.01**2
_C2 = 0.03**2


def _gaussian_kernel(size: int = 11, sigma: float = 1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs**2) / (2 * sigma**2))
    return [float(v) for v in (g / g.sum()).astype(np.float32)]


def _blur(img: torch.Tensor, kernel) -> torch.Tensor:
    """Separable Gaussian blur of [C, H, W], same size, edge-replicated."""
    k = len(kernel)
    pad = k // 2
    H, W = img.shape[-2:]
    x = F.pad(img[None], (0, 0, pad, pad), mode="replicate")[0]
    x = sum(kernel[i] * x[:, i:i + H, :] for i in range(k))
    x = F.pad(x[None], (pad, pad, 0, 0), mode="replicate")[0]
    return sum(kernel[i] * x[:, :, i:i + W] for i in range(k))


def ssim(img0, img1, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM between two [C, H, W] images in [0, 1]."""
    kernel = _gaussian_kernel(window_size, sigma)
    mu0 = _blur(img0, kernel)
    mu1 = _blur(img1, kernel)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    s00 = _blur(img0 * img0, kernel) - mu00
    s11 = _blur(img1 * img1, kernel) - mu11
    s01 = _blur(img0 * img1, kernel) - mu01
    num = (2 * mu01 + _C1) * (2 * s01 + _C2)
    den = (mu00 + mu11 + _C1) * (s00 + s11 + _C2)
    return torch.mean(num / den)


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def rgb_loss(pred, gt, lambda_dssim: float = 0.2):
    """Canonical 3DGS photometric loss."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - ssim(pred, gt))


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
