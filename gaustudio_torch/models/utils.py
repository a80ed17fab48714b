"""Activations and covariance builders (port of gaustudio_tpu/models/utils.py)."""

from __future__ import annotations

import torch

from gaustudio_torch.ops.gaussian import quat_to_rotmat


def inverse_sigmoid(x):
    """log(x / (1 - x)) in float32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.log(x / (1 - x))


def get_activation(name):
    """Name -> elementwise activation (those of the vanilla model's config)."""
    if name is None or name.lower() == "none":
        return lambda x: x
    name = name.lower()
    if name == "exp":
        return torch.exp
    if name == "sigmoid":
        return lambda x: 1.0 / (1.0 + torch.exp(-x))
    if name == "normalize":
        return lambda x: x / torch.clamp_min(
            torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)
    raise ValueError(f"unknown activation: {name}")


def build_scaling_rotation(s, q):
    """L = R(q) @ diag(s)."""
    return quat_to_rotmat(q, normalize=True) * s[..., None, :]


def strip_symmetric(sym):
    """Symmetric [..., 3, 3] -> upper-triangle [..., 6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [sym[..., 0, 0], sym[..., 0, 1], sym[..., 0, 2],
         sym[..., 1, 1], sym[..., 1, 2], sym[..., 2, 2]],
        dim=-1,
    )


def build_covariance_from_scaling_rotation(scaling, scaling_modifier, rotation):
    """Sigma = L L^T as the 6-vector."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation)
    return strip_symmetric(L @ L.transpose(-1, -2))
