"""The Scaffold-GS state of a benchmark run, made from the run's seed alone:
anchors, their offsets, features, scalings and rotations, and the three MLP
heads' weights.

Anchors lie in the vanilla scene's layout (``generate.vanilla_scene``'s
positions and log-normal scales: a central ball, a ground disk and a far
shell), so the ring of cameras sees a lit, multi-layer image in every
direction. Per anchor:

* ``scale`` [N, 6]: [:3] scale the offsets, [3:] are the neural Gaussians'
  base scale; both are the anchor's log-normal scale about its group's
  sigma, plus log ``offset_spread`` and log ``gaussian_spread``;
* ``offset`` [N, 3k]: standard normal, so an anchor's k Gaussians spread
  about it by its offset scaling;
* ``anchor_feat`` [N, F]: normal with deviation ``feature_sigma``;
* ``rot`` [N, 4]: the identity (Scaffold-GS's anchors keep it; no head reads
  it).

The heads' weights are drawn as the model draws them at creation, each
Linear's U(-1/sqrt(n_in), 1/sqrt(n_in)); the hidden biases are zero, and
each output's bias is minus that output's median over the anchors seen
from the first training camera. So every opacity output is positive for
half the anchors, and the colours' and scales' sigmoids are centred on 0.5,
whatever the seed: the work of a step does not swing with the draw. Their
keys are the training state's: ``mlp.<head>.<0|2>.<weight|bias>``, a weight
[n_out, n_in] (``nn.Linear``'s layout).

Everything is drawn on the device from ``generate.generator`` streams; the
seed changes the values, never the shapes.
"""

from __future__ import annotations

import math

import torch

from gsbench import generate
from gsbench.reference import scaffold as R


def head_widths(cfg: dict) -> dict:
    """{head: (n_in, hidden, n_out)}: the input is the feature, the view
    direction and the view distance."""
    n_in = int(cfg["feat_dim"]) + 4
    return {name: (n_in, int(cfg["mlp_hidden"]), int(out)) for name, out in cfg["heads"].items()}


def scene(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``}: the anchor attributes (anchor,
    offset, anchor_feat, scale, rot) and the heads' weights."""
    n, k, f = int(cfg["anchors"]), int(cfg["n_offsets"]), int(cfg["feat_dim"])
    s = cfg["scene"]
    base = generate.vanilla_scene({"gaussians": n, "scene": s}, seed, device)
    gen = generate.generator(seed, device, 2)
    f32 = dict(device=device, dtype=torch.float32)
    log_scale = base["scale"]
    rot = torch.zeros((n, 4), **f32)
    rot[:, 0] = 1.0
    out = {
        "anchor": base["xyz"],
        "offset": torch.randn((n, 3 * k), generator=gen, **f32),
        "anchor_feat": s["feature_sigma"] * torch.randn((n, f), generator=gen, **f32),
        "scale": torch.cat([log_scale + math.log(s["offset_spread"]),
                            log_scale + math.log(s["gaussian_spread"])], dim=1),
        "rot": rot,
    }
    del base
    for name, (n_in, hidden, n_out) in head_widths(cfg).items():
        for layer, (fan_in, width) in ((0, (n_in, hidden)), (2, (hidden, n_out))):
            bound = 1.0 / math.sqrt(fan_in)
            w = (2.0 * torch.rand((width, fan_in), generator=gen, **f32) - 1.0) * bound
            out[f"mlp.{name}.{layer}.weight"] = w
            out[f"mlp.{name}.{layer}.bias"] = torch.zeros((width,), **f32)
    campos = torch.tensor(generate.split(cfg, generate.cameras(cfg))[0][0]["position"], **f32)
    x = R.head_input(out["anchor"], out["anchor_feat"], campos)
    for name in cfg["heads"]:
        out[f"mlp.{name}.2.bias"] = -torch.median(R.mlp(out, name, x), dim=0).values
    return out
