"""Float32 operations a Scaffold-GS training step needs, stage by stage,
counted from its inputs and not from the kernels or fusions that carry it,
so that the step's share of the chip's peak (``scaffold_step_mfu``) bounds
any later change to how the step is computed.

Per unit of work (a transcendental counts as one operation; a backward
counts twice its forward, as in ``step``):

* the decode, per anchor: the three heads' matrix products, 3 x 36·32·2
  + 32·(10 + 70 + 30)·2 = 13,952; their biases and activations (ReLU 3 x 32
  and the biases 3 x 32 + 110, tanh 10, sigmoid 30): 342; the view vector,
  its norm and direction: 12; the scaling's exp: 6; per decoded row, its
  position 6, scale (sigmoid and product) 6, normalised rotation 12 and the
  opacity test 1: 25;
* the rasterizer, per live row (a row of positive opacity) and its view's
  work as ``census.view_work`` counts it: ``step``'s preprocess without SH
  (the colours are decoded), K1's candidates, the sort, the compositors'
  pairs and the loss's pixels;
* the volume term, per decoded row: the product of three scales, the
  mask and the sum: 5;
* the statistics, ``step``'s 10 per decoded row, and per anchor the
  opacity sum over k rows and its test: k + 3;
* Adam, ``step``'s 16 per parameter, over the anchors and the heads.

The live rows of a view are decoded by the plain reference
(``reference/scaffold.py``) from the state the traced window leaves.
"""

from __future__ import annotations

import torch

from gsbench.counts import census, step
from gsbench.reference import raster
from gsbench.reference import scaffold as R

HEAD_MATMULS = 3 * 36 * 32 * 2 + 32 * (10 + 70 + 30) * 2
HEAD_ELEMENTWISE = 3 * 32 + 3 * 32 + 110 + 10 + 30
DECODE_PER_ANCHOR = HEAD_MATMULS + HEAD_ELEMENTWISE + 12 + 6
DECODE_PER_ROW = 25
VOLUME_PER_ROW = 5


@torch.no_grad()
def work(ctx: dict) -> list:
    """The work of every view the traced window trained on, in order: each
    view's live rows counted by ``census.view_work``, with the state's
    anchors, decoded rows and parameters. Kept in ``ctx``; None where the
    window rendered no view."""
    if "_scaffold_work" not in ctx:
        views = ctx.get("views")
        if not views:
            ctx["_scaffold_work"] = None
            return None
        state = ctx["params"]()
        device = state["anchor"].device
        n = int(state["anchor"].shape[0])
        k = int(state["offset"].shape[1]) // 3
        params = int(sum(v.numel() for v in state.values()))
        seen = {}
        for cam, scale in views:
            if cam["id"] not in seen:
                live = R.raw(R.decode(state, raster.view(cam, device).campos, k))
                w = census.view_work("3dgs", live, cam, scale, device)
                w.update(anchors=n, rows=n * k, live=w["gaussians"], params=params)
                seen[cam["id"]] = w
        ctx["_scaffold_work"] = [seen[cam["id"]] for cam, _ in views]
        del state
    return ctx["_scaffold_work"]


def stages(w: dict) -> dict:
    """{stage: float32 operations} of one training step of view work ``w``."""
    back = 1 + step.BACKWARD
    n, rows = w["anchors"], w["rows"]
    k = rows // max(n, 1)
    return {
        "decode": back * (DECODE_PER_ANCHOR * n + DECODE_PER_ROW * rows),
        "preprocess": back * step.PREPROCESS * w["in_frustum"],
        "binning": step.K1_PER_CANDIDATE * w["rect_tiles"] + step.SORT_PER_ENTRY * w["entries"],
        "compositor": step.PAIR_FWD * w["fwd_pairs"] + step.PAIR_BWD * w["bwd_pairs"],
        "loss": back * (step.LOSS_PER_PIXEL * w["pixels"] + VOLUME_PER_ROW * rows),
        "statistics": step.STATS_PER_GAUSSIAN * rows + (k + 3) * n,
        "adam": step.ADAM_PER_PARAM * w["params"],
    }


def step_ops(w: dict) -> float:
    return float(sum(stages(w).values()))
