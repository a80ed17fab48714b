"""Float32 operations a 3DGS training step needs, stage by stage, counted
from the work of its inputs (``census.view_work``) and not from the kernels or
fusions that carry it, so that the step's share of the chip's peak
(``train_step_mfu``) bounds any later change to how the step is computed.

Per unit of work (a transcendental counts as one operation; a backward
counts twice its forward, the usual cost of a vector-Jacobian product):

* preprocess, per Gaussian in the frustum: view transform 18, projection
  and divide 30, quaternion to rotation 42, covariance R S S R^T 39, the
  EWA Jacobian and J W 46, J W Sigma (J W)^T 51, low-pass, determinant,
  conic 12, eigenvalue radius 10, support rect 25, activations 7: 280;
* SH degree 3, per Gaussian in the frustum: direction and norm 11, the 16
  basis values 44, 48 multiply-adds 96, offset and clamp 6: 157;
* K1, per (Gaussian, rect tile) candidate: the max-alpha tile test 79;
* the sort, per entry: one compare a radix digit of the 64-bit key, 8
  digits;
* the compositors, per (entry, pixel) pair: K3 20, K4 60 (``k3``, ``k4``);
* the loss, per pixel: L1 9; D-SSIM's five blurred maps, two 11-tap passes
  a channel, 660, and its products and ratio 69: 738;
* the statistics, per Gaussian: viewspace norm and accumulators 10;
* Adam, per parameter: moments 7, bias corrections 4, step 5: 16.
"""

from __future__ import annotations

PREPROCESS = 280
SH3 = 157
K1_PER_CANDIDATE = 79
SORT_PER_ENTRY = 8
PAIR_FWD = 20
PAIR_BWD = 60
LOSS_PER_PIXEL = 9 + 738
STATS_PER_GAUSSIAN = 10
ADAM_PER_PARAM = 16
BACKWARD = 2  # a backward's operations per forward operation


def stages(w: dict) -> dict:
    """{stage: float32 operations} of one training step of view work ``w``."""
    g = w["in_frustum"]
    return {
        "preprocess": (1 + BACKWARD) * (PREPROCESS + SH3) * g,
        "binning": K1_PER_CANDIDATE * w["rect_tiles"] + SORT_PER_ENTRY * w["entries"],
        "compositor": PAIR_FWD * w["fwd_pairs"] + PAIR_BWD * w["bwd_pairs"],
        "loss": (1 + BACKWARD) * LOSS_PER_PIXEL * w["pixels"],
        "statistics": STATS_PER_GAUSSIAN * w["gaussians"],
        "adam": ADAM_PER_PARAM * w["params"],
    }


def step_ops(w: dict) -> float:
    return float(sum(stages(w).values()))
