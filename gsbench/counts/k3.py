"""K3 (``render_tiles_kernel``, the 3DGS forward compositor): a frozen copy
of ``chip_smoke.py``'s ``vanilla_bounds`` entry. Bytes: each tile's range,
each entry's index, 40 bytes a Gaussian (means2d, conic, opacity, colour,
depth) read once, 36 bytes a pixel written (colour 3, depth, median depth,
weight and id, final T, n_contrib). Operations: ~20 a forward pair (power,
exp, alpha, tests, blend), counted from csrc/composite.cu."""

from gsbench.counts.peaks import bound_ms

KERNEL = "render_tiles_kernel"
OPS_PER_PAIR = 20


def bound(w: dict) -> tuple:
    return bound_ms(w["tiles"] * 8 + w["entries"] * 4 + w["gaussians"] * 40 + w["pixels"] * 36,
                    OPS_PER_PAIR * w["fwd_pairs"])
