"""K4 (``render_tiles_backward_kernel``, the 3DGS backward compositor): a
frozen copy of ``chip_smoke.py``'s ``vanilla_bounds`` entry. Bytes: ranges,
entries, the Gaussians' 40 bytes read and 40 bytes of gradients written, 32
bytes a pixel read (final T, n_contrib, the cotangents). Operations: ~60 a
backward pair, counted from csrc/composite_bwd.cu."""

from gsbench.counts.peaks import bound_ms

KERNEL = "render_tiles_backward_kernel"
OPS_PER_PAIR = 60


def bound(w: dict) -> tuple:
    return bound_ms(w["tiles"] * 8 + w["entries"] * 4 + 2 * w["gaussians"] * 40
                    + w["pixels"] * 32, OPS_PER_PAIR * w["bwd_pairs"])
