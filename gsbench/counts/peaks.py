"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates) and the
roofline bound of a piece of work: the larger of its bytes over the memory
rate and its float32 operations over the float32 rate outside the tensor
cores. A frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``,
``F32_OPS_PER_S`` and ``bound_ms``."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(least milliseconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_share(ctx: dict, kernel) -> float:
    """Percent of its roofline that ``kernel`` (a module of this package with
    ``KERNEL`` and ``bound``) reaches over a traced window: the bound of the
    work each of its launches needed (``census.work``, one view a launch)
    over its device time by name. None where it did not run."""
    from gsbench.counts import census

    device_s = ctx.get("profile", {}).get("kernels_s", {}).get(kernel.KERNEL)
    if not device_s:
        return None
    work = census.work(ctx)
    if not work:
        return None
    return 100.0 * sum(kernel.bound(w)[0] for w in work) / 1e3 / device_s
