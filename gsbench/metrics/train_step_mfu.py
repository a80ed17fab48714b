"""The 3DGS training step's share of the float32 peak: the operations its
inputs need (gsbench/counts/step.py, from the work of each traced step's
view, gsbench/counts/census.py) over 67 TFLOP/s times the step's wall time
in the traced window."""

from gsbench.counts import census, step
from gsbench.counts.peaks import F32_OPS_PER_S


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("model") != "3dgs" or not ctx.get("steps"):
        return None
    work = census.work(ctx)
    if not work:
        return None
    step_ops = sum(step.step_ops(w) for w in work) / ctx["steps"]
    step_s = ctx["profile"]["window_s"] / ctx["steps"]
    return 100.0 * step_ops / (F32_OPS_PER_S * step_s)
