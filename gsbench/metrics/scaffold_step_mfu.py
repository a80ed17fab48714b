"""The Scaffold-GS training step's share of the float32 peak: the operations
its inputs need (gsbench/counts/scaffold.py: the decode, the rasterizer's
work over each traced view's live rows, the loss, the statistics and Adam)
over 67 TFLOP/s times the step's wall time in the traced window."""

from gsbench.counts import scaffold
from gsbench.counts.peaks import F32_OPS_PER_S


def read(ctx):
    if ctx.get("kind") != "train_scaffold" or not ctx.get("steps"):
        return None
    work = scaffold.work(ctx)
    if not work:
        return None
    step_ops = sum(scaffold.step_ops(w) for w in work) / ctx["steps"]
    step_s = ctx["profile"]["window_s"] / ctx["steps"]
    return 100.0 * step_ops / (F32_OPS_PER_S * step_s)
