"""K4's share of its roofline over the traced training window: the bound
of the work of each launch (gsbench/counts/k4.py) over its device time by
kernel name from torch.profiler."""

from gsbench.counts import k4
from gsbench.counts.peaks import roofline_share


def read(ctx):
    return roofline_share(ctx, k4)
