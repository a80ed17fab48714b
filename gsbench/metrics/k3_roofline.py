"""K3's share of its roofline over the traced training window: the bound
of the work of each launch (gsbench/counts/k3.py) over its device time by
kernel name from torch.profiler."""

from gsbench.counts import k3
from gsbench.counts.peaks import roofline_share


def read(ctx):
    return roofline_share(ctx, k3)
