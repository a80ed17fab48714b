"""Device milliseconds a frame of ``gs.bin``, binning (``ops/binning.py``
``bin_gaussians``: K1, the sort, K2): the program's CUDA events around it,
over the traced window's frames."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "render", "gs.bin")
