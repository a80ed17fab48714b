"""Device milliseconds a training step of ``gs.bin``, binning (``ops/binning.py``
``bin_gaussians``: K1's count, its read-back and write, the sort, K2): the
program's CUDA events around it, over the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "gs.bin")
