"""Device milliseconds a training step of ``gs.backward``, the backward
(``torch.autograd.grad`` in ``optimise``: K4 and autograd through preprocess):
the program's CUDA events around it, over the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "gs.backward")
