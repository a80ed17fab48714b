"""Device milliseconds a training step of ``gs.loss``, the loss (the background
composited in, ``ops/ssim.py`` ``rgb_loss``, in ``train_step``): the program's
CUDA events around it, over the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "gs.loss")
