"""Device milliseconds a Scaffold-GS training step of ``gs.backward``, autograd
through the compositor, preprocess, the compaction and the heads
(``train_step_scaffold``'s ``torch.autograd.grad``): the program's CUDA
events around it, over the traced window's training steps."""

from gsbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train_scaffold", "gs.backward")
