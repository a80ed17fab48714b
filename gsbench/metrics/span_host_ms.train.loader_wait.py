"""Host milliseconds a training step of ``gs.loader_wait``, the loader's wait
(``Trainer.train``'s ``next_batch()``: the prefetch queue's ``get``, or a
cache lookup): the profiler's host events of the span, over the traced
window's training steps."""

from gsbench import spans


def read(ctx):
    s = spans.host_s(ctx, "train", "gs.loader_wait")
    return None if s is None else 1e3 * s
