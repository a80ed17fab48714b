"""Host seconds an extraction of ``gs.mesh.writer_wait``, the main thread blocked
on ``BackgroundWriter`` (back-pressure in ``submit``, the join at its end):
the profiler's host events of the span, over the traced window's extractions."""

from gsbench import spans


def read(ctx):
    return spans.host_s(ctx, "mesh", "gs.mesh.writer_wait")
