"""Host seconds an extraction of ``gs.mesh.march``, marching tetrahedra's slab
loop with its read-backs (``ops/mcubes.py``): the profiler's host events of
the span, over the traced window's extractions."""

from gsbench import spans


def read(ctx):
    return spans.host_s(ctx, "mesh", "gs.mesh.march")
