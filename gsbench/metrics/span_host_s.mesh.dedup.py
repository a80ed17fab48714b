"""Host seconds an extraction of ``gs.mesh.dedup``, marching's host dedup
(``np.unique``), degenerate faces, winding and world vertices
(``ops/mcubes.py``): the profiler's host events of the span, over the traced
window's extractions."""

from gsbench import spans


def read(ctx):
    return spans.host_s(ctx, "mesh", "gs.mesh.dedup")
