"""Host seconds an extraction of ``gs.mesh.views``, the views' loop
(``extract_mesh``: render, masked depth, the view's files handed to the
writers, ``tsdf.integrate``): the profiler's host events of the span, over the
traced window's extractions."""

from gsbench import spans


def read(ctx):
    return spans.host_s(ctx, "mesh", "gs.mesh.views")
