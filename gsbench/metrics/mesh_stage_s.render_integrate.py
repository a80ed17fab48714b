"""Seconds of one extraction spent rendering and fusing its views
(``iter_fused_depths`` with ``tsdf.integrate``): the host clock, fenced by
``synchronize()``, around the benchmark's own calls into the pipeline."""


def read(ctx):
    return ctx.get("mesh_stages", {}).get("render_integrate")
