"""Seconds of one whole ``extract_mesh`` call with its files, as users wait
for it: the host clock over a closed loop of extractions in the traced run,
before and without the profiler, divided by their number."""


def read(ctx):
    return ctx.get("extract_wall_s")
