"""Seconds of one extraction spent in marching tetrahedra (``ops/mcubes.py``:
slabs on the card, the host's dedup and winding) and the mesh's file: the
host clock, fenced by ``synchronize()``, around the benchmark's own calls."""


def read(ctx):
    return ctx.get("mesh_stages", {}).get("march")
