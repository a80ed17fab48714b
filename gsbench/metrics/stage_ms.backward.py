"""Device milliseconds of a training step's backward stage: CUDA events around
the benchmark's own call into the program's stage, median of 5 steps of the
cell's own state (chip_smoke.py's step_breakdown, frozen in the train
driver)."""


def read(ctx):
    return ctx.get("stage_ms", {}).get("backward")
