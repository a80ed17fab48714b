"""Percent of the traced Scaffold-GS train window in which no operation ran on
the device: 1 - (the union of the device's activity intervals / the window's
wall), both from the same profiled window."""


def read(ctx):
    if ctx.get("kind") != "train_scaffold":
        return None
    prof = ctx["profile"]
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
