"""The readings of the program's own spans and counters in a traced window
(``gaustudio_torch/utils/observability.py``: ``annotate``, ``count``,
``report``), shared by the ``span_*`` readers and ``bin_keep_share.render``.

A device reading is a span's CUDA-event time from ``report()``; a host
reading sums the profiler's host events of the span's name in
``ctx["profile"]["spans"]["host"]``; a counter is ``report()``'s total. Each
is divided by the window's steps, frames or extractions (``ctx["steps"]``).
Every reading is None in a run of another kind, in a program without
``observability.report`` (a checkout before the spans) and where the
window recorded nothing of that name.
"""

from __future__ import annotations


def program_report():
    """The program's ``observability.report()``, or None where it has none."""
    try:
        from gaustudio_torch.utils import observability
    except ImportError:
        return None
    report = getattr(observability, "report", None)
    return report() if report is not None else None


def _report(ctx: dict, kind: str):
    return program_report() if ctx.get("kind") == kind else None


def device_ms(ctx: dict, kind: str, span: str):
    """Device milliseconds of ``span`` a step (its CUDA events)."""
    rep = _report(ctx, kind)
    ms = ((rep or {}).get("spans", {}).get(span) or {}).get("device_ms")
    return None if ms is None else ms / ctx["steps"]


def host_s(ctx: dict, kind: str, span: str):
    """Host seconds of ``span`` a step (the profiler's events of its name)."""
    if _report(ctx, kind) is None:
        return None
    ns = [end - start for start, end, name in ctx["profile"]["spans"]["host"] if name == span]
    return sum(ns) / 1e9 / ctx["steps"] if ns else None


def counter(ctx: dict, kind: str, name: str):
    """The window's total of counter ``name``."""
    rep = _report(ctx, kind)
    return (rep or {}).get("counters", {}).get(name)
