"""The benchmark's readings of a device trace: ``torch.profiler`` over one
steady window, reduced to device time by kernel, the union of the device's
busy intervals, and the longest idle gaps named by what the host was doing.

The window's wall is the host clock from just before the first call to
just after the ``synchronize()`` that ends it, measured inside the same
profiled window as the busy time.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

# the longest idle gaps that are named by the host op under them and summed
# by that name in "idle_gaps"
LABELLED_GAPS = 200


def kernel_name(key: str) -> str:
    """A short name of a profiler key: the function's own name without its
    namespaces, template arguments and parameters, as in
    ``void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)`` ->
    ``vectorized_elementwise_kernel``."""
    if key.startswith(("Memcpy", "Memset")):
        return key.split("(")[0].strip()
    s = key.replace("(anonymous namespace)", "")
    depth, head = 0, s
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            head = s[:i]
            break
    out, depth = [], 0
    for ch in head:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split()
    parts = [p for p in words[-1].split("::") if p] if words else []
    if not parts:
        return key.strip()
    # a generic last part ("kernel") keeps its namespace: "gemvx::kernel"
    return "::".join(parts[-2:]) if parts[-1] == "kernel" and len(parts) > 1 else parts[-1]


class Window:
    """Profile ``fn()`` calls (the caller runs them inside ``with``); with
    ``host=False`` the device's activity alone, which a long window needs."""

    def __init__(self, host: bool = True):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] if host else []
        self._prof = profile(activities=activities + [ProfilerActivity.CUDA])
        self.wall_s = 0.0

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def busy_s(self) -> float:
        """The union of the device's activity intervals, in seconds: the one
        reading of ``reduce`` that a window of some million events affords."""
        cuda = torch.autograd.DeviceType.CUDA
        return _union(sorted(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in self._prof.profiler.kineto_results.events()
            if ev.device_type() == cuda))[0] / 1e9

    def reduce(self, top: int = 10) -> dict:
        """{"kernels_s": {name: device s}, "busy_s", "window_s",
        "device_ops": [[name, s]...], "idle_gaps": [[host op, s]...],
        "spans": {"device": [...], "host": [...]}}; a span is (start ns,
        end ns, name), the profiler's events of the window as recorded."""
        dev, host = [], []
        for ev in self._prof.profiler.kineto_results.events():
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((start, end, ev.name()))
            elif ev.device_type() == torch.autograd.DeviceType.CPU and end > start:
                host.append((start, end, ev.name()))
        by_name = defaultdict(float)
        for s, e, name in dev:
            by_name[kernel_name(name)] += (e - s) / 1e9
        busy, gaps = _union(sorted((s, e) for s, e, _ in dev))
        gap_by_host = defaultdict(float)
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
            gap_by_host[_host_at(host, (g0 + g1) // 2)] += (g1 - g0) / 1e9
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"kernels_s": dict(by_name), "busy_s": busy / 1e9, "window_s": self.wall_s,
                "device_ops": rank(by_name), "idle_gaps": rank(gap_by_host),
                "spans": {"device": dev, "host": host}}


def _union(intervals):
    """(total covered ns, the gaps between covered stretches)."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _host_at(host, t) -> str:
    """The innermost host op running at ``t`` (ns)."""
    best, span = "host (no op recorded)", None
    for s, e, name in host:
        if s <= t < e and (span is None or e - s < span):
            best, span = name, e - s
    return best
