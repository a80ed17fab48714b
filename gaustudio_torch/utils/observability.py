"""Tracing, metrics and failure detection (port of
gaustudio_tpu/utils/observability.py).

* ``trace``: a block profiled with ``torch.profiler`` (CPU, and CUDA on the
  card), written as one Chrome / Perfetto trace file and, beside it, the
  block's ``report``;
* ``annotate`` / ``count``: the program's spans and counters (``gs.*``),
  live only while a ``torch.profiler`` runs; ``report``: what they recorded
  in the current profiled window;
* ``MetricsLogger``: append-only JSONL scalar metrics (loss, PSNR, point
  count, densify counts) with wall-clock timestamps;
* ``snapshot_on_nonfinite``: when any tensor of a nested dict / list is
  non-finite, ``torch.save`` the whole tree for offline repro.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

from gaustudio_torch.utils.misc import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, name: str = "gaustudio", device=None):
    """Profile the block with torch.profiler inside a ``name`` region and
    write one Chrome / Perfetto trace file into ``log_dir`` (open it in
    ui.perfetto.dev or chrome://tracing), and beside it the block's
    :func:`report` as JSON (``<trace>.spans.json``, see :func:`report_path`),
    the record of the block's spans and counters alone. Records CPU activity, and CUDA activity when ``device`` (None: the
    current CUDA device, as every entry point resolves it) is a card. Yields
    the trace file's path."""
    from torch.profiler import ProfilerActivity, profile, record_function

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("trace: this torch.profiler cannot record CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.{time.strftime('%Y%m%d_%H%M%S')}.{os.getpid()}"
                                 ".pt.trace.json")
    _RECORD.reset()
    with profile(activities=activities) as prof:
        with record_function(name):
            yield path
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    with open(report_path(path), "w") as f:
        json.dump(report(), f, indent=1)


def report_path(trace_path: str) -> str:
    """The report file that :func:`trace` writes beside ``trace_path``."""
    return trace_path[:-len(".pt.trace.json")] + ".spans.json"


class _Record:
    """The spans and counters of one profiled window.

    A device span's CUDA events stay queued until the report is read; past
    FOLD pending pairs (or counter tensors), the finished ones are folded
    into a total, so a long window holds a bounded number of them and the
    hot path never waits for the device."""

    FOLD = 64

    def __init__(self):
        self._lock = threading.Lock()
        self.idle = True  # a span or counter saw no profiler since the last window
        self.reset()

    def reset(self):
        self.spans = {}  # name -> {"calls", "parent", "device_ms", "pending"}
        self.counters = {}  # name -> [total, pending device tensors]
        self.stack = []  # open spans, innermost last

    def _start_window(self):
        if self.idle:
            self.idle = False
            self.reset()

    def open(self, name: str) -> None:
        with self._lock:
            self._start_window()
            span = self.spans.get(name)
            if span is None:
                span = self.spans[name] = {"calls": 0, "parent": self.stack[-1] if self.stack
                                           else None, "device_ms": None, "pending": []}
            span["calls"] += 1
            self.stack.append(name)

    def close(self, name: str, events=None) -> None:
        with self._lock:
            if self.stack and self.stack[-1] == name:
                self.stack.pop()
            elif name in self.stack:
                self.stack.remove(name)
            if events is None:
                return
            pending = self.spans[name]["pending"]
            pending.append(events)
            if len(pending) >= self.FOLD:
                self._fold(name, wait=False)

    def _fold(self, name: str, wait: bool) -> None:
        """Add the finished event pairs of span ``name`` to its device time
        (with ``wait``, every pair, once the device reaches it)."""
        span = self.spans[name]
        keep = []
        for start, end in span["pending"]:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((start, end))
                continue
            span["device_ms"] = (span["device_ms"] or 0.0) + start.elapsed_time(end)
        span["pending"] = keep

    def add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.sum() if value.dim() else value  # one reduction, no read-back
        with self._lock:
            self._start_window()
            counter = self.counters.setdefault(name, [0, []])
            if not isinstance(value, torch.Tensor):
                counter[0] += int(value)
                return
            counter[1].append(value)
            if len(counter[1]) >= self.FOLD:
                counter[1] = [torch.stack([v.to(torch.int64) for v in counter[1]]).sum()]

    def read(self) -> dict:
        with self._lock:
            for name, span in self.spans.items():
                if span["pending"]:
                    self._fold(name, wait=True)
            for counter in self.counters.values():
                counter[0] += sum(int(v) for v in counter[1])
                counter[1] = []
            return {"spans": {name: {k: span[k] for k in ("calls", "parent", "device_ms")}
                              for name, span in self.spans.items()},
                    "counters": {name: counter[0] for name, counter in self.counters.items()}}


_RECORD = _Record()
_NULL = contextlib.nullcontext()


class _Span:
    """An open span (see :func:`annotate`)."""

    __slots__ = ("name", "cuda", "region", "start")

    def __init__(self, name: str, on):
        self.name = name
        self.cuda = on is not None and on.is_cuda

    def __enter__(self):
        _RECORD.open(self.name)
        # an operator's host event: record_function's user annotation would be
        # mirrored onto the card's timeline, where it reads as device activity
        self.region = torch._C._profiler._RecordFunctionFast(self.name)
        self.region.__enter__()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        events = None
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (self.start, end)
        self.region.__exit__(*exc)
        _RECORD.close(self.name, events)
        return False


def annotate(name: str, on: Optional[torch.Tensor] = None):
    """A named span (a context manager), live only while a
    ``torch.profiler`` runs in the process; otherwise one flag check and a
    shared null context.

    A live span records a host event named ``name`` (an operator's event, as
    ``record_function`` records one but never mirrored onto the card's
    timeline), and counts its calls and its parent span (the innermost one
    open when it first opened) in :func:`report`. Where ``on``
    (the tensor the span's work runs on) is on a card, a pair of CUDA events
    on the current stream gives the span's device time, read only when the
    report is. The spans of the program open on the calling thread only."""
    if _profiler._is_profiler_enabled:
        return _Span(name, on)
    _RECORD.idle = True
    return _NULL


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a ``torch.profiler`` runs
    (otherwise nothing): an int, or a tensor whose sum is taken on its device
    (one reduction) and read only when the report is."""
    if _profiler._is_profiler_enabled:
        _RECORD.add(name, value)
    else:
        _RECORD.idle = True


def report() -> dict:
    """The spans and counters of the current profiled window (the last one,
    once it has ended): ``{"spans": {name: {"calls", "parent", "device_ms"}},
    "counters": {name: total}}``. ``device_ms`` is the span's device time
    summed over its calls, None for a span with no CUDA events.

    The record starts afresh at :func:`trace`'s start and at the first span
    or counter of a window that follows a span, counter or report made with
    no profiler running; so two windows with none of these between them
    share one record."""
    if not _profiler._is_profiler_enabled:
        _RECORD.idle = True
    return _RECORD.read()


class MetricsLogger:
    """Append-only JSONL scalar metrics with wall-clock timestamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            body = "  ".join(f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}"
                             for k, v in rec.items() if k != "wall_s")
            print(body, flush=True)
        return rec

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def snapshot_on_nonfinite(tree, dump_path: str, context: str = "") -> bool:
    """If any floating tensor leaf has a non-finite value, write the whole
    tree (on the CPU) to ``dump_path`` with ``torch.save`` and return True.
    The test runs where the leaves are: one ``isfinite().all()`` a leaf,
    stacked, and one read-back a device."""
    leaves = [(path, leaf) for path, leaf in _leaves(tree)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    finite = {}
    for device in {leaf.device for _, leaf in leaves}:
        on = [(path, leaf) for path, leaf in leaves if leaf.device == device]
        flags = torch.stack([torch.isfinite(leaf).all() for _, leaf in on]).tolist()
        finite.update((path, ok) for (path, _), ok in zip(on, flags))
    bad = [path for path, _ in leaves if not finite[path]]
    if not bad:
        return False
    os.makedirs(os.path.dirname(os.path.abspath(dump_path)), exist_ok=True)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else (
        t.detach().cpu() if isinstance(t, torch.Tensor) else t)
    torch.save({"context": context, "bad_leaves": bad, "tree": to_cpu(tree)}, dump_path)
    print(f"[snapshot] non-finite values in {bad} -> {dump_path}")
    return True
