"""Tracing, metrics and failure detection (port of
gaustudio_tpu/utils/observability.py).

* ``trace``: a block profiled with ``torch.profiler`` (CPU, and CUDA on the
  card), written as one Chrome / Perfetto trace file; ``annotate``: a named
  region inside it;
* ``MetricsLogger``: append-only JSONL scalar metrics (loss, PSNR, point
  count, densify counts) with wall-clock timestamps;
* ``snapshot_on_nonfinite``: when any tensor of a nested dict / list is
  non-finite, ``torch.save`` the whole tree for offline repro.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

from gaustudio_torch.utils.misc import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, name: str = "gaustudio", device=None):
    """Profile the block with torch.profiler inside a ``name`` region and
    write one Chrome / Perfetto trace file into ``log_dir`` (open it in
    ui.perfetto.dev or chrome://tracing). Records CPU activity, and CUDA
    activity when ``device`` (None: the current CUDA device, as every entry
    point resolves it) is a card. Yields the trace file's path."""
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
    with profile(activities=activities) as prof:
        with record_function(name):
            yield path
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """A named region inside an active trace."""
    from torch.profiler import record_function

    with record_function(name):
        yield


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
