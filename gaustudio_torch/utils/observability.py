"""Metrics and failure detection (port of gaustudio_tpu/utils/observability.py).

* ``MetricsLogger``: append-only JSONL scalar metrics (loss, PSNR, point
  count, densify counts) with wall-clock timestamps;
* ``snapshot_on_nonfinite``: when any tensor of a nested dict / list is
  non-finite, ``torch.save`` the whole tree for offline repro.

The profiler helpers ``trace`` and ``annotate`` come with a later slice.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch


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
    tree (on the CPU) to ``dump_path`` with ``torch.save`` and return True."""
    bad = [path for path, leaf in _leaves(tree)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if not bad:
        return False
    os.makedirs(os.path.dirname(os.path.abspath(dump_path)), exist_ok=True)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else (
        t.detach().cpu() if isinstance(t, torch.Tensor) else t)
    torch.save({"context": context, "bad_leaves": bad, "tree": to_cpu(tree)}, dump_path)
    print(f"[snapshot] non-finite values in {bad} -> {dump_path}")
    return True
