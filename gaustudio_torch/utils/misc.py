"""Misc helpers (port of gaustudio_tpu/utils/misc.py)."""

from __future__ import annotations

import os


def searchForMaxIteration(folder: str) -> int:
    """Largest ``iteration_<n>`` under ``folder``."""
    saved_iters = [int(fname.split("_")[-1]) for fname in os.listdir(folder)]
    return max(saved_iters)
