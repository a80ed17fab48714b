"""Misc helpers (port of gaustudio_tpu/utils/misc.py), and the device rule
of the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; where it is None, the current CUDA device.

    The port's entry points run on the card unless the caller asks for the
    CPU. Where torch sees no CUDA device this raises rather than fall back:
    a CPU caller passes ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available: pass device="cpu" to run on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


def get_rank() -> int:
    """This process's rank: from the launcher's environment (RANK,
    LOCAL_RANK, SLURM_PROCID, JSM_NAMESPACE_RANK), else the process group's
    rank, else 0."""
    for key in ("RANK", "LOCAL_RANK", "SLURM_PROCID", "JSM_NAMESPACE_RANK"):
        rank = os.environ.get(key)
        if rank is not None:
            return int(rank)
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def searchForMaxIteration(folder: str) -> int:
    """Largest ``iteration_<n>`` under ``folder``."""
    saved_iters = [int(fname.split("_")[-1]) for fname in os.listdir(folder)]
    return max(saved_iters)
