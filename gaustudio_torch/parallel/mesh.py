"""Process groups, the ("dp", "gs") device mesh and its collectives (port of
gaustudio_tpu/parallel/mesh.py).

One process per rank. ``init_distributed`` joins the process group that
torchrun's environment describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or a group of one
without it. ``LOCAL_RANK`` picks the card. The backend follows one rule:

  * NCCL where each rank has its own card;
  * gloo on the CPU;
  * gloo where ranks share one card, because NCCL refuses two ranks on one
    device. The compute stays on the card: only the collectives go
    through gloo.

Rows are split over gs as ``torch.tensor_split`` splits them: the first
N mod gs ranks hold one more row. ``all_gather_into_tensor`` needs equal
sizes, so ``Collectives.gather_rows`` pads only the send buffer and cuts the
gathered result.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gaustudio_torch.utils.misc import resolve_device


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where it is given, else the card that
    ``LOCAL_RANK`` names (modulo the cards this process sees, so ranks may
    share one); raises without a card, as utils.misc.resolve_device does."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)  # raises where torch sees no CUDA device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def choose_backend(device: torch.device) -> str:
    """NCCL where each local rank has its own card, gloo otherwise (the CPU,
    or ranks that share a card)."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(device=None) -> torch.device:
    """Join the process group (once a process) and return this rank's device.

    Under torchrun the group is the one its environment describes; a process
    started without ``MASTER_ADDR`` joins a group of one. Rank 0 prints the
    backend the rule chose."""
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # the kernels launch on the current device
    if not dist.is_initialized():
        backend = choose_backend(device)
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        if dist.get_rank() == 0:
            shared = " (ranks share a card)" if device.type == "cuda" and backend == "gloo" else ""
            print(f"torch.distributed: backend {backend}{shared}, world {dist.get_world_size()}, "
                  f"device {device.type}", flush=True)
    return device


def make_mesh(dp: Optional[int] = None, gs: int = 1, device=None) -> DeviceMesh:
    """A ("dp", "gs") mesh over the ranks of the process group.

    ``dp`` defaults to world // gs. With one rank this is a valid 1x1 mesh,
    so every parallel code path runs unchanged. ``device`` as for
    :func:`rank_device` (None: the card ``LOCAL_RANK`` names)."""
    device = init_distributed(device)
    world = dist.get_world_size()
    if dp is None:
        dp = world // gs
    if dp * gs != world:
        raise ValueError(f"mesh {dp}x{gs} != {world} ranks")
    return init_device_mesh(device.type, (dp, gs), mesh_dim_names=("dp", "gs"))


def shard_info(mesh: DeviceMesh) -> Tuple[int, int]:
    return mesh.size(0), mesh.size(1)


def row_counts(num_rows: int, parts: int) -> List[int]:
    """Rows of each part, as ``torch.tensor_split(x, parts)`` splits them."""
    return [num_rows // parts + (1 if i < num_rows % parts else 0) for i in range(parts)]


def row_range(num_rows: int, parts: int, index: int) -> Tuple[int, int]:
    counts = row_counts(num_rows, parts)
    lo = sum(counts[:index])
    return lo, lo + counts[index]


class Collectives:
    """The collectives of one ("dp", "gs") mesh, on this rank's device.

    ``nbytes`` counts the bytes this rank hands to the collectives (each
    send buffer once), for the bytes-per-step figure of a run."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.dp, self.gs = shard_info(mesh)
        self.dp_rank = mesh.get_local_rank("dp")
        self.gs_rank = mesh.get_local_rank("gs")
        self.dp_group = mesh.get_group("dp")
        self.gs_group = mesh.get_group("gs")
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))
        self.nbytes = 0

    def own_rows(self, num_rows: int) -> Tuple[int, int]:
        """This rank's [lo, hi) rows of ``num_rows`` split over gs."""
        return row_range(num_rows, self.gs, self.gs_rank)

    def gather_rows(self, x: torch.Tensor, num_rows: int) -> torch.Tensor:
        """The [num_rows, ...] concatenation over gs of each rank's rows
        ``x`` (rank i holds row_counts(num_rows, gs)[i] of them)."""
        if self.gs == 1:
            return x
        counts = row_counts(num_rows, self.gs)
        width = counts[0]
        send = x.contiguous()
        if send.shape[0] < width:  # pad the send buffer only
            send = torch.cat([send, send.new_zeros((width - send.shape[0],) + send.shape[1:])])
        out = send.new_empty((self.gs * width,) + send.shape[1:])
        self.nbytes += send.numel() * send.element_size()
        dist.all_gather_into_tensor(out, send, group=self.gs_group)
        if counts[-1] == width:
            return out
        return torch.cat([out[i * width:i * width + c] for i, c in enumerate(counts)])

    def gather_dp(self, x: torch.Tensor) -> torch.Tensor:
        """The concatenation over dp of each rank's ``x`` (equal shapes)."""
        if self.dp == 1:
            return x
        send = x.contiguous()
        out = send.new_empty((self.dp * send.shape[0],) + send.shape[1:])
        self.nbytes += send.numel() * send.element_size()
        dist.all_gather_into_tensor(out, send, group=self.dp_group)
        return out

    def sum_dp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over dp, in place."""
        return self._all_reduce(x, dist.ReduceOp.SUM, self.dp_group, self.dp)

    def max_dp(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum of ``x`` over dp, in place."""
        return self._all_reduce(x, dist.ReduceOp.MAX, self.dp_group, self.dp)

    def _all_reduce(self, x, op, group, size) -> torch.Tensor:
        if size == 1:
            return x
        self.nbytes += x.numel() * x.element_size()
        dist.all_reduce(x, op=op, group=group)
        return x


def collectives(mesh) -> Collectives:
    """The Collectives of a DeviceMesh; a Collectives as it is (so that
    callers can share one byte count)."""
    return mesh if isinstance(mesh, Collectives) else Collectives(mesh)
