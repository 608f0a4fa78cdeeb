"""The process-group layer of the parallel modes: the counterpart of
`initialize_distributed` and `make_mesh` (pix2pixhdaudiosr_tpu/parallel/
mesh.py:24-61) for torch.distributed.

A process started by torchrun (or any launcher that sets RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT) joins one
process group (`initialize`); without those variables, or with a
WORLD_SIZE of 1, the world is this process alone and no group is made, as
a one-device JAX run has a one-device mesh. `make_group(world, n)` gives
the first min(n, world size) ranks, over which an axis is split.

The backend is chosen, and printed:
  nccl  every rank of the host has a card of its own (`--device cuda` and
        at least LOCAL_WORLD_SIZE cards): rank r runs on cuda:LOCAL_RANK;
  gloo  ranks share a card (a `--device cuda:i` every rank names, or fewer
        cards than ranks: NCCL refuses two ranks on one device, "Duplicate
        GPU detected"), or run on the CPU.
Under gloo the compute stays on the card and only the transport differs:
all_reduce and broadcast take the device tensors (gloo supports CUDA
tensors for those two), point-to-point messages go as host copies. Under
nccl every message is a device tensor. One code path; the backend picks
the transport.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass
class World:
    """This process's place in the run: rank, size, the backend (None when
    the world is one process) and the device it computes on."""
    rank: int
    size: int
    backend: Optional[str]
    device: torch.device


def env_rank() -> int:
    """RANK of the launcher's environment (0 without one): known before
    the process group exists, e.g. to let rank 0 alone write a file."""
    return int(os.environ.get("RANK", "0"))


def initialize(device: torch.device, timeout_s: float = 900.0) -> World:
    """Join the launcher's process group (once; a second call reuses it)
    and map this rank to its device. `device`: the run's --device."""
    env = os.environ
    size = int(env.get("WORLD_SIZE", "1"))
    if size <= 1:
        return World(0, 1, None, device)
    rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    if device.type == "cuda":
        if device.index is None and torch.cuda.device_count() >= local_size:
            device, backend = torch.device("cuda", local_rank), "nccl"
        else:
            device, backend = torch.device("cuda", device.index or 0), "gloo"
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
    shared = " (ranks share the card)" if (
        backend == "gloo" and device.type == "cuda") else ""
    print(f"distributed: rank {rank} of {size} on {device}, backend "
          f"{backend}{shared}")
    return World(rank, size, backend, device)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Group:
    """Ranks 0..size-1 of the world, over which an axis (frames for CP,
    resblock channels for TP) is split; `rank` is this process's place in
    it. A rank of the world beyond `size` is no member (`member` False) and
    calls none of the collectives. With size 1 every collective is the
    identity and nothing is sent."""

    def __init__(self, world: World, size: int, pg=None):
        self.world, self.size, self.pg = world, size, pg
        self.rank = world.rank
        self.member = world.rank < size
        self.host_wire = world.backend == "gloo"
        self._traffic = {}

    def _count(self, kind: str, *tensors: torch.Tensor) -> None:
        n, b = self._traffic.get(kind, (0, 0))
        self._traffic[kind] = (n + 1, b + sum(t.numel() * t.element_size()
                                              for t in tensors))

    def traffic(self) -> dict:
        """What this rank sent since `reset_traffic`, by kind (exchange,
        all_reduce, broadcast, gather): calls and bytes."""
        return {k: dict(calls=n, bytes=b) for k, (n, b) in self._traffic.items()}

    def reset_traffic(self) -> None:
        self._traffic.clear()

    # -- collectives on device tensors ------------------------------------
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM of t over the group, in t's dtype (gloo reduces bf16
        CUDA tensors too: PyTorch 2.11 on an H100), layout and device."""
        if self.size == 1:
            return t
        channels_last = t.dim() == 4 and not t.is_contiguous() and \
            t.is_contiguous(memory_format=torch.channels_last)
        buf = (t.permute(0, 2, 3, 1) if channels_last else t).contiguous()
        self._count("all_reduce", buf)
        dist.all_reduce(buf, group=self.pg)
        return buf.permute(0, 3, 1, 2) if channels_last else buf

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t of rank `src` on every rank (in place; t contiguous)."""
        if self.size > 1:
            self._count("broadcast", t)
            dist.broadcast(t, src, group=self.pg)
        return t

    # -- point-to-point ---------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.host_wire else t

    def exchange(self, to_left: torch.Tensor, to_right: torch.Tensor
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Send `to_left` to rank - 1 and `to_right` to rank + 1; return
        (from_left, from_right), what rank - 1 sent right and rank + 1 sent
        left, each None at a global end. The shards are equal-sized, so a
        message from the left is shaped as `to_right`."""
        r, n = self.rank, self.size
        ops, recv = [], {}
        if r + 1 < n:
            ops.append(dist.P2POp(dist.isend, self._wire(to_right), r + 1,
                                  self.pg))
            recv["right"] = self._wire(torch.empty_like(
                to_left, memory_format=torch.contiguous_format))
            ops.append(dist.P2POp(dist.irecv, recv["right"], r + 1, self.pg))
        if r > 0:
            ops.append(dist.P2POp(dist.isend, self._wire(to_left), r - 1,
                                  self.pg))
            recv["left"] = self._wire(torch.empty_like(
                to_right, memory_format=torch.contiguous_format))
            ops.append(dist.P2POp(dist.irecv, recv["left"], r - 1, self.pg))
        if ops:
            self._count("exchange", *(op.tensor for op in ops
                                      if op.op is dist.isend))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        dev = to_left.device
        return tuple(recv[k].to(dev) if k in recv else None
                     for k in ("left", "right"))

    def gather_to_first(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's t (equal shapes) on rank 0, in rank order; None on
        the other ranks."""
        if self.size == 1:
            return [t]
        if self.rank != 0:
            self._count("gather", t)
            dist.send(self._wire(t), 0, group=self.pg)
            return None
        out = [t]
        for src in range(1, self.size):
            buf = self._wire(torch.empty_like(
                t, memory_format=torch.contiguous_format))
            dist.recv(buf, src, group=self.pg)
            out.append(buf.to(t.device))
        return out


def make_group(world: World, n: int) -> Group:
    """The group of the first min(n, world size) ranks, as the JAX package
    takes min(n, len(jax.devices())) devices. Every rank of the world calls
    it (a process group of a subset is made collectively)."""
    n = max(1, min(n, world.size))
    pg = None
    if n > 1:
        pg = dist.group.WORLD if n == world.size else dist.new_group(
            list(range(n)))
    return Group(world, n, pg)
