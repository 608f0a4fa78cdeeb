"""The process-group layer of the parallel modes: the counterpart of
`initialize_distributed`, `make_mesh` and `make_data_mesh`
(pix2pixhdaudiosr_tpu/parallel/mesh.py:24-81) for torch.distributed.

A process started by torchrun (or any launcher that sets RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT) joins one
process group (`initialize`); without those variables, or with a
WORLD_SIZE of 1, the world is this process alone and no group is made, as
a one-device JAX run has a one-device mesh. `make_group(world, n)` gives
the first min(n, world size) ranks, over which an axis is split;
`make_data_layout` lays the ranks out on the training mesh (--mesh_shape,
--mesh_axes) and gives the group that splits the batch;
`make_serving_layout` lays them out on a 2-D data x cp serving mesh
(parallel/halo.py, `make_cp_generator`'s `batch_group`).

The backend is chosen, and printed:
  nccl  every rank of the host has a card of its own (`--device cuda` and
        at least LOCAL_WORLD_SIZE cards): rank r runs on cuda:LOCAL_RANK;
  gloo  ranks share a card (a `--device cuda:i` every rank names, or fewer
        cards than ranks: NCCL refuses two ranks on one device, "Duplicate
        GPU detected"), or run on the CPU.
Under gloo the compute stays on the card and only the transport differs:
all_reduce and broadcast take the device tensors (gloo supports CUDA
tensors for those two), point-to-point messages and all_gather go as host
copies, and a reduce-scatter is an all_reduce of which each rank keeps its
slice. Under nccl every message is a device tensor (all_gather_into_tensor,
reduce_scatter_tensor). One code path; the backend picks the transport.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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
    """Ranks of the world over which an axis (frames for CP, resblock
    channels for TP, the batch for DP) is split: the first `size` ranks, or
    the world ranks `ranks` in their order; `rank` is this process's place
    in it. A rank of the world outside it is no member (`member` False) and
    calls none of the collectives. With size 1 every collective is the
    identity and nothing is sent."""

    def __init__(self, world: World, size: int, pg=None,
                 ranks: Optional[Sequence[int]] = None):
        self.ranks = list(range(size) if ranks is None else ranks)
        self.world, self.size, self.pg = world, len(self.ranks), pg
        self.member = world.rank in self.ranks
        self.rank = self.ranks.index(world.rank) if self.member else world.rank
        self.host_wire = world.backend == "gloo"
        self._traffic = {}

    def _count(self, kind: str, *tensors: torch.Tensor) -> None:
        n, b = self._traffic.get(kind, (0, 0))
        self._traffic[kind] = (n + 1, b + sum(t.numel() * t.element_size()
                                              for t in tensors))

    def traffic(self) -> dict:
        """What this rank sent since `reset_traffic`, by kind (exchange,
        all_reduce, broadcast, gather, all_gather, reduce_scatter): calls
        and bytes."""
        return {k: dict(calls=n, bytes=b) for k, (n, b) in self._traffic.items()}

    def reset_traffic(self) -> None:
        self._traffic.clear()

    # -- collectives on device tensors ------------------------------------
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        channels_last = t.dim() == 4 and not t.is_contiguous() and \
            t.is_contiguous(memory_format=torch.channels_last)
        buf = (t.permute(0, 2, 3, 1) if channels_last else t).contiguous()
        self._count("all_reduce", buf)
        dist.all_reduce(buf, op=op, group=self.pg)
        return buf.permute(0, 3, 1, 2) if channels_last else buf

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM of t over the group, in t's dtype (gloo reduces bf16
        CUDA tensors too: PyTorch 2.11 on an H100), layout and device."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise MAX of t over the group (as all_reduce_sum)."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_reduce_min(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise MIN of t over the group (as all_reduce_sum)."""
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's t (equal shapes) concatenated along `dim` in rank
        order, on t's device. Under gloo the shards travel as host copies."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        self._count("all_gather", x)
        if self.host_wire:
            parts = [torch.empty_like(x, device="cpu") for _ in self.ranks]
            dist.all_gather(parts, x.cpu(), group=self.pg)
            out = torch.cat(parts).to(t.device)
        else:
            out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=self.pg)
        return out.movedim(0, dim)

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice, along `dim` (of size divisible by the group's),
        of the SUM of t over the group. Under gloo: an all_reduce of t of
        which this rank keeps its slice."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter over {self.size} ranks of a dim "
                             f"of {x.shape[0]}")
        self._count("reduce_scatter", x)
        if self.host_wire:
            dist.all_reduce(x, group=self.pg)
            out = x.chunk(self.size)[self.rank]
        else:
            out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, group=self.pg)
        return out.movedim(0, dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t of the group's rank `src` on every rank (in place; t
        contiguous)."""
        if self.size > 1:
            self._count("broadcast", t)
            dist.broadcast(t, self.ranks[src], group=self.pg)
        return t

    def agree(self, flag: bool) -> bool:
        """Whether any rank of the group passes True (a MAX all-reduce of
        one flag; on the host under gloo)."""
        if self.size == 1:
            return bool(flag)
        dev = "cpu" if self.host_wire else self.world.device
        return bool(self.all_reduce_max(torch.tensor(
            [int(flag)], dtype=torch.int32, device=dev)).item())

    def barrier(self) -> None:
        """Wait for every rank of the group."""
        if self.size > 1:
            self.agree(False)

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
        r, n, peer = self.rank, self.size, self.ranks
        ops, recv = [], {}
        if r + 1 < n:
            ops.append(dist.P2POp(dist.isend, self._wire(to_right),
                                  peer[r + 1], self.pg))
            recv["right"] = self._wire(torch.empty_like(
                to_left, memory_format=torch.contiguous_format))
            ops.append(dist.P2POp(dist.irecv, recv["right"], peer[r + 1],
                                  self.pg))
        if r > 0:
            ops.append(dist.P2POp(dist.isend, self._wire(to_left),
                                  peer[r - 1], self.pg))
            recv["left"] = self._wire(torch.empty_like(
                to_right, memory_format=torch.contiguous_format))
            ops.append(dist.P2POp(dist.irecv, recv["left"], peer[r - 1],
                                  self.pg))
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
            dist.send(self._wire(t), self.ranks[0], group=self.pg)
            return None
        out = [t]
        for src in self.ranks[1:]:
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


def _subgroups(world: World, parts: List[List[int]]) -> Group:
    """The group of `parts` (disjoint lists of world ranks) that holds this
    rank; where none does, the first part, of which this rank is no member.
    Every rank of the world calls it with the same parts: each process
    group is made collectively, in the same order on every rank."""
    mine = Group(world, len(parts[0]), ranks=parts[0])
    for ranks in parts:
        pg = None
        if len(ranks) > 1:
            pg = dist.group.WORLD if len(ranks) == world.size else \
                dist.new_group(ranks)
        if world.rank in ranks:
            mine = Group(world, len(ranks), pg, ranks)
    return mine


@dataclass
class DataLayout:
    """This rank's place on the training mesh: `shape` over `axes` (one of
    them "data"), the world's ranks laid out row-major. `data` splits the
    global batch (its rank is this rank's data index); `replica` holds the
    ranks of this data index on the other axes, which compute the same
    rows, as JAX replicates over them; `members` is every rank of the mesh.
    A rank beyond the mesh sits out (`member` False)."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    members: Group
    data: Group
    replica: Group

    @property
    def member(self) -> bool:
        return self.members.member


def _resolve_shape(world_size: int, batch_size: int, mesh_shape, axes
                   ) -> Tuple[int, ...]:
    """The mesh shape make_data_mesh builds on `world_size` devices."""
    if "data" not in axes:
        raise SystemExit(f"--mesh_axes {','.join(axes)} has no 'data' axis: "
                         f"the training mesh splits the batch over 'data'")
    if len(mesh_shape) != len(axes):
        raise SystemExit(f"--mesh_shape {mesh_shape} and --mesh_axes {axes} "
                         f"differ in length")
    if tuple(mesh_shape) == (-1,) and tuple(axes) == ("data",):
        # the largest divisor of the batch that fits the devices
        n = world_size
        d = math.gcd(batch_size, n)
        while (d < n and batch_size % d == 0 and d * 2 <= n
               and batch_size % (d * 2) == 0):
            d *= 2
        return (max(1, math.gcd(batch_size, d)),)
    shape = list(mesh_shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1) or 1
        shape[shape.index(-1)] = world_size // known
    if math.prod(shape) > world_size:
        raise SystemExit(f"--mesh_shape {','.join(map(str, mesh_shape))} "
                         f"needs {math.prod(shape)} ranks, the world has "
                         f"{world_size}")
    return tuple(shape)


def make_data_layout(world: World, batch_size: int,
                     mesh_shape: Sequence[int] = (-1,),
                     mesh_axes: Sequence[str] = ("data",)) -> DataLayout:
    """The training mesh of make_data_mesh (the JAX package's
    parallel/mesh.py:51-81) over the world's ranks: with the default shape
    (-1,) over ("data",), the largest divisor of the batch that fits the
    world, the ranks beyond it sitting out; else exactly `mesh_shape`, a -1
    taking what the other axes leave of the world. Stops (SystemExit,
    naming the flags) on axes without "data", a mesh larger than the world
    or a batch the data axis does not divide. Every rank calls it."""
    axes = tuple(mesh_axes)
    shape = _resolve_shape(world.size, batch_size, tuple(mesh_shape), axes)
    d_axis = axes.index("data")
    if batch_size % shape[d_axis]:
        raise SystemExit(f"--batchSize {batch_size} is not divisible by the "
                         f"mesh's data axis of {shape[d_axis]} ranks "
                         f"(--mesh_shape {','.join(map(str, shape))})")
    total = math.prod(shape)
    coords = [tuple(int(c) for c in _unravel(r, shape)) for r in range(total)]
    by_rest, by_data = {}, {}
    for r, c in enumerate(coords):
        by_rest.setdefault(c[:d_axis] + c[d_axis + 1:], []).append(r)
        by_data.setdefault(c[d_axis], []).append(r)
    return DataLayout(shape, axes,
                      members=_subgroups(world, [list(range(total))]),
                      data=_subgroups(world, list(by_rest.values())),
                      replica=_subgroups(world, list(by_data.values())))


@dataclass
class ServingLayout:
    """This rank's place on a dp x cp serving mesh (`shape`, axes ("data",
    "cp")): `cp` holds the ranks of its data row, over which the frames are
    split (the halo exchanges and the InstanceNorm moments' all-reduce stay
    inside it); `data` the ranks of its column, over which the batch is
    split. A rank beyond the mesh is a member of neither."""
    shape: Tuple[int, int]
    data: Group
    cp: Group


def make_serving_layout(world: World, dp: int, cp: int) -> ServingLayout:
    """The dp x cp serving mesh over the world's first dp * cp ranks, laid
    out row-major as make_data_layout lays out its axes (the JAX package's
    make_mesh((dp, cp), ("data", "cp"))): rank d * cp + c holds data index d
    and frame shard c. Every rank calls it (each process group is made
    collectively, in the same order on every rank); a mesh larger than the
    world is refused (ValueError)."""
    total = dp * cp
    if dp < 1 or cp < 1 or total > world.size:
        raise ValueError(f"a {dp} x {cp} data x cp mesh needs {total} ranks, "
                         f"the world has {world.size}")
    rows = [list(range(d * cp, (d + 1) * cp)) for d in range(dp)]
    cols = [list(range(c, total, cp)) for c in range(cp)]
    return ServingLayout((dp, cp), data=_subgroups(world, cols),
                         cp=_subgroups(world, rows))


def _unravel(r: int, shape: Tuple[int, ...]) -> List[int]:
    """Row-major coordinates of index r in `shape`."""
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return out[::-1]
