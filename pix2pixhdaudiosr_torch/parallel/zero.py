"""ZeRO-1 optimizer-state sharding (--zero_opt_state): the counterpart of
pix2pixhdaudiosr_tpu/parallel/zero.py.

The Adam moments are sharded over the mesh's `data` axis: each leaf on
its largest dim divisible by the axis size (`leaf_spec`, a copy of the
JAX package's `_leaf_spec`, applied to the leaf in the flax layout:
convert.jax_layout), every other leaf replicated. A sharded leaf's grad is
reduce-scattered into the grad of this rank's slice (SUM, then / N), a
replicated leaf's averaged as in parallel/dp.py; each rank runs Adam
(torch.optim.Adam, or AdamMuBF16 with --adam_mu_bf16) over its slices of
the sharded leaves and over the whole replicated ones; after the update
every rank rebuilds the full parameters with one all_gather a bucket.
Adam is elementwise, so the step equals the replicated one. Saves 2 * 4
bytes a parameter * (1 - 1/N). parallel/fsdp.py differs only in freeing
the full parameters between steps.

`ShardedAdam.state_dict()` gathers the moments to full size, in the
layout a one-process Adam keeps them, so a save writes the one-process
file; `load_state_dict` takes that format and keeps this rank's slices (a
resume re-shards).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn as nn

from ..convert import jax_layout
from ..utils.checkpoint import d_params, g_params
from .dp import DataParallel, all_reduce_mean_, buckets
from .mesh import DataLayout, Group

MOMENTS = ("exp_avg", "exp_avg_sq")


def leaf_spec(shape: Sequence[int], n: int, axis: str = "data") -> tuple:
    """Shard the largest dim divisible by the axis size; replicate
    otherwise: the partition spec as a tuple (() replicates), as the JAX
    package's _leaf_spec gives it."""
    if not shape:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n == 0 and shape[i] >= n:
            spec = [None] * len(shape)
            spec[i] = axis
            return tuple(spec)
    return ()


def shard_dim(name: str, shape: Sequence[int], n: int) -> Optional[int]:
    """The dim of the tensor `name` (a state_dict key) that leaf_spec
    shards over n ranks, decided on the flax layout of the leaf so that
    both packages split the same axis; None: replicated."""
    if n == 1:
        return None
    perm = jax_layout(name, len(shape))
    spec = leaf_spec([shape[perm.index(j)] for j in range(len(shape))], n)
    return perm.index(spec.index("data")) if spec else None


def piece(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's slice of t along dim (a view)."""
    return t.chunk(group.size, dim)[group.rank]


def gather_along(group: Group, pieces: Sequence[torch.Tensor],
                 dims: Sequence[int]) -> List[torch.Tensor]:
    """Every rank's pieces[i] concatenated along dims[i] in rank order, the
    pieces flattened into a few buffers (one all_gather a bucket)."""
    n, out = group.size, [None] * len(pieces)
    for idx in buckets([p.numel() for p in pieces]):
        flat = group.all_gather(torch.cat([pieces[i].reshape(-1)
                                           for i in idx])).view(n, -1)
        off = 0
        for i in idx:
            k, shape = pieces[i].numel(), pieces[i].shape
            out[i] = torch.cat([flat[j, off:off + k].view(shape)
                                for j in range(n)], dims[i])
            off += k
    return out


def scatter_along(group: Group, fulls: Sequence[torch.Tensor],
                  dims: Sequence[int]) -> List[torch.Tensor]:
    """This rank's slice along dims[i] of the SUM of fulls[i] over the
    group: one reduce-scatter a bucket of rows [N, pieces]."""
    n, out = group.size, [None] * len(fulls)
    for idx in buckets([f.numel() for f in fulls]):
        rows = torch.stack([torch.cat([fulls[i].chunk(n, dims[i])[j]
                                       .reshape(-1) for i in idx])
                            for j in range(n)])
        mine = group.reduce_scatter_sum(rows, 0).reshape(-1)
        off = 0
        for i in idx:
            shape = fulls[i].chunk(n, dims[i])[0].shape
            k = shape.numel()
            out[i] = mine[off:off + k].view(shape)
            off += k
    return out


class ShardedAdam:
    """An Adam over this rank's slices of the sharded leaves and over the
    whole replicated ones; to its callers (trainer, utils/checkpoint) it
    is the one-process Adam over `model_params`: `param_groups` (the
    learning rate), `step()`, and `state_dict()` / `load_state_dict()` in
    the one-process format (moments gathered / sliced).

    params: the model's parameters, whole; dims: each one's shard dim or
    None; shards: the tensors the inner Adam steps (this rank's slice, or
    the parameter itself where dim is None), whose grads the strategy's
    reduce_grads sets; meta: the whole parameters' (shape, stride); gather:
    rebuild the parameters after a step (ZeRO-1; FSDP gathers them before
    the next forward instead)."""

    def __init__(self, params: Sequence[nn.Parameter],
                 dims: Sequence[Optional[int]], group: Group,
                 make_inner: Callable, shards: Sequence[torch.Tensor],
                 meta: Sequence[tuple], gather: bool = True):
        self.model_params, self.dims, self.group = list(params), list(dims), group
        self.shards, self.meta, self.gather = list(shards), list(meta), gather
        self.inner = make_inner(self.shards)
        self._full = None

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def _split(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d is not None]

    @torch.no_grad()
    def step(self) -> None:
        self.inner.step()
        for i in self._split():
            self.shards[i].grad = None
        if self.gather:
            self.publish()

    @torch.no_grad()
    def publish(self) -> None:
        """Rebuild every sharded parameter from the ranks' slices."""
        idx = self._split()
        fulls = gather_along(self.group, [self.shards[i] for i in idx],
                             [self.dims[i] for i in idx])
        for i, full in zip(idx, fulls):
            self.model_params[i].copy_(full)

    def _like(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """t (whole) in the layout of parameter i, as a one-process Adam
        keeps its moments."""
        shape, stride = self.meta[i]
        return torch.empty_strided(shape, stride, dtype=t.dtype,
                                   device=t.device).copy_(t)

    def state_dict(self) -> dict:
        """The one-process Adam's state_dict: every rank's moments gathered
        to full size (collective: every rank calls it), or the copy that
        `hold_full` keeps."""
        if self._full is not None:
            return self._full
        sd = self.inner.state_dict()
        state = {i: dict(st) for i, st in sd["state"].items()}
        idx = [i for i in self._split() if i in state]
        for key in MOMENTS:
            fulls = gather_along(self.group, [state[i][key] for i in idx],
                                 [self.dims[i] for i in idx])
            for i, full in zip(idx, fulls):
                state[i][key] = self._like(i, full)
        return {"state": state, "param_groups": sd["param_groups"]}

    @contextlib.contextmanager
    def hold_full(self) -> Iterator[None]:
        """Keep the gathered state_dict while inside (collective)."""
        self._full = self.state_dict()
        try:
            yield
        finally:
            self._full = None

    def load_state_dict(self, sd: dict) -> None:
        """Take a one-process Adam's state_dict, keeping this rank's slice
        of each sharded leaf's moments."""
        state = {}
        for i, st in sd["state"].items():
            d = self.dims[int(i)]
            state[int(i)] = st if d is None else {
                k: piece(v, d, self.group).contiguous() if k in MOMENTS else v
                for k, v in st.items()}
        self.inner.load_state_dict({"state": state,
                                    "param_groups": sd["param_groups"]})


def named_params(system) -> Dict[int, str]:
    """Every trained parameter's checkpoint name, by id."""
    return {id(p): n for named in (g_params(system), d_params(system))
            for n, p in named.items()}


class ZeroParallel(DataParallel):
    """ZeRO-1: Adam moments sharded over `data`, each sharded leaf's grad
    reduce-scattered into its slice (module docstring)."""

    mode = "zero"
    # rebuild the full parameters after each step (FSDP: before the next)
    publish = True

    def setup(self, state) -> None:
        super().setup(state)
        self.names = named_params(state.system)
        self.params = self._params(state)
        self.meta = {id(p): (p.shape, p.stride()) for p in self.params}
        self.dim = {id(p): shard_dim(self.names[id(p)], p.shape,
                                     self.data.size) for p in self.params}
        self.shard = {id(p): nn.Parameter(piece(p.detach(), d, self.data)
                                          .contiguous())
                      for p in self.params
                      if (d := self.dim[id(p)]) is not None}
        state.opt_g = self.reshard(state.opt_g, state.system.cfg)
        state.opt_d = self.reshard(state.opt_d, state.system.cfg)

    def _split(self) -> List[nn.Parameter]:
        return [p for p in self.params if id(p) in self.shard]

    def make_optimizer(self, params, cfg, lr=None):
        params = list(params)
        make = super().make_optimizer
        return ShardedAdam(
            params, [self.dim[id(p)] for p in params], self.data,
            lambda sh: make(sh, cfg, lr),
            [self.shard.get(id(p), p) for p in params],
            [self.meta[id(p)] for p in params], gather=self.publish)

    @torch.no_grad()
    def reduce_grads(self, state) -> None:
        """The replicated leaves' grads averaged as DP's; each sharded
        leaf's grad reduce-scattered into its slice's grad (over the
        replicas first on a 2-D mesh), the full grad dropped."""
        n = self.members.size
        whole = [p for p in self.params
                 if id(p) not in self.shard and p.grad is not None]
        all_reduce_mean_([p.grad for p in whole], self.members, n)
        split = [p for p in self._split() if p.grad is not None]
        grads = [p.grad for p in split]
        if self.layout.replica.size > 1:
            all_reduce_mean_(grads, self.layout.replica, 1)
        pieces = scatter_along(self.data, grads,
                               [self.dim[id(p)] for p in split])
        for p, g in zip(split, pieces):
            self.shard[id(p)].grad = g.div_(n)
            p.grad = None

    def reshard(self, opt, cfg) -> ShardedAdam:
        """A ShardedAdam over `opt`'s parameters carrying its state and
        learning rate (a one-process Adam, e.g. one just restored)."""
        params = [p for g in opt.param_groups for p in g["params"]]
        new = self.make_optimizer(params, cfg, opt.param_groups[0]["lr"])
        new.load_state_dict(opt.state_dict())
        return new

    @contextlib.contextmanager
    def full_state(self, state) -> Iterator[None]:
        with state.opt_g.hold_full(), state.opt_d.hold_full():
            yield


def apply_zero(state, layout: DataLayout) -> ZeroParallel:
    """Make `state` a ZeRO-1 train state over `layout`."""
    par = ZeroParallel(layout)
    par.setup(state)
    return par
