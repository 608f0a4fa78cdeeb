"""FSDP / ZeRO-3 parameter and optimizer-state sharding (--fsdp): the
counterpart of pix2pixhdaudiosr_tpu/parallel/fsdp.py.

Parameters and Adam moments are both sharded over the mesh's `data` axis
by ZeRO's rule (parallel/zero.py `shard_dim`), whose sliced Adam FSDP
shares. A rank holds only its slice of each sharded leaf, which the Adam
steps; the parameter itself keeps no storage of its own but while one of
its units runs. As the JAX package's XLA gathers each weight where its
consumer needs it, in the forward and again in the backward, and
reduce-scatters the grads, a step here gathers one *unit* at a time:

  units   each ResnetBlock and each other child of the generators (the
          trunk's head, downs and deconvs, the enhancer's convs, the final
          conv), of netE likewise, and each discriminator's scales (the
          HiFi-GAN D's MSD and MPD members) (`units_of`);
  forward a pre-hook gathers the unit's slices (one all_gather a bucket,
          zero.gather_along) into its parameters' storage; under autocast
          the unit makes the compute-dtype copy of each conv weight and
          bias itself (the cast autocast would make, so the same numbers,
          but one it can free: autocast caches a parameter's cast until its
          context exits) and frees the f32 weights at once; after the
          forward every gathered or cast byte is freed, and the storage of
          what autograd saved is resized to 0;
  backward the first grad to reach one of the unit's outputs regathers it
          and refills the saved storages; once every sharded leaf of the
          unit has its grad (a post-accumulate hook), the unit's grads are
          reduce-scattered into the slices (ZeroParallel.scatter_grads) and
          its storages freed again. A backward that does not accumulate the
          unit's grads (the G loss through D, torch.autograd.grad) frees it
          when the grad of its input is done, or at the backward's end.
          A use is done, and frees the unit unless another use holds it,
          when the grad of its input is (each forward takes its args
          through views of its own, whose grads are this use's share
          alone), or when every node of its graph that hands a grad to
          one of the unit's leaves has run. So a HiFi-GAN D member closes
          when its own backward is done: not when the last of the members
          that read D's input is (the G loss through D), nor when the
          forward on the other half of the pair is (the D loss).

`--remat_g` re-runs G's forward inside the backward: the pre-hooks gather
again there, and the copies the recompute saves join the unit's backward.
Every collective comes in the graph's order, the same on every rank. The
counter `gathered_bytes` (with its peak, `gathered_peak`) holds the bytes
of gathered weights and their casts alive on the rank: at most the two
largest units' f32 bytes. Between steps a sharded parameter is a
0-element tensor. The step equals the replicated one: the slices' grads
are the averaged grads' slices and Adam is elementwise.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn as nn

from ..models.generator import GlobalTrunk
from .dp import opt_bytes, trained_nets
from .mesh import DataLayout
from .zero import ZeroParallel, gather_along


def units_of(system) -> List[Tuple[str, nn.Module]]:
    """The FSDP units of a train state's nets, by name, in forward order:
    each child of a generator, netE and each discriminator, the global
    trunk's own children one by one."""
    out = []
    for key, net in trained_nets(system).items():
        for name, child in net.named_children():
            if isinstance(child, GlobalTrunk):
                out += [(f"{key}.{name}.{n}", c)
                        for n, c in child.named_children()]
            else:
                out.append((f"{key}.{name}", child))
    return out


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of a (nested) forward output or argument tuple."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _alias(t: torch.Tensor) -> torch.Tensor:
    """t's memory under a version counter of its own: writing it leaves
    t's version, which autograd checks on what it saved, as it is."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), t.storage_offset(), t.shape, t.stride())


class _Cast:
    """A compute-dtype copy a unit made of one of its leaves: a weak
    reference to it, its bytes, the leaf, and whether its storage is
    filled (and counted)."""

    __slots__ = ("ref", "nbytes", "leaf", "held")

    def __init__(self, c: torch.Tensor, leaf: torch.Tensor, died):
        self.ref = weakref.ref(c, lambda _, rec=self: died(rec))
        self.nbytes, self.leaf, self.held = c.untyped_storage().nbytes(), leaf, True


class _Use:
    """One forward of a unit whose graph autograd keeps, with the casts it
    made. pending: after its forward; open: from the first grad of its
    outputs; closed: done; adopted: made by a recompute inside a
    backward, opened with the unit's next use."""

    __slots__ = ("unit", "casts", "state", "waiting")

    def __init__(self, unit: "_Unit", casts: List[_Cast]):
        self.unit, self.casts, self.state = unit, casts, "pending"
        self.waiting = 0              # its nodes that grad a leaf, yet to run


class _Unit:
    """A group of sharded leaves gathered together: `params`; `slots` the
    (module, key, leaf) of those a conv module reads as its weight or bias,
    which the unit casts itself under autocast; `direct` whether another
    sharded leaf is read by the forward itself (it stays gathered through
    the forward and the backward)."""

    def __init__(self, name: str, module: nn.Module, params: list,
                 meta: dict):
        self.name, self.module, self.params = name, module, params
        ids = {id(p) for p in params}
        self.slots = [(m, k, p) for m in module.modules()
                      if isinstance(m, nn.modules.conv._ConvNd)
                      for k, p in m._parameters.items()
                      if p is not None and id(p) in ids]
        self.direct = len(self.slots) < len(params)
        self.nbytes = sum(meta[id(p)][0].numel() * p.element_size()
                          for p in params)
        self.filled = False
        self.casts: list = []         # (cast, _Cast) of the forward in flight
        self.open: List[_Use] = []
        self.adopt: List[_Use] = []
        self.done = set()             # its leaves whose grad accumulated


class FSDPParallel(ZeroParallel):
    """FSDP: ZeRO's sharded moments, the parameters sharded too and
    gathered a unit at a time (module docstring)."""

    mode = "fsdp"
    publish = False

    def setup(self, state) -> None:
        super().setup(state)
        self.whole = False
        self.gathered_bytes = self.gathered_peak = 0
        self._task = None
        self.units, seen = [], set()
        for name, module in units_of(state.system):
            params = [p for p in module.parameters()
                      if id(p) in self.shard and id(p) not in seen]
            seen.update(id(p) for p in params)
            if params:
                self.units.append(_Unit(name, module, params, self.meta))
        missing = [self.names[id(p)] for p in self._split()
                   if id(p) not in seen]
        if missing:
            raise ValueError(f"--fsdp: sharded leaves outside every unit: "
                             f"{missing[:4]}")
        for unit in self.units:
            unit.module.register_forward_pre_hook(
                lambda m, args, u=unit: self._pre_forward(u, args))
            unit.module.register_forward_hook(
                lambda m, args, out, u=unit: self._post_forward(u, args, out))
            for p in unit.params:
                p.register_post_accumulate_grad_hook(
                    lambda p, u=unit: self._accumulated(u, p))
        self._free()

    def unit_bytes(self) -> Dict[str, int]:
        """Each unit's sharded leaves' bytes, whole."""
        return {u.name: u.nbytes for u in self.units}

    def reset_gathered_peak(self) -> None:
        self.gathered_peak = self.gathered_bytes

    def _count(self, n: int) -> None:
        self.gathered_bytes += n
        self.gathered_peak = max(self.gathered_peak, self.gathered_bytes)

    # -- a unit's storage -----------------------------------------------------
    @torch.no_grad()
    def _fill(self, unit: _Unit) -> None:
        """Gather the unit's leaves into their own storage (one all_gather
        a bucket), unless they hold it."""
        if unit.filled:
            return
        fulls = gather_along(self.data,
                             [self.shard[id(p)] for p in unit.params],
                             [self.dim[id(p)] for p in unit.params])
        for p, full in zip(unit.params, fulls):
            shape, stride = self.meta[id(p)]
            if p.numel() == 0:            # its first gather of the step
                p.data = torch.empty_strided(shape, stride, dtype=full.dtype,
                                             device=full.device)
            else:
                p.untyped_storage().resize_(shape.numel() * p.element_size())
            _alias(p).copy_(full)
        unit.filled = True
        self._count(unit.nbytes)

    def _release(self, unit: _Unit) -> None:
        """Free the unit's gathered leaves (their shapes stay, for what
        autograd saved and for the grads' layout)."""
        if unit.filled:
            for p in unit.params:
                p.untyped_storage().resize_(0)
            unit.filled = False
            self._count(-unit.nbytes)

    def _free_casts(self, casts: List[_Cast]) -> None:
        for rec in casts:
            c = rec.ref()
            if c is not None and rec.held:
                c.untyped_storage().resize_(0)
                rec.held = False
                self._count(-rec.nbytes)

    @torch.no_grad()
    def _refill_casts(self, casts: List[_Cast]) -> None:
        for rec in casts:
            c = rec.ref()
            if c is not None and not rec.held:
                c.untyped_storage().resize_(rec.nbytes)
                _alias(c).copy_(rec.leaf)
                rec.held = True
                self._count(rec.nbytes)

    def _cast_died(self, rec: _Cast) -> None:
        """Autograd let a cast go (its node has run) with its storage."""
        if rec.held:
            rec.held = False
            self._count(-rec.nbytes)

    @staticmethod
    def _unswap(unit: _Unit) -> None:
        for m, key, p in unit.slots:
            m._parameters[key] = p

    # -- the hooks --------------------------------------------------------------
    def _pre_forward(self, unit: _Unit, args: tuple):
        """Gather the unit and cast its conv leaves under autocast; where
        autograd records, the forward's args, each tensor that needs a grad
        as a view of its own, whose grad is this use's share alone."""
        if self.whole:
            return None
        self._unswap(unit)
        self._fill(unit)
        dev = unit.params[0].device.type
        dtype = (torch.get_autocast_dtype(dev)
                 if torch.is_autocast_enabled(dev) else None)
        unit.casts = []
        if dtype is not None and dtype != unit.params[0].dtype and unit.slots:
            for m, key, p in unit.slots:
                c = p.to(dtype)
                m._parameters[key] = c
                unit.casts.append((c, _Cast(c, p, self._cast_died)))
                self._count(unit.casts[-1][1].nbytes)
            if not unit.direct and not unit.open:
                self._release(unit)
        if not torch.is_grad_enabled():
            return None
        return tuple(a.view_as(a) if torch.is_tensor(a) and a.requires_grad
                     else a for a in args)

    def _post_forward(self, unit: _Unit, args, output) -> None:
        if self.whole:
            return
        self._unswap(unit)
        casts = [rec for _, rec in unit.casts]
        unit.casts = []
        outs = [t for t in _tensors(output) if t.requires_grad]
        use = None
        if outs and torch.is_grad_enabled():
            use = _Use(unit, casts)
            for t in outs:
                t.register_hook(lambda g, u=use: self._open(u))
            for t in _tensors(args):
                if t.requires_grad:
                    t.register_hook(lambda g, u=use: self._close_use(u))
            feeders = self._feeders(unit, outs, args)
            use.waiting = len(feeders)
            for node in feeders:
                node.register_hook(lambda gi, go, u=use: self._fed(u))
            if unit.open:       # a recompute inside the unit's own backward
                use.state = "open"
                unit.open.append(use)
            elif torch._C._current_graph_task_id() != -1:
                use.state = "adopted"      # a recompute: what it saved is
                unit.adopt.append(use)     # the original forward's
        if use is None or use.state != "open":
            self._free_casts(casts)
        if not unit.open:
            self._release(unit)

    @torch.no_grad()
    def _open(self, use: _Use) -> None:
        """The unit's backward begins: regather it and refill what its
        forwards saved."""
        if use.state != "pending":
            return
        unit = use.unit
        uses, unit.adopt = [use, *unit.adopt], []
        unit.open += uses
        casts = [rec for u in uses for rec in u.casts if rec.ref() is not None]
        # a use without casts (f32) saved the leaves themselves
        keep = unit.direct or not all(u.casts for u in unit.open)
        if keep or casts:
            self._fill(unit)
        for u in uses:
            u.state = "open"
        self._refill_casts(casts)
        if not keep:
            self._release(unit)
        task = torch._C._current_graph_task_id()
        if task != self._task:
            self._task = task
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_of_backward)

    def _close(self, unit: _Unit) -> None:
        """The unit's backward is done: free everything it holds."""
        for u in unit.open:
            u.state = "closed"
            self._free_casts(u.casts)
        unit.open = []
        self._release(unit)

    def _close_use(self, use: _Use) -> None:
        """The grad of one of a use's inputs is done, so is its backward."""
        unit = use.unit
        if use.state == "open":
            use.state = "closed"
            unit.open.remove(use)
            self._free_casts(use.casts)
            if not unit.open:
                self._release(unit)

    @staticmethod
    def _feeders(unit: _Unit, outs, args) -> list:
        """The nodes of a use's graph that hand a grad to one of the unit's
        leaves (an edge to its AccumulateGrad), walked from the outputs'
        nodes back to the args' and the leaves'."""
        leaves = {id(p) for p in unit.params}
        stop = {t.grad_fn for t in _tensors(args) if t.grad_fn is not None}
        todo = [t.grad_fn for t in outs if t.grad_fn is not None]
        seen, found = set(), []
        while todo:
            node = todo.pop()
            if node in seen or node in stop:
                continue
            seen.add(node)
            feeds = False
            for nxt, _ in node.next_functions:
                if nxt is None:
                    continue
                if hasattr(nxt, "variable"):
                    feeds |= id(nxt.variable) in leaves
                else:
                    todo.append(nxt)
            if feeds:
                found.append(node)
        return found

    def _fed(self, use: _Use) -> None:
        """One more node of the use that grads its leaves has run; once
        every one has, its backward is done."""
        use.waiting -= 1
        if use.waiting == 0:
            self._close_use(use)

    def _accumulated(self, unit: _Unit, p: torch.Tensor) -> None:
        """p's grad is whole: once all of the unit's are, reduce-scatter
        them into the slices and free the unit."""
        unit.done.add(id(p))
        if len(unit.done) == len(unit.params):
            unit.done.clear()
            self.scatter_grads([q for q in unit.params if q.grad is not None])
            self._close(unit)

    def _end_of_backward(self) -> None:
        """What a backward left open (a unit whose grads it did not
        accumulate and whose input needs none), closed at its end; and a
        unit's own parameters back where a recompute that stopped inside
        its forward (torch.utils.checkpoint's early stop) left its casts."""
        for unit in self.units:
            self._unswap(unit)
            unit.adopt = []
            if unit.open:
                self._close(unit)

    # -- the step ---------------------------------------------------------------
    @torch.no_grad()
    def _gather(self) -> None:
        split = self._split()
        fulls = gather_along(self.data, [self.shard[id(p)] for p in split],
                             [self.dim[id(p)] for p in split])
        for p, full in zip(split, fulls):
            shape, stride = self.meta[id(p)]
            p.data = torch.empty_strided(shape, stride, dtype=full.dtype,
                                         device=full.device).copy_(full)

    def _free(self) -> None:
        """Every sharded parameter a 0-element tensor, every unit empty."""
        for p in self._split():
            p.data = p.data.new_empty(0)
        for unit in self.units:
            self._unswap(unit)
            unit.filled, unit.casts, unit.open, unit.adopt = False, [], [], []
            unit.done.clear()
        self.gathered_bytes = 0

    def grad_holder(self, p: nn.Parameter) -> torch.Tensor:
        return self.shard.get(id(p), p)

    def end_step(self, state) -> None:
        self._free()

    @contextlib.contextmanager
    def full_state(self, state) -> Iterator[None]:
        """Every parameter whole, and the units' hooks idle, while inside."""
        self._gather()
        self.whole = True
        try:
            with super().full_state(state):
                yield
        finally:
            self.whole = False
            self._free()

    def held_bytes(self, state) -> Dict[str, int]:
        return dict(params=sum(t.numel() * t.element_size() for t in
                               (*self.params, *self.shard.values())),
                    moments=opt_bytes(state.opt_g) + opt_bytes(state.opt_d))


def apply_fsdp(state, layout: DataLayout) -> FSDPParallel:
    """Make `state` an FSDP train state over `layout`."""
    par = FSDPParallel(layout)
    par.setup(state)
    return par
