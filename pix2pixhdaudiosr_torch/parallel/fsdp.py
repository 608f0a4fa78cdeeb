"""FSDP / ZeRO-3 parameter and optimizer-state sharding (--fsdp): the
counterpart of pix2pixhdaudiosr_tpu/parallel/fsdp.py.

Parameters and Adam moments are both sharded over the mesh's `data` axis
by ZeRO's rule (parallel/zero.py `shard_dim`), whose grad reduction and
sliced Adam FSDP shares. Between steps a rank holds only its slice of
each sharded leaf, for parameters and moments alike: the parameter's
storage is freed (a 0-element tensor) and the slice lives in a tensor of
its own, which the Adam steps. A step gathers every net's full weights
before the forward (one all_gather a bucket), reduce-scatters the sharded
leaves' grads as ZeRO-1 does, steps Adam on the slices and frees the
weights again. The gather is whole-step, not per module: the JAX package's XLA
gathers per layer, which a later slice may add. The step equals the
replicated one: the slices' grads are the averaged grads' slices and Adam
is elementwise.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from .dp import opt_bytes
from .mesh import DataLayout
from .zero import ZeroParallel, gather_along


class FSDPParallel(ZeroParallel):
    """FSDP: ZeRO's sharded moments, and the parameters sharded too."""

    mode = "fsdp"
    publish = False

    def setup(self, state) -> None:
        super().setup(state)
        self._free()

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
        for p in self._split():
            p.data = p.data.new_empty(0)

    def begin_step(self, state) -> None:
        self._gather()

    def end_step(self, state) -> None:
        self._free()

    @contextlib.contextmanager
    def full_state(self, state) -> Iterator[None]:
        self._gather()
        try:
            with super().full_state(state):
                yield
        finally:
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
