"""Data parallelism of the train step: the counterpart of the JAX
package's data mesh (parallel/mesh.py `make_data_mesh`, `shard_batch`;
train_loop.py:102-109), under which a train step is one global-batch step.

Each rank of the layout's `data` group holds its equal share of the global
batch's rows (train_loop's Loader decodes only those). The step's encode
normalizes and draws over the whole batch (`SpectroCodec.to_spectro`'s
group); each rank's losses are local means, so the global loss is their
mean and its grad the mean of the ranks' grads. After the backward, every
grad of G, netE and every discriminator is averaged over the mesh's ranks
(a SUM all-reduce of a few flat buffers a net, then / N), and every rank
steps the same Adam on the same grads, which keeps the parameters equal:
`check_replicas` holds them (and every buffer) to rank 0's at setup. Ranks
of one data index on other axes of a 2-D mesh compute the same rows, as
JAX replicates over them; averaging over every rank of the mesh gives the
data mean on each.

`DataParallel` is the strategy the train step calls (trainer.py:
`begin_step`, `reduce_grads`, `end_step`); parallel/zero.py (ZeRO-1) and
parallel/fsdp.py (FSDP) refine it.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator, List, Sequence

import torch

from ..trainer import make_optimizer
from .mesh import DataLayout, Group

# elements of a flat buffer of a bucketed collective (256 MB in f32)
BUCKET = 1 << 26


def buckets(sizes: Sequence[int], limit: int = BUCKET) -> List[List[int]]:
    """Consecutive indices of `sizes` grouped into runs of at most `limit`
    elements (a larger one alone)."""
    out, cur, n = [], [], 0
    for i, size in enumerate(sizes):
        if cur and n + size > limit:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += size
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Group,
                     n: int) -> None:
    """In place: each tensor becomes its SUM over `group` divided by n, the
    tensors flattened into a few buffers (one all-reduce a bucket)."""
    if group.size == 1:
        return
    for idx in buckets([t.numel() for t in tensors]):
        flat = group.all_reduce_sum(torch.cat(
            [tensors[i].reshape(-1) for i in idx]))
        flat.div_(n)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def trained_nets(system) -> Dict[str, torch.nn.Module]:
    """Every net the two Adams train, by its param-tree key (G, E, D,
    time_D, hifigan_D)."""
    return {**system.g_nets(), **system.d_nets()}


def named_state(system) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the trained nets, "<key>.<name>"."""
    return {f"{key}.{n}": t for key, net in trained_nets(system).items()
            for n, t in itertools.chain(net.named_parameters(),
                                        net.named_buffers())}


@torch.no_grad()
def check_replicas(tensors: Dict[str, torch.Tensor], group: Group) -> None:
    """Raise RuntimeError on every rank unless each tensor equals rank 0's
    (broadcast from rank 0 and compared bit for bit)."""
    if group.size == 1:
        return
    differ = []
    for name, t in tensors.items():
        ref = t.detach().clone(memory_format=torch.contiguous_format)
        group.broadcast(ref, 0)
        if not torch.equal(ref, t):
            differ.append(name)
    if group.agree(bool(differ)):
        raise RuntimeError(
            f"rank {group.rank}: the replicas differ from rank 0's"
            + (f" at {differ[:4]}" if differ else " (on another rank)"))


def opt_bytes(opt) -> int:
    """Bytes of an optimizer's moments held by this rank."""
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for k, t in st.items() if torch.is_tensor(t) and k != "step")


class DataParallel:
    """Plain data parallelism: parameters and Adam moments whole on every
    rank, grads averaged over the mesh (module docstring)."""

    mode = "dp"

    def __init__(self, layout: DataLayout):
        self.layout = layout
        self.members, self.data = layout.members, layout.data

    def setup(self, state) -> None:
        """Attach to a train state whose nets hold the same values on every
        rank (the same seed, or the same checkpoint), and check that they
        do."""
        state.system.data_group = self.data
        check_replicas(named_state(state.system), self.members)
        state.parallel = self

    def _params(self, state) -> List[torch.nn.Parameter]:
        return [p for net in trained_nets(state.system).values()
                for p in net.parameters()]

    def reduce_grads(self, state) -> None:
        """Average every grad the backward left over the mesh."""
        all_reduce_mean_([p.grad for p in self._params(state)
                          if p.grad is not None],
                         self.members, self.members.size)

    def grad_holder(self, p: torch.nn.Parameter) -> torch.Tensor:
        """The tensor whose .grad holds p's grad between the backward and
        reduce_grads: p (FSDP: a sharded leaf's slice)."""
        return p

    def begin_step(self, state) -> None:
        """Before a step's forward (ZeRO-1 and FSDP drop the slices' grads)."""

    def end_step(self, state) -> None:
        """After a step's optimizers (FSDP frees the weights here)."""

    def make_optimizer(self, params, cfg, lr=None):
        return make_optimizer(params, cfg, lr)

    @contextlib.contextmanager
    def full_state(self, state) -> Iterator[None]:
        """Within it, the nets and both optimizers' state_dict() are whole
        on every rank (collective: every rank enters it), for a save or the
        eval."""
        yield

    def held_bytes(self, state) -> Dict[str, int]:
        """Bytes this rank holds between steps: parameters, Adam moments."""
        return dict(params=sum(p.numel() * p.element_size()
                               for p in self._params(state)),
                    moments=opt_bytes(state.opt_g) + opt_bytes(state.opt_d))


def apply_dp(state, layout: DataLayout) -> DataParallel:
    """Make `state` a data-parallel train state over `layout`."""
    par = DataParallel(layout)
    par.setup(state)
    return par


def pool_rows(pool, fake_pair: torch.Tensor, group: Group) -> torch.Tensor:
    """The fake pool under data parallelism: every rank gathers the global
    fake pair, queries its pool (the same seed on every rank, so the same
    state) with it and keeps its own rows, so the pool draws exactly what
    a one-process pool draws. Returns this rank's pooled rows on the
    host."""
    pooled = torch.from_numpy(pool.query(
        group.all_gather(fake_pair).cpu().numpy()))
    return pooled.chunk(group.size)[group.rank] if group.size > 1 else pooled
