"""Multi-rank cases of the port's parallel modes, run on the CPU over gloo
(tests/test_torch_cp.py, tests/test_torch_tp.py).

`run_world(n, job, cases)` starts n ranks (torch.multiprocessing, spawn;
one thread each) that join one gloo group through the port's own
parallel.mesh.initialize, run each named case of `cases` on `job` (a dict:
seeds, toy flags, state dicts made by the test) and return every rank's
results, numpy arrays and floats keyed by case. A rank that fails, or a
world that outlives its time limit, fails the caller. This module imports
torch and the port only: the ranks never load jax.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

TOY = ["--ngf", "4", "--n_downsample_global", "2", "--n_blocks_global", "1",
       "--n_local_enhancers", "1", "--n_blocks_local", "1", "--input_nc",
       "2", "--output_nc", "2", "--label_nc", "0", "--no_instance",
       "--explicit_encoding", "--mask_mode", "mode2", "--compute_dtype",
       "float32", "--n_fft", "64", "--hop_length", "32", "--win_length", "64",
       "--segment_length", "480", "--seed", "11"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(n: int, job: dict, cases, timeout: float = 120.0):
    """Every rank's {case: result} of `cases` run on `job` by n gloo
    ranks, a list in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job.pt")
        torch.save(dict(job, cases=list(cases)), path)
        ctx = mp.start_processes(_rank_main, args=(n, free_port(), path),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{n} ranks ran past {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


def _rank_main(rank: int, n: int, port: int, path: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from pix2pixhdaudiosr_torch.parallel import mesh
    job = torch.load(path, weights_only=False)
    world = mesh.initialize(torch.device("cpu"))
    group = mesh.make_group(world, n)
    out = {name: CASES[name](group, job) for name in job["cases"]}
    torch.save(out, os.path.join(os.path.dirname(path), f"rank{rank}.pt"))
    mesh.shutdown()


def toy_system(net_g: str = "global", extra=(), device: str = "cpu",
               seed: int = 0, state=None):
    """A toy system (TOY flags), its G seeded N(0, 0.02) with N(0, 0.1)
    biases (so that a bias that feeds an InstanceNorm is not 0), or
    loaded from `state`."""
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.models.generator import init_normal_
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    cfg = parse_config(["--netG", net_g, *TOY, *extra], is_train=False,
                       save=False)
    system = Pix2PixHDSystem(cfg, device=device)
    if state is not None:
        system.netG.load_state_dict(state)
    else:
        gen = torch.Generator().manual_seed(seed)
        init_normal_(system.netG, gen)
        with torch.no_grad():
            for name, p in system.netG.named_parameters():
                if name.endswith("bias"):
                    p.normal_(0.0, 0.1, generator=gen)
    system.netG.eval()
    return system


def seeded(shape, seed: int, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def block_of(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's equal share of x along `dim`."""
    return x.chunk(group.size, dim)[group.rank].contiguous()


def gathered(t: torch.Tensor, group, dim: int = -1):
    """Every rank's t concatenated along `dim` on rank 0, else None."""
    parts = group.gather_to_first(t.contiguous())
    return None if parts is None else torch.cat(parts, dim)


# --------------------------------------------------------------------------
def case_halo(group, job):
    """halo_exchange of a block of x [1, 2, 3, 64] split on frames."""
    from pix2pixhdaudiosr_torch.parallel.halo import halo_exchange
    x = seeded((1, 2, 3, 64), 1)
    return halo_exchange(block_of(x, group), 4, group).numpy()


def case_pad(group, job):
    """cp_pad_w by 3 frames, zeros and reflect, of a block of x."""
    from pix2pixhdaudiosr_torch.parallel.halo import cp_pad_w
    x = block_of(seeded((1, 2, 3, 64), 2), group)
    return {m: cp_pad_w(x, 3, group, m).numpy() for m in ("zeros", "reflect")}


def _layers():
    """(name, module, input shape) of each layer kind with a cp path."""
    from pix2pixhdaudiosr_torch.models import layers as L
    torch.manual_seed(5)
    return [
        ("c7s1", L.ConvIN(3, 4, 7, reflect=3), (1, 3, 10, 32)),
        ("down", L.ConvIN(3, 4, 3, stride=2, pad=1), (1, 3, 9, 32)),
        ("res_half", L.ConvIN(4, 4, 3, reflect=1, act="none"), (1, 4, 8, 32)),
        ("final", L.ConvIN(4, 2, 7, reflect=3, norm=False, act="tanh"),
         (1, 4, 10, 32)),
        ("deconv", L.ConvTransposeIN(4, 3), (1, 4, 5, 32)),
        ("resblock", L.ResnetBlock(4), (2, 4, 6, 32)),
        ("pool", None, (2, 3, 9, 32)),
    ]


def case_layers(group, job):
    """Each layer on this rank's block against its slice of the unsharded
    output (rank 0): {name: (max|err|, max|y|)}; bias N(0, 1) so that it
    moves the InstanceNorm's input."""
    from pix2pixhdaudiosr_torch.models.layers import avg_pool_3s2
    from pix2pixhdaudiosr_torch.parallel.halo import set_cp
    res = {}
    for i, (name, module, shape) in enumerate(_layers()):
        x = seeded(shape, 10 + i)
        with torch.no_grad():
            if module is None:
                want = avg_pool_3s2(x)
                got = avg_pool_3s2(block_of(x, group), group)
            else:
                for p in module.parameters():
                    p.normal_(0.0, 1.0 if p.dim() == 1 else 0.2)
                want = module(x)
                got = set_cp(module, group)(block_of(x, group))
                set_cp(module, None)
        full = gathered(got, group)
        if full is not None:
            res[name] = ((full - want).abs().max().item(),
                         want.abs().max().item())
    return res


def case_torch_deconv_refused(group, job):
    """The torch-mode deconv under cp: its ValueError's text."""
    from pix2pixhdaudiosr_torch.models.layers import ConvTransposeIN
    from pix2pixhdaudiosr_torch.parallel.halo import set_cp
    m = set_cp(ConvTransposeIN(4, 3, "torch"), group)
    try:
        m(torch.zeros(1, 4, 4, 8))
    except ValueError as e:
        return str(e)
    return None


def _cp_vs_full(group, net_g, state=None, shape=(1, 64, 64, 2)):
    """The CP generator on this rank's frames, gathered, and the unsharded
    full-length forward (rank 0): (max|err|, max|y|, output)."""
    from pix2pixhdaudiosr_torch.generate import cp_forward
    from pix2pixhdaudiosr_torch.parallel.halo import make_cp_generator
    system = toy_system(net_g, state=state)
    spec = seeded(shape, 3)
    got = cp_forward(make_cp_generator(system, group), spec, group)
    if got is None:
        return None
    with torch.no_grad():
        want = system.netG(spec.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return ((got - want).abs().max().item(), want.abs().max().item(),
            got.numpy())


def case_generator(group, job):
    return {net_g: _cp_vs_full(group, net_g) for net_g in ("global", "local")}


def case_jax_generator(group, job):
    """The CP generator on JAX-initialised weights (job["jax_state"]), the
    spectrogram job["jax_spec"] (NHWC)."""
    from pix2pixhdaudiosr_torch.generate import cp_forward
    from pix2pixhdaudiosr_torch.parallel.halo import make_cp_generator
    system = toy_system("global", state=job["jax_state"])
    spec = torch.from_numpy(job["jax_spec"])
    got = cp_forward(make_cp_generator(system, group), spec, group)
    return None if got is None else got.numpy()


def case_cp_generate(group, job):
    """generate.cp_generate of the toy global system on job["lr"]."""
    from pix2pixhdaudiosr_torch.generate import cp_generate
    system = toy_system("global", extra=["--cp_shards", str(group.size)])
    return cp_generate(system, job["lr"], system.cfg, group)


def case_moments(group, job):
    """cp_instance_norm (B3's moments and apply twins around the
    all-reduce) of this rank's frames of job["in_x"] (NCHW), relu and
    none, gathered on rank 0."""
    from pix2pixhdaudiosr_torch.models.layers import cp_instance_norm
    x = torch.from_numpy(job["in_x"])
    out = {}
    for act in ("none", "relu"):
        y = gathered(cp_instance_norm(block_of(x, group), act, group), group)
        out[act] = None if y is None else y.numpy()
    return out


def case_tp_blocks(group, job):
    """Three ResnetBlocks (16 channels) sharded over the group against the
    same blocks whole, run in sequence: (max|err|, max|y|) on every rank."""
    from pix2pixhdaudiosr_torch.models.layers import ResnetBlock
    from pix2pixhdaudiosr_torch.parallel.tp import shard_generator
    torch.manual_seed(7)
    blocks = torch.nn.Sequential(*[ResnetBlock(16) for _ in range(3)])
    with torch.no_grad():
        for p in blocks.parameters():
            p.normal_(0.0, 0.1)
        x = seeded((2, 16, 8, 6), 4)
        want = blocks(x)
        whole = {k: v.clone() for k, v in blocks.state_dict().items()}
        named = torch.nn.Module()
        for i, b in enumerate(blocks):
            named.add_module(f"ResnetBlock_{i}", b)
        names = shard_generator(named, group)
        got = blocks(x)
    shapes = {k: tuple(v.shape) for k, v in blocks.state_dict().items()}
    return dict(err=(got - want).abs().max().item(),
                scale=want.abs().max().item(), names=names, shapes=shapes,
                whole={k: tuple(v.shape) for k, v in whole.items()})


def case_tp_generator(group, job):
    """The toy LocalEnhancer with its resblocks sharded over the group, on a
    seeded spectrogram, against its unsharded forward: (max|err|, max|y|),
    and B3's twin inputs by channel count (the shard's C/N)."""
    from pix2pixhdaudiosr_torch.parallel.tp import shard_generator
    system = toy_system("local")
    x = seeded((2, 2, 64, 16), 6)
    with torch.no_grad():
        want = system.netG(x)
        names = shard_generator(system.netG, group)
        got = system.netG(x)
    return dict(err=(got - want).abs().max().item(),
                scale=want.abs().max().item(), names=names)


def case_tp_generate(group, job):
    """generate.main with --tp_shards on job["wav"] (rank 0's audio)."""
    from pix2pixhdaudiosr_torch import generate
    return generate.main(job["argv"] + ["--tp_shards", str(group.size)])


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}
