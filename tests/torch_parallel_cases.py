"""Multi-rank cases of the port's parallel modes, run on the CPU over gloo
(tests/test_torch_cp.py, tests/test_torch_tp.py, tests/test_torch_dp.py,
tests/test_torch_zero_fsdp.py).

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
    world = mesh.initialize(torch.device(job.get("device", "cpu")))
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
    """This rank's equal share of x along `dim` (all of it without a
    group)."""
    if group is None:
        return x
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


# --------------------------------------------------------------------------
# The training half: data parallelism, ZeRO-1 and FSDP of the toy train step
# (TRAIN: TOY's LocalEnhancer and the 3-layer PatchGAN at ndf 4).
TRAIN = ["--netG", "local", *TOY, "--ndf", "4", "--n_layers_D", "3"]


def train_state(batch: int, extra=(), params=None, adam=None, seed: int = 3,
                device: str = "cpu"):
    """A toy training system on `device` and its fresh train state (seeded init,
    or the torch state_dicts `params` = {"G": ..., "D": ...}; `adam`:
    {"G": (mu, nu, count), "D": ...} as optax trees, installed with
    convert.load_adam_state)."""
    from pix2pixhdaudiosr_torch import trainer
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.convert import load_adam_state
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    cfg = parse_config([*TRAIN, "--batchSize", str(batch), *extra],
                       is_train=True, save=False)
    system = Pix2PixHDSystem(cfg, device=device)
    state = trainer.init_state(system, seed)
    nets = {"G": system.netG_train, "D": system.netD}
    for key, sd in (params or {}).items():
        nets[key].load_state_dict(sd)
    for key, (mu, nu, count) in (adam or {}).items():
        load_adam_state(state.opt_g if key == "G" else state.opt_d,
                        nets[key], mu, nu, count)
        state.step = int(count)
    return state


def train_rows(job, group) -> dict:
    """This rank's rows of the job's global batch (all of it in one
    process)."""
    return {k: block_of(torch.tensor(v), group, 0).to(job.get("device", "cpu"))
            for k, v in job["batch"].items()}


def read_state(state) -> dict:
    """Parameters and Adam moments by name ("G.<p>", "D.<p>"; moments under
    "opt_g." / "opt_d."), whole, as numpy: collective under a sharded
    strategy (every rank calls it)."""
    import contextlib
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    par = state.parallel
    with par.full_state(state) if par else contextlib.nullcontext():
        system = state.system
        out = {f"G.{k}": v.detach().cpu().numpy().copy()
               for k, v in system.netG_train.state_dict().items()}
        out.update({f"D.{k}": v.detach().cpu().numpy().copy()
                    for k, v in system.netD.state_dict().items()})
        for tag, opt, named in (("opt_g", state.opt_g,
                                 ckpt.g_params(system)),
                                ("opt_d", state.opt_d,
                                 ckpt.d_params(system))):
            sd = opt.state_dict()
            names = ckpt._param_names(opt, named)
            for i, st in sd["state"].items():
                for k in ("exp_avg", "exp_avg_sq"):
                    out[f"{tag}.{k}.{names[i]}"] = st[k].float().cpu().numpy().copy()
    return out


def shard_shapes(state) -> dict:
    """The shape of the tensor each G/D parameter's Adam steps on this rank
    (its slice under ZeRO and FSDP), by "G.<p>" / "D.<p>"."""
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    out = {}
    for key, opt, named in (("G", state.opt_g, ckpt.g_params(state.system)),
                            ("D", state.opt_d, ckpt.d_params(state.system))):
        names = ckpt._param_names(opt, named)
        out.update({f"{key}.{n}": tuple(t.shape)
                    for n, t in zip(names, opt.shards)})
    return out


def train_run(group, job, mode: str = "dp", extra=(), mesh_shape=(-1,),
              mesh_axes=("data",), steps: int = 2, first_noise: int = 0,
              params=None, adam=None, pool: int = 0, resume=None, save=None):
    """`steps` toy train steps of the job's global batch (job["batch"],
    numpy [B, S]) under `mode` (dp, zero, fsdp; "one": this process alone,
    no strategy, `group` unused), step i with the global mask noise
    job["noise"][first_noise + i]: {"losses": [per step], "states":
    [read_state after each step], "step"; under a strategy "held"
    (held_bytes between steps), and under ZeRO / FSDP "shards"
    (shard_shapes); in one process without the pool, "grads" (step_grads
    after the first step) and "void" (void_of)}; None on a rank outside
    the mesh. With `pool`: the
    fake pool's split steps (--pool_size pool), the pool queried through
    parallel.dp.pool_rows. `resume`: a directory whose `latest` is
    restored into another init (seed 99) before the strategy, as
    train_loop does ("step_before": its step count); `save`: a directory
    that one process writes `latest` into after the steps."""
    from pix2pixhdaudiosr_torch import trainer
    from pix2pixhdaudiosr_torch.parallel import mesh as M
    from pix2pixhdaudiosr_torch.parallel.dp import apply_dp, pool_rows
    from pix2pixhdaudiosr_torch.parallel.fsdp import apply_fsdp
    from pix2pixhdaudiosr_torch.parallel.zero import apply_zero
    from pix2pixhdaudiosr_torch.utils.image_pool import ImagePool
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    batch, device = len(job["batch"]["label"]), job.get("device", "cpu")
    state = train_state(batch, extra, params, adam, device=device,
                        seed=99 if resume else 3)
    if resume:
        ckpt.load_train_state(state, "latest", resume)
    step_before = state.step
    data = M.Group(M.World(0, 1, None, torch.device(device)), 1)
    if mode != "one":
        layout = M.make_data_layout(group.world, batch, mesh_shape, mesh_axes)
        if not layout.member:
            return None
        {"dp": apply_dp, "zero": apply_zero, "fsdp": apply_fsdp}[mode](
            state, layout)
        data = layout.data
    rows = train_rows(job, data)
    noises = [torch.tensor(n, device=device) for n in job["noise"][first_noise:]]
    losses, states = [], []
    if pool:
        g_step, d_step = trainer.make_pool_steps(state.system)
        image_pool = ImagePool(pool, 5)
        for i in range(steps):
            lg, aux = g_step(state, rows, noises[i])
            pooled = pool_rows(image_pool, aux["fake_pair"], data)
            ld = d_step(state, rows, noises[i], pooled)
            losses.append({**{k: float(v) for k, v in lg.items()},
                           **{f"d.{k}": float(v) for k, v in ld.items()}})
            states.append(read_state(state))
    else:
        step = trainer.make_train_step(state.system)
        for i in range(steps):
            lo, _ = step(state, rows, noises[i])
            losses.append({k: float(v) for k, v in lo.items()})
            states.append(read_state(state))
            if i == 0 and mode == "one":
                grads = step_grads(state.system)
    if save:
        ckpt.save_train_state(state, save, "latest")
    out = {"losses": losses, "states": states, "step": state.step,
           "step_before": step_before}
    if mode == "one" and not pool:
        out.update(grads=grads, void=void_of(state.system))
    if state.parallel is not None:
        out["held"] = state.parallel.held_bytes(state)
        if mode != "dp":
            out["shards"] = shard_shapes(state)
    return out


def step_grads(system) -> dict:
    """The grads a step left on G's and D's parameters, by "G.<p>" /
    "D.<p>", as numpy (in one process: under ZeRO and FSDP a sharded
    leaf's full grad is dropped after the reduction)."""
    return {f"{key}.{n}": q.grad.detach().cpu().numpy().copy()
            for key, net in (("G", system.netG_train), ("D", system.netD))
            for n, q in net.named_parameters()}


def void_of(system) -> set:
    """The conv biases of G and D that feed an InstanceNorm, by "G.<p>" /
    "D.<p>": their exact grad is 0, what a step computes there rounding."""
    from chip_smoke import norm_fed_biases
    return norm_fed_biases(system.netG_train, "G.") | \
        norm_fed_biases(system.netD, "D.")


def close_params(got, want, grads, void, big_tol, all_tol):
    """Every parameter within all_tol; where the leaf's grad is above 1e-3
    of its max|g| (a bias feeding an InstanceNorm excepted), big_tol."""
    for name, g in grads.items():
        a = np.abs(g)
        big = (a > 1e-3 * a.max()) & (name not in void)
        diff = np.abs(got[name] - want[name])
        assert diff[big].max(initial=0) <= big_tol, name
        assert diff.max() <= all_tol, name


def close_moments(got, want, void):
    """exp_avg within 1e-3, exp_avg_sq within 2e-3 of the leaf's max|m|
    (of its net's max for a bias feeding an InstanceNorm)."""
    names = [k for k in want if k.startswith("opt_")]
    assert names and set(names) == {k for k in got if k.startswith("opt_")}
    net_max = {}
    for k in names:
        tag, m, _ = k.split(".", 2)
        net_max[tag, m] = max(net_max.get((tag, m), 0), np.abs(want[k]).max())
    for k in names:
        tag, m, param = k.split(".", 2)
        leaf = ("G." if tag == "opt_g" else "D.") + param
        scale = net_max[tag, m] if leaf in void else np.abs(want[k]).max()
        tol = 1e-3 if m == "exp_avg" else 2e-3
        assert np.abs(got[k] - want[k]).max() <= tol * scale + 1e-30, k


def case_dp_steps(group, job):
    """DP of the toy step from the job's params (the JAX init): at 4
    ranks, at 2 (--mesh_shape 2: ranks 2 and 3 sit out) and on a 2 x 2
    data x model mesh, 2 steps each; at 4 ranks one step from the JAX
    state after step 1 (params1, adam1) with the second noise; and 2 fake
    pool steps (--pool_size 2) at 4 ranks."""
    p = job["params"]
    return {"dp4": train_run(group, job, params=p),
            "dp2": train_run(group, job, mesh_shape=(2,), params=p),
            "dp2x2": train_run(group, job, mesh_shape=(2, 2),
                               mesh_axes=("data", "model"), params=p),
            "from1": train_run(group, job, steps=1, first_noise=1,
                               params=job["params1"], adam=job["adam1"]),
            "pool": train_run(group, job, params=p, pool=2)}


def case_sharded_steps(group, job):
    """2 toy steps of the job's batch at 2 ranks: replicated (DP), ZeRO-1,
    FSDP, and DP and ZeRO-1 with --adam_mu_bf16, from one seeded init."""
    bf16 = ["--adam_mu_bf16"]
    return {"dp": train_run(group, job), "zero": train_run(group, job, "zero"),
            "fsdp": train_run(group, job, "fsdp"),
            "dp_bf16": train_run(group, job, extra=bf16),
            "zero_bf16": train_run(group, job, "zero", extra=bf16)}


def case_sharded_resume(group, job):
    """test_fsdp.py::test_sharded_save_restore_continues for ZeRO and FSDP
    at 2 ranks: 2 sharded steps, `latest` saved (rank 0 writes; the state
    after them and the third step uninterrupted recorded), then a fresh
    init restored from it and sharded takes the third step. And the
    reverse: a one-process run's `latest` (2 steps, rank 0 writes)
    restored into a ZeRO run for the third step."""
    from pix2pixhdaudiosr_torch import trainer
    from pix2pixhdaudiosr_torch.parallel import mesh as M
    from pix2pixhdaudiosr_torch.parallel.fsdp import apply_fsdp
    from pix2pixhdaudiosr_torch.parallel.zero import apply_zero
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    out = {}
    batch = len(job["batch"]["label"])
    for mode in ("zero", "fsdp"):
        tag_dir = os.path.join(job["dir"], mode)
        state = train_state(batch)
        layout = M.make_data_layout(group.world, batch)
        (apply_fsdp if mode == "fsdp" else apply_zero)(state, layout)
        step = trainer.make_train_step(state.system)
        rows = train_rows(job, layout.data)
        for i in range(2):
            step(state, rows, torch.tensor(job["noise"][i]))
        saved = read_state(state)
        with state.parallel.full_state(state):
            if group.world.rank == 0:
                ckpt.save_train_state(state, tag_dir, "latest")
        group.barrier()
        lo, _ = step(state, rows, torch.tensor(job["noise"][2]))
        out[mode] = {"saved": saved, "dir": tag_dir, "uninterrupted": {
            "losses": [{k: float(v) for k, v in lo.items()}],
            "states": [read_state(state)], "step": state.step},
            "resumed": None}
        out[mode]["resumed"] = train_run(group, job, mode, steps=1,
                                         first_noise=2, resume=tag_dir)
    one_dir = os.path.join(job["dir"], "one")
    if group.world.rank == 0:
        train_run(None, job, "one", save=one_dir)
    group.barrier()
    out["one_to_zero"] = train_run(group, job, "zero", steps=1, first_noise=2,
                                   resume=one_dir)
    return out


def case_dp_card(group, job):
    """2 toy DP steps on the job's device (the ranks sharing cuda:0 over
    gloo), each from the state the one-process step starts from: the
    seeded init, then job["resume"]'s `latest` (the one-process state
    after step 1)."""
    torch.backends.cudnn.allow_tf32 = False     # f32, as the one process
    return [train_run(group, job, steps=1),
            train_run(group, job, steps=1, first_noise=1,
                      resume=job["resume"])]


def case_layouts(group, job):
    """make_data_layout on this world for each of job["layouts"] (batch,
    mesh_shape, mesh_axes): (members' size, data size and rank, replica
    size and ranks, member) or the SystemExit's text."""
    from pix2pixhdaudiosr_torch.parallel import mesh as M
    out = []
    for batch, shape, axes in job["layouts"]:
        try:
            lay = M.make_data_layout(group.world, batch, shape, axes)
        except SystemExit as e:
            out.append(str(e))
            continue
        out.append(dict(shape=lay.shape, members=lay.members.size,
                        member=lay.member, data=(lay.data.size, lay.data.rank,
                                                 lay.data.ranks),
                        replica=lay.replica.ranks))
    return out


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}
