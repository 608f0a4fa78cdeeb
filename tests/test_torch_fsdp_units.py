"""The port's FSDP (parallel/fsdp.py, --fsdp) gathers a unit at a time, on
the CPU over gloo: one world of 2 ranks (tests/torch_parallel_cases.py,
case_fsdp_units) runs the toy train step (TRAIN, global batch 4) under
replicated DP and under FSDP from one seeded init, 2 steps each: plain,
--remat_g full and dots, the niter_fix_global phase, the fake pool's split
steps, bf16 compute, the time-D + match recipe, the HiFi-GAN D (one step:
its four members all read D's input) and Family A's netE. Each
FSDP run equals its DP run within test_torch_zero_fsdp.py's bounds, holds
at most the two largest units' bytes gathered at any moment, keeps no
whole grad of a sharded leaf beyond its unit's backward, and makes the same
collectives on both ranks. And the 730M default G (G9L3 at ngf 64): the
port's shard_dim splits the axis the JAX package's fsdp.param_shardings
splits, leaf by leaf, at 2, 4 and 8 ranks (one jax.eval_shape)."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_cases as cases  # noqa: E402
from test_torch_zero_fsdp import _same_run, _torch_name  # noqa: E402

from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.parallel.fsdp import param_shardings  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from pix2pixhdaudiosr_torch.convert import jax_layout  # noqa: E402
from pix2pixhdaudiosr_torch.models.generator import build_generator  # noqa: E402
from pix2pixhdaudiosr_torch.parallel.zero import shard_dim  # noqa: E402

BATCH, SEG, N = 4, 480, 2
RUNS = ["plain", "remat_full", "remat_dots", "fix_global", "pool", "bf16",
        "time_d_match", "hifigan", "family_a"]
# the reference's default generator: --netG local at its defaults
G730 = ["--netG", "local", "--input_nc", "2", "--output_nc", "2",
        "--label_nc", "0", "--no_instance", "--explicit_encoding"]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    job = dict(batch={k: (rng.standard_normal((BATCH, SEG)) * 0.2)
                      .astype(np.float32) for k in ("label", "image")},
               noise=[np.random.default_rng(30 + i).standard_normal(
                   (BATCH, int(64 * (1 - 1 / 6.0)), 16, 2)).astype(np.float32)
                   for i in range(2)],
               fsdp_runs=RUNS)
    return [r["fsdp_units"] for r in cases.run_world(N, job, ["fsdp_units"],
                                                     timeout=240)]


@pytest.mark.parametrize("run", RUNS)
def test_per_unit_step_matches_replicated(world, run):
    """Each run's FSDP steps against the replicated ones over the same 2
    ranks, on both ranks: losses rtol 1e-4, parameters atol 1e-6, moments
    rtol 1e-6, after each step (test_torch_zero_fsdp.py's bounds)."""
    for r in world:
        _same_run(r[run]["fsdp"], r[run]["dp"])


@pytest.mark.parametrize("run", RUNS)
def test_gathered_peak_within_two_units(world, run):
    """The bytes of gathered weights and their casts alive on a rank never
    exceed the two largest units' (f32) bytes, and the weights travel a
    unit at a time: more all_gathers than units, and a reduce-scatter for
    each unit of a step's backward."""
    for r in world:
        units = r[run]["fsdp"]["units"]
        sizes = sorted(units["bytes"].values())
        assert 0 < units["peak"] <= sizes[-1] + sizes[-2], units["peak"]
        calls = {k: v["calls"] for k, v in units["traffic"].items()}
        assert calls["all_gather"] > len(sizes), calls
        assert calls["reduce_scatter"] >= len(sizes), calls


@pytest.mark.parametrize("run", RUNS)
def test_no_whole_grad_outlives_its_unit(world, run):
    """Whenever a sharded leaf's grad accumulates, the whole grads alive on
    the rank are one unit's at most: each unit's are reduce-scattered
    into the slices as soon as they are all there, and none is left for
    reduce_grads."""
    for r in world:
        units = r[run]["fsdp"]["units"]
        assert units["grads_alive"] == 1, units["grads_alive"]
        assert units["leftover"] == 0


@pytest.mark.parametrize("run", RUNS)
def test_ranks_make_the_same_collectives(world, run):
    """Both ranks make the same collectives, kind by kind, in calls and
    bytes: the hooks fire in the graph's order on each."""
    assert world[0][run]["fsdp"]["units"]["traffic"] == \
        world[1][run]["fsdp"]["units"]["traffic"]


@pytest.fixture(scope="module")
def g730_shapes():
    """The JAX package's G9L3@64 param tree, shapes only."""
    jsys = JSystem(jparse([*G730, "--batchSize", "1"], is_train=True,
                          save=False))
    return jax.eval_shape(lambda k: jsys.init_params(k, batch=1),
                          jax.random.PRNGKey(0))["G"]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_dim_matches_param_shardings_g730(g730_shapes, n):
    """At the 730M default G (730,713,346 parameters), the dim the port's
    shard_dim splits of each parameter (a state_dict key, in the port's
    layout) is the one the JAX package's fsdp.param_shardings splits of
    the flax leaf, at n ranks, through convert.py's names; and the port's
    G has every one of those leaves, at their shapes."""
    shapes = g730_shapes
    specs = param_shardings(shapes, Mesh(np.array(jax.devices()[:n]),
                                         ("data",)))
    port = build_generator("local", 2, 2, 64, 4, 9, 1, 3, device="meta")
    port_shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_of = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: hasattr(x, "spec"))
    assert sum(int(np.prod(leaf.shape)) for _, leaf in leaves) == 730_713_346
    assert len(leaves) == len(spec_of) == len(port_shapes)
    split = 0
    for (path, leaf), sharding in zip(leaves, spec_of):
        name = _torch_name(path)
        perm = jax_layout(name, len(leaf.shape))
        torch_shape = tuple(leaf.shape[j] for j in perm)
        assert port_shapes[name] == torch_shape, name
        spec = tuple(sharding.spec)
        want = spec.index("data") if "data" in spec else None
        got = shard_dim(name, torch_shape, n)
        assert (None if got is None else perm[got]) == want, name
        split += want is not None
    assert split > 0.9 * len(leaves)
