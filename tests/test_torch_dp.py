"""The port's data-parallel train step (parallel/mesh.make_data_layout,
parallel/dp.py, the global-batch encode of ops/encoding.py) on the CPU
over gloo: one world of 4 ranks (tests/torch_parallel_cases.py) runs the
toy step (TRAIN: LocalEnhancer ngf 4, PatchGAN ndf 4, f32) on a global
batch of 4 at 4 ranks, at 2 (--mesh_shape 2) and on a 2 x 2 data x model
mesh, 2 steps each, and the fake pool's split steps at 4 ranks; each is
held to

  * the port's one-process step on the whole batch (same init, batch and
    mask noise): losses within rtol 1e-5; every parameter whose step-1
    grad is above 1e-3 of its leaf's max|g| within 2e-3 lr (1e-3 lr a
    step, test_torch_train_step's bound), every other within 4.2 lr (two
    Adam steps, each of at most lr and 1.054 lr at beta1 0.5, beta2
    0.999, whose direction follows the rounding where the grad is
    rounding alone: the conv biases that feed an InstanceNorm, whose
    exact grad is 0); the Adam moments within 1e-3 (first) and 2e-3
    (second) of their leaf's max (of the net's max for those biases);
  * the JAX package's make_train_step on make_mesh((4,), ("data",)) over
    the conftest's virtual CPU devices (one compile: the same step at two
    rngs), from the same params (convert.py), batch and noise, within
    tests/test_torch_train_step.py's bounds: losses rtol 1e-4, each step's
    params as its _check_params reads them (step 2 from JAX's state after
    step 1, moments carried over), the moments after it within 1e-3 /
    2e-3 of their leaf's max;

every rank reporting the same losses and holding the same parameters and
moments; the recipe configs (time-D + match, HiFi-GAN in explicit and
implicit encoding, Family A's netE, --remat_g full) over 2 data ranks
against their one-process steps under the first bounds; and
make_data_layout against make_data_mesh on the default shape (batch 6 on
4 ranks), a 2 x 2 data x model mesh and the refusals.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_cases as cases  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.parallel import (make_mesh, replicated,  # noqa: E402
                                           shard_batch)
from pix2pixhdaudiosr_tpu.parallel.mesh import make_data_mesh  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402

BATCH, SEG, LR = 4, 480, 2e-4
NOISE_SHAPE = (BATCH, int(64 * (1 - 1 / 6.0)), 16, 2)
LAYOUTS = [(6, (-1,), ("data",)), (4, (2, 2), ("data", "model")),
           (3, (2,), ("data",)), (4, (4,), ("model",))]


def _mask_noise(rng):
    """The JAX step's lr mask draw at `rng` (test_torch_train_step)."""
    k_enc = jax.random.split(rng, 3)[0]
    k_lr = jax.random.split(k_enc)[0]
    sub = jax.random.split(k_lr, 3)[1]
    return np.asarray(jax.random.normal(sub, NOISE_SHAPE, jnp.float32))


def _named(params):
    """{"G.<p>": ..., "D.<p>": ...} numpy of a JAX param tree."""
    return {f"{key}.{k}": v.numpy() for key in ("G", "D")
            for k, v in jax_to_torch_generator(params[key]).items()}


def _moments(state):
    """A JAX train state's optax Adam moments as read_state names them."""
    out = {}
    for tag, key, opt in (("opt_g", "G", state.opt_g),
                          ("opt_d", "D", state.opt_d)):
        adam = opt.inner_state[0]
        for m, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            if key in tree:
                out.update({f"{tag}.{m}.{k}": v.numpy() for k, v in
                            jax_to_torch_generator(tree[key]).items()})
    return out


@pytest.fixture(scope="module")
def jax_run():
    """JAX's state after 0, 1 and 2 mesh-sharded steps, its losses, the
    batch and the two steps' mask noise."""
    jcfg = jparse([*cases.TRAIN, "--batchSize", str(BATCH)], is_train=True,
                  save=False)
    jsys = JSystem(jcfg)
    state, opt_g, opt_d = jtrainer.init_state(jsys, jax.random.PRNGKey(4),
                                              batch=BATCH)
    mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
    rng = np.random.default_rng(5)
    batch = {k: (rng.standard_normal((BATCH, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")}
    step = jtrainer.make_train_step(jsys, opt_g, opt_d, donate=False)
    rngs = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    states, losses = [jax.device_put(state, replicated(mesh))], []
    for r in rngs:
        s, lo, _ = step(states[-1], shard_batch(batch, mesh), r, None,
                        fix_global=False, with_visuals=False)
        states.append(s)
        losses.append({k: float(v) for k, v in lo.items()})
    states = jax.device_get(states)
    s1 = states[1]
    adam1 = {key: (o.inner_state[0].mu[key], o.inner_state[0].nu[key],
                   o.inner_state[0].count)
             for key, o in (("G", s1.opt_g), ("D", s1.opt_d))}
    return dict(states=states, losses=losses, batch=batch,
                noise=[_mask_noise(r) for r in rngs], adam1=adam1,
                params=[{k: jax_to_torch_generator(s.params[k])
                         for k in ("G", "D")} for s in states[:2]])


@pytest.fixture(scope="module")
def recipe_one(jax_run, tmp_path_factory):
    """Each recipe's two steps in one process on the whole batch
    (cases.recipe_reference), and the job that holds their states after
    the first step."""
    tmp = tmp_path_factory.mktemp("recipes")
    job = dict(batch=jax_run["batch"], noise=jax_run["noise"],
               recipe_dirs={n: str(tmp / n) for n in cases.RECIPE_NAMES})
    return job, {name: cases.recipe_reference(job, name)
                 for name in cases.RECIPE_NAMES}


@pytest.fixture(scope="module")
def world(jax_run, recipe_one):
    job = dict(batch=jax_run["batch"], noise=jax_run["noise"],
               params=jax_run["params"][0], params1=jax_run["params"][1],
               adam1=jax_run["adam1"], layouts=LAYOUTS,
               recipe_dirs=recipe_one[0]["recipe_dirs"])
    return cases.run_world(4, job, ["dp_steps", "layouts", "recipe_steps"],
                           timeout=300)


@pytest.fixture(scope="module")
def one_process(jax_run):
    """The port's one-process steps, plain and with the fake pool, and the
    grads of its first step (which entries' updates are rounding)."""
    job = dict(batch=jax_run["batch"], noise=jax_run["noise"])
    p = jax_run["params"][0]
    plain = cases.train_run(None, job, mode="one", params=p)
    return dict(plain=plain, grads=plain["grads"], void=plain["void"],
                pool=cases.train_run(None, job, mode="one", params=p, pool=2))


@pytest.mark.parametrize("key", ["dp4", "dp2", "dp2x2", "pool"])
def test_dp_matches_one_process(world, one_process, key):
    """DP at 4 and 2 ranks, on the 2 x 2 mesh and with the fake pool:
    losses, params and moments after 2 steps against the port's one
    process on the whole batch (the bounds of the module docstring)."""
    ref = one_process["pool" if key == "pool" else "plain"]
    got = world[0]["dp_steps"][key]
    for lo, want in zip(got["losses"], ref["losses"]):
        assert lo.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(lo[k], want[k], rtol=1e-5, err_msg=k)
    g, w = got["states"][-1], ref["states"][-1]
    cases.close_params(g, w, one_process["grads"], one_process["void"],
                  2e-3 * LR, 4.2 * LR)
    cases.close_moments(g, w, one_process["void"])


@pytest.mark.parametrize("key", ["dp4", "dp2", "dp2x2", "pool", "from1"])
def test_every_rank_reports_the_same(world, key):
    """Every rank of the mesh reports the same losses and holds the same
    parameters and moments after each step; ranks outside it (2 and 3
    under --mesh_shape 2) return nothing."""
    runs = [r["dp_steps"][key] for r in world]
    if key == "dp2":
        assert runs[2] is None and runs[3] is None
        runs = runs[:2]
    for other in runs[1:]:
        assert other["losses"] == runs[0]["losses"]
        for a, b in zip(other["states"], runs[0]["states"]):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", cases.RECIPE_NAMES)
@pytest.mark.parametrize("step", [0, 1])
def test_recipe_under_dp_matches_one_process(world, recipe_one, name, step):
    """The recipe configs under 2 data ranks (--mesh_shape 2 in the world
    of 4): the time-D + match step (its frames' norm_param per rank), the
    HiFi-GAN D (explicit encoding, and implicit, where to_audio draws the
    pseudo-phase at the global shape), Family A's netE (--instance_feat)
    and --remat_g full. Each step from the state the one-process step
    starts from (cases.recipe_steps: the seeded init, then the one-process
    state after step 1), against that step on the whole batch under the
    one-step bounds of test_dp_matches_the_jax_mesh_step and
    test_torch_zero_fsdp's resume: losses rtol 1e-5; every net's
    parameters (G, netE, D, time_D, hifigan_D) within 1e-3 lr where the
    step's grad is above 1e-3 of its leaf's max|g| (not a conv bias feeding
    an InstanceNorm), all within 2.2 lr; the moments as close_moments
    holds them. Both member ranks the same, ranks 2 and 3 idle."""
    ref = recipe_one[1][name][step]
    runs = [r["recipe_steps"][name] for r in world]
    assert runs[2] is None and runs[3] is None
    got, other = runs[0][step], runs[1][step]
    assert other["losses"] == got["losses"]
    assert got["step_before"] == ref["step_before"] == step
    for lo, want in zip(got["losses"], ref["losses"]):
        assert lo.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(lo[k], want[k], rtol=1e-5, err_msg=k)
    g, w = got["states"][-1], ref["states"][-1]
    assert g.keys() == w.keys()
    nets = {k.split(".")[1] for k in w
            if k.startswith(("G.E.", "D.time_D.", "D.hifigan_D."))}
    assert nets == {"time_d_match": {"time_D"}, "hifigan": {"hifigan_D"},
                    "hifigan_implicit": {"hifigan_D"}, "family_a": {"E"},
                    "remat_full": set()}[name]
    cases.close_params(g, w, ref["grads"], ref["void"], 1e-3 * LR, 2.2 * LR)
    cases.close_moments(g, w, ref["void"])


def _check_step(got, want, before, grads, void):
    """test_torch_train_step._check_params: within 1e-3 lr where |g| >
    1e-3 max|g| of the leaf (not a bias feeding an InstanceNorm), all
    within 2 lr; some entry moved by more than lr / 2."""
    cases.close_params(got, want, grads, void, 1e-3 * LR, 2 * LR)
    assert any((np.abs(got[k] - before[k]) > 0.5 * LR).any() for k in grads)


@pytest.mark.parametrize("key", ["dp4", "dp2"])
def test_dp_matches_the_jax_mesh_step(world, jax_run, one_process, key):
    """DP at 4 and 2 ranks against the JAX package's train step on a
    4-device data mesh: both steps' losses within rtol 1e-4, step 1's
    params as test_torch_train_step reads them; step 2 from JAX's state
    after step 1 (4 ranks) likewise, and its moments."""
    run = world[0]["dp_steps"][key]
    for lo, want in zip(run["losses"], jax_run["losses"]):
        assert lo.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(lo[k], want[k], rtol=1e-4, err_msg=k)
    s0, s1, s2 = (_named(s.params) for s in jax_run["states"])
    _check_step(run["states"][0], s1, s0, one_process["grads"],
                one_process["void"])
    from1 = world[0]["dp_steps"]["from1"]
    for k, want in jax_run["losses"][1].items():
        np.testing.assert_allclose(from1["losses"][0][k], want, rtol=1e-4)
    _check_step(from1["states"][0], s2, s1, one_process["grads"],
                one_process["void"])
    cases.close_moments(from1["states"][0], _moments(jax_run["states"][2]),
                   one_process["void"])


def _jax_layout(batch, shape, axes):
    """make_data_mesh on 4 virtual devices and the batch's placement:
    (mesh shape by axis) or the error's type."""
    try:
        m = make_data_mesh(batch, shape, axes, devices=jax.devices()[:4])
        shard_batch({"x": np.zeros((batch, 2), np.float32)}, m)
    except (ValueError, KeyError, AssertionError) as e:
        return type(e).__name__
    return dict(m.shape)


def test_layout_matches_make_data_mesh(world):
    """make_data_layout at 4 ranks against make_data_mesh on 4 devices:
    the default shape with batch 6 takes 2 (ranks 2, 3 sit out); a 2 x 2
    data x model mesh lays ranks out row-major (data groups {0, 2}, {1,
    3}; replicas {0, 1}, {2, 3}); where JAX cannot place the batch (3 rows
    on 2, or no 'data' axis), the port stops naming the flag."""
    got = [r["layouts"] for r in world]
    want = [_jax_layout(*c) for c in LAYOUTS]
    assert want[0] == {"data": 2}
    assert [g[0]["shape"] for g in got] == [(2,)] * 4
    assert [g[0]["member"] for g in got] == [True, True, False, False]
    assert [g[0]["data"][:2] for g in got[:2]] == [(2, 0), (2, 1)]
    assert want[1] == {"data": 2, "model": 2}
    assert [g[1]["data"] for g in got] == [(2, 0, [0, 2]), (2, 0, [1, 3]),
                                           (2, 1, [0, 2]), (2, 1, [1, 3])]
    assert [g[1]["replica"] for g in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert isinstance(want[2], str) and isinstance(want[3], str)
    for g in got:
        assert "--batchSize 3" in g[2] and "--mesh_shape 2" in g[2]
        assert "--mesh_axes model" in g[3]
