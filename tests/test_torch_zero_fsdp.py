"""The port's ZeRO-1 (parallel/zero.py, --zero_opt_state) and FSDP
(parallel/fsdp.py, --fsdp) on the CPU over gloo: one world of 2 ranks
(tests/torch_parallel_cases.py) runs the toy train step (TRAIN, f32) on a
global batch of 4, replicated, ZeRO-1, FSDP, and replicated and ZeRO-1
with --adam_mu_bf16, 2 steps each from one seeded init: each sharded run
equals the replicated one (losses rtol 1e-4, params atol 1e-6, as
tests/test_zero.py and tests/test_fsdp.py hold the JAX package; its
moments too), every shardable leaf's slice and its moments hold 1/N of the
whole on each rank, and the shard dims follow the JAX package's
_leaf_spec leaf by leaf; the time-D + match step (a third net in the D
optimizer) likewise under ZeRO-1 and FSDP. The save and restore of test_fsdp.py
(test_sharded_save_restore_continues) for both, the saved file loaded by
one process, and a one-process file resumed under ZeRO-1."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_cases as cases  # noqa: E402

from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.parallel.zero import _leaf_spec  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from pix2pixhdaudiosr_torch.convert import jax_layout  # noqa: E402
from pix2pixhdaudiosr_torch.parallel.zero import leaf_spec, shard_dim  # noqa: E402
from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt  # noqa: E402

BATCH, SEG, LR, N = 4, 480, 2e-4, 2
NOISE_SHAPE = (BATCH, int(64 * (1 - 1 / 6.0)), 16, 2)


def _job(tmp):
    rng = np.random.default_rng(7)
    return dict(batch={k: (rng.standard_normal((BATCH, SEG)) * 0.2)
                       .astype(np.float32) for k in ("label", "image")},
                noise=[np.random.default_rng(30 + i).standard_normal(
                    NOISE_SHAPE).astype(np.float32) for i in range(3)],
                dir=str(tmp))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    job = _job(tmp_path_factory.mktemp("zero_fsdp"))
    return job, cases.run_world(N, job, ["sharded_steps", "sharded_resume",
                                         "sharded_recipe"], timeout=240)


def _same_run(got, want, params_atol=1e-6):
    """Losses within rtol 1e-4 each step, every parameter within
    params_atol and every moment within rtol 1e-6 after each step."""
    for lo, w in zip(got["losses"], want["losses"]):
        assert lo.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(lo[k], w[k], rtol=1e-4, err_msg=k)
    for g, w in zip(got["states"], want["states"]):
        assert g.keys() == w.keys()
        for k in w:
            if k.startswith("opt_"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-30,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=params_atol, err_msg=k)


@pytest.mark.parametrize("mode,ref", [("zero", "dp"), ("fsdp", "dp"),
                                      ("zero_bf16", "dp_bf16")])
def test_sharded_step_matches_replicated(world, mode, ref):
    """ZeRO-1, FSDP and ZeRO-1 with bf16 first moments against the
    replicated step over the same 2 ranks, on both ranks."""
    _, res = world
    for r in res:
        runs = r["sharded_steps"]
        _same_run(runs[mode], runs[ref])
    bf16 = [k for k in res[0]["sharded_steps"]["zero_bf16"]["states"][0]
            if k.startswith("opt_g.exp_avg.")]
    assert bf16


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_time_d_match_sharded_matches_replicated(world, mode):
    """The time-D + match step (cases.RECIPES["time_d_match"]: a third net,
    time_D, in the D optimizer) under ZeRO-1 and FSDP against the
    replicated step over the same 2 ranks, 2 steps (test_sharded_step_
    matches_replicated's bounds), on both ranks; time_D's parameters and
    moments are in every state read."""
    _, res = world
    for r in res:
        runs = r["sharded_recipe"]
        _same_run(runs[mode], runs["dp"])
    keys = res[0]["sharded_recipe"]["dp"]["states"][0]
    assert any(k.startswith("D.time_D.") for k in keys)
    assert any(k.startswith("opt_d.exp_avg.time_D.") for k in keys)


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_time_d_match_shards_and_held_bytes(world, mode):
    """Under the time-D + match step, every shardable leaf of every net (G,
    D and time_D) is sliced per shard_dim and its moments hold 1/N on each
    rank: held_bytes counts time_D's moments (and under FSDP its
    parameters) at 1/N, as the replicated run's less the slices'."""
    _, res = world
    whole = _whole(res[0], "sharded_recipe")
    assert any(k.startswith("D.time_D.") for k in whole)
    for r in res:
        run = r["sharded_recipe"][mode]
        split = {"all": 0, "time_D": 0}
        for name, shape in whole.items():
            d = shard_dim(name.split(".", 1)[1], shape, N)
            want = list(shape)
            if d is not None:
                want[d] //= N
                split["all"] += int(np.prod(shape))
                if name.startswith("D.time_D."):
                    split["time_D"] += int(np.prod(shape))
            assert run["shards"][name] == tuple(want), name
        assert split["time_D"] > 0
        rep, held = r["sharded_recipe"]["dp"]["held"], run["held"]
        assert held["moments"] == rep["moments"] - 8 * split["all"] // N
        assert held["params"] == (rep["params"] if mode == "zero" else
                                  rep["params"] - 4 * split["all"] // N)


def _whole(res, case="sharded_steps"):
    """Every parameter's whole shape, by read_state's names ("G.<p>",
    "D.<p>", "D.time_D.<p>", ...)."""
    state = res[case]["dp"]["states"][0]
    return {k: state[k].shape for k in state if k[:2] in ("G.", "D.")}


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_shards_follow_leaf_spec_and_hold_1_over_n(world, mode):
    """Each rank's slice of every parameter (the tensor its Adam steps, and
    so its moments) is the whole leaf with shard_dim halved: 1/N of the
    bytes of every shardable leaf; the rest whole. Between steps ZeRO-1
    holds the whole parameters and the slices' moments, FSDP the slices
    alone (the whole ones freed)."""
    _, res = world
    whole = _whole(res[0])
    for r in res:
        run = r["sharded_steps"][mode]
        split = 0
        for name, shape in whole.items():
            d = shard_dim(name.split(".", 1)[1], shape, N)
            want = list(shape)
            if d is not None:
                want[d] //= N
                split += int(np.prod(shape))
            assert run["shards"][name] == tuple(want), name
        assert split > 0.9 * sum(int(np.prod(s)) for s in whole.values())
        rep = r["sharded_steps"]["dp"]["held"]
        held = run["held"]
        # the moments: 2 f32 a parameter, the shardable ones' halved
        assert held["moments"] == rep["moments"] - 8 * split // N
        assert held["params"] == (rep["params"] if mode == "zero" else
                                  rep["params"] - 4 * split // N)


def _torch_name(path):
    keys = [p.key for p in path][1:]
    return ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else
                                 keys[-1]])


def test_leaf_spec_matches_jax():
    """leaf_spec is the JAX package's _leaf_spec, on its test's shapes and
    more; shard_dim applied to each toy G and D parameter (a state_dict
    key, OIHW) splits the dim that _leaf_spec splits on the flax leaf
    (HWIO, deconv kernels flipped and transposed), through convert.py's
    names, at 2 and 4 ranks; with the time-domain and the HiFi-GAN Ds
    (1-D and 2-D weight-normed convs, their g), whose shapes jax.eval_shape
    gives without a compile."""
    for shape in [(7, 16), (3, 3, 2, 48), (5,), (), (4, 4, 3, 3), (3, 3, 4, 4),
                  (1, 1), (16, 8, 8), (6,)]:
        for n in (2, 4, 8):
            assert leaf_spec(shape, n) == tuple(_leaf_spec(shape, n, "data"))
    jsys = JSystem(jparse([*cases.TRAIN, "--batchSize", str(BATCH),
                           "--use_time_D", "--use_hifigan_D"],
                          is_train=True, save=False))
    params = jax.eval_shape(lambda k: jsys.init_params(k, batch=BATCH),
                            jax.random.PRNGKey(0))
    assert {"G", "D", "time_D", "hifigan_D"} <= set(params)
    checked = 0
    for key in ("G", "D", "time_D", "hifigan_D"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                params[key])[0]:
            name = _torch_name(path)
            perm = jax_layout(name, len(leaf.shape))
            torch_shape = tuple(leaf.shape[j] for j in perm)
            for n in (2, 4):
                spec = tuple(_leaf_spec(leaf.shape, n, "data"))
                want = spec.index("data") if spec else None
                got = shard_dim(name, torch_shape, n)
                assert (None if got is None else perm[got]) == want, name
                checked += 1
    assert checked > 100


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_sharded_save_restore_continues(world, mode):
    """test_fsdp.py::test_sharded_save_restore_continues: after 2 sharded
    steps `latest` is saved; a fresh init (another seed) restored from it
    and sharded takes the third step equal to the uninterrupted one, the
    step count carried."""
    _, res = world
    for r in res:
        run = r["sharded_resume"][mode]
        assert run["resumed"]["step_before"] == 2
        assert run["resumed"]["step"] == run["uninterrupted"]["step"] == 3
        _same_run(run["resumed"], run["uninterrupted"])


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_sharded_file_is_the_one_process_file(world, mode):
    """The sharded run's `latest` loads into one process and holds exactly
    the state after its 2 steps: every parameter and moment, whole, in the
    one-process layout (a parameter's strides), and the step count."""
    _, res = world
    run = res[0]["sharded_resume"][mode]
    state = cases.train_state(BATCH, seed=99)
    loaded = ckpt.load_train_state(state, "latest", run["dir"])
    assert "step" in loaded and state.step == 2
    got = cases.read_state(state)
    assert got.keys() == run["saved"].keys()
    for k, v in run["saved"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    saved = torch.load(os.path.join(run["dir"], "latest_optim.pth"),
                       weights_only=True)
    for name, p in state.system.netG_train.named_parameters():
        assert saved["G"]["state"][name]["exp_avg"].stride() == p.stride()


def test_one_process_file_resumes_under_zero(world):
    """A one-process run's `latest` (2 steps on the whole batch) restored
    into ZeRO-1 at 2 ranks: its third step against the one-process third
    step from that file: losses rtol 1e-5; every parameter whose grad in
    that step is above 1e-3 of its leaf's max|g| (not a bias feeding an
    InstanceNorm, whose grad is rounding alone) within 1e-3 lr (one step
    of test_torch_dp's bound), all within 2.2 lr; the moments after it
    within 1e-3 (first) and 2e-3 (second) of their leaf's max, as
    test_torch_dp holds them: the moments the file carried were sliced
    into the ranks' Adams and stepped there."""
    job, res = world
    state = cases.train_state(BATCH, seed=99)
    ckpt.load_train_state(state, "latest", os.path.join(job["dir"], "one"))
    from pix2pixhdaudiosr_torch import trainer
    lo, _ = trainer.make_train_step(state.system)(
        state, cases.train_rows(job, None), torch.tensor(job["noise"][2]))
    grads, void = cases.step_grads(state.system), cases.void_of(state.system)
    want = cases.read_state(state)
    for r in res:
        got = r["sharded_resume"]["one_to_zero"]
        assert got["step_before"] == 2 and got["step"] == 3
        for k, v in lo.items():
            np.testing.assert_allclose(got["losses"][0][k], float(v),
                                       rtol=1e-5)
        cases.close_params(got["states"][0], want, grads, void, 1e-3 * LR,
                           2.2 * LR)
        cases.close_moments(got["states"][0], want, void)
