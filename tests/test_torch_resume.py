"""The port's training loop beyond the step, against the JAX package (CPU,
f32, toy size): the in-training eval (its row against JAX's arithmetic,
its eval_size + 1 batches and two-sided snr), the visual slices, the fake
pool's steps, resume (bit-identical at an epoch boundary, the cadences
counted from the resume point), the warm start's key set against JAX's
merge_matching, the train state's round trip on the CPU, Ctrl+C and the
divergence guard's save.

Toy configuration: tests/test_torch_train_step.py's (n_fft 64 / hop 32 /
win 64, 480-sample segments, LocalEnhancer ngf 4, the 2-scale PatchGAN at
ndf 4, batch 2).
"""

import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.metrics import compute_metrics as jmetrics  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402
from pix2pixhdaudiosr_tpu.utils.checkpoint import merge_matching  # noqa: E402

from chip_smoke import norm_fed_biases  # noqa: E402
from pix2pixhdaudiosr_torch import train_loop, trainer  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.data.wavio import write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402
from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_slice import _jax_mask_noise, _toy_params  # noqa: E402
from test_torch_train_step import (LR, SEG, TOY, _leaves,  # noqa: E402
                                   _mask_noise, _port)


def _system(argv=(), is_train=True):
    return Pix2PixHDSystem(parse_config(TOY + list(argv), is_train=is_train,
                                        save=False), device="cpu")


def _batches(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal((b, SEG)) * 0.2).astype(np.float32)
             for k in ("label", "image")} for b in sizes]


def _corpus(path, n, length=300, seed=0):
    """n wavs of `length` samples (shorter than the 480-sample segment:
    the dataset draws no random offset for them)."""
    path.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_wav(str(path / f"a{i}.wav"),
                  (rng.standard_normal(length) * 0.2).astype(np.float32), 48000)
    return path


def _run_argv(tmp_path, corpus, name="run", *extra):
    return TOY + ["--name", name, "--checkpoints_dir", str(tmp_path),
                  "--dataroot", str(corpus), "--device", "cpu", "--no_html",
                  "--niter_decay", "0", "--serial_batches", *extra]


# ---------------------------------------------------------------- eval
def test_eval_row_matches_jax_eval_model():
    """eval_model over 3 batches (the last partial) with --eval_size 1
    against the JAX loop's arithmetic (pix2pixhdaudiosr_tpu/train_loop.py:
    141-167) with its eval_step, the same G and JAX's mask noise: every
    column within rtol 1e-4 (atol 1e-4 for the near-zero ssnr)."""
    argv = TOY + ["--eval_size", "1"]
    jcfg = jparse(argv, is_train=True, save=False)
    jsys, params = _toy_params(jcfg)
    jstep = jax.jit(jtrainer.make_eval_step(jsys))
    batches = _batches(8, (2, 2, 1))
    errs, snrs, segs, pesqs, lsds = [], [], [], [], []
    for j, data in enumerate(batches):
        sr, _ = jstep(params, jnp.asarray(data["label"]),
                      jax.random.PRNGKey(jcfg.seed + j))
        m, s_sr, s_lr, ss_sr, _, pesq, lsd = jmetrics(
            data["image"], data["label"], np.asarray(sr), jcfg.n_fft,
            jcfg.hop_length, jcfg.win_length, jcfg.center)
        errs.append(m)
        snrs.append((s_lr, s_sr))
        segs.append(ss_sr)
        pesqs.append(pesq)
        lsds.append(lsd)
        if j >= jcfg.eval_size:
            break
    want = [np.mean(v) for v in (errs, snrs, segs, pesqs, lsds)]

    system = _system(["--eval_size", "1"])
    system.netG.load_state_dict(jax_to_torch_generator(jax.device_get(params)))
    row = train_loop.eval_model(system, trainer.make_eval_step(system),
                                batches, _jax_mask_noise(jcfg.seed))
    assert list(row) == ["err", "snr", "snr_seg", "pesq", "lsd"]
    np.testing.assert_allclose(list(row.values()), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("eval_size", [0, 2])
def test_eval_model_scores_eval_size_plus_one_batches(monkeypatch, eval_size):
    """The JAX loop's quirks: it breaks after the batch j >= eval_size, so
    it scores eval_size + 1 batches; its snr column averages s_lr and s_sr;
    batch j's noise is asked for as noise(j, [b, masked bins, frames, 2])."""
    monkeypatch.setattr(train_loop, "compute_metrics",
                        lambda *a: (0.5, 1.0, 3.0, 0.25, -9.0, 0.0, 0.75))
    system = _system(["--eval_size", str(eval_size)])
    asked, calls = [], []

    def noise(j, shape):
        asked.append((j, shape))
        return torch.zeros(shape)

    def eval_step(lr, n):
        calls.append(lr.shape[0])
        return torch.zeros(lr.shape), None

    row = train_loop.eval_model(system, eval_step, _batches(3, (2, 2, 2, 1)),
                                noise)
    assert len(calls) == eval_size + 1
    assert row == {"err": 0.5, "snr": 2.0, "snr_seg": 0.25, "pesq": 0.0,
                   "lsd": 0.75}
    mask = system.codec.mask_size(64)
    assert asked == [(j, (calls[j], mask, 16, 2)) for j in range(len(calls))]


# ---------------------------------------------------------------- visuals
@pytest.mark.parametrize("explicit", [True, False])
def test_visual_slices_match_jax(rng_np, explicit):
    """system.visual_slices against JAX's _visual_slices on the same
    arrays, within 1e-5 in f32."""
    argv = list(TOY)
    if not explicit:
        argv.remove("--explicit_encoding")
        argv[argv.index("--input_nc") + 1] = "1"
        argv[argv.index("--output_nc") + 1] = "1"
    c = 2 if explicit else 1
    spec = [rng_np.random((2, 64, 16, c)).astype(np.float32) for _ in range(3)]
    pha = [np.sign(rng_np.standard_normal((2, 64, 16))).astype(np.float32)
           for _ in range(2)]
    jsys = JSystem(jparse(argv, is_train=True, save=False))
    want = jsys._visual_slices(*map(jnp.asarray, spec), *map(jnp.asarray, pha))
    system = Pix2PixHDSystem(parse_config(argv, is_train=True, save=False),
                             device="cpu")
    got = system.visual_slices(*map(torch.from_numpy, spec),
                               torch.from_numpy(pha[1]))
    assert list(got) == list(want)
    assert len(got) == (6 if explicit else 3)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-5)


# ---------------------------------------------------------------- pool
def _check_net(got, want, before, grads, void, lr=LR):
    """Updated weights against JAX's, as test_torch_train_step's
    _check_params holds them: 1e-3 lr where |g| > 1e-3 max|g| of the leaf
    (and the leaf is no InstanceNorm-fed bias), 2 lr everywhere; and some
    weights moved."""
    assert set(got) == set(want)
    moved = 0
    for name, w in want.items():
        g = np.abs(grads[name])
        big = (g > 1e-3 * g.max()) & (name not in void)
        diff = np.abs(got[name] - w)
        assert diff[big].max(initial=0) <= 1e-3 * lr, name
        assert diff.max() <= 2 * lr, name
        moved += int((np.abs(got[name] - before[name]) > 0.5 * lr).sum())
    assert moved > 0


def _weights(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def test_pool_steps_match_jax():
    """make_pool_steps from the JAX init against JAX's make_pool_steps on
    the same batch, noise and pooled pair (the step's pair, batch
    reversed): g_step's and d_step's losses within rtol 1e-4; g_step moves
    G alone and d_step D alone, each as optax does; g_step's visuals
    (with_visuals) within 1e-5 of JAX's (the pseudo-phase on the bins
    where JAX's two sr channels differ by more than 1e-4)."""
    jcfg = jparse(TOY + ["--pool_size", "2"], is_train=True, save=False)
    jsys = JSystem(jcfg)
    state, opt_g, opt_d = jtrainer.init_state(jsys, jax.random.PRNGKey(4),
                                              batch=2)
    j_g, j_d = jtrainer.make_pool_steps(jsys, opt_g, opt_d)
    batch = _batches(5, (2,))[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(21)
    s1, g_losses, aux = j_g(state, jbatch, rng, fix_global=False,
                            with_visuals=True)
    pooled = np.asarray(aux["fake_pair"])[::-1].copy()
    s2, d_losses = j_d(s1, jbatch, rng, jnp.asarray(pooled))
    s0, s1, s2 = jax.device_get((state, s1, s2))

    system = _port(s0.params)
    st = trainer.TrainState(system, *[trainer.make_optimizer(p, system.cfg)
                                      for p in trainer._split_params(system)])
    g_step, d_step = trainer.make_pool_steps(system)
    noise = _mask_noise(rng, (2, system.codec.mask_size(64), 16, 2))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    g0, d0 = _weights(system.netG_train), _weights(system.netD)

    losses, taux = g_step(st, tbatch, noise, with_visuals=True)
    assert set(losses) == set(g_losses)
    for k, v in g_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4)
    assert all(p.grad is None for p in system.netD.parameters())
    g_grads = {n: p.grad.numpy() for n, p in system.netG_train.named_parameters()}
    _check_net(_weights(system.netG_train), _leaves(s1.params["G"]), g0,
               g_grads, norm_fed_biases(system.netG_train))
    assert all(np.array_equal(v, d0[k]) for k, v in
               _weights(system.netD).items())
    vis = {k: np.asarray(v) for k, v in aux["visuals"].items()}
    sr = np.asarray(aux["sr"])[0]
    clear = np.abs(sr[..., 0] - sr[..., 1]) > 1e-4
    for k, v in vis.items():
        got = taux["visuals"][k].numpy()
        where = clear if k in ("label_pha", "generated_pha") else np.ones_like(clear)
        np.testing.assert_allclose(got[where], v[where], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(taux["fake_pair"].numpy(),
                               np.asarray(aux["fake_pair"]), atol=1e-5)

    g1 = _weights(system.netG_train)
    losses = d_step(st, tbatch, noise, torch.from_numpy(pooled))
    assert st.step == 1
    assert set(losses) == set(d_losses)
    for k, v in d_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4)
    assert all(p.grad is None for p in system.netG_train.parameters())
    d_grads = {n: p.grad.numpy() for n, p in system.netD.named_parameters()}
    _check_net(_weights(system.netD), _leaves(s2.params["D"]), d0, d_grads,
               norm_fed_biases(system.netD))
    assert all(np.array_equal(v, g1[k]) for k, v in
               _weights(system.netG_train).items())


def test_pool_run_through_the_train_loop(tmp_path, capsys):
    """--pool_size 2 on the CPU: 2 steps, each a G step and a D step, with
    every loss printed."""
    corpus = _corpus(tmp_path / "wavs", 4)
    state = train_loop.main(_run_argv(tmp_path, corpus, "pool", "--niter", "1",
                                      "--pool_size", "2", "--print_freq", "2",
                                      "--validation_split", "0"))
    assert state.step == 2
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("(epoch: 1")]
    assert len(lines) == 2 and all("D_fake: " in ln and "G_GAN: " in ln
                                   for ln in lines)


# ---------------------------------------------------------------- resume
def _state_tensors(state):
    out = {f"G.{k}": v for k, v in state.system.netG_train.state_dict().items()}
    out.update({f"D.{k}": v for k, v in state.system.netD.state_dict().items()})
    for key, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{key}.{i}.{k}": v for k, v in s.items()})
    return out


def test_resume_at_an_epoch_boundary_is_bit_identical(tmp_path, capsys):
    """2 epochs in one run against 1 epoch, then --continue_train for the
    second (serial batches, files shorter than the segment, so that the
    restarting loader and dataset draw nothing): weights, Adam moments and
    step equal bit for bit."""
    corpus = _corpus(tmp_path / "wavs", 4)
    common = ["--validation_split", "0", "--print_freq", "0",
              "--save_latest_freq", "0", "--save_epoch_freq", "1"]
    whole = train_loop.main(_run_argv(tmp_path, corpus, "whole", "--niter",
                                      "2", *common))
    train_loop.main(_run_argv(tmp_path, corpus, "split", "--niter", "1",
                              *common))
    resumed = train_loop.main(_run_argv(tmp_path, corpus, "split", "--niter",
                                        "2", "--continue_train", *common))
    out = capsys.readouterr().out
    assert "Resuming from epoch 2 at iteration 0" in out
    assert "restored checkpoint 'latest'" in out
    assert whole.step == resumed.step == 4
    a, b = _state_tensors(whole), _state_tensors(resumed)
    assert set(a) == set(b) and len(a) > 0
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_counts_the_cadences_from_the_resume_point(tmp_path, capsys):
    """The JAX loop's deltas: a run resumed at 8 samples with print and eval
    every 6 prints and evaluates at 14 (8 + 6), where the uninterrupted run
    would at 12; the persisted validation split is kept."""
    corpus = _corpus(tmp_path / "wavs", 6)
    common = ["--validation_split", "0.34", "--eval_freq", "6",
              "--eval_size", "0", "--print_freq", "6", "--save_latest_freq",
              "0", "--save_epoch_freq", "2"]
    train_loop.main(_run_argv(tmp_path, corpus, "run", "--niter", "2", *common))
    split = (tmp_path / "run" / "validation_indices.json").read_text()
    capsys.readouterr()
    train_loop.main(_run_argv(tmp_path, corpus, "run", "--niter", "4",
                              "--continue_train", *common))
    out = capsys.readouterr().out.splitlines()
    prints = [ln for ln in out if ln.startswith("(epoch")]
    assert len(prints) == 1 and prints[0].startswith("(epoch: 4, iters: 2,")
    assert len([ln for ln in out if ln.startswith("Evaluation:")]) == 1
    assert (tmp_path / "run" / "validation_indices.json").read_text() == split
    rows = (tmp_path / "run" / "eval.csv").read_text().splitlines()
    assert len(rows) == 1 + 2     # at 6, then at 14


def _stepped_state(argv, seed):
    """A CPU train state after one step (so that both Adams hold state)."""
    system = _system(argv)
    state = trainer.init_state(system, seed)
    batch = {k: torch.from_numpy(v) for k, v in _batches(seed, (2,))[0].items()}
    trainer.make_train_step(system)(state, batch,
                                    torch.Generator().manual_seed(seed))
    return state


def test_train_state_round_trip_holds_cpu_tensors(tmp_path):
    """save_train_state writes every tensor on the CPU (the Adams' state
    included, keyed by parameter name); load_train_state into a state of
    another seed restores every weight, moment, step and learning rate."""
    state = _stepped_state((), 0)
    trainer.set_learning_rate(state, 1.5e-4)
    ckpt.save_train_state(state, str(tmp_path), "t")
    saved = torch.load(tmp_path / "t_optim.pth", weights_only=True)
    names = [n for n, _ in state.system.netG_train.named_parameters()]
    assert list(saved["G"]["state"]) == names
    tensors = [v for part in ("G", "D") for s in saved[part]["state"].values()
               for v in s.values()]
    assert tensors and all(v.device.type == "cpu" for v in tensors)
    fresh = trainer.init_state(_system(), 9)
    loaded = ckpt.load_train_state(fresh, "t", str(tmp_path))
    want = _state_tensors(state)
    got = _state_tensors(fresh)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert fresh.step == 1 and "step" in loaded
    assert [g["lr"] for o in (fresh.opt_g, fresh.opt_d)
            for g in o.param_groups] == [1.5e-4, 1.5e-4]
    assert ckpt.has("t", str(tmp_path)) and not ckpt.has("u", str(tmp_path))
    assert ckpt.load_iter(str(tmp_path)) == (1, 0)
    ckpt.save_iter(str(tmp_path), 3, 8)
    assert ckpt.load_iter(str(tmp_path)) == (3, 8)


def _jax_copied(src_argv, dst_argv):
    """The names JAX's merge_matching copies from a `src_argv` train state
    into a `dst_argv` one, in the port's naming ("G.<param>", "D.<param>",
    "opt_g.<param>", "opt_d.<param>", "step"): the saved leaves are all 7,
    so a merged leaf of 7s came from the save."""
    src, dst = (jtrainer.init_state(
        JSystem(jparse(TOY + list(a), is_train=True, save=False)),
        jax.random.PRNGKey(i), batch=2)[0] for i, a in enumerate(
            (src_argv, dst_argv)))
    saved = flax.serialization.to_state_dict(
        jax.tree.map(lambda a: jnp.full_like(a, 7), jax.device_get(src)))
    merged = merge_matching(jax.device_get(dst), saved)

    def sevens(prefix, tree, leaves):
        return {f"{prefix}.{n}" for n, v in leaves(tree).items()
                if np.all(v == 7)}
    out = set()
    for net, opt in (("G", merged.opt_g), ("D", merged.opt_d)):
        out |= sevens(net, merged.params[net], _leaves)
        out |= sevens(f"opt_{net.lower()}", opt.inner_state[0].mu[net],
                      _leaves)
    if np.all(np.asarray(merged.step) == 7):
        out.add("step")
    return out


@pytest.mark.parametrize("src,dst", [
    (["--netG", "global"], []),                          # G1 -> G3L2
    ([], ["--n_blocks_local", "2"]),                     # a new block
    ([], ["--ngf", "8"]),                                # shapes differ
])
def test_warm_start_copies_the_jax_key_set(tmp_path, src, dst):
    """load_train_state from a run of one config into a state of another
    takes exactly the leaves JAX's merge_matching takes between the same
    two configs: by name where the shapes match."""
    ckpt.save_train_state(_stepped_state(src, 0), str(tmp_path), "latest")
    target = trainer.init_state(_system(dst), 1)
    loaded = ckpt.load_train_state(target, "latest", str(tmp_path))
    want = _jax_copied(src, dst)
    assert loaded == want
    assert any(k.startswith("D.") for k in loaded)


def test_warm_start_through_the_train_loop(tmp_path, capsys, monkeypatch):
    """--load_pretrain DIR: the new run's G and D before its first step are
    DIR's latest."""
    corpus = _corpus(tmp_path / "wavs", 2)
    common = ["--validation_split", "0", "--print_freq", "0", "--niter", "1",
              "--save_latest_freq", "0", "--save_epoch_freq", "1"]
    train_loop.main(_run_argv(tmp_path, corpus, "first", *common))
    saved = torch.load(tmp_path / "first" / "latest_net_G.pth",
                       weights_only=True)
    seen = []
    make = train_loop.make_train_step

    def hooked(system):
        step = make(system)

        def first(state, *a, **kw):
            seen.append(all(torch.equal(v, saved[k]) for k, v in
                            system.netG_train.state_dict().items()))
            return step(state, *a, **kw)
        return first

    monkeypatch.setattr(train_loop, "make_train_step", hooked)
    train_loop.main(_run_argv(tmp_path, corpus, "second", *common,
                              "--load_pretrain", str(tmp_path / "first")))
    assert seen == [True]
    assert f"warm-started from {tmp_path / 'first'}" in capsys.readouterr().out


# ---------------------------------------------------------------- saves
def _hook_steps(monkeypatch, on_step):
    """Route the train loop's steps through on_step(n, state, losses)."""
    make = train_loop.make_train_step
    count = [0]

    def hooked(system):
        step = make(system)

        def wrapped(state, *a, **kw):
            losses, aux = step(state, *a, **kw)
            count[0] += 1
            return on_step(count[0], state, losses), aux
        return wrapped

    monkeypatch.setattr(train_loop, "make_train_step", hooked)


def test_sigint_saves_latest_the_epoch_tag_and_the_cursor(tmp_path, capsys,
                                                          monkeypatch):
    """SIGINT after the first step: at the next batch the loop saves
    `latest` and the epoch tag, sets iter.txt to the next epoch and
    returns; the SIGINT handler in place before the run is back."""
    before = signal.getsignal(signal.SIGINT)

    def on_step(n, state, losses):
        if n == 1:
            os.kill(os.getpid(), signal.SIGINT)
        return losses

    _hook_steps(monkeypatch, on_step)
    corpus = _corpus(tmp_path / "wavs", 6)
    state = train_loop.main(_run_argv(
        tmp_path, corpus, "run", "--niter", "2", "--validation_split", "0",
        "--print_freq", "0", "--save_latest_freq", "0", "--save_epoch_freq",
        "0"))
    assert signal.getsignal(signal.SIGINT) is before
    out = capsys.readouterr().out
    assert "You pressed Ctrl+C!" in out
    assert "exiting and saving the model at epoch 1, iters 2" in out
    assert state.step == 1
    run = tmp_path / "run"
    for tag in ("latest", "1"):
        for part in ("net_G", "net_D", "optim"):
            assert (run / f"{tag}_{part}.pth").exists()
    assert (run / "iter.txt").read_text().strip() == "2,0"
    saved = torch.load(run / "latest_net_G.pth", weights_only=True)
    assert all(torch.equal(v, saved[k]) for k, v in
               state.system.netG_train.state_dict().items())


def test_divergence_saves_diverged_and_keeps_latest(tmp_path, monkeypatch):
    """A non-finite loss at the second step: the guard saves the state
    under `diverged` and stops before any save could overwrite `latest`,
    which keeps the first step's weights; iter.txt stays at that save."""
    snapshot = {}

    def on_step(n, state, losses):
        if n == 2:
            snapshot["latest"] = (tmp_path / "run" / "latest_net_G.pth"
                                  ).read_bytes()
            return {k: torch.tensor(float("nan")) for k in losses}
        return losses

    _hook_steps(monkeypatch, on_step)
    before = signal.getsignal(signal.SIGINT)
    corpus = _corpus(tmp_path / "wavs", 6)
    with pytest.raises(SystemExit, match="diverged"):
        train_loop.main(_run_argv(
            tmp_path, corpus, "run", "--niter", "1", "--validation_split",
            "0", "--print_freq", "2", "--save_latest_freq", "2",
            "--save_epoch_freq", "1"))
    assert signal.getsignal(signal.SIGINT) is before
    run = tmp_path / "run"
    for part in ("net_G", "net_D", "optim"):
        assert (run / f"diverged_{part}.pth").exists()
    assert (run / "latest_net_G.pth").read_bytes() == snapshot["latest"]
    assert (run / "iter.txt").read_text().strip() == "1,2"
    assert not (run / "1_net_G.pth").exists()
    latest = torch.load(run / "latest_net_G.pth", weights_only=True)
    diverged = torch.load(run / "diverged_net_G.pth", weights_only=True)
    assert any(not torch.equal(latest[k], diverged[k]) for k in latest)
