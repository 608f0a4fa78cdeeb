"""The PyTorch port's memory knobs on the CPU: --remat_g full|dots (grads
bit-identical to the plain step's, each InstanceNorm of G run again in the
backward, nothing drawn from the RNG), --adam_mu_bf16 against optax's
adam(mu_dtype=bfloat16) on fixed grads, a checkpoint round trip of netE
and the bf16 moments that resumes bit-identically, and the training CLI
with netE and both knobs.

Toy configuration: tests/test_torch_train_step.py's TOY (LocalEnhancer
ngf 4, PatchGAN ndf 4, n_fft 64, 480-sample segments, batch 2). The plain
step is held to the JAX package there; this file compiles no JAX step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pix2pixhdaudiosr_tpu import trainer as jtrainer  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402

from pix2pixhdaudiosr_torch import train_loop, trainer  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.data.wavio import write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.models import layers  # noqa: E402
from pix2pixhdaudiosr_torch.models.layers import ConvIN, ConvTransposeIN  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402
from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_train_step import SEG, TOY  # noqa: E402

FEAT = ["--instance_feat", "--feat_num", "2", "--nef", "4",
        "--n_downsample_E", "2"]


def _system(extra, seed=3):
    cfg = parse_config(TOY + extra, is_train=True, save=False)
    system = Pix2PixHDSystem(cfg, device="cpu")
    return system, trainer.init_state(system, seed)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(2, SEG, generator=g) * 0.2
            for k in ("label", "image")}


def _noise(system, seed=1):
    b, f, t, c = system.spectro_shape(2)
    return torch.randn(b, system.codec.mask_size(f), t, c,
                       generator=torch.Generator().manual_seed(seed))


def _norms(net) -> int:
    """InstanceNorms in one forward of net."""
    return sum(isinstance(m, ConvTransposeIN) or (isinstance(m, ConvIN)
                                                  and m.norm)
               for m in net.modules())


def _grads(system):
    return {f"{k}.{n}": p.grad.clone() for nets in (system.g_nets(),
                                                     system.d_nets())
            for k, net in nets.items() for n, p in net.named_parameters()}


@pytest.mark.parametrize("mode,extra", [
    ("full", []), ("dots", []),
    ("full", FEAT + ["--compute_dtype", "bfloat16"]),
    ("dots", FEAT + ["--compute_dtype", "bfloat16"]),
])
def test_remat_grads_equal_the_plain_step(monkeypatch, mode, extra):
    """losses_and_grads with --remat_g `mode`: every loss and every G, E
    and D grad torch.equal to the plain step's (f32; and bf16 under
    autocast with netE); G's and netE's InstanceNorms run twice (the
    forward, then its recompute in the backward: the kernel's output is
    not saved under "dots"), D's as in the plain step; the step leaves
    torch's RNG state as it found it (the mask noise is drawn before the
    G forward, which draws nothing)."""
    calls = []
    real = layers.instance_norm_act

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(layers, "instance_norm_act", counted)
    plain, _ = _system(extra)
    remat, _ = _system(extra + ["--remat_g", mode])
    assert remat.cfg.remat_g == mode
    counts = []
    results = []
    for system in (plain, remat):
        calls.clear()
        rng = torch.get_rng_state()
        losses, _ = system.losses_and_grads(_batch(), noise=_noise(system))
        assert torch.equal(torch.get_rng_state(), rng)
        counts.append(len(calls))
        results.append((losses, _grads(system)))
    g_norms = sum(_norms(net) for net in plain.g_nets().values())
    d_norms = 3 * _norms(plain.netD)
    assert counts == [g_norms + d_norms, 2 * g_norms + d_norms]
    (l0, g0), (l1, g1) = results
    assert l0.keys() == l1.keys() and g0.keys() == g1.keys()
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert any(k.startswith("E.") for k in g0) == bool(extra)


def _optax_adam_bf16(params, grads_seq, lrs):
    """The JAX package's --adam_mu_bf16 optimizer (trainer.make_optimizer)
    applied eagerly: the params and the state after each update."""
    jcfg = jparse(TOY + ["--adam_mu_bf16"], is_train=True, save=False)
    opt = jtrainer.make_optimizer(jcfg)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(p)
    out = []
    for g, lr in zip(grads_seq, lrs):
        st.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        p = optax.apply_updates(p, upd)
        adam = st.inner_state[0]
        out.append(({k: np.asarray(v) for k, v in p.items()},
                    {k: np.asarray(v) for k, v in adam.mu.items()},
                    {k: np.asarray(v) for k, v in adam.nu.items()}))
    return out


def test_adam_mu_bf16_matches_optax():
    """AdamMuBF16 against optax's adam(mu_dtype=bfloat16) on the same params
    and fixed grads, one and two updates (the second at the lr that
    set_learning_rate gives it): the stored first moment bf16 and
    bit-equal, the second moment f32 within 1e-7 relative, the params
    within 1e-7 relative."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 4, 3, 3), "b": (8,), "v": (64, 33)}
    params = {k: (rng.standard_normal(s) * 0.02).astype(np.float32)
              for k, s in shapes.items()}
    grads_seq = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 0))
                  .astype(np.float32) for k, s in shapes.items()}
                 for _ in range(2)]
    lrs = [2e-4, 1.3e-4]
    want = _optax_adam_bf16(params, grads_seq, lrs)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    cfg = parse_config(TOY + ["--adam_mu_bf16"], is_train=True, save=False)
    opt = trainer.make_optimizer(list(tparams.values()), cfg)
    assert isinstance(opt, trainer.AdamMuBF16)
    assert opt.param_groups[0]["betas"] == (0.5, 0.999)
    assert opt.param_groups[0]["eps"] == 1e-8
    for (g, lr), (wp, wmu, wnu) in zip(zip(grads_seq, lrs), want):
        for group in opt.param_groups:
            group["lr"] = lr
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            assert st["exp_avg_sq"].dtype == torch.float32
            np.testing.assert_array_equal(
                st["exp_avg"].view(torch.int16).numpy(),
                wmu[k].view(np.int16), err_msg=k)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), wnu[k],
                                       rtol=1e-7, err_msg=k)
            np.testing.assert_allclose(p.detach().numpy(), wp[k], rtol=1e-7,
                                       err_msg=k)


def _step(state, seed):
    system = state.system
    return trainer.make_train_step(system)(state, _batch(seed),
                                           _noise(system, seed))


def _params(system):
    return {f"{k}.{n}": p.detach().clone() for nets in (system.g_nets(),
                                                         system.d_nets())
            for k, net in nets.items() for n, p in net.named_parameters()}


def test_resume_round_trips_e_and_the_bf16_moments(tmp_path):
    """A --instance_feat --adam_mu_bf16 --remat_g dots state after one step,
    saved and loaded into a fresh state: netE and every moment equal bit
    for bit (the first moments still bf16), netE's under "E." in the G
    optimizer's file; the next step from the loaded state equals the next
    step from the original. Into a plain-Adam state the same file loads
    with f32 first moments equal to the bf16 ones, and back again."""
    extra = FEAT + ["--adam_mu_bf16", "--remat_g", "dots"]
    system, state = _system(extra)
    _step(state, 0)
    ckpt.save_train_state(state, str(tmp_path), "latest")
    assert (tmp_path / "latest_net_E.pth").exists()
    saved = torch.load(tmp_path / "latest_optim.pth", weights_only=True)
    e_names = {n for n in saved["G"]["state"] if n.startswith("E.")}
    assert e_names == {f"E.{n}" for n, _ in system.netE.named_parameters()}
    assert all(s["exp_avg"].dtype == torch.bfloat16
               for part in ("G", "D") for s in saved[part]["state"].values())

    system2, state2 = _system(extra, seed=9)
    loaded = ckpt.load_train_state(state2, "latest", str(tmp_path))
    assert {f"E.{n}" for n, _ in system.netE.named_parameters()} <= loaded
    assert {f"opt_g.{n}" for n in e_names} <= loaded
    assert state2.step == 1
    for k, v in _params(system).items():
        assert torch.equal(_params(system2)[k], v), k
    for opt, opt2 in ((state.opt_g, state2.opt_g), (state.opt_d, state2.opt_d)):
        ps = [p for g in opt.param_groups for p in g["params"]]
        ps2 = [p for g in opt2.param_groups for p in g["params"]]
        for p, p2 in zip(ps, ps2):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                a, b = opt.state[p][key], opt2.state[p2][key]
                assert a.dtype == b.dtype and torch.equal(a, b), key
    _step(state, 1)
    _step(state2, 1)
    for k, v in _params(system).items():
        assert torch.equal(_params(system2)[k], v), k

    plain_sys, plain = _system(FEAT)
    ckpt.load_train_state(plain, "latest", str(tmp_path))
    p0 = next(iter(plain_sys.netE.parameters()))
    s0 = saved["G"]["state"]["E." + next(iter(
        n for n, _ in plain_sys.netE.named_parameters()))]
    assert plain.opt_g.state[p0]["exp_avg"].dtype == torch.float32
    assert torch.equal(plain.opt_g.state[p0]["exp_avg"], s0["exp_avg"].float())
    ckpt.save_train_state(plain, str(tmp_path / "f32"), "latest")
    _, back = _system(extra, seed=5)
    ckpt.load_train_state(back, "latest", str(tmp_path / "f32"))
    q0 = next(iter(back.system.netE.parameters()))
    assert back.opt_g.state[q0]["exp_avg"].dtype == torch.bfloat16
    assert torch.equal(back.opt_g.state[q0]["exp_avg"], s0["exp_avg"])


def test_train_loop_with_netE_and_the_knobs(tmp_path, capsys):
    """The training CLI on the CPU with --instance_feat --remat_g full
    --adam_mu_bf16: 2 steps over 4 wavs, E saved beside G with bf16 first
    moments; --continue_train restores E and goes on from step 2."""
    corpus = tmp_path / "wavs"
    corpus.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        write_wav(str(corpus / f"a{i}.wav"),
                  (rng.standard_normal(3000) * 0.2).astype(np.float32), 48000)
    argv = TOY + FEAT + [
        "--remat_g", "full", "--adam_mu_bf16", "--name", "run",
        "--checkpoints_dir", str(tmp_path), "--dataroot", str(corpus),
        "--no_html", "--device", "cpu", "--validation_split", "0",
        "--niter", "1", "--niter_decay", "0", "--print_freq", "2",
        "--save_latest_freq", "0", "--save_epoch_freq", "1",
        "--serial_batches"]
    state = train_loop.main(argv)
    assert state.step == 2
    run = tmp_path / "run"
    saved_e = torch.load(run / "latest_net_E.pth", weights_only=True)
    for k, v in state.system.netE.state_dict().items():
        assert torch.equal(saved_e[k], v), k
    optim = torch.load(run / "latest_optim.pth", weights_only=True)
    assert optim["G"]["state"]["E.ConvIN_0.Conv_0.weight"]["exp_avg"].dtype \
        == torch.bfloat16
    resumed = train_loop.main(argv + ["--continue_train", "--niter", "2"])
    out = capsys.readouterr().out
    assert "restored checkpoint 'latest'" in out
    assert resumed.step == 4
