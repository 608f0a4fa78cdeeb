"""The converged-quality gate (tests/test_quality_gate.py) on the port's
training CLI, on the CPU.

The JAX gate's fixed-seed synthetic harmonic corpus (its `_make_corpus`,
seed 42), its configuration flag for flag (a 2-downsample global G at ngf
16 with 2 resblocks, the 2-scale PatchGAN at ndf 8, the match loss, batch
4, 32 steps, an eval every 4 steps over the 2 validation files), seed 7
and f32 compute go through pix2pixhdaudiosr_torch.train_loop.main, and
the in-training eval's eval.csv is held to the JAX gate's three
conditions, unchanged: the last LSD below 2.8, an improvement of more
than 0.4 LSD on the first eval, and an SNR above the first.

The slow test trains the same gate on both packages from one init (the
JAX loop's, seeded from cfg.seed, carried across by convert.py) with the
JAX loop's mask-noise draws fed to the port's steps and evals, and holds
the port's LSD and SNR trajectory against JAX's. Run it with
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quality_gate.py -m slow
"""

import csv
import dataclasses
import filecmp
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from test_quality_gate import _make_corpus  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import GATE_FLAGS, gate_misses  # noqa: E402
from pix2pixhdaudiosr_torch import train_loop, trainer  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402


def gate_argv(tmp_path, device="cpu"):
    """The gate's corpus (the JAX gate's _make_corpus) written under
    tmp_path, and the CLI's argv."""
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    _make_corpus(str(wav_dir))
    return GATE_FLAGS + ["--checkpoints_dir", str(tmp_path / "ck"),
                         "--dataroot", str(wav_dir), "--device", device]


def jax_gate_config(tmp_path, checkpoints_dir):
    """tests/test_quality_gate.py's Config (its lines 45-53)."""
    from pix2pixhdaudiosr_tpu.config import Config
    return Config(
        name="qgate", checkpoints_dir=str(checkpoints_dir),
        dataroot=str(tmp_path / "wavs"), net_g="global", ngf=16,
        n_downsample_global=2, n_blocks_global=2, ndf=8, n_layers_d=2,
        num_d=2, input_nc=2, output_nc=2, label_nc=0, batch_size=4,
        explicit_encoding=True, mask_mode="mode2", no_instance=True,
        no_vgg_loss=True, use_match_loss=True, niter=32, niter_decay=0,
        save_epoch_freq=10**6, save_latest_freq=10**9, print_freq=10**9,
        display_freq=10**9, eval_freq=16, validation_split=0.25,
        eval_size=2, n_threads=2, seed=7, compute_dtype="float32")


def read_eval(path):
    """eval.csv's rows: (lsds, snrs)."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [float(r["lsd"]) for r in rows], [float(r["snr"]) for r in rows]


def check_gate(lsds, snrs):
    """The JAX gate's three conditions (tests/test_quality_gate.py:58-64)."""
    assert not gate_misses(lsds, snrs), (lsds, snrs)


def test_gate_flags_are_the_jax_gate_config(tmp_path):
    """chip_smoke.GATE_FLAGS parse to the JAX gate's Config, field for
    field, but --no_html (the gallery, which display_freq 10**9 never
    renders, off so that the card's machine needs no matplotlib)."""
    argv = gate_argv(tmp_path)
    got = dataclasses.asdict(parse_config(argv[:-2], is_train=True,
                                          save=False))
    want = dataclasses.asdict(jax_gate_config(tmp_path, tmp_path / "ck"))
    assert got.pop("no_html") and not want.pop("no_html")
    assert got == want


def test_gate_corpus_is_the_jax_corpus(tmp_path):
    """chip_smoke.write_gate_corpus writes the JAX gate's _make_corpus
    files byte for byte."""
    (tmp_path / "jax").mkdir()
    _make_corpus(str(tmp_path / "jax"))
    chip_smoke.write_gate_corpus(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 8
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port",
                                           names, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("case,lsds,snrs,missed", [
    ("met", [3.0, 2.7, 2.5], [5.0, 6.0, 5.5], 0),
    ("final", [3.5, 2.9, 2.85], [5.0, 6.0, 6.5], 1),
    ("gain", [2.7, 2.4, 2.35], [5.0, 6.0, 6.5], 1),
    ("snr", [3.0, 2.7, 2.5], [6.0, 5.0, 6.0], 1),
    ("all", [2.9, 2.85, 2.9], [6.0, 5.0, 5.5], 3),
])
def test_gate_misses_reads_the_jax_conditions(case, lsds, snrs, missed):
    """chip_smoke.gate_misses: the last LSD below 2.8, the first more than
    0.4 above the least, an SNR above the first; each missed alone, and
    all three."""
    assert len(gate_misses(lsds, snrs)) == missed, case


@pytest.fixture(scope="module")
def gate_calls():
    """One gate train step (batch 4) and one eval batch (batch 2) on the
    CPU, every InstanceNorm forward and backward recorded by (H, W, C):
    what a card's run would launch; and the InstanceNorms of a G and of a
    D forward (chip_smoke.count_norms)."""
    from pix2pixhdaudiosr_torch.models import layers
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    cfg = parse_config(GATE_FLAGS, is_train=True, save=False)
    system = Pix2PixHDSystem(cfg, device="cpu")
    state = trainer.init_state(system, cfg.seed)
    seen = {"fwd": {}, "bwd": {}}

    def spy(kind, fn):
        def call(x, *args, **kw):
            key = tuple(x.shape[2:]) + (x.shape[1],)
            seen[kind][key] = seen[kind].get(key, 0) + 1
            return fn(x, *args, **kw)
        return call

    fwd, bwd = layers.instance_norm_act, layers.instance_norm_act_grad
    layers.instance_norm_act = spy("fwd", fwd)
    layers.instance_norm_act_grad = spy("bwd", bwd)
    try:
        out = []
        rng = np.random.default_rng(0)
        for train, batch in ((True, 4), (False, 2)):
            seen["fwd"], seen["bwd"] = {}, {}
            x = {k: torch.from_numpy((rng.standard_normal(
                (batch, cfg.segment_length)) * 0.1).astype(np.float32))
                for k in ("label", "image")}
            gen = torch.Generator().manual_seed(1)
            if train:
                trainer.make_train_step(system)(state, x, gen)
            else:
                trainer.make_eval_step(system)(x["label"], torch.randn(
                    batch, system.codec.mask_size(
                        system.spectro_shape(batch)[1]),
                    *system.spectro_shape(batch)[2:], generator=gen))
            out.append((train, batch, dict(seen["fwd"]), dict(seen["bwd"])))
    finally:
        layers.instance_norm_act, layers.instance_norm_act_grad = fwd, bwd
    norms = (chip_smoke.count_norms(system.netG_train),
             chip_smoke.count_norms(system.netD))
    return cfg, norms, out


def _planned_delta(cfg, train, batch, fwd, bwd):
    """The counts a card's step or eval batch would leave from 0, every
    launch on its planner's route (the wrappers' counts by kernel)."""
    from pix2pixhdaudiosr_torch.ops import mdct_kernels, norm
    f32 = torch.float32
    tc = mdct_kernels.tc_route(cfg.win_length, cfg.hop_length, cfg.n_fft)
    n_b1, n_b2 = (2, 0) if train else (1, 1)
    routes = {}
    for (H, W, C), n in bwd.items():
        r = norm.plan_instance_norm_grad(batch, H, W, C, f32).route
        routes[r] = routes.get(r, 0) + n
    return {
        "mdct2": {"launches": n_b1, "launches_tc": n_b1 * tc},
        "imdct2": {"launches": n_b2, "launches_tc": n_b2 * tc},
        "imdct2_grad": {"launches": 0, "launches_tc": 0},
        "instance_norm_act": {
            "launches": sum(fwd.values()), "launches_by_shape": fwd,
            "launches_onepass": sum(
                n for (H, W, C), n in fwd.items() if norm.plan_instance_norm(
                    batch, H, W, C, f32).route == "onepass")},
        "instance_norm_act_grad": {
            "launches": sum(bwd.values()), "launches_by_shape": bwd,
            "launches_by_route": routes}}


@pytest.mark.parametrize("fault", [None, "missing", "b3_route",
                                   "b3_grad_route", "b1_route", "b2"])
def test_card_leg_holds_each_launch_to_its_planner(gate_calls, fault):
    """chip_smoke.check_planned_routes, the card leg's launch check, on
    the counts a CPU step and eval batch of the gate imply: the
    InstanceNorms a step calls (21 forwards and 21 backwards) and an eval
    batch (9) are planned_launches' from count_norms of the built G and
    D; every launch on its planner's route
    passes; a launch missing, one B3 or B3 backward launch on the other
    route, a B1 launch off the tensor cores or a B2 launch in a step
    fails."""
    cfg, norms, calls = gate_calls
    assert norms == (9, 4)
    for train, batch, fwd, bwd in calls:
        want = chip_smoke.planned_launches(train, *norms)
        assert sum(fwd.values()) == want["instance_norm_act"]
        assert sum(bwd.values()) == want["instance_norm_act_grad"]
        delta = _planned_delta(cfg, train, batch, fwd, bwd)
        if fault and train:
            if fault == "missing":
                delta["instance_norm_act_grad"]["launches"] -= 1
            elif fault == "b3_route":
                delta["instance_norm_act"]["launches_onepass"] -= 1
            elif fault == "b3_grad_route":
                routes = delta["instance_norm_act_grad"]["launches_by_route"]
                r = next(iter(routes))
                routes[r] -= 1
                routes["other"] = 1
            elif fault == "b1_route":
                delta["mdct2"]["launches_tc"] -= 1
            else:
                delta["imdct2"]["launches"] += 1
            with pytest.raises(chip_smoke.SmokeFailure):
                chip_smoke.check_planned_routes("step", delta, cfg, batch,
                                                want)
        else:
            chip_smoke.check_planned_routes("call", delta, cfg, batch, want)


# The intra-op threads the CPU gate runs on: a thread count sets the order
# of the CPU's reductions, so eval.csv is reproducible under this pin.
GATE_THREADS = 2


@pytest.fixture
def gate_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(GATE_THREADS)
    yield
    torch.set_num_threads(threads)


def test_port_training_improves_lsd(tmp_path, gate_threads):
    """32 steps of the gate through the port's CLI on the CPU, on
    GATE_THREADS threads: 8 eval rows that meet the JAX gate's
    thresholds."""
    train_loop.main(gate_argv(tmp_path))
    lsds, snrs = read_eval(tmp_path / "ck" / "qgate" / "eval.csv")
    assert len(lsds) == 8, lsds
    check_gate(lsds, snrs)


# ------------------------------------------------ the port against JAX
# The slow test's bounds, from where the two f32 runs part (CPU, one init,
# JAX's noise). Through the 6th eval (step 24) the LSDs agreed to 2.3e-3
# and the SNRs to 0.20 dB (0.004 dB through the 4th); at the 7th and 8th
# the LSDs parted to 0.029 and 0.034, the SNRs to 0.70 dB. The runs from
# their own draws (the port's init and noise against JAX's) had stood 0.43
# LSD apart at step 12 and 0.13 at the end: both bounds would catch that.
EARLY_ROWS, EARLY_LSD, EARLY_SNR = 6, 0.01, 0.3
TRAJ_LSD, TRAJ_SNR = 0.1, 1.0


@pytest.mark.slow
def test_port_trajectory_matches_jax_from_one_init(tmp_path, monkeypatch):
    """The JAX gate (train_main on its Config) and the port's CLI from the
    JAX loop's init (init_state at PRNGKey(seed), batch 4, through
    convert.py), every train step's mask noise JAX's draw at
    PRNGKey(seed * 1000003 + total_steps) and every eval batch's at
    PRNGKey(seed + j): the first EARLY_ROWS eval rows' LSD within
    EARLY_LSD and SNR within EARLY_SNR dB of JAX's, every row's within
    TRAJ_LSD and TRAJ_SNR; and the port's run meets the gate."""
    import jax
    from pix2pixhdaudiosr_tpu import trainer as jtrainer
    from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem
    from pix2pixhdaudiosr_tpu.train_loop import main as jtrain_main
    from test_torch_slice import _jax_mask_noise as jax_eval_noise
    from test_torch_train_step import _mask_noise as jax_step_noise

    from pix2pixhdaudiosr_torch.convert import (jax_to_torch_discriminator,
                                                jax_to_torch_generator)

    argv = gate_argv(tmp_path)
    jcfg = jax_gate_config(tmp_path, tmp_path / "jck")
    jtrain_main(cfg=jcfg)
    want = read_eval(os.path.join(jcfg.expr_dir, "eval.csv"))

    # the JAX loop's init (train_loop.py:92-93)
    jstate, _, _ = jtrainer.init_state(JSystem(jcfg),
                                       jax.random.PRNGKey(jcfg.seed),
                                       batch=jcfg.batch_size)
    params = jax.device_get(jstate.params)

    port = {}

    def init_state(system, seed):
        port["system"] = system
        state = trainer.init_state(system, seed)
        system.netG_train.load_state_dict(jax_to_torch_generator(params["G"]))
        system.netD.load_state_dict(jax_to_torch_discriminator(params["D"]))
        return state

    def step_noise(device, seed):
        system = port["system"]
        b, f, t, c = system.spectro_shape(jcfg.batch_size)
        return jax_step_noise(jax.random.PRNGKey(seed),
                              (b, system.codec.mask_size(f), t, c)).to(device)

    monkeypatch.setattr(train_loop, "init_state", init_state)
    monkeypatch.setattr(train_loop, "_generator", step_noise)
    monkeypatch.setattr(train_loop, "seeded_noise",
                        lambda system, seed: jax_eval_noise(seed))
    train_loop.main(argv)
    got = read_eval(tmp_path / "ck" / "qgate" / "eval.csv")
    print("jax lsd", want[0], "snr", want[1])
    print("port lsd", got[0], "snr", got[1])
    assert len(got[0]) == len(want[0]) == 8
    early = slice(0, EARLY_ROWS)
    np.testing.assert_allclose(got[0][early], want[0][early], rtol=0,
                               atol=EARLY_LSD)
    np.testing.assert_allclose(got[1][early], want[1][early], rtol=0,
                               atol=EARLY_SNR)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TRAJ_LSD)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TRAJ_SNR)
    check_gate(*got)
