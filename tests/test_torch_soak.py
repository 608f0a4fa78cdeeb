"""The flagship soak's recipe, corpus, thresholds and schedule on the CPU
(tools/flagship_soak_torch.py; chip_smoke.py phase 12 runs it on the
card at half its schedule, the tool at full depth).

SOAK_FLAGS are the flags scripts/realspeech_soak.sh hands the JAX
training CLI (the words bash runs), and parse to its Config field for
field; the corpus is byte-stable and holds its f0s out; soak_misses and
serve_misses read their thresholds. At toy width (the TOY LocalEnhancer
of tests/test_torch_train_step.py, one step an epoch, fix-global to
epoch 3, decay over epochs 5 and 6) train_leg's run, SIGINT once epoch 1
has ended and resumed inside fix-global, ends bit for bit where the
uninterrupted run ends when that run also skips the step of the epoch the
interrupt saves as done (epoch 2: a Ctrl+C saves its epoch + 1 as the
cursor, pix2pixhdaudiosr_torch/train_loop.py:311-318, as the JAX loop
does); G's learning rate held at 0 (the planted fault) leaves eval.csv
flat. The slow test trains that toy schedule on the JAX CLI and the
port's from one init and noise and holds the trajectories together.
"""

import dataclasses
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import flagship_soak_torch as soak  # noqa: E402
from chip_smoke import TOY_TRAIN  # noqa: E402
from pix2pixhdaudiosr_torch import train_loop  # noqa: E402
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.data.wavio import read_wav, write_wav  # noqa: E402

# tests/test_torch_train_step.py's TOY (the slow test checks it)
TOY = TOY_TRAIN + ["--seed", "11"]


def _script_train_words(tmp_path):
    """The words scripts/realspeech_soak.sh hands train.py, as bash
    expands them (a shell function records each `python` command)."""
    log = tmp_path / "commands.log"
    prelude = ('python() { printf "%s\\037" "$@" >> "$LOG"; '
               'printf "\\n" >> "$LOG"; }\n')
    env = dict(os.environ, LOG=str(log), CORPUS="/data/rs", CKPT="/data/ck")
    res = subprocess.run(["bash", "-c", prelude + f"source {ROOT}/scripts/"
                          "realspeech_soak.sh"], cwd=tmp_path, env=env,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    cmds = [ln.split("\x1f")[:-1] for ln in log.read_text().splitlines()]
    (train,) = [c for c in cmds if c[0] == "train.py"]
    return train[1:]


def test_soak_flags_are_the_jax_recipe_config(tmp_path):
    """SOAK_MODEL + SOAK_SCHEDULE + SCRIPT_SAVES are the JAX script's
    train.py words but its name and paths, in order, and parse to the
    Config the JAX package parses from them, field for field; the soak's
    own saves (soak_saves) change save_latest_freq, save_epoch_freq and
    no_html alone."""
    from pix2pixhdaudiosr_tpu.config import parse_config as jparse
    words = _script_train_words(tmp_path)
    head = ["--name", "rs_soak", "--checkpoints_dir", "/data/ck",
            "--dataroot", "/data/rs/train"]
    assert words[:6] == head
    saves = words.index("--save_latest_freq")
    assert words[saves:saves + 4] == soak.SCRIPT_SAVES
    assert words[6:saves] + words[saves + 4:] == soak.SOAK_FLAGS
    want = dataclasses.asdict(jparse(words, is_train=True, save=False))
    got = dataclasses.asdict(parse_config(
        head + soak.SOAK_FLAGS + soak.SCRIPT_SAVES, is_train=True, save=False))
    assert got == want
    ours = dataclasses.asdict(parse_config(
        head + soak.SOAK_FLAGS + soak.soak_saves(200), is_train=True,
        save=False))
    assert {k for k in want if ours[k] != want[k]} == {
        "save_latest_freq", "save_epoch_freq", "no_html"}
    assert (ours["compute_dtype"], ours["batch_size"], ours["niter"],
            ours["niter_decay"], ours["niter_fix_global"]) == (
        "bfloat16", 64, 150, 50, 30)


def _md5s(path):
    return {name: hashlib.md5((path / name).read_bytes()).hexdigest()
            for name in sorted(os.listdir(path))}


def test_soak_corpus_is_stable_and_holds_its_f0s_out(tmp_path):
    """write_soak_corpus twice from one seed: every file byte for byte the
    same; 160 one-second and 2 three-second 48 kHz files; each file's
    strongest bin is its f0, and the held-out f0s are no training
    file's."""
    f0s = soak.write_soak_corpus(str(tmp_path / "a"))
    assert soak.write_soak_corpus(str(tmp_path / "b")) == f0s
    for sub in ("train", "eval"):
        assert _md5s(tmp_path / "a" / sub) == _md5s(tmp_path / "b" / sub)
    assert len(f0s["train"]) == len(set(f0s["train"])) == 160
    assert len(f0s["eval"]) == 2
    assert not set(f0s["eval"]) & set(f0s["train"])
    assert all(80 <= f <= 400 for f in f0s["train"] + f0s["eval"])
    for sub, seconds in (("train", 1), ("eval", 3)):
        names = sorted(os.listdir(tmp_path / "a" / sub))
        assert len(names) == len(f0s[sub])
        for name, f0 in zip(names, f0s[sub]):
            x, rate = read_wav(str(tmp_path / "a" / sub / name))
            assert rate == 48000 and x.shape == (1, 48000 * seconds)
            peak = np.argmax(np.abs(np.fft.rfft(x[0]))) / seconds
            assert peak == f0, (name, peak)
    other = soak.write_soak_corpus(str(tmp_path / "c"), seed=1)
    assert other != f0s


# eval.csv of chip_smoke's leg on an H100: an honest run, and G's lr held
# at 0 (the planted fault: G never moves; the rows move with the card's
# nondeterministic convs alone)
CONVERGING = ([2.1249, 2.4439, 2.0097, 1.2343, 1.5504, 1.0663, 1.0351,
               0.9974, 0.9443],
              [6.737, 6.709, 7.217, 8.494, 7.675, 9.43, 9.913, 10.122,
               10.165])
G_LR_0 = ([2.1764, 2.1764, 2.1841, 2.1853, 2.1805, 2.1831, 2.181, 2.1787,
           2.1778],
          [7.145, 7.145, 7.149, 7.149, 7.151, 7.151, 7.151, 7.149, 7.148])


@pytest.mark.parametrize("case,lsds,snrs,missed", [
    ("converging", *CONVERGING, []),
    ("G's lr 0", *G_LR_0, ["final", "improved"]),
    ("flat", [2.1] * 6, [3.0] * 6, ["final", "improved", "SNR"]),
    ("diverging", [2.1, 1.8, 2.4, 3.5, 5.0, 7.0],
     [3.0, 3.5, 2.0, 1.0, 0.0, -2.0], ["final", "improved"]),
    ("late NaN", CONVERGING[0][:-1] + [float("nan")], CONVERGING[1],
     ["non-finite"]),
    ("one row", [2.1], [3.0], ["1 eval rows"]),
])
def test_soak_misses_reads_its_thresholds(case, lsds, snrs, missed):
    """soak_misses passes a converging trajectory and names what the G-lr-0
    fault's, a flat one, a diverging one, a NaN row and a single row
    miss."""
    got = soak.soak_misses(lsds, snrs)
    assert len(got) == len(missed), (case, got)
    assert all(w in g for w, g in zip(missed, got)), (case, got)


def _served(**lsd):
    """A held-out file's LSDs as an H100 run of the leg served them."""
    base = {"plain": 1.255, "fused": 1.2453, "int8_trunk": 1.2548,
            "data_type_8": 1.2468, "lowpass": 3.8663, "untrained": 2.138}
    base.update(lsd)
    return {"held0.wav": {k: {"lsd": v} for k, v in base.items()}}


@pytest.mark.parametrize("case,files,missed", [
    ("met", _served(), 0),
    ("G's lr 0", _served(plain=2.1863, fused=2.1007, int8_trunk=2.1873,
                         data_type_8=2.1868), 3),
    ("no better than the untrained G", _served(**{k: 1.9 for k in (
        "plain", "fused", "int8_trunk", "data_type_8")}), 2),
    ("int8 trunk off", _served(int8_trunk=1.255 + 2 * soak.SERVE_DELTA[
        "int8_trunk"]), 1),
    ("--data_type 8 off", _served(data_type_8=1.255 - 2 * soak.SERVE_DELTA[
        "data_type_8"]), 1),
    ("fused off", _served(fused=1.255 - 2 * soak.SERVE_DELTA["fused"]), 1),
])
def test_serve_misses_reads_its_thresholds(case, files, missed):
    """serve_misses: the trained G below the lowpassed input and the
    untrained G by their margins, each way within its delta of plain; the
    G-lr-0 fault's serve misses both margins and the fused delta."""
    assert len(soak.serve_misses(files)) == missed, case


def _run(leg, lsds):
    return leg, {"name": f"leg{leg}", "lsd": lsds}


def test_spread_summary_holds_knobs_to_3x_the_plain_spread():
    """spread_summary: the spread is the widest gap between the plain
    runs (leg 1 and each leg 2), by the last row and by the mean of the
    last TAIL_ROWS rows; each knob run's gap to leg 1 is held to 3x it
    (final rows of an H100 run at full depth: 0.9203, 0.9162, remat
    0.9208, --adam_mu_bf16 0.9346)."""
    pad = [1.0] * (soak.TAIL_ROWS - 1)
    done = [_run(1, pad + [0.9203]), _run(2, pad + [0.9162]),
            _run(3, pad + [0.9208]), _run(4, pad + [0.9346]), (5, {})]
    got = soak.spread_summary(done)
    final = got["final"]
    assert final["spread"] == pytest.approx(0.0041)
    assert [k["within_3x"] for k in final["knobs"]] == [True, False]
    assert got["tail"]["spread"] == pytest.approx(0.0041 / soak.TAIL_ROWS)
    done.insert(2, _run(2, pad + [0.9362]))
    assert all(k["within_3x"] for k in soak.spread_summary(done)["final"][
        "knobs"])
    assert soak.spread_summary(done[1:]) == {}


def test_cadence_count_follows_the_loop_deltas():
    """cadence_count counts from a run's start, as the loop's deltas do:
    a resume at 1408 samples with a 1280 cadence lands at 2688, 3968,
    ..."""
    assert soak.cadence_count(0, 2560, 64, 1280) == 2
    assert soak.cadence_count(1408, 12800, 64, 1280) == 8
    assert soak.cadence_count(4, 12, 2, 2) == 4


# ------------------------------------------------ the toy schedule
TOY_SCHEDULE = ["--niter", "4", "--niter_decay", "2", "--niter_fix_global",
                "3", "--validation_split", "0.34", "--eval_freq", "2",
                "--eval_size", "0", "--print_freq", "0", "--serial_batches",
                "--nThreads", "1", *soak.soak_saves(6)]


def _toy_corpus(path):
    """3 wavs shorter than the 480-sample segment (no random offset): 2
    train (one step an epoch at batch 2), 1 validates."""
    path.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        write_wav(str(path / f"t{i}.wav"),
                  (rng.standard_normal(300) * 0.2).astype(np.float32), 48000)
    return str(path)


def _toy_flags(tmp_path, name):
    return [*TOY, *TOY_SCHEDULE, "--name", name, "--checkpoints_dir",
            str(tmp_path / "ck"), "--dataroot", str(tmp_path / "wavs")]


def _saved(expr):
    """Every tensor and number of a run's `latest` save, by name."""
    out = {}
    for part in ("net_G", "net_D", "optim"):
        sd = torch.load(expr / f"latest_{part}.pth", weights_only=True)
        stack = [(part, sd)]
        while stack:
            key, v = stack.pop()
            if isinstance(v, dict):
                stack += [(f"{key}.{k}", w) for k, w in v.items()]
            elif isinstance(v, (list, tuple)):
                stack += [(f"{key}.{i}", w) for i, w in enumerate(v)]
            else:
                out[key] = v
    return out


def _equal(a, b):
    assert set(a) == set(b) and len(a) > 10
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _skip_step(at):
    """A make_train_step whose call number `at` takes no step: it returns
    the last call's losses, as if that epoch had not been trained."""
    make = train_loop.make_train_step
    calls = []

    def made(system):
        fn = make(system)

        def step(state, *args, **kw):
            calls.append(1)
            if len(calls) == at:
                return last[0]
            last[0] = fn(state, *args, **kw)
            return last[0]
        last = [None]
        return step
    return made


@pytest.fixture
def toy_corpus(tmp_path):
    _toy_corpus(tmp_path / "wavs")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tmp_path
    torch.set_num_threads(threads)


def test_toy_interrupt_inside_fix_global_resumes_bit_for_bit(
        toy_corpus, monkeypatch):
    """train_leg at toy width, SIGINT once epoch 1 has ended: the loop
    saves at epoch 2's first batch, the run resumes at epoch 3 inside
    fix-global (G, D and both Adams bit-equal to the saved state before
    its first step), switches once after epoch 3, ends with both learning
    rates 0, and its `latest` save (G, D, both Adams, their learning
    rates) and eval.csv rows equal bit for bit those of the uninterrupted
    run that takes no step in epoch 2 (its epoch-2 row dropped)."""
    tmp_path = toy_corpus
    leg = soak.train_leg(_toy_flags(tmp_path, "cut"), "cpu", 1)
    assert leg["misses"] == [] and leg["resumed_equal"]
    assert leg["steps"] == 5 and len(leg["lsd"]) == 5
    monkeypatch.setattr(train_loop, "make_train_step", _skip_step(2))
    whole = train_loop.main([*_toy_flags(tmp_path, "whole"), "--device",
                             "cpu"])
    assert [g["lr"] for opt in (whole.opt_g, whole.opt_d)
            for g in opt.param_groups] == [0.0, 0.0]
    ck = tmp_path / "ck"
    _equal(_saved(ck / "cut"), _saved(ck / "whole"))
    cut = (ck / "cut" / "eval.csv").read_text().splitlines()
    rows = (ck / "whole" / "eval.csv").read_text().splitlines()
    assert len(rows) == 1 + 6
    assert cut == rows[:2] + rows[3:]


def test_toy_leg_with_g_lr_0_stays_flat(toy_corpus):
    """The planted fault (train_leg's g_lr0): G's learning rate 0 from the
    first step leaves G where it started, so every eval row is the same
    and soak_misses fails the trajectory; the schedule's own checks
    still pass."""
    leg = soak.train_leg(_toy_flags(toy_corpus, "fault"), "cpu", 1,
                         fault="g_lr0")
    assert leg["misses"] == []
    assert len(set(leg["lsd"])) == 1 and len(set(leg["snr"])) == 1
    misses = soak.soak_misses(leg["lsd"], leg["snr"])
    assert any("improved" in m for m in misses), misses


# ------------------------------------------------ the port against JAX
@pytest.mark.slow
def test_toy_schedule_matches_jax_from_one_init(toy_corpus, monkeypatch):
    """The toy schedule (fix-global, the fresh G Adam, the decay) on the
    JAX CLI and the port's, uninterrupted, from the JAX loop's init
    (convert.py) with its mask-noise draws, as
    tests/test_torch_quality_gate.py's slow test runs the gate: the eval
    rows' LSD and SNR within that test's bounds of JAX's."""
    import jax
    from pix2pixhdaudiosr_tpu import trainer as jtrainer
    from pix2pixhdaudiosr_tpu.config import parse_config as jparse
    from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem
    from pix2pixhdaudiosr_tpu.train_loop import main as jtrain_main
    from test_torch_quality_gate import (EARLY_LSD, EARLY_ROWS, EARLY_SNR,
                                         TRAJ_LSD, TRAJ_SNR)
    from test_torch_slice import _jax_mask_noise as jax_eval_noise
    from test_torch_train_step import TOY as TRAIN_STEP_TOY
    from test_torch_train_step import _mask_noise as jax_step_noise

    from pix2pixhdaudiosr_torch import trainer
    from pix2pixhdaudiosr_torch.convert import (jax_to_torch_discriminator,
                                                jax_to_torch_generator)

    assert sorted(TOY) == sorted(TRAIN_STEP_TOY)
    tmp_path = toy_corpus
    jcfg = jparse(_toy_flags(tmp_path, "jax"), is_train=True)
    jtrain_main(cfg=jcfg)
    want = soak.read_eval(os.path.join(jcfg.expr_dir, "eval.csv"))
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
    train_loop.main([*_toy_flags(tmp_path, "port"), "--device", "cpu"])
    got = soak.read_eval(tmp_path / "ck" / "port" / "eval.csv")
    print("jax lsd", want[0], "snr", want[1])
    print("port lsd", got[0], "snr", got[1])
    assert len(got[0]) == len(want[0]) == 6
    early = slice(0, EARLY_ROWS)
    np.testing.assert_allclose(got[0][early], want[0][early], rtol=0,
                               atol=EARLY_LSD)
    np.testing.assert_allclose(got[1][early], want[1][early], rtol=0,
                               atol=EARLY_SNR)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TRAJ_LSD)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TRAJ_SNR)
