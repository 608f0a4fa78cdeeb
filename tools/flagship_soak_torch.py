#!/usr/bin/env python3
"""The flagship recipe trained to convergence through the port's training
CLI on one NVIDIA GPU, interrupted and resumed inside its fix-global
phase, then served and scored on held-out files.

The recipe is scripts/realspeech_soak_torch.sh's (lines 26-36), flag for
flag (SOAK_FLAGS), on a seeded synthetic corpus in that script's layout
(write_soak_corpus: train/ with 160 one-second 48 kHz harmonic tones, 128
of them training after the 0.2 split, i.e. 2 steps an epoch at batch 64,
and eval/ with two held-out 3 s tones whose f0s no training file uses).
Only the save cadences differ (soak_saves): the end of the run saves, and
a Ctrl+C saves, nothing else; and --no_html, since the gallery would need
matplotlib.

    python3 tools/flagship_soak_torch.py [--legs 1,2,3,4,5]
    python3 tools/flagship_soak_torch.py --legs 1,2,2,2,3,4,5
    python3 tools/flagship_soak_torch.py --half [--runs 3] [--fault g_lr0]

Full depth, the recipe's 200 epochs (400 steps), one JSON line a leg (its
eval.csv LSD and SNR trajectory, seconds, peak GiB, losses at the first
step, around the interrupt and at the last step, the schedule's checks):

  1. plain, SIGINT once epoch 20 has ended (inside fix-global, which runs
     to epoch 30), then --continue_train to epoch 200; G, D and both Adam
     states before the first resumed step against the state the
     interrupt saved;
  2. plain, uninterrupted, the same seed (the widest gap between the
     plain runs, leg 1 and each leg 2, is the spread);
  3. --remat_g full; 4. --adam_mu_bf16 (uninterrupted, the same seed):
     each one's gap to leg 1 against 3x the spread (spread_summary, by
     the last eval row's LSD and by the mean of the last TAIL_ROWS);
  5. the serve chain on leg 1's latest_net_G.pth: the generate CLI on
     each held-out file plain (bf16, batch 16), --fused_enhancer at batch
     128, --int8_trunk and --data_type 8 (LSD, SNR and SSNR read from its
     output), beside the lowpassed input and a seeded N(0, 0.02) G
     (chip_smoke.flagship_generator_pth); then the evaluate CLI on eval/.
A leg given twice in --legs runs twice.

A Ctrl+C stops at the next batch and saves that epoch as done (iter.txt
epoch + 1), as the JAX loop does (pix2pixhdaudiosr_tpu/train_loop.py:
196-206): the SIGINT after epoch 20 saves at epoch 21's first batch, and
the resumed run starts at epoch 22; epoch 21 is never trained.

--half runs chip_smoke.py's leg of phase 12 (phase_flagship_soak) alone
and its checks, --runs times: the same flags at half the schedule (100
epochs, fix-global 15, decay from epoch 76), SIGINT after epoch 10.
--fault g_lr0 holds G's learning rate at 0 from the first step, a planted
fault the leg must fail on. Checkpoints go under --work (default
_soak_run/, gitignored) and are deleted when a leg no longer needs them.
Exits non-zero without a card, and where a --half run fails.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scripts/realspeech_soak_torch.sh:26-29 (FLAGSHIP) and :33-36 (train)
SOAK_MODEL = [
    "--no_instance", "--no_vgg_loss", "--label_nc", "0", "--output_nc", "2",
    "--input_nc", "2", "--nThreads", "16", "--mask", "--mask_mode", "mode2",
    "--netG", "local", "--abs_spectro", "--center", "--explicit_encoding",
    "--n_blocks_global", "3", "--n_blocks_local", "2", "--ngf", "48",
    "--use_match_loss"]
SOAK_SCHEDULE = [
    "--batchSize", "64", "--niter", "150", "--niter_decay", "50",
    "--niter_fix_global", "30", "--validation_split", "0.2",
    "--eval_freq", "1280", "--eval_size", "32", "--print_freq", "256"]
SOAK_FLAGS = SOAK_MODEL + SOAK_SCHEDULE
# chip_smoke's leg: half the schedule
HALF_SCHEDULE = ["--niter", "75", "--niter_decay", "25",
                 "--niter_fix_global", "15"]
# the script saves `latest` every 2560 samples and the epoch every 100
# epochs (--save_latest_freq 2560 --save_epoch_freq 100); here only the last
# epoch saves (1.9 GB a tag at flagship width), besides the interrupt
SCRIPT_SAVES = ["--save_latest_freq", "2560", "--save_epoch_freq", "100"]


def soak_saves(last_epoch: int) -> list:
    return ["--save_latest_freq", "0", "--save_epoch_freq", str(last_epoch),
            "--no_html"]


# the SIGINT: once this epoch has ended (full depth, the half leg)
INTERRUPT_EPOCH, HALF_INTERRUPT_EPOCH = 20, 10
# landing's tail: the last eval rows averaged
TAIL_ROWS = 5
SERVE_WAYS = {"plain": ["--batchSize", "16"],
              "fused": ["--fused_enhancer", "--batchSize", "128"],
              "int8_trunk": ["--int8_trunk", "--batchSize", "16"],
              "data_type_8": ["--data_type", "8", "--batchSize", "16"]}

# the corpus
CORPUS_RATE, TRAIN_FILES, EVAL_FILES = 48000, 160, 2
TRAIN_SECONDS, EVAL_SECONDS = 1, 3
F0_RANGE, TOP_HZ, NOISE_DB = (80, 400), 20000, -40.0

# The half leg's thresholds (soak_misses, serve_misses), each the worst of
# three H100 runs of the leg (PERF.md §6) widened by three times the
# runs' spread: final LSD 0.935-1.049 (limit 1.049 + 3 x 0.114); the
# least LSD 1.05-1.18 below the first (1.05 - 3 x 0.13); a held-out
# file's trained LSD 2.55 below the lowpassed input's and 0.82 below the
# untrained G's at the least, its spread 0.096 (2.55 - 0.29, 0.82 -
# 0.29); |way - plain| up to 0.0175 fused (spread 0.0102), 0.0007 int8
# trunk (0.0005), 0.0082 --data_type 8 (0.0059). G at lr 0 read a final
# LSD of 2.178, 0.0 below the first, 1.68 below the input's.
SOAK_FINAL_LSD, SOAK_LSD_GAIN = 1.4, 0.65
SERVE_LOWPASS_MARGIN, SERVE_UNTRAINED_MARGIN = 2.2, 0.5
SERVE_DELTA = {"int8_trunk": 0.01, "data_type_8": 0.03, "fused": 0.05}


def harmonic_tone(rng, f0: int, seconds: int) -> "np.ndarray":
    """A tone at integer f0 (so that every harmonic sits on an FFT bin of a
    whole-second file): harmonics k f0 below TOP_HZ at 1/k, random phases,
    a slow amplitude envelope, peak 0.5, noise NOISE_DB below its RMS."""
    import numpy as np
    n = CORPUS_RATE * seconds
    spec = np.zeros(n // 2 + 1, np.complex128)
    k = np.arange(1, (TOP_HZ - 1) // f0 + 1)
    spec[k * f0 * seconds] = (n / 2) / k * np.exp(
        1j * rng.uniform(0, 2 * np.pi, k.size))
    t = np.arange(n) / CORPUS_RATE
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t
                             + rng.uniform(0, 2 * np.pi))
    x = np.fft.irfft(spec, n) * env
    x *= 0.5 / np.max(np.abs(x))
    rms = np.sqrt(np.mean(x ** 2))
    x += rng.standard_normal(n) * rms * 10 ** (NOISE_DB / 20)
    return x.astype(np.float32)


def write_soak_corpus(out: str, seed: int = 0) -> dict:
    """TRAIN_FILES one-second tones in out/train and EVAL_FILES 3 s ones in
    out/eval (harmonic_tone, written by the port's write_wav), from
    numpy's default_rng(seed): the held-out f0s drawn first, the training
    f0s from the other integers of F0_RANGE without repeats. Returns
    {"train": [f0, ...], "eval": [f0, ...]} in file order."""
    import numpy as np
    from pix2pixhdaudiosr_torch.data.wavio import write_wav
    rng = np.random.default_rng(seed)
    f0s = np.arange(F0_RANGE[0], F0_RANGE[1] + 1)
    held = rng.choice(f0s, EVAL_FILES, replace=False)
    train = rng.choice(np.setdiff1d(f0s, held), TRAIN_FILES, replace=False)
    for sub, picks, seconds in (("train", train, TRAIN_SECONDS),
                                ("eval", held, EVAL_SECONDS)):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
        for i, f0 in enumerate(picks):
            write_wav(os.path.join(out, sub, f"{sub}{i:03d}_{f0}hz.wav"),
                      harmonic_tone(rng, int(f0), seconds), CORPUS_RATE)
    return {"train": [int(f) for f in train], "eval": [int(f) for f in held]}


def quiet_config(flags: list, is_train: bool):
    """parse_config without its printout."""
    from pix2pixhdaudiosr_torch.config import parse_config
    with contextlib.redirect_stdout(io.StringIO()):
        return parse_config(flags, is_train=is_train, save=False)


def read_eval(path: str) -> tuple:
    """eval.csv's (lsds, snrs)."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [float(r["lsd"]) for r in rows], [float(r["snr"]) for r in rows]


def soak_misses(lsds: list, snrs: list) -> list:
    """The half leg's convergence conditions that an eval.csv trajectory
    misses: every value finite, the last LSD below SOAK_FINAL_LSD, the
    least at least SOAK_LSD_GAIN below the first, an SNR above the
    first."""
    if len(lsds) < 2:
        return [f"{len(lsds)} eval rows"]
    if not all(math.isfinite(v) for v in lsds + snrs):
        return [f"a non-finite row: LSD {lsds}, SNR {snrs}"]
    return [what for what, ok in (
        (f"final LSD {lsds[-1]} not below {SOAK_FINAL_LSD}",
         lsds[-1] < SOAK_FINAL_LSD),
        (f"LSD improved by {lsds[0] - min(lsds)}, less than {SOAK_LSD_GAIN}",
         lsds[0] - min(lsds) >= SOAK_LSD_GAIN),
        (f"no SNR above the first {snrs[0]}", max(snrs[1:]) > snrs[0]))
        if not ok]


def serve_misses(files: dict) -> list:
    """The half leg's serving conditions, each held-out file's: the
    trained G's LSD (plain) at least SERVE_LOWPASS_MARGIN below the
    lowpassed input's and SERVE_UNTRAINED_MARGIN below the untrained G's,
    and each other way within SERVE_DELTA of plain."""
    misses = []
    for name, f in files.items():
        plain = f["plain"]["lsd"]
        for ref, margin in (("lowpass", SERVE_LOWPASS_MARGIN),
                            ("untrained", SERVE_UNTRAINED_MARGIN)):
            if not plain <= f[ref]["lsd"] - margin:
                misses.append(f"{name}: LSD {plain} not {margin} below "
                              f"{ref}'s {f[ref]['lsd']}")
        for way, delta in SERVE_DELTA.items():
            if not abs(f[way]["lsd"] - plain) <= delta:
                misses.append(f"{name}: {way} LSD {f[way]['lsd']} not within "
                              f"{delta} of plain's {plain}")
    return misses


def cadence_count(start: int, end: int, batch: int, freq: int) -> int:
    """How many of a run's steps from `start` samples to `end` land on a
    cadence of `freq` samples counted from the run's start (the loop's
    deltas)."""
    return sum(1 for t in range(start + batch, end + 1, batch)
               if t % freq == start % freq)


def state_tensors(state) -> dict:
    """G, D and both Adams' state (a copy of every tensor, where it lies)
    and their learning rates, by name."""
    import torch
    g = state.system.netG_train.state_dict()
    out = {f"G.{k}": v for k, v in g.items()}
    for key, net in state.system.d_nets().items():
        out.update({f"{key}.{k}": v for k, v in net.state_dict().items()})
    for key, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        sd = opt.state_dict()
        for i, s in sd["state"].items():
            out.update({f"{key}.{i}.{k}": v for k, v in s.items()})
        for i, group in enumerate(sd["param_groups"]):
            out[f"{key}.group{i}.lr"] = group["lr"]
    return {k: v.detach().clone() if torch.is_tensor(v) else v
            for k, v in out.items()}


def state_differs(state, saved: dict) -> list:
    """The names whose value in `state` is not bit-equal to `saved`'s."""
    import torch
    now = state_tensors(state)
    if set(now) != set(saved):
        return sorted(set(now) ^ set(saved))
    return [k for k, v in now.items()
            if not (torch.equal(v, saved[k]) if torch.is_tensor(v)
                    else v == saved[k])]


def train_leg(flags: list, device: str, interrupt_epoch: int = 0,
              wrap=None, fault: str = None) -> dict:
    """train_loop.main on `flags` (with --name, --checkpoints_dir and
    --dataroot) in this process, its output kept. With interrupt_epoch,
    SIGINT once that epoch's last step is done (signal.raise_signal), then
    --continue_train to the end; before the first resumed step G, D and
    both Adams are held against the state the interrupt saved.
    `wrap(make, train)` wraps train_loop.make_train_step (train True) and
    make_eval_step; `fault` "g_lr0" sets G's learning rate to 0 before
    every step. Returns the eval.csv trajectory, seconds, peak GiB,
    losses and `misses`: the schedule's checks the run failed (the epochs
    trained, the fix-global switch printed once after its epoch, both
    learning rates 0 after the last epoch, the eval rows on their
    cadence, the save and the resume)."""
    import torch
    from pix2pixhdaudiosr_torch import train_loop
    from pix2pixhdaudiosr_torch.data.filelist import (discover_files,
                                                      train_val_split)
    cfg = quiet_config(flags, True)
    train_idx, _ = train_val_split(len(discover_files(cfg.dataroot)),
                                   cfg.validation_split, cfg.seed)
    spe = len(train_idx) // cfg.batch_size
    ds = spe * cfg.batch_size
    last = cfg.niter + cfg.niter_decay
    stop = interrupt_epoch * spe
    seen = {"resumed": False, "differs": None}
    losses, saved, at, marks = [], {}, [], {}

    def leg_step(make):
        def made(system):
            fn = make(system)

            def step(state, *args, **kw):
                if fault == "g_lr0":
                    for group in state.opt_g.param_groups:
                        group["lr"] = 0.0
                if seen["resumed"] and seen["differs"] is None:
                    marks["resumed"] = time.perf_counter()
                    seen["differs"] = state_differs(state, saved)
                    saved.clear()
                at.append(time.perf_counter())
                out = fn(state, *args, **kw)
                losses.append({k: v.detach() if torch.is_tensor(v) else v
                               for k, v in out[0].items()})
                if not seen["resumed"] and len(losses) == stop:
                    signal.raise_signal(signal.SIGINT)
                return out
            return step
        return made

    makers = train_loop.make_train_step, train_loop.make_eval_step
    train_loop.make_train_step = leg_step(
        wrap(makers[0], True) if wrap else makers[0])
    if wrap:
        train_loop.make_eval_step = wrap(makers[1], False)
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()
    argv = [*flags, "--device", device]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text):
            state = train_loop.main(argv)
        marks["returned"] = time.perf_counter()
        first_steps = state.step
        if interrupt_epoch:
            saved.update(state_tensors(state))
            marks["snapshot"] = time.perf_counter()
            del state
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            seen["resumed"] = True
            with contextlib.redirect_stdout(text):
                state = train_loop.main(argv + ["--continue_train"])
        if cuda:
            torch.cuda.synchronize()
        marks["end"] = time.perf_counter()
        seconds = marks["end"] - t0
    finally:
        train_loop.make_train_step, train_loop.make_eval_step = makers
    lines = text.getvalue().splitlines()
    lsds, snrs = read_eval(os.path.join(cfg.expr_dir, "eval.csv"))
    ends = [(i, int(m.group(1))) for i, ln in enumerate(lines)
            for m in [re.match(r"End of epoch (\d+) /", ln)] if m]
    switch = [i for i, ln in enumerate(lines)
              if ln.startswith("------------ Now also finetuning")]
    ended = [epoch for _, epoch in ends]
    before = [epoch for i, epoch in ends if switch and i < switch[0]]
    epochs = list(range(1, last + 1))
    rows = cadence_count(0, last * ds, cfg.batch_size, cfg.eval_freq)
    if interrupt_epoch:
        epochs.remove(interrupt_epoch + 1)
        rows = (cadence_count(0, stop * cfg.batch_size, cfg.batch_size,
                              cfg.eval_freq)
                + cadence_count((interrupt_epoch + 1) * ds, last * ds,
                                cfg.batch_size, cfg.eval_freq))
    lrs = [g["lr"] for opt in (state.opt_g, state.opt_d)
           for g in opt.param_groups]
    checks = [
        (f"epochs ended {ended}, expected {epochs}", ended == epochs),
        (f"steps {state.step}, expected {len(epochs) * spe}",
         state.step == len(epochs) * spe == len(losses)),
        (f"the fix-global switch printed {len(switch)} times, after epoch "
         f"{before[-1:]} (expected once, after {cfg.niter_fix_global})",
         len(switch) == 1 and before[-1:] == [cfg.niter_fix_global]),
        (f"learning rates {lrs} after the last epoch, not 0",
         all(abs(lr) <= 1e-9 * cfg.lr for lr in lrs)),
        (f"{len(lsds)} eval rows, expected {rows}", len(lsds) == rows)]
    if interrupt_epoch:
        want = [f"exiting and saving the model at epoch {interrupt_epoch + 1}",
                f"Resuming from epoch {interrupt_epoch + 2} at iteration 0",
                "restored checkpoint 'latest'"]
        checks += [
            (f"the interrupted run took {first_steps} steps, not {stop}",
             first_steps == stop),
            (f"the interrupt and the resume printed no {want}",
             "You pressed Ctrl+C!" in lines
             and all(any(ln.startswith(w) for ln in lines) for w in want)),
            (f"before the first resumed step these differ from the saved "
             f"state: {(seen['differs'] or [])[:5]}", seen["differs"] == [])]
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None

    def floats(i):
        return {k: float(v) for k, v in losses[i].items()} if losses else {}
    res = dict(name=cfg.name, lsd=lsds,
               snr=snrs, seconds=seconds, host_s=host_timeline(
                   t0, at, marks, spe, stop), peak_gib=peak, steps=state.step,
               interrupt_epoch=interrupt_epoch, first_losses=floats(0),
               last_losses=floats(-1),
               misses=[what for what, ok in checks if not ok])
    if interrupt_epoch:
        res.update(pre_interrupt_losses=floats(stop - 1),
                   resumed_losses=floats(stop),
                   resumed_equal=seen["differs"] == [])
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def host_timeline(t0: float, at: list, marks: dict, spe: int,
                  stop: int) -> dict:
    """Where a leg's wall time went, host clock, s: to the first step (the
    run's set-up and first batch), the steps' calls (each step's gap to the
    next: those within an epoch, those across an epoch's end, which take
    its eval and the loader's next epoch), and around the interrupt (the
    save, the snapshot, the resume's restore and the check of its state)
    and the end (the last step's work and the end save)."""
    import numpy as np
    def median(x):
        return float(np.median(x)) if x.size else None
    gaps = np.diff(at)
    idx = np.arange(1, len(at))
    cut = idx == stop if stop else np.zeros_like(idx, bool)
    across = (idx % spe == 0) & ~cut
    out = dict(to_first_step=at[0] - t0, steps=float(gaps[~cut].sum()),
               gap_within_epoch=median(gaps[~across & ~cut]),
               gap_across_epochs=median(gaps[across]),
               end=marks["end"] - at[-1])
    if stop:
        out.update(interrupt_to_return=marks["returned"] - at[stop - 1],
                   snapshot=marks["snapshot"] - marks["returned"],
                   resume_to_first_step=marks["resumed"] - marks["snapshot"],
                   state_check=at[stop] - marks["resumed"])
    return out


def parse_scores(text: str) -> dict:
    """The generate CLI's SNR_SR, SNR_LR, LSD and SSNR lines
    (pix2pixhdaudiosr_torch/generate.py:324-334)."""
    got = dict(re.findall(r"^(SNR_SR|SNR_LR|LSD|SSNR): (\S+)$", text, re.M))
    return {"snr": float(got["SNR_SR"]), "snr_lr": float(got["SNR_LR"]),
            "lsd": float(got["LSD"]), "ssnr": float(got["SSNR"])}


def lowpass_scores(wav: str, cfg) -> dict:
    """The lowpassed input of `wav` (the generate CLI's lr_audio) scored
    against the file as the CLI scores its output (snr, lsd, ssnr), and
    its SNR as the CLI prints SNR_LR (snr_lr)."""
    import torch
    from pix2pixhdaudiosr_torch.data.dataset import AudioTestDataset
    from pix2pixhdaudiosr_torch.metrics import compute_metrics, segmental_snr
    ds = AudioTestDataset(wav, cfg.lr_sampling_rate, cfg.hr_sampling_rate,
                          cfg.segment_length, is_lr_input=cfg.is_lr_input)
    n = ds.audio_len
    hr = torch.from_numpy(ds.raw_audio[None, :n])
    lr = torch.from_numpy(ds.lr_audio[None, :n])
    _, snr, snr_lr, _, _, _, lsd = compute_metrics(
        hr, lr, lr, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.center)
    return {"snr": float(snr), "snr_lr": float(snr_lr), "lsd": float(lsd),
            "ssnr": float(segmental_snr(ds.raw_audio[:n], ds.lr_audio[:n]))}


def serve_chain(device: str, trained: str, untrained: str, eval_dir: str,
                work: str, around=None) -> dict:
    """The generate CLI on every held-out file of eval_dir: the trained G
    (the latest_net_G.pth in `trained`) each of SERVE_WAYS, the untrained
    G in `untrained` plain, and the lowpassed input. `around(way)` is a
    context manager entered around each CLI run. Returns {file: {way:
    scores}} and the seconds."""
    from pix2pixhdaudiosr_torch import generate
    cfg = quiet_config(SOAK_MODEL, False)
    t0 = time.perf_counter()
    files = {}
    for name in sorted(os.listdir(eval_dir)):
        wav = os.path.join(eval_dir, name)
        scores = {"lowpass": lowpass_scores(wav, cfg)}
        runs = [(way, trained, extra) for way, extra in SERVE_WAYS.items()]
        runs.append(("untrained", untrained, SERVE_WAYS["plain"]))
        for way, ckpt, extra in runs:
            argv = [*SOAK_MODEL, "--name", f"serve_{way}", "--checkpoints_dir",
                    work, "--dataroot", wav, "--load_pretrain", ckpt,
                    "--no_html", "--device", device, *extra]
            text = io.StringIO()
            with around(way) if around else contextlib.nullcontext():
                with contextlib.redirect_stdout(text):
                    generate.main(argv)
            scores[way] = parse_scores(text.getvalue())
        files[name] = scores
    return dict(files=files, seconds=time.perf_counter() - t0)


def prune(expr: str, keep=("eval.csv", "latest_net_G.pth")) -> None:
    """Delete a run's checkpoints but `keep`."""
    for name in os.listdir(expr):
        if name not in keep:
            path = os.path.join(expr, name)
            (shutil.rmtree if os.path.isdir(path) else os.remove)(path)


def landing(lsds: list) -> dict:
    """Where a trajectory ends: its last eval row's LSD, and the mean of its
    last TAIL_ROWS rows (at full depth the last 50 epochs, the decay's
    end), which a single row's noise moves less."""
    return {"final": lsds[-1], "tail": sum(lsds[-TAIL_ROWS:]) / TAIL_ROWS}


def spread_summary(done: list) -> dict:
    """The plain spread, the widest gap between two plain runs (leg 1 and
    every leg 2), by landing; each knob run's (legs 3, 4) gap to leg 1
    and whether it is within 3x the spread."""
    plain = [res for leg, res in done if leg in (1, 2)]
    first = next((res for leg, res in done if leg == 1), None)
    if len(plain) < 2 or first is None:
        return {}
    out = {}
    for key in ("final", "tail"):
        ends = [landing(r["lsd"])[key] for r in plain]
        spread = max(ends) - min(ends)
        out[key] = dict(plain=ends, spread=spread, knobs=[])
        for leg, res in done:
            if leg in (3, 4):
                gap = abs(landing(res["lsd"])[key]
                          - landing(first["lsd"])[key])
                out[key]["knobs"].append(dict(
                    leg=leg, name=res["name"], gap=gap,
                    within_3x=gap <= 3 * spread))
    return out


def full_legs(legs: list, work: str, device: str) -> list:
    """The legs in order at full depth (module docstring), a leg given
    twice run twice; one JSON line each, then the spread_summary."""
    sys.path.insert(0, ROOT)
    from chip_smoke import flagship_generator_pth
    from pix2pixhdaudiosr_torch import evaluate
    corpus = os.path.join(work, "corpus")
    f0s = write_soak_corpus(corpus)
    print("[soak corpus] " + json.dumps(
        {"eval_f0": f0s["eval"],
         "train_f0_range": [min(f0s["train"]), max(f0s["train"])]}))
    runs = {1: ("soak_plain", [], INTERRUPT_EPOCH),
            2: ("soak_plain_again", [], 0),
            3: ("soak_remat_full", ["--remat_g", "full"], 0),
            4: ("soak_adam_mu_bf16", ["--adam_mu_bf16"], 0)}
    done = []
    for i, leg in enumerate(legs):
        if leg in runs:
            name, extra, interrupt = runs[leg]
            name = f"{name}_{i}"
            flags = [*SOAK_FLAGS, *extra, *soak_saves(200), "--name", name,
                     "--checkpoints_dir", work,
                     "--dataroot", os.path.join(corpus, "train")]
            res = train_leg(flags, device, interrupt)
            prune(os.path.join(work, name), ("eval.csv", "latest_net_G.pth")
                  if leg == 1 else ("eval.csv",))
        elif leg == 5:
            trained = next(os.path.join(work, r["name"])
                           for n, r in done if n == 1)
            untrained = os.path.join(work, "untrained")
            os.makedirs(untrained, exist_ok=True)
            flagship_generator_pth(untrained)
            res = serve_chain(device, trained, untrained,
                              os.path.join(corpus, "eval"), work)
            res["eval_matric"] = evaluate.main([
                *SOAK_MODEL, "--name", "soak_eval", "--checkpoints_dir", work,
                "--dataroot", os.path.join(corpus, "eval"), "--load_pretrain",
                trained, "--batchSize", "2", "--niter", "1",
                "--validation_split", "0", "--device", device])
        else:
            raise SystemExit(f"no leg {leg}: the legs are 1-5")
        done.append((leg, res))
        print(f"[leg {leg}] " + json.dumps(res))
    print("[soak summary] " + json.dumps(spread_summary(done)))
    return done


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--legs", default="1,2,3,4,5")
    parser.add_argument("--work", default=os.path.join(ROOT, "_soak_run"))
    parser.add_argument("--half", action="store_true")
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--fault", choices=("g_lr0",))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flagship_soak_torch: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    print(chip_smoke.nvidia_smi())
    from pix2pixhdaudiosr_torch.ops import _cuda
    _cuda.library()
    shutil.rmtree(args.work, ignore_errors=True)
    try:
        if not args.half:
            full_legs([int(x) for x in args.legs.split(",")], args.work,
                      "cuda")
            return 0
        failed = 0
        for run in range(args.runs):
            try:
                chip_smoke.phase_flagship_soak(
                    "cuda", chip_smoke.soak_counters(), args.work,
                    fault=args.fault)
            except chip_smoke.SmokeFailure as e:
                failed += 1
                print(f"[soak half {run}] FAILED: {e}")
        return 1 if failed else 0
    finally:
        shutil.rmtree(args.work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
