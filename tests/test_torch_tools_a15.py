"""The last tools and scripts' jax-free twins against their originals (CPU):
tools/score_reference_outputs_torch.py, tools/prep_realspeech_torch.py and
tools/fetch_vctk_torch.py against the JAX tools on a reference layout and
a VCTK layout the tests write (the originals read the reference checkout
at a fixed root, which the tests point at theirs), and
scripts/train_recipes_torch.sh and scripts/realspeech_soak_torch.sh against
the original scripts: their syntax, their lines, and the commands bash
runs (a shell function in place of `python` records them), whose flags the
port's CLIs parse. The JAX metrics run eagerly: no jit."""

import hashlib
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import fetch_vctk as jfetch  # noqa: E402
from tools import fetch_vctk_torch as fetch  # noqa: E402
from tools import prep_realspeech as jprep  # noqa: E402
from tools import prep_realspeech_torch as prep  # noqa: E402
from tools import score_reference_outputs as jscore  # noqa: E402
from tools import score_reference_outputs_torch as score  # noqa: E402

from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.data import read_wav, write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.data.flac import write_flac  # noqa: E402

RATE = 48000
# the score's rounding: decimals a key
UNITS = {"mse": 1e-6, "snr_sr": 1e-3, "snr_lr": 1e-3, "ssnr_sr": 1e-3,
         "ssnr_lr": 1e-3, "lsd_sr": 1e-4, "lsd_lr": 1e-4}
# each twin's name beside its original's
TWINS = {"train_torch.py": "train.py", "eval_matric_torch.py": "eval_matric.py",
         "generate_audio_torch.py": "generate_audio.py",
         "tools/prep_realspeech_torch.py": "tools/prep_realspeech.py"}
SCRIPTS = ["train_recipes", "realspeech_soak"]


def _speech(n, seed, f0=180.0):
    """A seeded voiced-like signal: harmonics under a slow envelope, noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.28)) / k
            for k in range(1, 30))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    x += 0.02 * rng.standard_normal(n)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


# ------------------------------------------------ score_reference_outputs
def test_score_matches_the_jax_tool(tmp_path, capsys):
    """Two of the four variants' triplets (the sr and lr of other lengths
    than hr): each score the JAX tool's score_triplet gives, every number
    within its rounding unit and the sample count equal; the missing
    variants skipped, as the original skips them; the JSON at --out."""
    ref = tmp_path / "ref"
    hr = _speech(60000, 1)
    for i, v in enumerate(score.VARIANTS[:2]):
        base = ref / "generated" / v
        base.mkdir(parents=True)
        rng = np.random.default_rng(10 + i)
        write_wav(str(base / "hr_audio.wav"), hr, RATE)
        write_wav(str(base / "lr_audio.wav"),
                  np.convolve(hr, np.ones(6) / 6, "same")[:59000], RATE)
        write_wav(str(base / "sr_audio.wav"), (hr + 0.01 * (i + 1) *
                                               rng.standard_normal(hr.size))
                  .astype(np.float32)[:59500], RATE)
    assert score.VARIANTS == jscore.VARIANTS
    out = tmp_path / "scores.json"
    score.main(["--ref", str(ref), "--out", str(out)])
    printed = capsys.readouterr().out
    got = __import__("json").loads(out.read_text())
    assert list(got) == score.VARIANTS[:2]
    for v in score.VARIANTS[2:]:
        assert f"{v}: missing, skipped" in printed
    for v in score.VARIANTS[:2]:
        want = jscore.score_triplet(str(ref / "generated" / v))
        assert list(got[v]) == list(want)
        assert got[v]["samples"] == want["samples"] == 59000
        for k, unit in UNITS.items():
            assert abs(got[v][k] - want[k]) <= unit * (1 + 1e-6), (v, k)


@pytest.mark.parametrize("tool", ["score", "prep"])
def test_twin_requires_ref(tool, tmp_path, monkeypatch, capsys):
    """Neither twin reads a reference checkout it was not given: without
    --ref each exits with argparse's usage error, and prep (whose --out
    defaults to `realspeech` in the working directory) writes nothing."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        {"score": score, "prep": prep}[tool].main([])
    assert e.value.code == 2
    assert "--ref" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


# ------------------------------------------------ prep_realspeech
@pytest.mark.parametrize("variants", [False, True])
def test_prep_writes_the_jax_tools_files(tmp_path, monkeypatch, variants):
    """The JAX tool (its sources pointed at the test's reference layout)
    and the twin (--ref at it) write the same train and eval files, each
    one's samples and rate bit-equal; with --include_sr_variants the sr
    pools (segment-padded past the utterance) too."""
    ref = tmp_path / "ref"
    lengths = {prep.SOURCES[0]: 300000, prep.SOURCES[1]: 200000}
    lengths.update({s: 210000 for s in prep.SR_VARIANT_SOURCES})
    for i, (name, n) in enumerate(lengths.items()):
        path = ref / name
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(str(path), _speech(n, 20 + i, 150 + 20 * i), RATE)
    monkeypatch.setattr(jprep, "SOURCES", [str(ref / s) for s in prep.SOURCES])
    monkeypatch.setattr(jprep, "SR_VARIANT_SOURCES",
                        [str(ref / s) for s in prep.SR_VARIANT_SOURCES])
    assert [os.path.basename(s) for s in jprep.SOURCES] == \
        [os.path.basename(s) for s in prep.SOURCES]
    flags = ["--n_train", "5", "--seed", "3"] + (
        ["--include_sr_variants"] if variants else [])
    monkeypatch.setattr(sys, "argv", ["prep_realspeech.py", "--out",
                                      str(tmp_path / "jax"), *flags])
    jprep.main()
    prep.main(["--out", str(tmp_path / "port"), "--ref", str(ref), *flags])
    for sub in ("train", "eval"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) == (5 if sub == "train" else 2)
        for name in names:
            (a, ra), (b, rb) = (read_wav(str(tmp_path / d / sub / name))
                                for d in ("jax", "port"))
            assert ra == rb == RATE and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------ fetch_vctk
def _vctk(root):
    """A small extracted VCTK layout: wav48_silence_trimmed/<speaker>/, FLAC
    and wav files of two speakers, and a stray text file."""
    for s, speaker in enumerate(("p225", "p226")):
        d = root / jfetch.EXPECTED_SUBDIR / speaker
        d.mkdir(parents=True)
        for i in range(3):
            x = _speech(6000 + 500 * i, 40 + 3 * s + i)
            if i % 2:
                write_wav(str(d / f"{speaker}_00{i}_mic1.wav"), x, RATE)
            else:
                write_flac(str(d / f"{speaker}_00{i}_mic1.flac"), x, RATE)
    (root / "README.txt").write_text("VCTK\n")


def test_prepare_writes_the_jax_tools_lists(tmp_path, capsys):
    """`prepare` on the layout (the wav48 sub-directory found, a sample of
    files decoded, the shuffle split) writes the same train.csv and
    test.csv as the JAX tool's, and prints the same lines; on a directory
    without audio both return 1."""
    _vctk(tmp_path / "VCTK")
    out = {}
    for name, tool in (("jax", jfetch), ("port", fetch)):
        assert tool.main(["prepare", str(tmp_path / "VCTK"), "--out",
                          str(tmp_path / name), "--test", "2",
                          "--seed", "5"]) == 0
        out[name] = capsys.readouterr().out.replace(str(tmp_path / name), "OUT")
    assert out["jax"] == out["port"]
    assert "6 audio files under" in out["port"]
    for csv in ("train.csv", "test.csv"):
        lines = (tmp_path / "port" / csv).read_text().splitlines()
        assert lines == (tmp_path / "jax" / csv).read_text().splitlines()
        assert len(lines) == (4 if csv == "train.csv" else 2)
    (tmp_path / "empty").mkdir()
    for tool in (jfetch, fetch):
        assert tool.main(["prepare", str(tmp_path / "empty"), "--out",
                          str(tmp_path / "o")]) == 1


@pytest.mark.parametrize("match", [False, True])
def test_verify_gives_the_jax_tools_verdict(tmp_path, monkeypatch, capsys,
                                            match):
    """`verify` of an archive: the same printed line and exit code as the
    JAX tool's, for a digest that misses the published one and for one
    that matches it (the published digest set to the file's)."""
    archive = tmp_path / "VCTK-Corpus-0.92.zip"
    archive.write_bytes(bytes(range(256)) * 5000)
    if match:
        digest = hashlib.sha256(archive.read_bytes()).hexdigest()
        monkeypatch.setattr(jfetch, "VCTK_SHA256", digest)
        monkeypatch.setattr(fetch, "VCTK_SHA256", digest)
    assert fetch.VCTK_URL == jfetch.VCTK_URL
    rcs, lines = [], []
    for tool in (jfetch, fetch):
        rcs.append(tool.main(["verify", str(archive)]))
        lines.append(capsys.readouterr().out)
    assert rcs == [0, 0] if match else rcs == [1, 1]
    assert lines[0] == lines[1]
    assert ("OK" in lines[1]) == match


def test_download_instructions_name_the_same_archive(capsys):
    """--download-instructions: the same URL, checksum, unzip and layout
    lines as the JAX tool's, the next step naming the twin."""
    outs = []
    for tool in (jfetch, fetch):
        assert tool.main(["--download-instructions"]) == 0
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[0][1:-1] == outs[1][1:-1]
    assert outs[1][-1].startswith("Then: python tools/fetch_vctk_torch.py "
                                  "prepare")


# ------------------------------------------------ the scripts
def _logical(path):
    """The script's commands and assignments, a backslash-continued line
    joined, comments and blank lines dropped."""
    text = open(path).read().replace("\\\n", " ")
    return [" ".join(ln.split()) for ln in text.splitlines()
            if ln.strip() and not ln.strip().startswith("#")]


def _untwin(line):
    for twin, original in TWINS.items():
        line = line.replace(twin, original)
    return line


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_twin_parses(script):
    """bash -n on the twin."""
    res = subprocess.run(["bash", "-n", f"scripts/{script}_torch.sh"],
                         cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_twin_lines_are_the_originals(script):
    """Every line of the twin but its comments is the original's with the
    CLI and tool names swapped for their _torch twins, and every python
    command of it runs a twin."""
    twin = _logical(os.path.join(ROOT, "scripts", f"{script}_torch.sh"))
    original = _logical(os.path.join(ROOT, "scripts", f"{script}.sh"))
    assert [_untwin(ln) for ln in twin] == original
    runs = [m for ln in twin for m in re.findall(r"python (\S+)", ln)]
    assert runs and all(r in TWINS for r in runs), runs


def _commands(tmp_path, script):
    """The commands the script runs, as bash expands them: a shell
    function `python` records each one's words; every --load_pretrain
    directory exists (under tmp_path, the working directory)."""
    body = open(os.path.join(ROOT, "scripts", script)).read()
    for d in re.findall(r"run_if_ckpt (\S+)", body):
        (tmp_path / d).mkdir(parents=True, exist_ok=True)
    log = tmp_path / f"{script}.log"
    prelude = ('python() { printf "%s\\037" "$@" >> "$LOG"; '
               'printf "\\n" >> "$LOG"; }\n')
    env = dict(os.environ, LOG=str(log), VCTK="/data/vctk",
               HIFITTS="/data/hifitts", CORPUS="/data/rs", CKPT="/data/ck")
    res = subprocess.run(["bash", "-c", prelude + f"source {ROOT}/scripts/"
                          f"{script}"], cwd=tmp_path, env=env,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return [ln.split("\x1f")[:-1] for ln in log.read_text().splitlines()]


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_twin_runs_the_originals_commands(tmp_path, script, capsys):
    """The commands bash runs from the twin are the original's, word for
    word but the CLI and tool names; each train_torch.py,
    eval_matric_torch.py and generate_audio_torch.py command's flags are
    accepted by the port's parse_config (is_train as its CLI asks)."""
    twin = _commands(tmp_path, f"{script}_torch.sh")
    original = _commands(tmp_path, f"{script}.sh")
    assert len(twin) == len(original) > 0
    assert [[_untwin(w) for w in cmd] for cmd in twin] == original
    parsed = 0
    for cmd in twin:
        if cmd[0] in ("train_torch.py", "eval_matric_torch.py",
                      "generate_audio_torch.py"):
            cfg = parse_config(cmd[1:], is_train=cmd[0] == "train_torch.py",
                               save=False)
            assert cfg.name == cmd[cmd.index("--name") + 1]
            parsed += 1
    capsys.readouterr()
    assert parsed == len(twin) - (script == "realspeech_soak"), \
        [shlex.join(c) for c in twin]
