"""The port's own Config (pix2pixhdaudiosr_torch/config.py, a copy of the
JAX package's) against pix2pixhdaudiosr_tpu/config.py: the same fields and
defaults, and parse_config giving the same options on the argv the port's
tests, CLIs and chip_smoke.py use.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from pix2pixhdaudiosr_tpu import config as jconfig  # noqa: E402

import chip_smoke  # noqa: E402
from pix2pixhdaudiosr_torch import config as tconfig  # noqa: E402
from test_torch_slice import TOY as SLICE_TOY  # noqa: E402
from test_torch_train_step import TOY as TRAIN_TOY  # noqa: E402


def test_config_has_the_jax_fields_and_defaults():
    """Field by field: name, type annotation and default; the derived
    properties agree at the defaults."""
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.Config)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfig.Config)]
    assert tf == jf
    j, t = jconfig.Config(), tconfig.Config()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("up_ratio", "netg_input_nc", "netd_input_nc", "use_features",
                 "expr_dir"):
        assert getattr(t, prop) == getattr(j, prop)
    assert (tconfig.FRAME_LENGTH, tconfig.BINS) == (jconfig.FRAME_LENGTH, jconfig.BINS)


ARGVS = {
    "defaults": [],
    "flagship": chip_smoke.FLAGSHIP + ["--batchSize", "64"],
    "flagship_fused": chip_smoke.FLAGSHIP + chip_smoke.FUSED,
    "flagship_int8": chip_smoke.FLAGSHIP + chip_smoke.QUANT,
    "toy_serve": SLICE_TOY,
    "toy_train": TRAIN_TOY,
    "chip_toy_train": chip_smoke.TOY_TRAIN,
    "cli": chip_smoke.FLAGSHIP + [
        "--name", "cli", "--checkpoints_dir", "ck", "--dataroot", "c",
        "--device", "cpu", "--batchSize", "2", "--print_freq", "2",
        "--niter", "1", "--niter_decay", "0", "--validation_split", "0.25",
        "--eval_freq", "2", "--eval_size", "0", "--display_freq", "2",
        "--tf_log", "--save_latest_freq", "0", "--save_epoch_freq", "1",
        "--no_html", "--pool_size", "2", "--continue_train", "--debug",
        "--gpu_ids", "1", "--mesh_shape", "2,4", "--mesh_axes", "data,model"],
}


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_config_matches_jax(name, is_train, capsys):
    """parse_config gives equal dataclasses.asdict results and prints the
    same option listing (an argv the Config does not know, --device, is
    the CLIs' own and is stripped first, as they strip it)."""
    argv = list(ARGVS[name])
    if "--device" in argv:
        i = argv.index("--device")
        del argv[i:i + 2]
    want = jconfig.parse_config(argv, is_train=is_train, save=False)
    printed = capsys.readouterr().out
    got = tconfig.parse_config(argv, is_train=is_train, save=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert capsys.readouterr().out == printed
