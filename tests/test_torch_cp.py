"""The port's frame-axis context parallelism (parallel/halo.py, the `cp`
paths of models/layers.py, generate.cp_generate) on the CPU: the halo
exchange, every layer kind and the toy generators at 2 and 4 gloo ranks
(tests/torch_parallel_cases.py; one rank: in this process) against the
unsharded full-length forward within 1e-5 max|y|, and against the JAX
package: plan_cp_padding over its test grid, InstanceNorm's moments under
shard_map, the CP generator on the virtual 8-device mesh, the
full-length forward and cp_generate; dp x cp serving on a 2 x 2 mesh
(make_serving_layout, make_cp_generator's batch_group) against the
unsharded G and the JAX package's batch_axis forward. Toy size: n_fft 64,
ngf 4, f32."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_cases as cases  # noqa: E402

from pix2pixhdaudiosr_tpu import generate as jgenerate  # noqa: E402
from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.models import layers as jlayers  # noqa: E402
from pix2pixhdaudiosr_tpu.parallel import make_mesh  # noqa: E402
from pix2pixhdaudiosr_tpu.parallel.halo import make_cp_generator  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from pix2pixhdaudiosr_torch import generate  # noqa: E402
from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.parallel import mesh  # noqa: E402
from pix2pixhdaudiosr_torch.parallel.halo import (  # noqa: E402
    generator_receptive_halo)

IN_X = np.random.default_rng(8).standard_normal((2, 8, 6, 16)).astype(
    np.float32) * 2 + 0.5
LR = (np.random.default_rng(9).standard_normal(2000) * 0.2).astype(np.float32)
HOP = 32


def _one_rank():
    return mesh.make_group(mesh.World(0, 1, None, torch.device("cpu")), 1)


def _jax_params(cfg, shape):
    jsys = JSystem(cfg)
    params = jax.jit(jsys.netG.init)(jax.random.PRNGKey(4),
                                     jnp.zeros(shape, jnp.float32))
    return jsys, params


@pytest.fixture(scope="module")
def jax_case():
    """JAX-initialised toy global weights, a spectrogram [1, 64, 64, 2]
    and the JAX CP generator's output at 2 shards."""
    jcfg = jparse(["--netG", "global", *cases.TOY], is_train=False,
                  save=False)
    spec = cases.seeded((1, 64, 64, 2), 3).numpy()
    jsys, params = _jax_params(jcfg, spec.shape)
    mesh2 = make_mesh((2,), ("cp",), devices=jax.devices()[:2])
    want = np.asarray(make_cp_generator(jsys, mesh2, axis="cp")(
        params, jnp.asarray(spec)))
    state = jax_to_torch_generator(jax.device_get(params))
    return dict(spec=spec, state=state, want=want, params=params)


DP_CP_SPEC = cases.seeded((2, 64, 64, 2), 13).numpy()


@pytest.fixture(scope="module")
def jax_dp_cp(jax_case):
    """The JAX package's make_cp_generator(..., batch_axis="data") on a
    (2, 2) data x cp virtual mesh, on jax_case's weights, of DP_CP_SPEC
    (2 samples)."""
    jcfg = jparse(["--netG", "global", *cases.TOY], is_train=False,
                  save=False)
    jsys = JSystem(jcfg)
    params = jax_case["params"]
    mesh22 = make_mesh((2, 2), ("data", "cp"), devices=jax.devices()[:4])
    return np.asarray(make_cp_generator(jsys, mesh22, axis="cp",
                                        batch_axis="data")(
        params, jnp.asarray(DP_CP_SPEC)))


@pytest.fixture(scope="module")
def world4(jax_case):
    return cases.run_world(4, dict(lr=LR, in_x=IN_X,
                                   jax_state=jax_case["state"],
                                   dp_cp_spec=DP_CP_SPEC), [
        "halo", "pad", "layers", "torch_deconv_refused", "generator",
        "cp_generate", "dp_cp"])


@pytest.fixture(scope="module")
def world2(jax_case):
    return cases.run_world(2, dict(in_x=IN_X, jax_state=jax_case["state"],
                                   jax_spec=jax_case["spec"]),
                           ["generator", "moments", "moments_cropped",
                            "jax_generator"])


@pytest.fixture(scope="module")
def jax_cp_norm():
    """layers.instance_norm(x, cp_axis=...) under shard_map on 2 devices
    (its moments pmean'd) of IN_X, NCHW: {act: output}."""
    x = jnp.asarray(np.transpose(IN_X, (0, 2, 3, 1)))
    mesh2 = make_mesh((2,), ("cp",), devices=jax.devices()[:2])
    spec = P(None, None, "cp", None)
    fn = jax.shard_map(lambda b: jlayers.instance_norm(b, cp_axis="cp"),
                       mesh=mesh2, in_specs=spec, out_specs=spec)
    want = np.transpose(np.asarray(fn(x)), (0, 3, 1, 2))
    return {"none": want, "relu": np.maximum(want, 0)}


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("win,hop", [(512, 256), (512, 512), (1024, 256),
                                     (512, 128), (512, 160), (512, 384),
                                     (400, 256)])
@pytest.mark.parametrize("shards,stride", [(1, 4), (4, 8), (8, 16)])
def test_plan_cp_padding_matches_jax(win, hop, center, shards, stride):
    """The copy of plan_cp_padding equals the JAX function over the grid of
    tests/test_halo_cp.py::test_cp_padding_envelope."""
    for length in (32512, 32512 + 1, 100000, hop * 7 + 3, win):
        got = generate.plan_cp_padding(length, hop, win, center, shards,
                                       stride)
        assert got == jgenerate.plan_cp_padding(length, hop, win, center,
                                                shards, stride)


def test_receptive_halo_matches_jax():
    from pix2pixhdaudiosr_tpu.parallel.halo import (
        generator_receptive_halo as jhalo)
    for args in ((4, 3), (4, 9), (2, 1, 1, 1), (4, 3, 1, 2)):
        assert generator_receptive_halo(*args) == jhalo(*args)


def test_halo_exchange_exact(world4):
    """Twin of tests/test_halo_cp.py::test_halo_exchange_exact, 4 ranks:
    each block padded with 4 frames of its neighbours, zeros at the ends."""
    x = cases.seeded((1, 2, 3, 64), 1).numpy()
    shard, halo = 16, 4
    for d, res in enumerate(world4):
        block = res["halo"]
        assert block.shape == (1, 2, 3, 24)
        left = x[..., d * shard - halo: d * shard] if d else 0
        right = x[..., (d + 1) * shard: (d + 1) * shard + halo] if d < 3 else 0
        np.testing.assert_array_equal(block[..., :halo], left + 0 * block[..., :halo])
        np.testing.assert_array_equal(block[..., halo: halo + shard],
                                      x[..., d * shard: (d + 1) * shard])
        np.testing.assert_array_equal(block[..., halo + shard:],
                                      right + 0 * block[..., halo + shard:])


@pytest.mark.parametrize("mode", ["zeros", "reflect"])
def test_cp_pad_w_exact(world4, mode):
    """cp_pad_w by 3 at 4 ranks: interior edges take the neighbours'
    frames; the global ends zeros, or reflect (the edge frame left out),
    which is the whole axis padded as F.pad does."""
    x = cases.seeded((1, 2, 3, 64), 2)
    whole = torch.nn.functional.pad(x, (3, 3, 0, 0), mode={
        "zeros": "constant", "reflect": "reflect"}[mode])
    for d, res in enumerate(world4):
        np.testing.assert_array_equal(res["pad"][mode],
                                      whole[..., d * 16: d * 16 + 22].numpy())


@pytest.mark.parametrize("name", ["c7s1", "down", "res_half", "final",
                                  "deconv", "resblock", "pool"])
def test_layer_blocks_match_unsharded(world4, name):
    """Every layer kind at 4 ranks, each rank's output against its slice of
    the unsharded layer's: the reflect corners (frequency first, then
    frames), the stride-2 down's zero pad, the same-mode deconv's crop, the
    pool's counts at interior edges; within 1e-5 max|y|."""
    err, scale = world4[0]["layers"][name]
    assert scale > 0 and err <= 1e-5 * scale, (err, scale)


def test_torch_mode_deconv_refused_under_cp(world4):
    assert world4[0]["torch_deconv_refused"] == (
        "the torch-mode deconv (--torch_deconv) does not support context "
        "parallelism")


@pytest.mark.parametrize("net_g", ["global", "local"])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_cp_generator_matches_full_length(world2, world4, net_g, ranks):
    """The CP generator (every layer's halo, the moments averaged over the
    ranks) against the port's unsharded full-length forward of the same
    spectrogram [1, 64, 64, 2], within 1e-5 max|y|."""
    if ranks == 1:
        err, scale, _ = cases._cp_vs_full(_one_rank(), net_g)
    else:
        err, scale, _ = {2: world2, 4: world4}[ranks][0]["generator"][net_g]
    assert scale > 0 and err <= 1e-5 * scale, (err, scale)


def test_serving_layout_is_row_major(world4):
    """make_serving_layout(world, 2, 2): rank d * 2 + c holds data index d
    and frame shard c, as make_mesh((2, 2), ("data", "cp")) lays out its
    devices: cp groups {0, 1}, {2, 3} (a data row), data groups {0, 2},
    {1, 3}; the halo exchanges stay inside the cp row."""
    got = [r["dp_cp"] for r in world4]
    assert [g["cp"] for g in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [g["data"] for g in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [(g["cp_rank"], g["data_rank"]) for g in got] == [
        (0, 0), (1, 0), (0, 1), (1, 1)]
    assert all(g["traffic"]["exchange"] > 0 for g in got)


def test_dp_x_cp_matches_unsharded(world4):
    """Twin of tests/test_halo_cp.py::test_cp_generator_2d_dp_x_cp: dp x cp
    serving on a 2 x 2 mesh (the batch of 2 over `data`, the frames over
    `cp`; make_cp_generator's batch_group) against the port's unsharded
    G, atol 5e-6; only rank 0 holds the gathered output."""
    res = world4[0]["dp_cp"]
    assert all("err" not in r["dp_cp"] for r in world4[1:])
    assert res["scale"] > 0 and res["err"] <= 5e-6, res["err"]


def test_dp_x_cp_matches_jax_batch_axis(world4, jax_dp_cp):
    """The port's dp x cp forward at 2 x 2 gloo ranks against the JAX
    package's make_cp_generator(..., axis="cp", batch_axis="data") on a
    (2, 2) virtual mesh, the same converted weights and spectrogram: atol
    5e-6."""
    got = world4[0]["dp_cp"]["jax"]
    assert got.shape == jax_dp_cp.shape == DP_CP_SPEC.shape
    np.testing.assert_allclose(got, jax_dp_cp, atol=5e-6)


def test_cp_generator_matches_jax_cp_at_2_shards(world2, jax_case):
    """The port's CP generator at 2 gloo ranks against the JAX package's
    make_cp_generator on 2 devices of the virtual mesh, on the same
    converted weights and spectrogram: atol 1e-4 (the bound of
    tests/test_torch_models.py's generator checks)."""
    got = world2[0]["jax_generator"]
    assert all(r["jax_generator"] is None for r in world2[1:])
    np.testing.assert_allclose(got, jax_case["want"], atol=1e-4)


@pytest.mark.parametrize("act", ["none", "relu"])
def test_cp_instance_norm_matches_jax_shard_map(world2, jax_cp_norm, act):
    """B3's moments and apply twins around the all-reduce, at 2 ranks,
    against layers.instance_norm(x, cp_axis=...) under shard_map on 2
    devices (its moments pmean'd), within 1e-6."""
    np.testing.assert_allclose(world2[0]["moments"][act], jax_cp_norm[act],
                               atol=1e-6)


@pytest.mark.parametrize("act", ["none", "relu"])
def test_cp_instance_norm_reads_a_cropped_view_against_jax(world2,
                                                           jax_cp_norm, act):
    """cp_instance_norm at 2 ranks on each rank's block held in a cropped
    channels_last view (the same-mode deconv's CP output), read as it is
    and the moments' SUM divided in the apply: within 1e-6 of the JAX
    shard_map InstanceNorm of the same values."""
    assert all(r["moments_cropped"][act] is None for r in world2[1:])
    np.testing.assert_allclose(world2[0]["moments_cropped"][act],
                               jax_cp_norm[act], atol=1e-6)


def _jax_noise(seed):
    """The mask draw of the JAX cp_generate's encode at PRNGKey(seed)."""
    def noise(offset, shape):
        k_lr, _ = jax.random.split(jax.random.PRNGKey(seed + offset))
        _, sub, _ = jax.random.split(k_lr, 3)
        return torch.from_numpy(np.asarray(
            jax.random.normal(sub, shape, jnp.float32)))
    return noise


def test_full_length_forward_and_cp_generate_match_jax():
    """The port's unsharded full-length forward (a system at
    segment_length=need, no cp) against the JAX package's on the same
    converted weights and mask noise, atol 1e-4; and the port's
    cp_generate in one process against the JAX cp_generate at 1 shard,
    atol 1e-4 max|wav|."""
    argv = ["--netG", "global", *cases.TOY, "--cp_shards", "4"]
    jcfg = jparse(argv, is_train=False, save=False)
    jsys, params = _jax_params(jcfg, (1, 64, 16, 2))
    system = cases.toy_system(
        "global", extra=["--cp_shards", "4"],
        state=jax_to_torch_generator(jax.device_get(params)))
    need, t = generate.plan_cp_padding(LR.size, HOP, 64, True, 1, 4)
    lr_full = np.zeros(need, np.float32)
    lr_full[:LR.size] = LR
    full_j = JSystem(jcfg.replace(segment_length=need))
    rng = jax.random.PRNGKey(jcfg.seed)
    spec_j = full_j.encode_input(jnp.asarray(lr_full[None]), None, rng)[0]
    want = np.asarray(jax.jit(full_j.netG.apply)(params, spec_j))
    full = generate.full_length_system(system, need)
    noise = _jax_noise(jcfg.seed)(0, (1, full.codec.mask_size(64), t, 2))
    got = full.inference(torch.from_numpy(lr_full[None]), noise=noise)[0]
    assert got.shape == want.shape == (1, 64, t, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    wav_j = jgenerate.cp_generate(jsys, params, LR, jcfg.replace(cp_shards=1))
    wav = generate.cp_generate(system, LR, system.cfg, _one_rank(),
                               noise=_jax_noise(jcfg.seed))
    assert wav.shape == wav_j.shape and wav.size >= LR.size
    np.testing.assert_allclose(wav, wav_j, atol=1e-4 * np.abs(wav_j).max())


def test_cp_generate_one_rank_matches_four(world4):
    """cp_generate at 4 gloo ranks against one process (the JAX test's
    1-against-4-shard check, tests/test_halo_cp.py:100): within 2e-5; only
    rank 0 returns the file."""
    one = cases.case_cp_generate(_one_rank(), dict(lr=LR))
    four = world4[0]["cp_generate"]
    assert all(r["cp_generate"] is None for r in world4[1:])
    n = min(one.size, four.size)
    assert n >= LR.size
    np.testing.assert_allclose(four[:n], one[:n], atol=2e-5)


def test_generate_cli_cp_in_one_process(tmp_path):
    """generate --cp_shards 4 in one process (one rank: the seamless
    full-length forward) writes the whole file; its audio is cp_generate's
    on a one-rank group."""
    from pix2pixhdaudiosr_torch.data.wavio import write_wav
    from pix2pixhdaudiosr_torch.utils.checkpoint import save_generator
    wav = tmp_path / "in.wav"
    write_wav(str(wav), LR, 48000)
    system = cases.toy_system("global", extra=["--cp_shards", "4"])
    save_generator(system.netG, str(tmp_path / "ck" / "latest_net_G.pth"))
    argv = ["--netG", "global", *cases.TOY, "--name", "run",
            "--checkpoints_dir", str(tmp_path), "--dataroot", str(wav),
            "--load_pretrain", str(tmp_path / "ck"), "--device", "cpu",
            "--no_html", "--cp_shards", "4"]
    audio = generate.main(argv)
    assert (tmp_path / "run" / "sr_audio.wav").exists()
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    from pix2pixhdaudiosr_torch.data.dataset import AudioTestDataset
    ds = AudioTestDataset(str(wav), 8000, 48000, 480)
    want = generate.cp_generate(system, ds.lr_audio, system.cfg, _one_rank())
    np.testing.assert_allclose(audio, want[: ds.segments.size], atol=1e-6)


def _jax_refusal(argv, monkeypatch):
    monkeypatch.setenv("AUDIOSR_NO_COMPILE_CACHE", "1")
    monkeypatch.setenv("AUDIOSR_INIT_TIMEOUT", "0")
    with pytest.raises(SystemExit) as e:
        jgenerate.main(argv)
    return str(e.value)


@pytest.mark.parametrize("extra", [
    ["--tp_shards", "2", "--cp_shards", "2"],
    ["--int8_trunk", "--cp_shards", "2"],
    ["--fused_enhancer", "--cp_shards", "2"],
])
def test_refusals_match_the_jax_cli(tmp_path, monkeypatch, extra):
    """The port's generate refuses what the JAX CLI refuses before any
    work, message for message."""
    argv = ["--netG", "local", *cases.TOY, "--name", "run",
            "--checkpoints_dir", str(tmp_path), "--dataroot", "missing.wav",
            "--no_html", *extra]
    want = _jax_refusal(argv, monkeypatch)
    with pytest.raises(SystemExit) as e:
        generate.main(argv + ["--device", "cpu"])
    assert str(e.value) == want


def test_feature_config_refusal_matches_jax_cp_generate():
    """A feature config with --cp_shards: the JAX cp_generate's message."""
    argv = ["--netG", "global", *cases.TOY, "--cp_shards", "2",
            "--instance_feat"]
    jcfg = jparse(argv, is_train=False, save=False)
    with pytest.raises(SystemExit) as want:
        jgenerate.cp_generate(JSystem(jcfg), None, LR, jcfg)
    from pix2pixhdaudiosr_torch.config import parse_config
    with pytest.raises(SystemExit) as got:
        generate.check_supported(parse_config(argv, is_train=False,
                                              save=False))
    assert str(got.value) == str(want.value)
