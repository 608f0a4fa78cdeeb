"""The port's Megatron tensor parallelism of the resblocks (parallel/tp.py,
models/layers.ResnetBlock's `tp` path, generate --tp_shards) on the CPU at
2 gloo ranks (tests/torch_parallel_cases.py): a resblock stack and the toy
LocalEnhancer against their unsharded forwards, generate --tp_shards 2
against --tp_shards 1, within 1e-5 max|y|; the int8 trunk under TP (its
split int32 accumulators and scales against the one-rank conv's, bit for
bit; the int8 G and generate --int8_trunk --tp_shards 2 against one rank);
which tensors are split, along which dim, against the JAX package's
shard_generator_params."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_cases as cases  # noqa: E402

from pix2pixhdaudiosr_torch import generate  # noqa: E402
from pix2pixhdaudiosr_torch.data.wavio import write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.parallel import mesh  # noqa: E402
from pix2pixhdaudiosr_torch.parallel.tp import (shard_generator,  # noqa: E402
                                                split_dim)
from pix2pixhdaudiosr_torch.utils.checkpoint import save_generator  # noqa: E402


def _cli(tmp_path, name):
    """A seeded toy LocalEnhancer saved for generate, a wav, and the argv."""
    wav = tmp_path / "in.wav"
    if not wav.exists():
        write_wav(str(wav), (np.random.default_rng(2).standard_normal(1500)
                             * 0.2).astype(np.float32), 48000)
        save_generator(cases.toy_system("local").netG,
                       str(tmp_path / "ck" / "latest_net_G.pth"))
    return ["--netG", "local", *cases.TOY, "--name", name,
            "--checkpoints_dir", str(tmp_path), "--dataroot", str(wav),
            "--load_pretrain", str(tmp_path / "ck"), "--device", "cpu",
            "--no_html", "--batchSize", "2"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return cases.run_world(2, dict(argv=_cli(tmp, "tp2"),
                                   argv_int8=_cli(tmp, "tp2_int8")
                                   + ["--int8_trunk"]),
                           ["tp_blocks", "tp_generator", "tp_generate",
                            "int8_tp", "int8_tp_generate"]), tmp


def _fake_group(rank, size):
    """A group for the slicing alone (no collective is called)."""
    return mesh.Group(mesh.World(rank, size, "gloo", torch.device("cpu")),
                      size)


def test_tp_resblocks_match_sequential(world2):
    """Twin of tests/test_tp.py::test_tp_resblocks_match_sequential: three
    16-channel ResnetBlocks sharded over 2 ranks (conv 1 column-parallel,
    conv 2 row-parallel, one all-reduce a block) against the same blocks
    whole, within 1e-5 max|y| on every rank."""
    for res in (r[0] if isinstance(r, tuple) else r for r in world2[0]):
        t = res["tp_blocks"]
        assert t["scale"] > 0 and t["err"] <= 1e-5 * t["scale"], t


def test_tp_shards_hold_halves(world2):
    """Each rank keeps C/2 output channels of ConvIN_0 (weight, bias) and
    C/2 input channels of ConvIN_1's weight; the rest whole."""
    t = world2[0][0]["tp_blocks"]
    assert t["names"] == ["ResnetBlock_0", "ResnetBlock_1", "ResnetBlock_2"]
    for k, shape in t["shapes"].items():
        whole = t["whole"][k]
        if "ConvIN_0" in k:
            assert shape == (whole[0] // 2,) + whole[1:], k
        elif k.endswith("ConvIN_1.Conv_0.weight"):
            assert shape == (whole[0], whole[1] // 2) + whole[2:], k
        else:
            assert shape == whole, k


def test_tp_generator_matches_unsharded(world2):
    """The toy LocalEnhancer with the trunk's and the enhancer's resblocks
    sharded over 2 ranks against its unsharded forward, within 1e-5
    max|y|, on both ranks."""
    for res in world2[0]:
        t = res["tp_generator"]
        assert t["names"] == ["global.ResnetBlock_0", "enh1_block0"]
        assert t["scale"] > 0 and t["err"] <= 1e-5 * t["scale"], t


def test_generate_tp2_matches_tp1(world2, tmp_path):
    """generate --tp_shards 2 at 2 ranks (rank 0 writes) against
    --tp_shards 1 in this process (one rank: nothing split), within 1e-5
    max|wav|."""
    res, tmp = world2
    two = res[0]["tp_generate"]
    assert res[1]["tp_generate"] is None
    assert (tmp / "tp2" / "sr_audio.wav").exists()
    one = generate.main(_cli(tmp, "tp1") + ["--tp_shards", "1"])
    assert two.shape == one.shape and np.abs(one).max() > 0
    np.testing.assert_allclose(two, one, atol=1e-5 * np.abs(one).max())


def test_split_dims_match_shard_generator_params():
    """Which generator tensors TP splits, and along which dim, against the
    JAX package's shard_generator_params on a 2-device mesh: a flax kernel
    HWIO split on O (dim 3) is an OIHW weight split on dim 0, on I (dim 2)
    dim 1; a bias split on dim 0 stays dim 0."""
    from pix2pixhdaudiosr_tpu.models.generator import build_generator
    from pix2pixhdaudiosr_tpu.parallel import make_mesh
    from pix2pixhdaudiosr_tpu.parallel.tp import shard_generator_params
    from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator
    jm = build_generator("local", 2, 2, 4, 2, 2, 1, 2, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 16, 2)))
    placed = shard_generator_params(
        params, make_mesh((2,), ("tp",), devices=jax.devices()[:2]))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        keys = [p.key for p in path][1:]
        spec = tuple(leaf.sharding.spec) + (None,) * leaf.ndim
        dim = next((i for i, s in enumerate(spec[:leaf.ndim]) if s), None)
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel"
                                     else "bias"])
        want[name] = {None: None, 3: 0, 2: 1, 0: 0}[dim] if leaf.ndim == 4 \
            else dim
    names = jax_to_torch_generator(jax.device_get(params)).keys()
    got = {n: split_dim(n) for n in names}
    assert set(got) == set(want)
    assert got == want
    assert sum(d is not None for d in got.values()) == 3 * 4


def test_fused_enhancer_keeps_the_enhancer_blocks_whole():
    """With --fused_enhancer the enhancer's blocks stay whole (the fused
    kernel takes whole weights, as GSPMD gathers a pallas_call's operands);
    the trunk's are split."""
    net = cases.toy_system("local").netG
    names = shard_generator(net, _fake_group(1, 2), replicate_enhancer=True)
    assert names == ["global.ResnetBlock_0"]
    blk = getattr(net, "global").ResnetBlock_0
    assert blk.ConvIN_0.Conv_0.weight.shape[0] == 32 // 2
    assert blk.ConvIN_1.Conv_0.weight.shape[1] == 32 // 2
    assert net.enh1_block0.ConvIN_0.Conv_0.weight.shape[0] == 8
    assert net.enh1_block0.tp is None and blk.tp is not None


def test_shard_generator_takes_the_rank_s_slice():
    """Rank 1 of 2 keeps the second half of the channels, values intact."""
    net = cases.toy_system("global").netG
    blk = net.GlobalTrunk_0.ResnetBlock_0
    w0 = blk.ConvIN_0.Conv_0.weight.detach().clone()
    w1 = blk.ConvIN_1.Conv_0.weight.detach().clone()
    b1 = blk.ConvIN_1.Conv_0.bias.detach().clone()
    shard_generator(net, _fake_group(1, 2))
    assert torch.equal(blk.ConvIN_0.Conv_0.weight, w0[8:])
    assert torch.equal(blk.ConvIN_1.Conv_0.weight, w1[:, 8:])
    assert torch.equal(blk.ConvIN_1.Conv_0.bias, b1)
    with pytest.raises(ValueError, match="multiple"):
        shard_generator(cases.toy_system("global").netG, _fake_group(0, 3))


@pytest.mark.parametrize("conv", ["col", "row"])
def test_int8_tp_split_accumulator_equals_one_rank(world2, conv):
    """The int8 trunk's convs split over 2 ranks: ConvIN_0's (its output
    channels split) int32 accumulator is the one-rank accumulator's slice;
    ConvIN_1's (its input channels split, the activation's absmax and the
    weight's per-channel absmax MAXed over the ranks, the int32 partial
    sums summed over them) is the one-rank accumulator; each with the
    one-rank activation scale, bit for bit, on both ranks."""
    res, _ = world2
    for r in res:
        t = r["int8_tp"]
        assert t["acc_nonzero"]
        assert t[f"{conv}_acc"] and t[f"{conv}_sx"] and t[f"{conv}_sw"], t


def test_int8_tp_row_parallel_sw_is_the_whole_weight_s(world2):
    """ConvIN_1's per-output-channel weight scale on each rank equals the
    whole weight's (quantize_leaf over every input channel); the scale of
    a shard quantized alone differs on some rank, so the MAX over the
    group is what makes it whole."""
    res, _ = world2
    assert all(r["int8_tp"]["row_sw_whole"] for r in res)
    assert not all(r["int8_tp"]["row_sw_shard_alone"] for r in res)


def test_int8_tp_generator_matches_one_rank_int8(world2):
    """The toy LocalEnhancer with --int8_trunk, the trunk's and the
    enhancer's resblocks sharded over 2 ranks, against its one-rank int8
    forward within 1e-5 max|y| (test_tp_generator_matches_unsharded's
    bound), on both ranks; the int8 convs still 2 a forward (one block)."""
    for r in world2[0]:
        t = r["int8_tp"]
        assert t["names"] == ["global.ResnetBlock_0", "enh1_block0"]
        assert t["launches"] == 2
        assert t["scale"] > 0 and t["err"] <= 1e-5 * t["scale"], t


def test_generate_int8_tp2_matches_tp1(world2):
    """generate --int8_trunk --tp_shards 2 at 2 ranks (served, not refused;
    rank 0 writes) against --int8_trunk --tp_shards 1 in this process,
    within 1e-5 max|wav|."""
    res, tmp = world2
    two = res[0]["int8_tp_generate"]
    assert res[1]["int8_tp_generate"] is None
    assert (tmp / "tp2_int8" / "sr_audio.wav").exists()
    one = generate.main(_cli(tmp, "tp1_int8") + ["--int8_trunk",
                                                 "--tp_shards", "1"])
    assert two.shape == one.shape and np.abs(one).max() > 0
    np.testing.assert_allclose(two, one, atol=1e-5 * np.abs(one).max())


def test_int8_tp_needs_8_channels_a_rank():
    """--int8_trunk with --tp_shards: each rank's share of a trunk block's
    channels must be a multiple of 8 (torch._int_mm's K = 9 C / N); 16
    channels over 4 ranks are refused, in shard_generator's words; without
    --int8_trunk the same split is taken."""
    with pytest.raises(ValueError, match="--tp_shards 4 with --int8_trunk: "
                                         ".* 4 a rank, not a multiple of 8"):
        shard_generator(cases.toy_system("global", extra=["--int8_trunk"])
                        .netG, _fake_group(0, 4))
    assert shard_generator(cases.toy_system("global").netG,
                           _fake_group(0, 4)) == ["GlobalTrunk_0.ResnetBlock_0"]


def test_generate_tp_in_one_process_prints_one_shard(tmp_path, capsys):
    """--tp_shards 2 in one process: min(2, 1 rank) = 1 shard, the plain
    forward, as the JAX CLI on one device."""
    a = generate.main(_cli(tmp_path, "tp_one") + ["--tp_shards", "2"])
    assert "tensor-parallel inference over 1 shards" in capsys.readouterr().out
    b = generate.main(_cli(tmp_path, "plain"))
    np.testing.assert_array_equal(a, b)
