"""The InstanceNorm kernel's host side on the CPU: the route planner, the
input check, the deconv crop reaching the norm uncopied, and a numpy
emulation of the one-pass kernel's summation order against the JAX package
(layers.instance_norm, and the Pallas fused_instance_norm in interpret
mode), f32, atol 1e-5. The kernels themselves run in tests/test_torch_cuda.py
on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from pix2pixhdaudiosr_tpu.models import layers as jlayers  # noqa: E402

from pix2pixhdaudiosr_torch.models import layers as tlayers  # noqa: E402
from pix2pixhdaudiosr_torch.ops import norm  # noqa: E402

# every distinct (H, W, C) an InstanceNorm of the flagship generator sees
IN_SHAPES = [(512, 128, 48), (256, 64, 96), (128, 32, 192), (64, 16, 384),
             (32, 8, 768), (16, 4, 1536)]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 128])
@pytest.mark.parametrize("hwc", IN_SHAPES)
def test_plan_takes_every_flagship_shape_one_pass(hwc, B, dtype):
    """One-pass, a cluster of at most 16, a tile of at least one 32-byte
    sector that divides C, every block with positions, shared memory within
    the limit."""
    H, W, C = hwc
    elem = torch.empty((), dtype=DTYPES[dtype]).element_size()
    plan = norm.plan_instance_norm(B, H, W, C, DTYPES[dtype])
    assert plan.route == "onepass"
    assert 1 <= plan.cluster <= norm.MAX_CLUSTER
    assert 32 <= plan.tile * elem <= 512 and C % plan.tile == 0
    assert (plan.cluster - 1) * plan.positions < H * W <= \
        plan.cluster * plan.positions
    assert plan.smem_bytes == norm.onepass_smem(plan.positions, plan.tile, elem)
    assert plan.smem_bytes <= norm.SMEM_LIMIT


# every distinct (H, W, C) an InstanceNorm of the flagship discriminator sees
# (scale 1, then scale 0, at a [B, 512, 128, 4] pair): odd planes
D_IN_SHAPES = [(129, 33, 128), (65, 17, 256), (66, 18, 512), (65, 17, 128),
               (33, 9, 256), (34, 10, 512)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("hwc", D_IN_SHAPES)
def test_plan_takes_every_discriminator_shape_one_pass(hwc, B, dtype):
    """The discriminator's planes (odd H and W, H * W no multiple of any
    tile or cluster) take the one-pass route under the same rules as the
    generator's: a cluster of at most 16, a tile of at least one sector
    that divides C, every block with positions and the last one partial at
    most, shared memory within the limit."""
    H, W, C = hwc
    elem = torch.empty((), dtype=DTYPES[dtype]).element_size()
    plan = norm.plan_instance_norm(B, H, W, C, DTYPES[dtype])
    assert plan.route == "onepass"
    assert 1 <= plan.cluster <= norm.MAX_CLUSTER
    assert 32 <= plan.tile * elem <= 512 and C % plan.tile == 0
    assert (plan.cluster - 1) * plan.positions < H * W <= \
        plan.cluster * plan.positions
    assert plan.smem_bytes == norm.onepass_smem(plan.positions, plan.tile, elem)
    assert plan.smem_bytes <= norm.SMEM_LIMIT


@pytest.mark.parametrize("shape,dtype", [
    ((1, 1024, 1024, 8), "bfloat16"),   # 16 MB a 16-byte tile: no cluster
    ((2, 512, 512, 48), "float32"),     # 4 MB a 16-byte tile
    ((2, 7, 9, 5), "float32"),          # 20-byte rows
    ((2, 7, 9, 4), "bfloat16")])        # 8-byte rows
def test_plan_routes_oversized_planes_and_ragged_rows_two_pass(shape, dtype):
    assert norm.plan_instance_norm(*shape, DTYPES[dtype]) == norm.INPlan("twopass")


def test_plan_prefers_full_sectors_small_blocks_and_wide_tiny_tiles():
    """At 512 x 128 x 48 bf16 the planner keeps a 32-byte tile (a whole
    sector of each 96-byte row) with a cluster of 16 blocks of 128 KB; held
    to the portable 8 it falls back to 16-byte tiles. At 256 x 64 x 96 it
    takes 64 KB blocks, and at 16 x 4 x 1536 (a 64-position plane) 512-byte
    tiles."""
    bf16 = torch.bfloat16
    assert norm.plan_instance_norm(128, 512, 128, 48, bf16)[1:4] == (16, 16, 4096)
    assert norm.plan_instance_norm(128, 512, 128, 48, bf16,
                                   max_cluster=8)[1:4] == (8, 8, 8192)
    assert norm.plan_instance_norm(128, 256, 64, 96, bf16)[1:4] == (32, 16, 1024)
    assert norm.plan_instance_norm(128, 16, 4, 1536, bf16)[1:4] == (256, 1, 64)


def test_input_check_takes_a_cropped_deconv_view():
    """The same-mode crop of a channels_last deconv output (strides
    (572, 1, 44, 4) for [2, 4, 12, 10] of [2, 4, 13, 11], say) is taken as
    it is, with its own pitches; a contiguous tensor with its own."""
    for dtype in DTYPES.values():
        full = torch.zeros(2, 48, 13, 11, dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        crop = full[..., :12, :10]
        assert not crop.is_contiguous(memory_format=torch.channels_last)
        assert norm.nhwc_pitches("t", crop) == (13 * 11 * 48, 11 * 48)
        assert norm.nhwc_pitches("t", full) == (13 * 11 * 48, 11 * 48)
    one = torch.zeros(1, 48, 1, 10).contiguous(memory_format=torch.channels_last)
    assert norm.nhwc_pitches("t", one) == (480, 480)


def test_input_check_refuses_what_the_kernel_cannot_read():
    crop = torch.zeros(2, 4, 13, 11, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)[..., :12, :10]   # 88-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        norm.nhwc_pitches("t", crop)
    with pytest.raises(ValueError, match="channels_last"):
        norm.nhwc_pitches("t", torch.zeros(2, 48, 6, 6))     # NCHW
    with pytest.raises(ValueError, match="channels_last"):
        norm.nhwc_pitches("t", torch.zeros(2, 48, 6, 6).contiguous(
            memory_format=torch.channels_last)[..., ::2])   # strided W
    with pytest.raises(ValueError, match="float16"):
        norm.nhwc_pitches("t", torch.zeros(1, 8, 2, 2, dtype=torch.float16))


def test_deconv_crop_reaches_the_norm_uncopied(monkeypatch):
    """ConvTransposeIN("same") hands instance_norm_act the cropped view
    itself, not a copy; the CPU twin normalizes it as it is."""
    seen = []

    def record(x, act):
        seen.append(x)
        return norm.instance_norm_act(x, act)

    monkeypatch.setattr(tlayers, "instance_norm_act", record)
    m = tlayers.ConvTransposeIN(8, 16, "same").to(memory_format=torch.channels_last)
    x = torch.randn(2, 8, 5, 6, generator=torch.Generator().manual_seed(0)
                    ).contiguous(memory_format=torch.channels_last)
    y = m(x)
    (v,) = seen
    assert v.shape == (2, 16, 10, 12)
    assert not v.is_contiguous(memory_format=torch.channels_last)
    assert v.stride() == (16 * 11 * 13, 1, 16 * 13, 16)
    assert norm.nhwc_pitches("t", v) == (16 * 11 * 13, 16 * 13)
    torch.testing.assert_close(y, norm.instance_norm_act_ref(v, "relu"))


def _fma(a, b, c):
    """f32 fma(a, b, c), rounded once (through float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_onepass(x: np.ndarray, plan: norm.INPlan, act: str,
                    eps: float = 1e-5) -> np.ndarray:
    """csrc/instance_norm.cu in_onepass_kernel's arithmetic in its order,
    in f32 numpy, for f32 x [B, H, W, C]: for each block of the cluster,
    512 threads sum positions g, g + G, ... (G = 512 / V, V the 16-byte
    vectors of a tile's position), a butterfly over the 32 / V groups of a
    warp, the 16 warps in order; the K blocks' sums in rank order; then
    mean, max(E[x^2] - mean^2, 0), rsqrt(var + eps) and the activation."""
    B, H, W, C = x.shape
    hw, tile, K, P = H * W, plan.tile, plan.cluster, plan.positions
    V = tile * 4 // 16
    G, per_warp = 512 // V, 32 // V
    xs = x.reshape(B, hw, C).astype(np.float32)
    y = np.empty_like(xs)
    for c0 in range(0, C, tile):
        S = np.zeros((B, tile), np.float32)
        Q = np.zeros((B, tile), np.float32)
        for r in range(K):
            blk = xs[:, r * P:min(hw, (r + 1) * P), c0:c0 + tile]
            rounds = -(-blk.shape[1] // G)
            pad = np.zeros((B, rounds * G, tile), np.float32)
            pad[:, :blk.shape[1]] = blk
            pad = pad.reshape(B, rounds, G, tile)
            s = np.zeros((B, G, tile), np.float32)
            q = np.zeros((B, G, tile), np.float32)
            for k in range(rounds):
                s = s + pad[:, k]
                q = _fma(pad[:, k], pad[:, k], q)
            s = s.reshape(B, 16, per_warp, tile)
            q = q.reshape(B, 16, per_warp, tile)
            n = per_warp
            while n > 1:
                n //= 2
                s = s[:, :, :n] + s[:, :, n:]
                q = q[:, :, :n] + q[:, :, n:]
            bs = np.zeros((B, tile), np.float32)
            bq = np.zeros((B, tile), np.float32)
            for w in range(16):
                bs = bs + s[:, w, 0]
                bq = bq + q[:, w, 0]
            S, Q = S + bs, Q + bq
        m = S / np.float32(hw)
        var = np.maximum(Q / np.float32(hw) - m * m, np.float32(0))
        rstd = (np.float32(1) / np.sqrt(var + np.float32(eps))).astype(np.float32)
        y[:, :, c0:c0 + tile] = (xs[:, :, c0:c0 + tile] - m[:, None]) * rstd[:, None]
    y = {"none": y, "relu": np.maximum(y, 0),
         "leaky": np.where(y >= 0, y, np.float32(0.2) * y)}[act]
    return y.reshape(B, H, W, C)


@pytest.fixture
def interpret_pallas(monkeypatch):
    import pix2pixhdaudiosr_tpu.ops.norm_pallas as N
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(N.pl, "pallas_call", interp)


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
@pytest.mark.parametrize("shape,block_bytes,cluster", [
    ((2, 32, 64, 8), norm.BLOCK_BYTES, 1),   # 8 positions a thread
    ((2, 32, 64, 8), 8192, 8),               # a cluster of 8
    ((2, 35, 11, 12), 1600, 4)])             # 3 tiles, ragged last block
def test_onepass_summation_order_matches_jax(rng_np, interpret_pallas, act,
                                             shape, block_bytes, cluster):
    """The kernel's summation order, emulated, against float64,
    layers.instance_norm and the Pallas fused_instance_norm (interpret),
    f32, atol 1e-5."""
    from pix2pixhdaudiosr_tpu.ops.norm_pallas import fused_instance_norm
    B, H, W, C = shape
    plan = norm.plan_instance_norm(B, H, W, C, torch.float32,
                                   block_bytes=block_bytes)
    assert plan.route == "onepass" and plan.cluster == cluster
    # mean 2: at mean 5 over 2048 positions JAX's own f32 E[x^2] - mean^2
    # is 1.2e-5 off float64 (the emulation 2.4e-6), which no order fixes
    x = (rng_np.standard_normal(shape) * 3 + 2).astype(np.float32)
    got = emulate_onepass(x, plan, act)
    x64 = x.astype(np.float64)
    want64 = (x64 - x64.mean((1, 2), keepdims=True)) / np.sqrt(
        x64.var((1, 2), keepdims=True) + 1e-5)
    np.testing.assert_allclose(emulate_onepass(x, plan, "none"), want64,
                               atol=1e-5)
    ref = np.asarray(jlayers.instance_norm(jnp.asarray(x)))
    ref = {"none": ref, "relu": np.maximum(ref, 0),
           "leaky": np.where(ref >= 0, ref, 0.2 * ref)}[act]
    np.testing.assert_allclose(got, ref, atol=1e-5)
    fused = np.asarray(fused_instance_norm(jnp.asarray(x), act=act))
    np.testing.assert_allclose(got, fused, atol=1e-5)
