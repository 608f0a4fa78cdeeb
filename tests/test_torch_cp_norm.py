"""B3's cross-shard InstanceNorm on the CPU (ops/norm.py `instance_moments`,
B3m, and `instance_apply`, B3a, and models/layers.cp_instance_norm): the
launch planner as a pure function over the shapes of a CP forward and
ragged ones, a numpy emulation of the B3m kernel's summation order against
float64 moments (within 1e-6 of each plane's scale), the twins on a
cropped view and with a shard count, and the same-mode deconv's crop
reaching both entries uncopied. On the card (marker `cuda`) the kernel
gives the emulation's bits; its other card tests are in
tests/test_torch_cuda.py, and cp_instance_norm over 2 gloo ranks against
JAX in tests/test_torch_cp.py."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pix2pixhdaudiosr_torch.models import layers as tlayers  # noqa: E402
from pix2pixhdaudiosr_torch.ops import norm  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parallel_cases import cropped_view  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the flagship G's 22 InstanceNorms by (H, W, C) on a block of T frames
G_IN_BY_LEVEL = [(512, 1, 48, 2), (256, 2, 96, 7), (128, 4, 192, 2),
                 (64, 8, 384, 2), (32, 16, 768, 2), (16, 32, 1536, 7)]


def cp_forward_shapes(T: int):
    """[(B, C, H, W), count] of a one-sample CP forward's InstanceNorms on
    a block of T frames: 22 in all."""
    return [((1, C, H, T // d), n) for H, d, C, n in G_IN_BY_LEVEL]


# blocks of 256 frames (a 5 s file over 4 ranks), 2816 (60 s over 4) and
# 11264 (60 s at one rank); then ragged shapes: 5 and 1001 channels (the
# scalar path), one position, odd planes, batch > 1
SHAPES = sorted({s for T in (256, 2816, 11264)
                 for s, _ in cp_forward_shapes(T)}) + [
    (2, 5, 7, 9), (3, 1001, 3, 5), (1, 48, 1, 1), (4, 24, 5, 3),
    (16, 768, 16, 4), (2, 8, 33, 17)]


def test_cp_forward_has_22_instance_norms():
    assert sum(n for _, n in cp_forward_shapes(256)) == 22


def _check_plan(plan, shape, dtype, vectors, blocks, unroll, moments):
    B, C, H, W = shape
    hw, elem = H * W, dtype.itemsize
    vec_path = vectors and (C * elem) % 16 == 0
    assert plan.vec == (16 // elem if vec_path else 1)
    assert plan.tile * plan.vec * plan.tiles == C
    assert plan.tile == 1 or plan.tile * plan.vec * elem <= norm.MAX_TILE_BYTES
    rows = 256 // plan.tile                   # positions a load covers
    assert plan.threads == rows * plan.tile <= 256
    assert plan.tile * plan.vec <= plan.threads   # a thread a channel at the end
    assert 1 <= plan.loads <= unroll
    windows = -(-hw // (rows * plan.loads))
    assert plan.chunks <= windows <= plan.chunks * plan.bursts   # none empty
    assert plan.bursts == -(-windows // plan.chunks)
    assert plan.bursts * plan.loads <= 256    # rows a thread sums
    assert plan.tiles <= 65535 and B <= 65535 and plan.chunks < 2 ** 31
    # fewer loads a burst only to fill the blocks aimed at on a small plane:
    # the fewest that keep the windows within them
    aim = -(-blocks // (B * plan.tiles))
    assert plan.loads in (1, unroll) or \
        -(-hw // (rows * (plan.loads - 1))) > aim
    if moments:
        per_round = norm.FINAL_UNROLL * max(1, plan.threads // (
            plan.tile * plan.vec))
        assert plan.group == min(plan.chunks,
                                 norm.GROUP_ROUNDS * per_round) >= 1
    else:
        assert plan.group == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_cross_shard_plans(shape, dtype):
    """Both entries' plans, vector and scalar path: the channel tiles cover
    C, a block of at most 256 threads, every chunk with a window of the
    plane, no thread summing more than 256 rows, fewer loads a burst only
    to fill the blocks aimed at (MOMENTS_BLOCKS, APPLY_BLOCKS) on a small
    plane, and B3m's first-level groups of chunks GROUP_ROUNDS rounds of
    loads a thread."""
    B, C, H, W = shape
    for vectors in (True, False):
        _check_plan(norm.plan_instance_moments(B, H, W, C, DTYPES[dtype],
                                               vectors),
                    shape, DTYPES[dtype], vectors, norm.MOMENTS_BLOCKS,
                    norm.MOMENTS_UNROLL, True)
        _check_plan(norm.plan_instance_apply(B, H, W, C, DTYPES[dtype],
                                             vectors),
                    shape, DTYPES[dtype], vectors, norm.APPLY_BLOCKS,
                    norm.APPLY_UNROLL, False)


def test_cross_shard_kernel_constants():
    """The planner's unroll and final-sum constants are the kernels'."""
    import pathlib
    src = (pathlib.Path(norm.__file__).parent.parent / "csrc" /
           "instance_norm.cu").read_text()
    assert (f"kMomentsUnroll = {norm.MOMENTS_UNROLL}, "
            f"kApplyUnroll = {norm.APPLY_UNROLL};") in src
    assert f"kFinalUnroll = {norm.FINAL_UNROLL};" in src


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 48, 512, 256), (1, 1536, 16, 8)])
def test_cross_shard_plans_give_every_sm_blocks(shape, dtype):
    """At one sample, a flagship CP block's enhancer and trunk shapes give
    both kernels a block for each of an H100's 132 SMs, or (the trunk's 16
    x 8 positions in bf16) as many blocks as leave every thread a load;
    16-byte loads, whole 32-byte sectors of a position."""
    B, C, H, W = shape
    elem = DTYPES[dtype].itemsize
    for plan in (norm.plan_instance_moments(B, H, W, C, DTYPES[dtype]),
                 norm.plan_instance_apply(B, H, W, C, DTYPES[dtype])):
        grid = B * plan.tiles * plan.chunks
        assert grid >= min(132, B * H * W * C * elem // 16 // plan.threads)
        assert plan.vec * elem == 16
        assert (plan.tile * 16) % 32 == 0 or plan.tiles == 1


def test_cross_shard_plans_are_the_planner_limits():
    """The enhancer's 48 bf16 channels are one tile of 6 loads (252
    threads); B3m fills MOMENTS_BLOCKS, B3a APPLY_BLOCKS, in whole waves:
    at the one-rank 60 s block the row bound asks B3m for 3 waves."""
    m = norm.plan_instance_moments(1, 512, 256, 48, torch.bfloat16)
    assert (m.vec, m.tile, m.threads, m.tiles, m.loads) == (8, 6, 252, 1, 8)
    assert m.chunks <= norm.MOMENTS_BLOCKS and m.bursts == 2
    a = norm.plan_instance_apply(1, 512, 256, 48, torch.bfloat16)
    assert a.chunks <= norm.APPLY_BLOCKS and a.loads == norm.APPLY_UNROLL
    long = norm.plan_instance_moments(1, 512, 11264, 48, torch.bfloat16)
    assert 2 * norm.MOMENTS_BLOCKS < long.chunks <= 3 * norm.MOMENTS_BLOCKS
    assert long.bursts * long.loads <= 256


def _fma(a, b, c):
    """f32 fma(a, b, c), rounded once (through float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _add_compensated(s, c, v):
    """csrc/instance_norm.cu add_compensated in f32: (sum, carry)."""
    t = (s + v).astype(np.float32)
    c = (c + np.where(np.abs(s) >= np.abs(v), (s - t) + v,
                      (v - t) + s)).astype(np.float32)
    return t, c


def _sum_partials(entries, threads: int, tc: int):
    """csrc/instance_norm.cu sum_partials: slice k of S = max(1,
    min(threads / tc, n)) over entries [k n / S, (k + 1) n / S),
    compensated, then the slices in order, compensated."""
    n = len(entries)
    S = max(1, min(threads // tc, n))
    slices = []
    for k in range(S):
        acc = [np.zeros(tc, np.float32) for _ in range(4)]
        for s, q in entries[n * k // S:n * (k + 1) // S]:
            acc[0], acc[1] = _add_compensated(acc[0], acc[1], s)
            acc[2], acc[3] = _add_compensated(acc[2], acc[3], q)
        slices.append((acc[0] + acc[1], acc[2] + acc[3]))
    acc = [np.zeros(tc, np.float32) for _ in range(4)]
    for s, q in slices:
        acc[0], acc[1] = _add_compensated(acc[0], acc[1], s)
        acc[2], acc[3] = _add_compensated(acc[2], acc[3], q)
    return acc[0] + acc[1], acc[2] + acc[3]


def emulate_moments(x: np.ndarray, plan: norm.CrossShardPlan) -> np.ndarray:
    """csrc/instance_norm.cu in_moments_kernel's arithmetic in its order,
    in f32 numpy, for f32 x [B, H*W, C]: in each (sample, tile, chunk)
    block, thread group g sums, burst by burst (window k * chunks + chunk),
    rows start + g + u G for u < loads (x with an f32 add, x^2 with an
    fma), a pairwise tree over the G groups; the sums of each group of
    `plan.group` chunks (`_sum_partials`), then, where there are several,
    those groups' totals; the moments are the sums over H*W."""
    B, hw, C = x.shape
    tc = plan.tile * plan.vec
    G = plan.threads // plan.tile
    window = G * plan.loads
    out = np.zeros((2, B, C), np.float32)
    for b in range(B):
        for t in range(plan.tiles):
            xs = x[b, :, t * tc:(t + 1) * tc]
            parts = []
            for chunk in range(plan.chunks):
                s = np.zeros((G, tc), np.float32)
                q = np.zeros((G, tc), np.float32)
                for start in range(chunk * window, hw, plan.chunks * window):
                    for u in range(plan.loads):
                        idx = start + np.arange(G) + u * G
                        v = np.where((idx < hw)[:, None],
                                     xs[np.minimum(idx, hw - 1)], 0).astype(
                                         np.float32)
                        s = (s + v).astype(np.float32)
                        q = _fma(v, v, q)
                span = 1
                while span < G:
                    span *= 2
                span //= 2
                while span > 0:
                    n = min(span, G - span)
                    s[:n] = s[:n] + s[span:span + n]
                    q[:n] = q[:n] + q[span:span + n]
                    span //= 2
                parts.append((s[0], q[0]))
            if plan.chunks == 1:
                totals = parts
            else:
                totals = [_sum_partials(parts[i:i + plan.group],
                                        plan.threads, tc)
                          for i in range(0, plan.chunks, plan.group)]
                if len(totals) > 1:
                    totals = [_sum_partials(totals, plan.threads, tc)]
            out[0, b, t * tc:(t + 1) * tc] = totals[0][0] / np.float32(hw)
            out[1, b, t * tc:(t + 1) * tc] = totals[0][1] / np.float32(hw)
    return out


# (shape, dtype, vectors, blocks, group rounds) of B3m's plans whose planes
# span one or several chunks, bursts and groups
EMULATED = [
    ((2, 48, 16, 40), torch.float32, True, 264, 1),   # 31 chunks, one level
    ((1, 48, 32, 48), torch.bfloat16, True, 2, 1),    # 3 bursts of 8 loads
    ((1, 48, 64, 64), torch.bfloat16, True, 264, 1),  # 2 groups: 2 levels
    ((1, 48, 64, 64), torch.bfloat16, True, 264, 4),  # the same, one level
    ((2, 96, 8, 20), torch.bfloat16, True, 20, 1),    # 12 loads, G 21
    ((1, 16, 128, 160), torch.float32, True, 1, 1),   # the row bound: 2 chunks
    ((2, 5, 7, 9), torch.float32, False, 264, 1),     # scalar path
    ((1, 1536, 4, 8), torch.bfloat16, True, 264, 1),  # 6 tiles, 1 load
]


def _emulated_case(shape, dtype, vectors, blocks, rounds):
    """(x f32 [B, H*W, C] of mean 0.5 and RMS 2, bf16-rounded for bf16;
    the plan) of one EMULATED case."""
    B, C, H, W = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((B, H * W, C)) * 2 + 0.5
                          ).astype(np.float32)).to(dtype).float().numpy()
    plan = norm.plan_cross_shard(B, H, W, C, dtype, vectors, blocks,
                                 norm.MOMENTS_UNROLL, rounds)
    assert plan.chunks > 1
    return x, plan


@pytest.mark.parametrize("shape,dtype,vectors,blocks,rounds", EMULATED)
def test_moments_summation_order_against_float64(shape, dtype, vectors,
                                                  blocks, rounds):
    """The kernel's order (`emulate_moments`) on a plan of the planner,
    here with other block targets and group sizes so that a plane spans
    one or several chunks, bursts and groups: the mean within 1e-6 of the
    plane's RMS and E[x^2] within 1e-6 relative of float64 moments, as the
    card's check holds the kernel."""
    x, plan = _emulated_case(shape, dtype, vectors, blocks, rounds)
    got = emulate_moments(x, plan)
    xd = x.astype(np.float64)
    exact = np.stack((xd.mean(1), (xd * xd).mean(1)))
    scale = np.stack((np.sqrt(exact[1]), exact[1]))
    assert (np.abs(got - exact) / scale).max() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,vectors,blocks,rounds", EMULATED)
def test_moments_kernel_gives_its_emulation_bits(monkeypatch, shape, dtype,
                                                 vectors, blocks, rounds):
    """On the card, p2p_instance_moments run on each EMULATED plan gives
    `emulate_moments`'s bits, so that the emulation above is the kernel's
    order and not a copy that could drift from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    B, C, H, W = shape
    x, plan = _emulated_case(shape, dtype, vectors, blocks, rounds)
    monkeypatch.setattr(norm, "plan_instance_moments", lambda *args: plan)
    xt = torch.from_numpy(x.reshape(B, H, W, C)).to(
        device="cuda", dtype=dtype).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(norm.instance_moments(xt).cpu().numpy(),
                                  emulate_moments(x, plan))


@pytest.mark.parametrize("dtype", DTYPES)
def test_twins_read_a_cropped_view(dtype):
    """On a cropped channels_last view the twins give the contiguous
    copy's moments within f32 rounding (1e-6 of each plane's scale: torch
    sums the two in other orders) and, from the same moments, the same
    apply bits; the view's pitches are what the kernels read."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 48, 6, 16)).astype(np.float32) * 2 + 0.5).to(DTYPES[dtype])
    view = cropped_view(x)
    flat = view.contiguous(memory_format=torch.channels_last)
    assert not view.is_contiguous(memory_format=torch.channels_last)
    assert norm.nhwc_pitches("t", view) == (8 * 21 * 48, 21 * 48)
    mv, mc = norm.instance_moments(view), norm.instance_moments(flat)
    scale = torch.stack((mc[1].sqrt(), mc[1]))
    assert ((mv - mc).abs() / scale).max() <= 1e-6
    for act in ("none", "relu", "leaky"):
        assert torch.equal(norm.instance_apply(view, mc, act),
                           norm.instance_apply(flat, mc, act))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_apply_count_divides_the_summed_moments(n):
    """instance_apply(..., count=n) on moments summed over n shards is the
    old caller's `sum / n` then the apply, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, 6, 16)).astype(np.float32) * 2 + 0.5)
    parts = [norm.instance_moments(x[..., i::n]) for i in range(n)]
    summed = sum(parts[1:], parts[0])
    for act in ("none", "relu"):
        assert torch.equal(norm.instance_apply(x, summed, act, count=n),
                           norm.instance_apply(x, summed / n, act))


def test_cp_norm_reads_the_deconv_crop_uncopied(monkeypatch):
    """ConvTransposeIN("same") with `cp` hands both cross-shard entries the
    cropped view itself (frames 2 .. 2W + 2 of the upsample), not a copy,
    with the shard count 1 for a one-rank group."""
    from pix2pixhdaudiosr_torch.parallel import mesh
    seen = []

    def moments(x):
        seen.append(("moments", x))
        return norm.instance_moments(x)

    def apply(x, m, act, count=1):
        seen.append(("apply", x, count))
        return norm.instance_apply(x, m, act, count=count)

    monkeypatch.setattr(tlayers, "instance_moments", moments)
    monkeypatch.setattr(tlayers, "instance_apply", apply)
    m = tlayers.ConvTransposeIN(8, 16, "same").to(
        memory_format=torch.channels_last)
    m.cp = mesh.make_group(mesh.World(0, 1, None, torch.device("cpu")), 1)
    x = torch.randn(2, 8, 5, 6, generator=torch.Generator().manual_seed(0)
                    ).contiguous(memory_format=torch.channels_last)
    y = m(x)
    (_, v), (_, v2, count) = seen
    assert v is v2 and count == 1
    assert v.shape == (2, 16, 10, 12)
    assert not v.is_contiguous(memory_format=torch.channels_last)
    assert norm.nhwc_pitches("t", v) == (16 * 11 * 17, 16 * 17)
    torch.testing.assert_close(y, norm.instance_norm_act_ref(v, "relu"))
