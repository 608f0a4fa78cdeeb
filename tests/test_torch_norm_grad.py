"""The InstanceNorm backward's host side (CPU): the twin of the backward
kernel (ops/norm.instance_norm_act_grad_ref, from the forward's saved
statistics) against jax.grad of pix2pixhdaudiosr_tpu/models/layers.
instance_norm + activation, the saved statistics against the forward's
twin, and the backward's planner at every training shape. The kernel
itself runs on the card only (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu.models import layers as jlayers  # noqa: E402

from pix2pixhdaudiosr_torch.models import layers as tlayers  # noqa: E402
from pix2pixhdaudiosr_torch.ops import norm  # noqa: E402

ACTS = {"none": lambda y: y, "relu": nn.relu,
        "leaky": lambda y: nn.leaky_relu(y, 0.2)}
# every distinct (H, W, C) an InstanceNorm of a flagship train step sees:
# the generator's, then the discriminator's on a [B, 512, 128, 4] pair
G_SHAPES = [(512, 128, 48), (256, 64, 96), (128, 32, 192), (64, 16, 384),
            (32, 8, 768), (16, 4, 1536)]
D_SHAPES = [(129, 33, 128), (65, 17, 256), (66, 18, 512), (65, 17, 128),
            (33, 9, 256), (34, 10, 512)]
# the time-domain discriminator's (--use_time_D), on [B, 2, 128, 512]
TIME_D_SHAPES = [(w, h, c) for h, w, c in D_SHAPES]
# Family A's netE (nef 16) and GlobalGenerator (ngf 64), at batch 10
FAMILY_A_SHAPES = [(512, 128, 16), (256, 64, 32), (128, 32, 64),
                   (64, 16, 128), (32, 8, 256), (512, 128, 64),
                   (256, 64, 128), (128, 32, 256), (64, 16, 512),
                   (32, 8, 1024)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jax_grad(x, dy, act):
    """jax.grad of sum(dy * act(layers.instance_norm(x))), x and dy NHWC."""
    def f(x_):
        return jnp.sum(dy * ACTS[act](jlayers.instance_norm(x_)))
    return np.asarray(jax.grad(f)(x).astype(jnp.float32))


def _case(rng, constant=False):
    x = (rng.standard_normal((2, 16, 12, 8)) * 3 + 2).astype(np.float32)
    if constant:   # one plane a constant with exact sums: its variance is 0
        x[1, :, :, 5] = 0.75
    dy = rng.standard_normal((2, 16, 12, 8)).astype(np.float32)
    return x, dy


def _twin_grad(x, dy, act):
    """The backward's twin from the forward's saved statistics."""
    y, saved = norm.instance_norm_act(x, act, with_stats=True)
    return norm.instance_norm_act_grad(x, dy, saved, act)


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
@pytest.mark.parametrize("layout", ["channels_last", "crop", "nchw_dy"])
def test_grad_twin_matches_jax(rng_np, act, layout):
    """The twin, f32, within 1e-5 max|dx| of jax.grad: on a channels_last
    x, on the same-mode deconv's crop of one (dx in the view's shape), and
    with an NCHW-contiguous dy."""
    x, dy = _case(rng_np)
    want = _jax_grad(jnp.asarray(x), jnp.asarray(dy), act)
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    if layout == "crop":
        full = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)), constant_values=9.)
        xt = nchw(full).contiguous(memory_format=torch.channels_last)[..., :16, :12]
    dyt = nchw(dy)
    if layout != "nchw_dy":
        dyt = dyt.contiguous(memory_format=torch.channels_last)
    got = _twin_grad(xt, dyt, act)
    assert got.shape == xt.shape and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_grad_twin_on_a_constant_plane_matches_jax(rng_np, act):
    """A plane whose variance is 0 (E[x^2] - mean^2 clamped): the saved
    variance is 0, the twin drops the variance term there, and dx agrees
    with jax.grad within 1e-5 max|dx|."""
    x, dy = _case(rng_np, constant=True)
    want = _jax_grad(jnp.asarray(x), jnp.asarray(dy), act)
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    _, saved = norm.instance_norm_act(xt, act, with_stats=True)
    assert saved[1, 1, 5] == 0 and (saved[1, 0] > 0).all()
    got = norm.instance_norm_act_grad(xt, nchw(dy), saved, act)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_grad_twin_bf16_matches_jax(rng_np, act):
    """bf16 x and dy in, bf16 dx out, statistics in f32: the twin against
    jax.grad of the bf16 instance_norm + activation, within 2 bf16 ulps of
    max|dx| (each side rounds dx once to bf16 after an f32 computation in
    its own order)."""
    x, dy = _case(rng_np)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _jax_grad(xb, jnp.asarray(dy).astype(jnp.bfloat16), act)
    xt = nchw(x).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    got = _twin_grad(xt, nchw(dy).to(torch.bfloat16), act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), want,
                               atol=2 * 2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_function_backward_equals_the_twin(rng_np, act):
    """models/layers.InstanceNormAct on the CPU: the forward's twin and the
    backward's twin from the statistics it saved (x and those, not y)."""
    x, dy = _case(rng_np)
    xt = nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y = tlayers.instance_norm(xt, act)
    saved_x, saved = y.grad_fn.saved_tensors
    assert saved_x is xt or saved_x.data_ptr() == xt.data_ptr()
    assert saved.shape == (2, 2, 8) and saved.dtype == torch.float32
    y.backward(nchw(dy))
    want = norm.instance_norm_act_grad_ref(xt.detach(), nchw(dy), saved, act)
    assert torch.equal(xt.grad, want)


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_grad_twin_matches_the_closed_form(rng_np, act):
    """The closed form (instance_norm_act_backward: statistics recomputed,
    the slope read off y), kept as a second twin and a timed comparison,
    agrees with the kernel's twin within 1e-5 max|dx| in f32."""
    x, dy = _case(rng_np)
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    y, saved = norm.instance_norm_act(xt, act, with_stats=True)
    want = norm.instance_norm_act_backward(xt, y, nchw(dy), act)
    got = norm.instance_norm_act_grad(xt, nchw(dy), saved, act)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_statistics_equal_the_forwards(rng_np, dtype):
    """The statistics the forward returns with with_stats are the twin's:
    the mean of instance_stats_ref, and a variance whose rsqrt(var + eps)
    is its rstd, bit for bit; y is the same as without them."""
    x, _ = _case(rng_np)
    xt = nchw(x).to(DTYPES[dtype]).contiguous(memory_format=torch.channels_last)
    y, saved = norm.instance_norm_act(xt, "relu", with_stats=True)
    mean, rstd = norm.instance_stats_ref(xt)
    assert torch.equal(saved[0], mean)
    assert torch.equal(torch.rsqrt(saved[1] + 1e-5), rstd)
    assert torch.equal(y, norm.instance_norm_act(xt, "relu"))


def _assert_onepass_plan(plan, H, W, C, dtype):
    """A one-pass plan keeps x and dy of its plane in one cluster (K <= 16
    blocks, every position owned, a tile of at least a 32-byte sector)
    within SMEM_LIMIT."""
    elem = dtype.itemsize
    assert plan.route == "onepass" and 1 <= plan.cluster <= norm.MAX_CLUSTER
    assert plan.tile * elem >= 32 and C % plan.tile == 0
    assert plan.cluster * plan.positions >= H * W
    assert (plan.cluster - 1) * plan.positions < H * W
    assert plan.smem_bytes == norm.grad_onepass_smem(plan.positions,
                                                     plan.tile, elem)
    assert plan.smem_bytes <= norm.SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hwc", G_SHAPES + D_SHAPES)
def test_grad_plan_takes_every_training_shape(hwc, dtype):
    """At batch 64 every training shape gets a route: the one-pass cluster
    route wherever a tile of a 32-byte sector or more fits a cluster; at
    512 x 128 x 48, where only a 16-byte tile does, the two-pass route,
    which an H100 measured faster there than that narrow one-pass plan and
    than three 3-plane designs tried for it (tools/in_grad_ablation.py,
    PERF.md)."""
    H, W, C = hwc
    plan = norm.plan_instance_norm_grad(64, H, W, C, DTYPES[dtype])
    if hwc == (512, 128, 48):
        assert plan == norm.INPlan("twopass")
        narrow = norm.plan_instance_norm_grad(64, H, W, C, DTYPES[dtype],
                                              narrow=True)
        assert narrow.route == "onepass"
        assert narrow.tile * DTYPES[dtype].itemsize == 16
        return
    _assert_onepass_plan(plan, H, W, C, DTYPES[dtype])


@pytest.mark.parametrize("batch,hwc", [(64, s) for s in TIME_D_SHAPES]
                         + [(10, s) for s in FAMILY_A_SHAPES])
def test_grad_plan_routes_time_d_and_family_a_shapes(batch, hwc):
    """The time-domain D's 6 shapes (batch 64) take the one-pass route as
    D's; Family A's 10 (batch 10, bf16) too, the 512 x 128 x 16 plane at a
    16-byte tile (a position's 32 bytes are one sector, which its two tiles
    split: 0.061 ms against the two-pass route's 0.078 on an H100), but
    for 512 x 128 x 64, where the
    two-pass route measured fastest."""
    H, W, C = hwc
    plan = norm.plan_instance_norm_grad(batch, H, W, C, torch.bfloat16)
    if hwc == (512, 128, 64):
        assert plan == norm.INPlan("twopass")
    elif hwc == (512, 128, 16):
        assert plan.route == "onepass" and plan.tile * 2 == 16
        assert plan.cluster * plan.positions >= H * W
        assert plan.smem_bytes <= norm.SMEM_LIMIT
    else:
        _assert_onepass_plan(plan, H, W, C, torch.bfloat16)


@pytest.mark.parametrize("case", [
    # (x dtype, dy dtype, shape, strides, misalign, vectors) -> decision
    ("aligned nchw", torch.bfloat16, (64, 48, 512, 128), None, 0, True,
     ("planar", 48 * 65536, 65536)),
    ("odd-plane nchw", torch.bfloat16, (64, 128, 129, 33), None, 0, True,
     ("planar", 128 * 4257, 4257)),
    ("odd-plane nchw, 2-byte start", torch.bfloat16, (64, 128, 129, 33),
     None, 2, True, ("planar", 128 * 4257, 4257)),
    ("channels_last", torch.bfloat16, (64, 48, 512, 128), "cl", 0, True,
     ("nhwc", 512 * 128 * 48, 128 * 48)),
    ("padded-row crop", torch.bfloat16, (2, 48, 64, 32), (66 * 34 * 48, 1,
                                                          34 * 48, 48),
     0, True, ("nhwc", 66 * 34 * 48, 34 * 48)),
    ("channels_last, 2-byte start", torch.bfloat16, (2, 96, 16, 8), "cl",
     2, True, None),
    ("channels_last, 2-byte start, two-pass", torch.bfloat16, (2, 96, 16, 8),
     "cl", 2, False, ("nhwc", 16 * 8 * 96, 8 * 96)),
    ("another dtype", torch.float32, (2, 96, 16, 8), None, 0, True, None),
    ("expanded", torch.bfloat16, (2, 96, 16, 8), (0, 0, 0, 0), 0, True,
     None),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_dy_layout_decides_by_dtype_and_strides(case):
    """The backward reads an NCHW bf16 dy in place, its channel planes
    16-byte aligned (G: 512 x 128) or not (D: 129 x 33, at any start), and
    a channels_last one or a crop of one with padded rows; it copies a dy
    of another dtype than x's, an expanded one, and a channels_last one
    whose start the 16-byte vector loads cannot take."""
    _, dy_dtype, shape, strides, misalign, vectors, want = case
    B, C, H, W = shape
    if strides is None:
        strides = (C * H * W, H * W, W, 1)
    elif strides == "cl":
        strides = (H * W * C, 1, W * C, C)
    assert norm.dy_layout(torch.bfloat16, dy_dtype, shape, strides, misalign,
                          vectors) == want


def test_readable_dy_copies_only_what_it_cannot_read():
    """_readable_dy hands an NCHW dy of x's dtype back uncopied and counts
    a copy of a dy of another dtype, channels_last in x's dtype."""
    x = torch.zeros(2, 8, 6, 5, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(2, 8, 6, 5).to(torch.bfloat16)
    got, layout, sample, pitch = norm._readable_dy(x, dy, True)
    assert got is dy and (layout, sample, pitch) == ("planar", 240, 30)
    fn = norm.instance_norm_act_grad
    n = fn.dy_copies_by_shape.get((6, 5, 8), 0)
    got, layout, _, _ = norm._readable_dy(x, dy.float(), True)
    assert fn.dy_copies_by_shape[(6, 5, 8)] == n + 1
    assert layout == "nhwc" and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, dy)


def test_grad_plan_routes_ragged_rows_two_pass_and_keeps_the_forwards():
    """Rows that are no multiple of 16 bytes take the two-pass route; the
    forward's plan at 512 x 128 x 48 is still a 32-byte tile in a cluster
    of 16 (test_torch_norm.py pins the rest)."""
    assert norm.plan_instance_norm_grad(2, 7, 9, 5, torch.float32).route == "twopass"
    assert norm.plan_instance_norm_grad(2, 8, 8, 12, torch.bfloat16).route == "twopass"
    assert norm.plan_instance_norm(128, 512, 128, 48, torch.bfloat16)[1:4] == (16, 16, 4096)


@pytest.mark.parametrize("B,HW,nv", [(64, 65536, 6), (64, 64, 192),
                                      (1, 65536, 6), (2, 63, 5), (64, 64, 384)])
def test_grad_chunks_fill_the_card_and_bound_each_sum(B, HW, nv):
    """The two-pass partial sums: at least ~1056 blocks where the shape has
    the rows, at most 256 rows summed by one thread, P within [1, HW]."""
    P = norm.grad_chunks(B, HW, nv)
    ctv = min(nv, 256)
    tiles = -(-nv // ctv)
    assert 1 <= P <= HW
    assert -(-HW // P) <= (256 // ctv) * 256
    assert B * tiles * P >= min(1056, B * tiles * HW) or P == HW
