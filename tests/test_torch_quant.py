"""The port's int8 quantization (pix2pixhdaudiosr_torch/ops/quant.py)
against the JAX package's (CPU, toy sizes).

The JAX functions run op by op, as the JAX generate CLI calls
quantize_params (outside any jit): under jit XLA may rewrite x / 127 as
x * (1 / 127), which moves a scale by one ulp now and then. Inputs come from
numpy seeds; flax kernels (HWIO, channel last) go to the port's layouts by
convert.py's maps. The Pallas stochastic quantizer cannot run on the CPU
(tests/test_quant.py skips it: the TPU PRNG has no interpreter), so the
twin's q is held against a jnp restatement of the kernel body fed the
twin's own u.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pix2pixhdaudiosr_tpu.models import generator as jgen  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import quant as J  # noqa: E402

from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.models.generator import build_generator  # noqa: E402
from pix2pixhdaudiosr_torch.ops import quant as T  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def oihw(k):
    return np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1))


def nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2))).to(dtype).contiguous(
            memory_format=torch.channels_last)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("deconv", [False, True])
def test_quantize_leaf_matches_jax(rng_np, dtype, deconv):
    """q, scale and the dequantized weight bit-exact against JAX in f32 and
    in bf16, for a conv (channel dim 0 of OIHW) and a deconv weight (dim 1
    of [ci, co, kh, kw]). Runs op by op, bf16 rounds w / scale before the
    round in both; a fused XLA kernel could keep it in f32, which would
    move a q by at most one step, so bf16 is bounded at +-1 too."""
    jdt, tdt = DTYPES[dtype]
    k = (rng_np.standard_normal((3, 3, 24, 40)) * 0.05).astype(np.float32)
    k[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    qj, sj = J.quantize_leaf(jnp.asarray(k, jdt))
    if deconv:  # convert.py: flip_hw then [ci, co, kh, kw]
        w, axis = k[::-1, ::-1].transpose(2, 3, 0, 1), 1
        qj_t = np.asarray(qj)[::-1, ::-1].transpose(2, 3, 0, 1)
    else:
        w, axis = k.transpose(3, 2, 0, 1), 0
        qj_t = np.asarray(qj).transpose(3, 2, 0, 1)
    q, s = T.quantize_leaf(torch.from_numpy(np.ascontiguousarray(w)).to(tdt),
                           axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape[axis] == 40 and s.numel() == 40
    np.testing.assert_array_equal(s.numpy().reshape(-1),
                                  np.asarray(sj).reshape(-1))
    diff = np.abs(q.numpy().astype(np.int32) - qj_t)
    print(f"{dtype}: {int((diff > 0).sum())} of {diff.size} q differ")
    assert diff.max() <= 1
    if dtype == "float32":
        np.testing.assert_array_equal(diff, 0)
        back = T.dequantize_leaf(q, s, torch.float32).numpy()
        want = np.asarray(J.dequantize_leaf(qj, sj, jnp.float32))
        want = (want[::-1, ::-1].transpose(2, 3, 0, 1) if deconv
                else want.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(back, want)


def _toy_local():
    kw = dict(input_nc=2, output_nc=2, ngf=4, n_downsample_global=2,
              n_blocks_global=1, n_local_enhancers=1, n_blocks_local=1)
    g = jgen.LocalEnhancer(**kw)
    params = jax.jit(g.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 16, 2)))
    return g, kw, params


def test_state_dict_roundtrip_matches_jax():
    """quantize_state_dict -> dequantize_state_dict on a toy LocalEnhancer
    against JAX dequantize_params(quantize_params(p)) carried through
    convert.py: bit-exact in f32, deconv weights included; biases pass
    through; quantized_size_bytes equal to JAX's on the same tree."""
    _, kw, params = _toy_local()
    params = jax.device_get(params)
    qtree, scales = J.quantize_params(params)
    want = jax_to_torch_generator(jax.device_get(
        J.dequantize_params(qtree, scales, jnp.float32)))
    state = jax_to_torch_generator(params)
    qstate, tscales = T.quantize_state_dict(state)
    assert any(k.endswith("ConvTranspose_0.weight") for k in qstate)
    for key, t in qstate.items():
        is_w = key.endswith(".weight")
        assert (t.dtype == torch.int8) == is_w
        assert (tscales[key] is None) != is_w
    got = T.dequantize_state_dict(qstate, tscales)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)
    assert T.quantized_size_bytes(qstate) == J.quantized_size_bytes(qtree)
    net = build_generator("local", **{k: v for k, v in kw.items()})
    net.load_state_dict(got)  # the round trip loads as it is


def _jax_acc(x, k):
    """JAX _conv3x3_int8 (ops/quant.py:93-109) up to its int32 accumulator."""
    B, H, W, C = x.shape
    xq, sx = J._quant_act_tensor(x)
    kq, _ = J.quantize_leaf(k)
    xp = jnp.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    acc = jnp.zeros((B * H * W, k.shape[-1]), jnp.int32)
    for dh in range(3):
        for dw in range(3):
            win = xp[:, dh:dh + H, dw:dw + W, :].reshape(B * H * W, C)
            acc = acc + jax.lax.dot_general(
                win, kq[dh, dw], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
    return acc, sx


def ulp(a, dtype):
    """One ulp of |a| in `dtype` (f32 or bf16), as f32."""
    bits = 23 if dtype == "float32" else 7
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - bits)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 48), (1, 4, 2, 8, 16)])
def test_conv3x3_int8_matches_jax(rng_np, dtype, shape):
    """The int32 accumulator identical to JAX's nine shifted dots (the
    activation scale too); the output within one ulp of its dtype. The
    second shape has B*H*W = 8 rows, under _int_mm's M > 16 on the card,
    and W = 2, the smallest reflect pad."""
    B, H, W, C, co = shape
    jdt, tdt = DTYPES[dtype]
    x = rng_np.standard_normal((B, H, W, C)).astype(np.float32)
    k = (rng_np.standard_normal((3, 3, C, co)) * 0.08).astype(np.float32)
    b = (rng_np.standard_normal(co) * 0.05).astype(np.float32)
    xj, kj, bj = (jnp.asarray(a, jdt) for a in (x, k, b))
    acc_j, sx_j = _jax_acc(xj, kj)
    y_j = f32(J._conv3x3_int8(xj, kj, bj))

    kq, sw = T.quantize_conv_weight(torch.from_numpy(oihw(k)).to(tdt))
    n = T.conv3x3_int8.launches
    acc, sx = T.conv3x3_int8_acc(nchw(x, tdt), kq)
    assert acc.dtype == torch.int32 and acc.shape == (B * H * W, co)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert sx.item() == float(sx_j)
    y = T.conv3x3_int8(nchw(x, tdt), kq, sw, torch.from_numpy(b).to(tdt))
    assert T.conv3x3_int8.launches == n + 2
    assert y.dtype == tdt and y.is_contiguous(memory_format=torch.channels_last)
    err = np.abs(nhwc(y) - y_j)
    assert (err <= ulp(y_j, dtype)).all(), err.max()


def test_conv3x3_int8_refuses_unaligned_channels():
    kq = torch.zeros(8, 9 * 12, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 8"):
        T.conv3x3_int8_acc(torch.zeros(1, 12, 4, 4), kq)


def _stack_inputs(rng, C=32, n=3):
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)

    def pair():
        return ((rng.standard_normal((3, 3, C, C)) * .08).astype(np.float32),
                (rng.standard_normal((C,)) * .05).astype(np.float32))

    return x, [(pair(), pair()) for _ in range(n)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_resblock_stack_matches_jax(rng_np, dtype):
    """Three int8 resblocks at [2, 8, 8, 32] (tests/test_quant.py:69)
    against JAX int8_resblock_stack, same weights. The convs' integer sums
    agree exactly; the InstanceNorm sums do not (another order), so an
    activation that sits on a rounding boundary of the next conv's int8
    quantization can land one step off: max|x| / 127 of that conv's input.
    The bound is that step relative to max|want|, 1/127, in f32, and two
    steps in bf16, where the InstanceNorm output also rounds to bf16
    (2^-8 relative) before it is quantized."""
    jdt, tdt = DTYPES[dtype]
    x, blocks = _stack_inputs(rng_np)
    want = f32(J.int8_resblock_stack(
        jnp.asarray(x, jdt), [tuple((jnp.asarray(k, jdt), jnp.asarray(b, jdt))
                                    for k, b in pair) for pair in blocks]))
    tblocks = [tuple(T.quantize_conv_weight(torch.from_numpy(oihw(k)).to(tdt))
                     + (torch.from_numpy(b).to(tdt),) for k, b in pair)
               for pair in blocks]
    got = T.int8_resblock_stack(nchw(x, tdt), tblocks)
    assert got.dtype == tdt
    rel = np.abs(nhwc(got) - want).max() / np.abs(want).max()
    print(f"{dtype}: max|got - want| / max|want| = {rel:.2e}")
    assert rel <= (1 if dtype == "float32" else 2) / 127, rel


@pytest.mark.parametrize("net_g", ["global", "local"])
def test_int8_trunk_generator_matches_jax(rng_np, net_g):
    """A toy generator with int8_trunk against the JAX one (f32, same
    params, JAX under jit as it serves): the state_dict is the plain
    generator's, the output within 0.02 of max|want|, and the int8 convs
    ran. Under jit XLA may move a weight scale by one ulp (module
    docstring), which can flip a weight's q by one step; the tanh output
    carries a few such steps, well inside 0.02."""
    if net_g == "global":
        kw = dict(input_nc=2, output_nc=2, ngf=8, n_downsampling=2, n_blocks=2)
        jg = jgen.GlobalGenerator(**kw, int8_trunk=True)
        tkw = dict(ngf=8, n_downsample_global=2, n_blocks_global=2,
                   n_local_enhancers=1, n_blocks_local=1)
    else:
        _, lkw, _ = _toy_local()
        jg = jgen.LocalEnhancer(**lkw, int8_trunk=True)
        tkw = {k: v for k, v in lkw.items() if k not in ("input_nc", "output_nc")}
    x = rng_np.standard_normal((2, 32, 16, 2)).astype(np.float32)
    params = jax.jit(jg.init)(jax.random.PRNGKey(5), jnp.asarray(x))
    want = np.asarray(jax.jit(jg.apply)(params, jnp.asarray(x)))
    net = build_generator(net_g, 2, 2, int8_trunk=True, **tkw)
    plain = build_generator(net_g, 2, 2, **tkw)
    state = jax_to_torch_generator(jax.device_get(params))
    net.load_state_dict(state)
    plain.load_state_dict(state)
    assert net.state_dict().keys() == plain.state_dict().keys()
    n = T.conv3x3_int8.launches
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    assert T.conv3x3_int8.launches - n == 2 * (2 if net_g == "global" else 1)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 0.02, rel


def test_int8_trunk_weights_quantized_once_per_weight_version(rng_np,
                                                              monkeypatch):
    """The trunk's quantized weights are reused while the weights stand and
    redone after load_state_dict (an in-place write) and after a dtype
    cast (a new tensor behind the same parameter)."""
    net = build_generator("global", 2, 2, 8, 2, 1, 1, 1, int8_trunk=True)
    trunk = net.GlobalTrunk_0
    x = nchw(rng_np.standard_normal((1, 16, 8, 2)).astype(np.float32))
    calls = []
    orig = T.quantize_conv_weight

    def spy(w):
        calls.append(w.dtype)
        return orig(w)

    monkeypatch.setattr(T, "quantize_conv_weight", spy)
    with torch.no_grad():
        y0 = net(x)
        net(x)
        assert calls == [torch.float32] * 2
        state = {k: v * 2 for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        y1 = net(x)
        assert len(calls) == 4 and not torch.equal(y0, y1)
        net.to(torch.bfloat16)
        net(x.to(torch.bfloat16))
        assert calls[4:] == [torch.bfloat16] * 2
    assert trunk._int8_cache[2][0][0].dtype == torch.int8


# ---------------------------------------------------------------------------
# B6: the stochastic quantizer's twin
# ---------------------------------------------------------------------------
def _b6_input(rng, shape=(64, 136)):
    x = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    x[:, 5] *= 1e-3   # a column of small values
    return x


def test_stochastic_scale_matches_jax_quantize_leaf(rng_np):
    """The twin's per-column scale is JAX quantize_leaf's over axis 0 of a
    2-D array, bit for bit."""
    x = _b6_input(rng_np)
    _, s = T.stochastic_quantize_2d_ref(torch.from_numpy(x), seed=3)
    assert s.shape == (1, x.shape[1]) and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(J.quantize_leaf(
        jnp.asarray(x))[1]))


def test_stochastic_q_matches_jax_kernel_body(rng_np):
    """For the u the twin draws, q equals the Pallas kernel body
    (ops/quant.py:139-148) restated in jnp; q is floor(x/s) or one above."""
    x = _b6_input(rng_np)
    seed = 11
    q, s = T.stochastic_quantize_2d_ref(torch.from_numpy(x), seed)
    bits = T.random_bits(seed, torch.arange(x.size)).numpy().astype(
        np.uint32).reshape(x.shape)

    xv = jnp.asarray(x)
    amax = jnp.max(jnp.abs(xv), axis=0, keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    u = (jnp.asarray(bits) >> 8).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / (1 << 24))
    want = jnp.clip(jnp.floor(xv / scale + u), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))
    lo = np.floor(x / s.numpy())
    assert np.isin(q.numpy() - lo, (0, 1)).all()
    assert np.abs(q.numpy()).max() <= 127


def test_stochastic_rounding_is_unbiased(rng_np):
    """Over 64 seeds the mean of q*s - x is within 3 standard errors of 0,
    and the bits look uniform: u's mean within 3 SE of 1/2."""
    x = torch.from_numpy(_b6_input(rng_np))
    errs, us = [], []
    for seed in range(64):
        q, s = T.stochastic_quantize_2d_ref(x, seed)
        errs.append((q.float() * s - x).double())
        us.append((T.random_bits(seed, torch.arange(x.numel())) >> 8
                   ).double() / 2 ** 24)
    e, u = torch.stack(errs), torch.cat(us)
    assert abs(e.mean().item()) <= 3 * e.std().item() / e.numel() ** 0.5
    assert abs(u.mean().item() - 0.5) <= 3 * (1 / 12) ** 0.5 / u.numel() ** 0.5


def test_stochastic_seeds_repeat_and_differ(rng_np):
    x = torch.from_numpy(_b6_input(rng_np))
    q1, s1 = T.stochastic_quantize_2d_ref(x, 5)
    q2, s2 = T.stochastic_quantize_2d_ref(x, 5)
    q3, _ = T.stochastic_quantize_2d_ref(x, 6)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert not torch.equal(q1, q3)
    i = torch.arange(4)
    assert torch.equal(T.random_bits(-1, i), T.random_bits(2 ** 32 - 1, i))


def test_stochastic_wrapper_cpu_twin_and_refusals(rng_np):
    """A CPU tensor runs the twin (no launch counted); any other device
    without CUDA raises instead of falling back."""
    x = torch.from_numpy(_b6_input(rng_np))
    n = T.stochastic_quantize_2d.launches
    q, s = T.stochastic_quantize_2d(x, 9)
    q_ref, s_ref = T.stochastic_quantize_2d_ref(x, 9)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert T.stochastic_quantize_2d.launches == n
    with pytest.raises(ValueError, match="CUDA"):
        T.stochastic_quantize_2d(torch.empty(4, 8, device="meta"), 0)


def test_random_bits_hash_reference_values():
    """random_bits against a pure-Python restatement of the hash that
    csrc/quant.cu computes in uint32 (indices past 2^32 included)."""
    def h(v):
        v &= 0xFFFFFFFF
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)

    seed = 1234
    k = h(seed ^ 0x9E3779B9)
    index = [0, 1, 2, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 3 * 2 ** 32 + 5]
    got = T.random_bits(seed, torch.tensor(index, dtype=torch.int64))
    assert got.tolist() == [h(h((i & 0xFFFFFFFF) ^ k) ^ (i >> 32) ^ k)
                            for i in index]


@pytest.mark.parametrize("M,N", [(13824, 1536), (1000, 136)])
def test_quantize_plan_takes_the_strip_route(M, N):
    """B6 at a flagship trunk conv weight's 2-D shape and a ragged one: one
    launch, a cluster of at most 16 blocks owning the widest strip of at
    most STRIP_COLS columns that divides N (32 columns, 128 bytes a row, at
    1536; 8 at 136), every row owned by one block, its rows within the
    block's shared memory."""
    plan = T.plan_quantize(M, N)
    assert plan.route == "strip"
    assert plan.cols == max(w for w in (4, 8, 16, 32)
                            if w <= T.STRIP_COLS and N % w == 0)
    assert N % plan.cols == 0 and 1 <= plan.cluster <= T.STRIP_MAX_CLUSTER
    assert plan.cluster * plan.rows >= M > (plan.cluster - 1) * plan.rows
    assert plan.rows * plan.cols * 4 <= T._STRIP_SMEM


@pytest.mark.parametrize("M,N,aligned", [(1_000_000, 8, True),
                                         (250_000, 4, True), (7, 3, True),
                                         (5, 1, True), (13824, 1536, False)])
def test_quantize_plan_takes_three_launches_where_no_cluster_holds_a_strip(
        M, N, aligned):
    """The three-launch route where a strip of even 4 columns is more than
    16 blocks' shared memory, where a row is no multiple of 16 bytes, and
    for an x whose start is not on 16 bytes."""
    assert T.plan_quantize(M, N, aligned) == T.QuantPlan("threepass")
