"""The port's fused enhancer section (pix2pixhdaudiosr_torch/ops/enhancer.py,
ops/conv.py) against the JAX package's Pallas kernels (CPU, toy sizes).

The JAX fused kernel runs in interpret mode off the TPU on its own
(enhancer_pallas.py:_interpret); conv3x3_pallas is patched into interpret
mode as tests/test_pallas_kernels.py does. Inputs come from numpy seeds and
weights are carried by convert.py. Layouts: the JAX side is NHWC (the fused
kernel [H, W, C, B]), the port takes [B, C, H, W] (a permute of the same
array). The JAX fused path needs B % 128, so the chain, the section and the
generator are compared at B = 128; direct kernel calls take a small B.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from pix2pixhdaudiosr_tpu.models.generator import LocalEnhancer  # noqa: E402
from pix2pixhdaudiosr_tpu.ops import enhancer_pallas as ep  # noqa: E402

from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.models.generator import build_generator  # noqa: E402
from pix2pixhdaudiosr_torch.ops import conv as tconv  # noqa: E402
from pix2pixhdaudiosr_torch.ops import enhancer as te  # noqa: E402


def nchw(x):
    """NHWC numpy (or jax) array -> [B, C, H, W] torch tensor, same dtype."""
    a = np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x,
                   np.float32)
    t = torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def oihw(k):
    """flax HWIO kernel -> torch OIHW weight (convert.py's map)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def bf16_ulp(a):
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _mk_blocks(rng, c, n):
    """JAX test_enhancer_pallas._mk_blocks: [((k1, b1), (k2, b2)), ...]."""
    return [tuple((jnp.asarray(rng.standard_normal((3, 3, c, c))
                               .astype(np.float32) * .1),
                   jnp.asarray(rng.standard_normal((c,))
                               .astype(np.float32) * .1)) for _ in range(2))
            for _ in range(n)]


def _torch_blocks(blocks):
    return [tuple((oihw(k).to(torch.bfloat16), torch.from_numpy(
        np.array(b, np.float32))) for k, b in pair) for pair in blocks]


@pytest.mark.parametrize("prologue", list(te.PROLOGUES))
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 5, 7, 8)])
def test_conv3x3_in_twin_matches_jax_kernel(shape, prologue):
    """conv3x3_in_ref against conv3x3_in_wcb (interpret): y within one bf16
    ulp; mean and scale within rtol 1e-5, atol 1e-6. Odd H, W exercise the
    reflect maps."""
    B, H, W, C = shape
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    res = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                      jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((3, 3, C, C)).astype(np.float32) * .1)
    b = jnp.asarray(rng.standard_normal((C,)).astype(np.float32) * .1)
    mean = (rng.standard_normal((B, C)) * .3).astype(np.float32)
    scale = rng.uniform(.5, 2., (B, C)).astype(np.float32)
    with_stats = prologue is not None
    with_res = prologue in ("in_relu_add", "in_add")
    aux = ep._aux(b, jnp.asarray(mean.T) if with_stats else None,
                  jnp.asarray(scale.T) if with_stats else None, C, B)
    y_t, s1, s2 = ep.conv3x3_in_wcb(
        ep.to_wcb(x), ep._pack_weights(k), aux,
        res_t=ep.to_wcb(res) if with_res else None, prologue=prologue)
    want_m, want_s = ep._finalize_stats(s1, s2, H * W, 1e-5)
    want = np.asarray(ep.from_wcb(y_t), np.float32)

    got, (m, s) = te.conv3x3_in_ref(
        nchw(x), te.pack_weights(oihw(k)), torch.from_numpy(np.array(b)),
        torch.from_numpy(mean) if with_stats else None,
        torch.from_numpy(scale) if with_stats else None,
        nchw(res) if with_res else None, prologue)
    assert got.dtype == torch.bfloat16 and got.shape == (B, C, H, W)
    got = nhwc(got)
    ulp = np.maximum(bf16_ulp(got), bf16_ulp(want))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m).T, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s).T, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape,nblocks", [
    ((128, 8, 8, 16), 2),
    ((128, 5, 7, 8), 1),
])
def test_fused_resblock_chain_matches_jax(shape, nblocks):
    """Bound: max|got - want| <= 0.03 max|want| (the JAX file's own bound
    against XLA); the port's twin agrees with the Pallas chain within
    ~1e-2 of that (bf16 rounding flips only)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * .5,
                    jnp.bfloat16)
    blocks = _mk_blocks(rng, shape[3], nblocks)
    want = np.asarray(ep.fused_resblock_chain(x, blocks), np.float32)
    got = te.fused_resblock_chain(nchw(x), _torch_blocks(blocks))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = np.abs(nhwc(got) - want).max() / np.abs(want).max()
    assert err <= 0.03, err


def test_fused_section_matches_jax():
    """conv_s2_raw + fused_enhancer_section against JAX at the shapes of
    tests/test_enhancer_pallas.py:63-81; bound 0.03 max|want|."""
    rng = np.random.default_rng(2)
    B, H, W, C = 128, 8, 8, 16
    x = jnp.asarray(rng.standard_normal((B, 2 * H, 2 * W, C // 2))
                    .astype(np.float32) * .5, jnp.bfloat16)
    out = jnp.asarray(rng.standard_normal((B, H, W, C)).astype(np.float32) * .5,
                      jnp.bfloat16)
    kd = jnp.asarray(rng.standard_normal((3, 3, C // 2, C)).astype(np.float32) * .1)
    bd = jnp.asarray(rng.standard_normal((C,)).astype(np.float32) * .1)
    blocks = _mk_blocks(rng, C, 2)
    d_want = ep.conv_s2_raw(x, kd, bd)
    want = np.asarray(ep.fused_enhancer_section(d_want, out, blocks), np.float32)

    d_raw = te.conv_s2_raw(nchw(x), oihw(kd).to(torch.bfloat16),
                           torch.from_numpy(np.array(bd)).to(torch.bfloat16))
    assert d_raw.dtype == torch.bfloat16
    d_err = np.abs(nhwc(d_raw) - np.asarray(d_want, np.float32)).max()
    assert d_err <= 2 * bf16_ulp(np.abs(np.asarray(d_want, np.float32)).max())
    got = te.fused_enhancer_section(d_raw, nchw(out), _torch_blocks(blocks))
    err = np.abs(nhwc(got) - want).max() / np.abs(want).max()
    assert err <= 0.03, err


def test_supports_conditions():
    """The JAX gate's cases (tests/test_enhancer_pallas.py:84-91)."""
    ok = (128, 8, 8, 16)
    assert te.supports(ok, torch.bfloat16)
    assert not te.supports(ok, torch.float32)              # bf16 only
    assert not te.supports((64, 8, 8, 16), torch.bfloat16)  # batch % 128
    assert not te.supports((128, 8, 8, 12), torch.bfloat16)  # C % 8
    assert not te.supports((128, 1, 8, 16), torch.bfloat16)  # H >= 2
    assert not te.supports((128, 8, 2, 16), torch.bfloat16)  # W >= 3
    assert not te.supports((128, 8, 8), torch.bfloat16)
    for shape in (ok, (64, 8, 8, 16), (128, 8, 8, 12), (128, 8, 2, 16)):
        for dt in (torch.bfloat16, torch.float32):
            jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
            assert te.supports(shape, dt) == ep.supports(shape, jdt)


_TOY_G = dict(input_nc=2, output_nc=2, ngf=8, n_downsample_global=1,
              n_blocks_global=1, n_local_enhancers=1)


def _torch_toy(n_blocks_local, fused, params):
    g = build_generator("local", 2, 2, 8, 1, 1, 1, n_blocks_local,
                        fused_enh_blocks=fused)
    g.load_state_dict(jax_to_torch_generator(jax.device_get(params)))
    return g.to(dtype=torch.bfloat16, memory_format=torch.channels_last).eval()


def test_fallback_on_unsupported_batch():
    """B = 2 fails the gate: the fused model takes the plain path, output
    exactly equal (tests/test_enhancer_pallas.py:113-125)."""
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 16, 16, 2)),
                    jnp.float32).astype(jnp.bfloat16)
    params = jax.jit(LocalEnhancer(**_TOY_G, n_blocks_local=1,
                                   dtype=jnp.bfloat16).init)(
        jax.random.PRNGKey(0), x)
    g0, g1 = (_torch_toy(1, fused, params) for fused in (False, True))
    assert not g1._fused(1, torch.empty(2, 8, 16, 16, dtype=torch.bfloat16))
    with torch.no_grad():
        y0, y1 = g0(nchw(x)), g1(nchw(x))
    assert torch.equal(y0, y1)


def test_local_enhancer_fused_matches_jax_fused(monkeypatch):
    """Toy LocalEnhancer with fused_enh_blocks at B = 128, bf16, against the
    JAX fused generator on the same params and input: max|diff| within
    0.05 max|want| (the JAX file's bound); the state_dict is the unfused
    model's."""
    kw = dict(_TOY_G, n_blocks_local=2, dtype=jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((128, 16, 16, 2)),
                    jnp.float32).astype(jnp.bfloat16)
    params = jax.jit(LocalEnhancer(**kw).init)(jax.random.PRNGKey(0), x)
    want = np.asarray(LocalEnhancer(**kw, fused_enh_blocks=True).apply(
        params, x), np.float32)
    g = _torch_toy(2, True, params)
    assert set(g.state_dict()) == set(_torch_toy(2, False, params).state_dict())
    calls = []
    orig = te.fused_enhancer_section
    monkeypatch.setattr(te, "fused_enhancer_section",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        got = nhwc(g(nchw(x)))
    assert calls == [1]
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-3)
    assert err <= 0.05, err


@pytest.fixture
def interpret_conv_pallas(monkeypatch):
    import pix2pixhdaudiosr_tpu.ops.conv_pallas as C
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(C.pl, "pallas_call", interp)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,co,th", [((2, 66, 34, 16), 16, 32),
                                         ((2, 18, 11, 8), 24, 8)])
def test_conv3x3_valid_twin_matches_jax(interpret_conv_pallas, shape, co, th,
                                        relu):
    """conv3x3_valid_ref against conv3x3_pallas (interpret), f32, atol 1e-5,
    Ci == Co and Ci != Co."""
    from pix2pixhdaudiosr_tpu.ops.conv_pallas import conv3x3_pallas
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[3], co)) * .1).astype(np.float32)
    want = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), th=th,
                                     relu=relu))
    got = tconv.conv3x3_valid(nchw(x), oihw(w), relu=relu)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


def test_wrappers_on_cpu_run_twins_and_refuse():
    """A CPU tensor runs the twin and launches nothing; a tensor on no CUDA
    device is refused; bad prologues and missing operands raise."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 5, 4, generator=g).to(torch.bfloat16)
    w = te.pack_weights(torch.randn(16, 8, 3, 3, generator=g) * .1)
    assert w.shape == (9, 16, 8) and w.dtype == torch.bfloat16
    torch.testing.assert_close(te.unpack_weights(w).float(),
                               w.float().reshape(3, 3, 16, 8).permute(2, 3, 0, 1))
    bias = torch.zeros(16)
    n = te.conv3x3_in.launches
    y, (m, s) = te.conv3x3_in(x, w, bias)
    want = te.conv3x3_in_ref(x, w, bias)
    assert torch.equal(y, want[0]) and torch.equal(m, want[1][0])
    assert y.shape == (2, 16, 5, 4) and m.shape == s.shape == (2, 16)
    nv = tconv.conv3x3_valid.launches
    tconv.conv3x3_valid(x, torch.randn(8, 8, 3, 3, generator=g))
    assert te.conv3x3_in.launches == n and tconv.conv3x3_valid.launches == nv
    meta = torch.empty(2, 8, 5, 4, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        te.conv3x3_in(meta, w, bias)
    with pytest.raises(ValueError, match="CUDA"):
        tconv.conv3x3_valid(meta, torch.empty(8, 8, 3, 3))
    with pytest.raises(ValueError, match="prologue"):
        te.conv3x3_in(x, w, bias, prologue="relu")
    with pytest.raises(ValueError, match="needs mean"):
        te.conv3x3_in(x, w, bias, prologue="in_relu")
    with pytest.raises(ValueError, match="needs res"):
        te.conv3x3_in(x, w, bias, m, s, prologue="in_add")


def test_conv_tiling():
    """(th, tw, bn, P): 2 x 64 tiles and all 96 channels at the flagship;
    a smaller channel tile when the weights would not fit; a refusal when
    nothing fits."""
    assert te.conv_tiling(256, 64, 96, 96) == (2, 64, 96, 128)
    assert te.conv_tiling(5, 7, 8, 8) == (5, 7, 32, 1)
    assert te.conv_tiling(40, 7, 8, 24) == (18, 7, 32, 3)
    assert te.conv_tiling(256, 200, 16, 64) == (1, 128, 64, 512)
    assert te.conv_tiling(256, 64, 128, 128) == (2, 64, 64, 128)
    with pytest.raises(ValueError, match="shared memory"):
        te.conv_tiling(256, 64, 512, 512)
