"""The port's CUDA kernels against their plain twins, and the int8 trunk
conv against the CPU, on the card.

These tests need an NVIDIA GPU (sm_90a build, nvcc): they skip without one.
On the card, run them with `python -m pytest tests/test_torch_cuda.py`;
chip_smoke.py makes the same comparisons at the flagship shapes.
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("win,hop", [(512, 256), (512, 160), (64, 32)])
def test_mdct_kernels_match_twins(cuda, win, hop, B):
    """Both routes (512/256 and 64/32 on the tensor cores, 512/160 on FFMA)
    within atol 1e-5 of their twins; T (36 or 38 frames) is no tile
    multiple, and B = 3 leaves a partial row tile. Each call counts one
    launch, on the tensor-core counter only where mdct_kernels.tc_route
    admits the codec."""
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.framing import pad_signal
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin
    gen = torch.Generator(device=cuda).manual_seed(0)
    kw = dict(n_fft=win, hop_length=hop, win_length=win, window=kbdwin(win),
              device=cuda)
    x = torch.randn(B, hop * 37, generator=gen, device=cuda) * 0.3
    x_pad = pad_signal(x, hop, True).contiguous()
    fwd, inv = MDCT2(**kw), IMDCT2(**kw)
    tc = int(mk.tc_route(win, hop, win))
    counts = [(f.launches, f.launches_tc) for f in (mk.mdct2, mk.imdct2)]
    spec = mk.mdct2(x_pad, fwd.basis, hop, fwd.planes)
    wav = mk.imdct2(spec, inv.basis, hop, inv.planes)
    assert [(f.launches, f.launches_tc) for f in (mk.mdct2, mk.imdct2)] == [
        (n + 1, n_tc + tc) for n, n_tc in counts]
    assert spec.shape == (B, (x_pad.shape[1] - win) // hop + 1, win)
    torch.testing.assert_close(spec, mk.mdct2_ref(x_pad, fwd.basis, hop),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(wav, mk.imdct2_ref(spec, inv.basis, hop),
                               atol=1e-5, rtol=0)
    # without planes the wrapper derives them: the same bits
    assert torch.equal(mk.mdct2(x_pad, fwd.basis, hop), spec)
    assert torch.equal(mk.imdct2(spec, inv.basis, hop), wav)


def test_mdct_tc_kernels_take_views_and_propagate_nan(cuda):
    """The tensor-core route on a signal whose data starts off the 16-byte
    grid (a view into a larger tensor), and a NaN sample with CUDA's
    canonical bits 0x7FFFFFFF, whose rounding to tf32 carries into the sign
    bit: the frames that hold it come out NaN, the others finite."""
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin
    kw = dict(n_fft=512, hop_length=256, win_length=512, window=kbdwin(512),
              device=cuda)
    fwd, inv = MDCT2(**kw), IMDCT2(**kw)
    big = torch.randn(2 * 256 * 12 + 1, device=cuda)
    x_pad = big[1:].view(2, 256 * 12)
    assert x_pad.data_ptr() % 16 != 0
    spec = mk.mdct2(x_pad, fwd.basis, 256, fwd.planes)
    torch.testing.assert_close(spec, mk.mdct2_ref(x_pad, fwd.basis, 256),
                               atol=1e-5, rtol=0)
    x_nan = x_pad.clone()
    x_nan.view(torch.int32)[1, 256 * 5 + 7] = 0x7FFFFFFF
    spec = mk.mdct2(x_nan, fwd.basis, 256, fwd.planes)
    bad = spec.isnan().any(-1)
    assert bad[1, 4] and bad[1, 5] and int(bad.sum()) == 2
    wav = mk.imdct2(spec, inv.basis, 256, inv.planes)
    assert wav[1].isnan().any() and torch.isfinite(wav[0]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 48, 64, 16), (3, 1536, 4, 4),
                                   (2, 5, 7, 9)])
def test_instance_norm_kernel_matches_twin(cuda, dtype, shape):
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_ref)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5).to(
        getattr(torch, dtype)).contiguous(memory_format=torch.channels_last)
    for act in ("none", "relu", "leaky"):
        got, want = instance_norm_act(x, act), instance_norm_act_ref(x, act)
        assert got.dtype == x.dtype
        tol = 1e-5 if dtype == "float32" else 2 ** -7 * want.abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    with pytest.raises(ValueError, match="channels_last"):
        instance_norm_act(x.contiguous())


def _ulp_excess(got, want):
    """max of |got - want| - one bf16 ulp (of the larger) - 1e-6 max(1,
    max|want|): <= 0 when every element agrees within one ulp. Near zero
    the ulp is smaller than the f32 sums' own rounding, which scales with
    the size of the partial sums (~max|want|), hence the floor."""
    def ulp(v):
        a = v.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        return torch.exp2(torch.floor(torch.log2(a)) - 7)
    floor = 1e-6 * max(1.0, want.float().abs().max().item())
    return ((got.float() - want.float()).abs() - floor
            - torch.maximum(ulp(got), ulp(want))).max().item()


@pytest.mark.parametrize("prologue", [None, "in_relu", "in_relu_add", "in_add"])
@pytest.mark.parametrize("shape", [(2, 96, 16, 64), (3, 8, 5, 7),
                                   (1, 40, 5, 150)])
def test_conv3x3_in_kernel_matches_twin(cuda, shape, prologue):
    """y within one bf16 ulp; mean and scale within 1e-4 of the channel's
    magnitude (|mean| + std, and |scale|): a one-ulp flip of y moves the
    mean by ulp / (H * W) however small the mean itself is. (1, 40, 5, 150)
    takes two column tiles, one a partial, and a partial channel tile."""
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    B, C, H, W = shape
    gen = torch.Generator(device=cuda).manual_seed(2)

    def act():
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, res = act(), act()
    w = te.pack_weights(torch.randn(C, C, 3, 3, generator=gen, device=cuda) * .1)
    bias = torch.randn(C, generator=gen, device=cuda) * .1
    mean = torch.randn(B, C, generator=gen, device=cuda) * .3
    scale = torch.rand(B, C, generator=gen, device=cuda) * 1.5 + .5
    args = (x, w, bias, mean, scale, res, prologue)
    n = te.conv3x3_in.launches
    y, (m, s) = te.conv3x3_in(*args)
    assert te.conv3x3_in.launches == n + 1
    y_ref, (m_ref, s_ref) = te.conv3x3_in_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (B, C, H, W)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _ulp_excess(y, y_ref) <= 0
    assert ((m - m_ref).abs() <= 1e-4 * (m_ref.abs() + 1 / s_ref)).all()
    assert ((s - s_ref).abs() <= 1e-4 * s_ref).all()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,co", [((2, 96, 18, 66), 96), ((3, 16, 7, 9), 24),
                                      ((1, 16, 7, 9), 136)])
def test_conv3x3_valid_kernel_matches_twin(cuda, shape, co, relu):
    from pix2pixhdaudiosr_torch.ops.conv import conv3x3_valid, conv3x3_valid_ref
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = (torch.randn(co, shape[1], 3, 3, generator=gen, device=cuda) * .1
         ).to(torch.bfloat16)
    n = conv3x3_valid.launches
    y = conv3x3_valid(x, w, relu)
    assert conv3x3_valid.launches == n + 1
    want = conv3x3_valid_ref(x, w, relu)
    torch.cuda.synchronize()
    assert y.shape == (shape[0], co, shape[2] - 2, shape[3] - 2)
    assert _ulp_excess(y, want) <= 0
    if relu:
        assert (y >= 0).all()


def test_instance_stats_kernel_matches_twin(cuda):
    from pix2pixhdaudiosr_torch.ops.norm import instance_stats, instance_stats_ref
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(2, 96, 16, 64, generator=gen, device=cuda) + .5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    n = instance_stats.launches
    m, s = instance_stats(x)
    assert instance_stats.launches == n + 1
    m_ref, s_ref = instance_stats_ref(x)
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-6)


def test_fused_section_launches_and_refusals(cuda):
    """One fused enhancer section at B = 2 launches instance_stats once and
    conv3x3_in twice a block; f32 and non-channels_last inputs raise."""
    from pix2pixhdaudiosr_torch.ops import conv as tconv
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    from pix2pixhdaudiosr_torch.ops.norm import instance_stats
    gen = torch.Generator(device=cuda).manual_seed(5)
    shape = (2, 16, 8, 8)
    d, o = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for _ in range(2))
    blocks = [tuple((torch.randn(16, 16, 3, 3, generator=gen, device=cuda) * .1,
                     torch.zeros(16, device=cuda)) for _ in range(2))
              for _ in range(2)]
    n_conv, n_stats = te.conv3x3_in.launches, instance_stats.launches
    h = te.fused_enhancer_section(d, o, blocks)
    torch.cuda.synchronize()
    assert te.conv3x3_in.launches - n_conv == 4
    assert instance_stats.launches - n_stats == 1
    assert h.shape == shape and torch.isfinite(h.float()).all()
    w = torch.randn(16, 16, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tconv.conv3x3_valid(torch.randn(2, 16, 6, 6, device=cuda).contiguous(
            memory_format=torch.channels_last), w)
    with pytest.raises(ValueError, match="channels_last"):
        tconv.conv3x3_valid(torch.randn(2, 16, 6, 6, device=cuda).to(
            torch.bfloat16), w)
    with pytest.raises(ValueError, match="channels_last"):
        te.conv3x3_in(d.contiguous(), te.pack_weights(w), torch.zeros(16,
                                                                    device=cuda))


@pytest.mark.parametrize("shape", [(13824, 1536), (1000, 136), (7, 3),
                                   (5, 1)])
def test_stochastic_quantize_kernel_matches_twin(cuda, shape):
    """q and scale bit-identical to the twin on the card; the dequantized
    values within one step of x. (7, 3) and (5, 1) take the scalar quantize
    path (M * N not a multiple of 4)."""
    from pix2pixhdaudiosr_torch.ops import quant
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(shape, generator=gen, device=cuda) * 0.02
    n = quant.stochastic_quantize_2d.launches
    q, s = quant.stochastic_quantize_2d(x, 1234)
    assert quant.stochastic_quantize_2d.launches == n + 1
    q_ref, s_ref = quant.stochastic_quantize_2d_ref(x, 1234)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.shape == (1, shape[1])
    assert torch.equal(s, s_ref) and torch.equal(q, q_ref)
    assert ((q.float() * s - x).abs() <= s).all()
    with pytest.raises(ValueError, match="float32"):
        quant.stochastic_quantize_2d(x.double(), 0)


@pytest.mark.parametrize("shape,dtype", [((128, 1536, 16, 4), "bfloat16"),
                                         ((2, 32, 8, 8), "float32"),
                                         ((1, 16, 4, 2), "bfloat16")])
def test_conv3x3_int8_on_card_matches_cpu(cuda, shape, dtype):
    """The int32 accumulator of the int8 trunk conv on the card (cuBLASLt
    through torch._int_mm) equals the CPU's exactly, and so does the
    output; (1, 16, 4, 2) has 8 rows, padded to _int_mm's M > 16."""
    from pix2pixhdaudiosr_torch.ops import quant
    B, C, H, W = shape
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=gen).to(getattr(torch, dtype)).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn(C, C, 3, 3, generator=gen) * 0.02).to(x.dtype)
    b = (torch.randn(C, generator=gen) * 0.05).to(x.dtype)
    kq, sw = quant.quantize_conv_weight(w)
    kq_c, sw_c = quant.quantize_conv_weight(w.to(cuda))
    assert torch.equal(kq_c.cpu(), kq) and torch.equal(sw_c.cpu(), sw)
    acc, sx = quant.conv3x3_int8_acc(x, kq)
    acc_c, sx_c = quant.conv3x3_int8_acc(x.to(cuda), kq_c)
    assert torch.equal(acc_c.cpu(), acc) and sx_c.item() == sx.item()
    y = quant.conv3x3_int8(x, kq, sw, b)
    y_c = quant.conv3x3_int8(x.to(cuda), kq_c, sw_c, b.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(y_c.cpu(), y)
