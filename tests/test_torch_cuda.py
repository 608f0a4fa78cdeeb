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


@pytest.mark.parametrize("B,T", [(1, 5), (3, 37), (32, 128)])
def test_imdct2_grad_matches_autograd_through_the_twin(cuda, B, T):
    """B2's backward (B1's kernel on the transposed inverse basis) at
    512/256 on the tensor-core route within 1e-5 max|dspec| of autograd
    through imdct2's twin, one launch counted on its own counter (not
    mdct2's); through ops/mdct.IMDCT2Fn with the codec's crop as well."""
    from pix2pixhdaudiosr_torch.ops import framing
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin
    inv = IMDCT2(n_fft=512, hop_length=256, win_length=512,
                 window=kbdwin(512), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    spec = torch.randn(B, T, 512, generator=gen, device=cuda)
    dy = torch.randn(B, (T - 1) * 256 + 512, generator=gen, device=cuda)
    sr = spec.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(mk.imdct2_ref(sr, inv.basis, 256), sr, dy)
    n, n_b1 = mk.imdct2_grad.launches_tc, mk.mdct2.launches
    got = mk.imdct2_grad(dy, inv.basis_t, 256, inv.planes_t)
    assert (mk.imdct2_grad.launches_tc, mk.mdct2.launches) == (n + 1, n_b1)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    crop = dy[:, 256:-256]
    sk = spec.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(inv(sk), sk, crop)
    sr = spec.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(framing.center_crop(
        mk.imdct2_ref(sr, inv.basis, 256), 512), sr, crop)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_hifigan_train_step_on_card_matches_cpu(cuda):
    """chip_smoke.phase_train_reference with --use_hifigan_D: losses within
    rtol 1e-4 of the CPU step on the card's InstanceNorm outputs, every
    grad as the plain step's, hifigan_D's within 1e-3 of its net's max
    against the independent CPU step, IMDCT2 and its backward launched
    once on the tensor-core route, G's grad from G_GAN_t not 0. It raises
    chip_smoke.SmokeFailure on a miss."""
    import chip_smoke
    res = chip_smoke.phase_train_reference("cuda", ["--use_hifigan_D"])
    assert res["imdct2_grad_launches_tc"] == 1 and res["g_gan_t_grad_max"] > 0


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


# every distinct (H, W, C) an InstanceNorm of the flagship generator sees
IN_SHAPES = [(512, 128, 48), (256, 64, 96), (128, 32, 192), (64, 16, 384),
             (32, 8, 768), (16, 4, 1536)]


def _in_input(cuda, shape, dtype, seed=8):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5).to(
        getattr(torch, dtype)).contiguous(memory_format=torch.channels_last)


def _assert_in_close(got, want):
    """f32 within 1e-5; bf16 within one ulp (+ the near-zero floor)."""
    assert got.dtype == want.dtype
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        assert _ulp_excess(got, want) <= 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 48, 512, 256), (2, 768, 16, 4)],
                         ids=["cp", "tp"])
def test_instance_moments_and_apply_match_twins(cuda, shape, dtype):
    """B3's cross-shard entries at a CP shape (a flagship full-file block of
    the enhancer, 256 frames) and a TP shape (the trunk's 1536 channels over
    2 ranks): the moments (below), the apply
    (from the twin's moments, so that only the apply is tested) within
    tolerance for each activation, one launch each counted by shape, and
    the two composed (one shard) within it of the one-launch norm's twin.
    The moments
    are held to float64 ones: within 1e-6 relative to each plane's scale
    (its RMS for the mean, E[x^2] for E[x^2]), or no farther than the
    twin's f32 reduction."""
    from pix2pixhdaudiosr_torch.ops import norm
    x = _in_input(cuda, shape, dtype)
    B, C, H, W = shape
    n = (norm.instance_moments.launches, norm.instance_apply.launches)
    got = norm.instance_moments(x)
    want = norm.instance_moments_ref(x)
    assert got.shape == (2, B, C) and got.dtype == torch.float32
    xd = x.double()
    exact = torch.stack((xd.mean(dim=(2, 3)), (xd * xd).mean(dim=(2, 3))))
    scale = torch.stack((exact[1].sqrt(), exact[1]))

    def rel(m):
        return ((m.double() - exact).abs() / scale).max().item()
    assert rel(got) <= max(1e-6, rel(want)), (rel(got), rel(want))
    for act in ("none", "relu", "leaky"):
        _assert_in_close(norm.instance_apply(x, want, act),
                         norm.instance_apply_ref(x, want, act))
    assert (norm.instance_moments.launches,
            norm.instance_apply.launches) == (n[0] + 1, n[1] + 3)
    assert norm.instance_apply.launches_by_shape[(H, W, C)] >= 3
    _assert_in_close(norm.instance_apply(x, got, "relu"),
                     norm.instance_norm_act_ref(x, "relu"))
    with pytest.raises(ValueError, match="channels_last"):
        norm.instance_moments(x.contiguous())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hwc", IN_SHAPES)
def test_instance_norm_onepass_at_flagship_shapes(cuda, hwc, dtype):
    """Every flagship InstanceNorm shape at batch 3 takes the one-pass
    route, for every activation within tolerance of the twin, and two runs
    give the same bits."""
    from pix2pixhdaudiosr_torch.ops.norm import (ACTS, instance_norm_act,
                                                 instance_norm_act_ref)
    H, W, C = hwc
    x = _in_input(cuda, (3, C, H, W), dtype)
    n, n1 = instance_norm_act.launches, instance_norm_act.launches_onepass
    for act in ACTS:
        got = instance_norm_act(x, act)
        assert got.is_contiguous(memory_format=torch.channels_last)
        _assert_in_close(got, instance_norm_act_ref(x, act))
    assert instance_norm_act.launches == n + 3
    assert instance_norm_act.launches_onepass == n1 + 3
    assert torch.equal(instance_norm_act(x, "none"), instance_norm_act(x, "none"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_reads_cropped_view_in_place(cuda, dtype):
    """The same-mode deconv crop [..., :2H, :2W] of a channels_last tensor
    takes the one-pass route as it is (a cluster of 16 here), agrees with
    the twin, and gives the bits of its contiguous copy, run after run."""
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_ref,
                                                 plan_instance_norm)
    x = _in_input(cuda, (2, 48, 257, 129), dtype)[..., :256, :128]
    assert not x.is_contiguous(memory_format=torch.channels_last)
    assert plan_instance_norm(2, 256, 128, 48, x.dtype).cluster == 16
    n1 = instance_norm_act.launches_onepass
    got = instance_norm_act(x, "relu")
    assert instance_norm_act.launches_onepass == n1 + 1
    _assert_in_close(got, instance_norm_act_ref(x, "relu"))
    assert torch.equal(instance_norm_act(x, "relu"), got)
    assert torch.equal(instance_norm_act(
        x.contiguous(memory_format=torch.channels_last), "relu"), got)


def test_instance_norm_two_pass_route_and_counters(cuda):
    """A plane that no cluster holds (1024 x 1024 positions: 16 MB at a
    16-byte tile) and rows of 5 channels take the two-pass route, counted in
    `launches` and by shape, not in `launches_onepass`; a strided view there
    is copied by the wrapper. A view whose row pitch is no multiple of 16
    bytes, and an NCHW tensor, are refused."""
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_ref,
                                                 plan_instance_norm)
    for x in (_in_input(cuda, (1, 8, 1024, 1024), "bfloat16"),
              _in_input(cuda, (1, 8, 1025, 1025), "bfloat16")[..., :1024, :1024],
              _in_input(cuda, (2, 5, 7, 9), "float32")):
        B, C, H, W = x.shape
        assert plan_instance_norm(B, H, W, C, x.dtype).route == "twopass"
        n, n1 = instance_norm_act.launches, instance_norm_act.launches_onepass
        by_shape = instance_norm_act.launches_by_shape.get((H, W, C), 0)
        got = instance_norm_act(x, "leaky")
        assert instance_norm_act.launches == n + 1
        assert instance_norm_act.launches_onepass == n1
        assert instance_norm_act.launches_by_shape[(H, W, C)] == by_shape + 1
        _assert_in_close(got, instance_norm_act_ref(x, "leaky"))
    with pytest.raises(ValueError, match="16-byte"):
        instance_norm_act(_in_input(cuda, (2, 4, 9, 11), "bfloat16")[..., :8, :10])
    with pytest.raises(ValueError, match="channels_last"):
        instance_norm_act(_in_input(cuda, (2, 48, 8, 8), "bfloat16").contiguous())


# the discriminator's InstanceNorm shapes on a [B, 512, 128, 4] pair
D_IN_SHAPES = [(129, 33, 128), (65, 17, 256), (66, 18, 512), (65, 17, 128),
               (33, 9, 256), (34, 10, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hwc,act", [(s, "relu") for s in IN_SHAPES]
                         + [(s, "leaky") for s in D_IN_SHAPES])
def test_instance_norm_function_matches_twin_autograd(cuda, hwc, act, dtype):
    """InstanceNormAct (the kernel forward, the backward kernel) at every
    training InstanceNorm shape, batch 2, against the twins
    (chip_smoke.in_grad_check): y within 1e-5 in f32 and one bf16 ulp in
    bf16; the saved statistics; dx against the backward's twin and against
    autograd through the forward's twin within 1e-4 max|dx| in f32, one
    bf16 ulp (+ that floor) in bf16, in x's dtype and shape, with no slope
    flip; the forward on the one-pass route."""
    import chip_smoke
    from pix2pixhdaudiosr_torch.ops.norm import instance_norm_act
    H, W, C = hwc
    x = _in_input(cuda, (2, C, H, W), dtype)
    dy = _in_input(cuda, (2, C, H, W), dtype, seed=9)
    n1 = instance_norm_act.launches_onepass
    res = chip_smoke.in_grad_check(x, act, dy)
    assert instance_norm_act.launches_onepass == n1 + 1
    assert res["ok"], res


def _assert_grad_close(got, want):
    """dx within one bf16 ulp + 1e-4 max|dx| (bf16), 1e-4 max|dx| (f32)."""
    import chip_smoke
    assert got.dtype == want.dtype and got.shape == want.shape
    floor = 1e-4 * want.float().abs().max().item()
    if got.dtype == torch.float32:
        assert (got - want).abs().max().item() <= floor
    else:
        assert chip_smoke.ulp_excess(got, want, floor) <= 0


def _grad_plan(route, B, H, W, C, dtype):
    """The backward's plan on `route`: one-pass with 16-byte tiles admitted
    (so every training shape has one), or two-pass."""
    from pix2pixhdaudiosr_torch.ops import norm
    if route == "onepass":
        return norm.plan_instance_norm_grad(B, H, W, C, dtype, narrow=True)
    return norm.INPlan("twopass")


@pytest.mark.parametrize("route", ["onepass", "twopass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hwc,act", [(s, "relu") for s in IN_SHAPES]
                         + [(s, "leaky") for s in D_IN_SHAPES])
def test_instance_norm_grad_kernel_matches_twin(cuda, hwc, act, dtype, route):
    """The backward kernel at every training InstanceNorm shape, batch 2, on
    every route: dx within tolerance of the twin from the forward's saved
    statistics, channels_last in x's dtype, bit-identical over two runs,
    each launch counted on its route; the forward's saved statistics equal
    to the twin's (mean within 1e-5, variance within 1e-5 relative)."""
    from pix2pixhdaudiosr_torch.ops import norm
    H, W, C = hwc
    x = _in_input(cuda, (2, C, H, W), dtype)
    dy = _in_input(cuda, (2, C, H, W), dtype, seed=9)
    y, saved = norm.instance_norm_act(x, act, with_stats=True)
    mean, var = norm.instance_mean_var_ref(x)
    torch.testing.assert_close(saved[0], mean, atol=1e-5, rtol=0)
    torch.testing.assert_close(saved[1], var, atol=0, rtol=1e-5)
    plan = _grad_plan(route, 2, H, W, C, x.dtype)
    assert plan.route == route
    n = norm.instance_norm_act_grad.launches_by_route.get(route, 0)
    got = norm.instance_norm_act_grad(x, dy, saved, act, plan=plan)
    assert norm.instance_norm_act_grad.launches_by_route[route] == n + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_grad_close(got, norm.instance_norm_act_grad_ref(x, dy, saved, act))
    assert torch.equal(norm.instance_norm_act_grad(x, dy, saved, act,
                                                   plan=plan), got)


@pytest.mark.parametrize("route", ["onepass", "twopass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_grad_reads_crop_and_padded_dy(cuda, dtype, route):
    """Through the Function: x the same-mode deconv crop [..., :2H, :2W]
    and dy a crop of a padded channels_last tensor are both read in place
    (no dy copy), dx lands in the full tensor's grad (zero outside the
    view), and equals the dx of contiguous copies bit for bit."""
    from pix2pixhdaudiosr_torch.models.layers import InstanceNormAct
    from pix2pixhdaudiosr_torch.ops import norm
    full = _in_input(cuda, (2, 48, 65, 33), dtype).requires_grad_(True)
    x = full[..., :64, :32]
    dy = _in_input(cuda, (2, 48, 66, 34), dtype, seed=9)[..., 1:65, :32]
    plan = _grad_plan(route, 2, 64, 32, 48, x.dtype)
    grad = norm.instance_norm_act_grad
    copies, n = grad.dy_copies, grad.launches

    def plain(x_, dy_):
        y, saved = norm.instance_norm_act(x_, "relu", with_stats=True)
        return grad(x_, dy_, saved, "relu", plan=plan)
    got = plain(x, dy)
    assert grad.dy_copies == copies and grad.launches == n + 1
    want = plain(x.detach().contiguous(memory_format=torch.channels_last),
                 dy.contiguous(memory_format=torch.channels_last))
    assert torch.equal(got, want)
    if route == "onepass" and plan == norm.plan_instance_norm_grad(
            2, 64, 32, 48, x.dtype):
        y = InstanceNormAct.apply(x, "relu")
        y.backward(dy)
        assert torch.equal(full.grad[..., :64, :32], got)
        assert not full.grad[..., 64:, :].any() and not full.grad[..., 32:].any()


@pytest.mark.parametrize("route", ["onepass", "twopass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hwc", [(16, 8, 96), (129, 33, 128)])
def test_instance_norm_grad_reads_an_nchw_dy_in_place(cuda, hwc, dtype, route):
    """An NCHW-contiguous dy, as the reflect pad's backward and the
    feature-matching L1 hand it, is read in place on every route (no copy):
    a plane of 16 x 8 (16-byte aligned channel planes) and a discriminator
    plane of 129 x 33 (8514 bytes in bf16: 2-byte aligned), at a start one
    element past the storage's too; dx equals that of its channels_last
    copy bit for bit. A dy of another dtype, and an expanded one, are still
    copied and counted by shape."""
    from pix2pixhdaudiosr_torch.ops import norm
    grad = norm.instance_norm_act_grad
    H, W, C = hwc
    x = _in_input(cuda, (2, C, H, W), dtype)
    y, saved = norm.instance_norm_act(x, "leaky", with_stats=True)
    plan = _grad_plan(route, 2, H, W, C, x.dtype)
    dy = _in_input(cuda, (2, C, H, W), dtype, seed=9)
    want = grad(x, dy, saved, "leaky", plan=plan)
    shifted = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=cuda)
    shifted[1:] = dy.contiguous().flatten()
    for nchw in (dy.contiguous(), shifted[1:].view(dy.shape)):
        assert not nchw.is_contiguous(memory_format=torch.channels_last)
        copies, n = grad.dy_copies, grad.launches_by_route.get(route, 0)
        got = grad(x, nchw, saved, "leaky", plan=plan)
        assert grad.dy_copies == copies
        assert grad.launches_by_route[route] == n + 1
        assert torch.equal(got, want)
    other = torch.float32 if dtype == "bfloat16" else torch.bfloat16
    for dy_c in (dy.to(other), torch.ones(1, 1, 1, 1, device=cuda,
                                          dtype=x.dtype).expand(x.shape)):
        copies = grad.dy_copies_by_shape.get((H, W, C), 0)
        got = grad(x, dy_c, saved, "leaky", plan=plan)
        assert grad.dy_copies_by_shape[(H, W, C)] == copies + 1
        assert torch.equal(got, grad(x, dy_c.to(x.dtype).contiguous(
            memory_format=torch.channels_last), saved, "leaky", plan=plan))


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_instance_norm_grad_at_512x128x48_reads_dy_in_place(cuda, layout):
    """The flagship's largest plane, 512 x 128 x 48 bf16 at batch 4, on the
    planner's route there (two-pass, which an H100 measured faster than the
    one-pass plan at a 16-byte tile and than three 3-plane designs): dy
    channels_last or NCHW, as the reflect pad's backward hands it, read in
    place (no copy); dx within one bf16 ulp + 1e-4 max|dx| of the twin and
    bit-identical over two runs."""
    from pix2pixhdaudiosr_torch.ops import norm
    grad = norm.instance_norm_act_grad
    shape = (4, 48, 512, 128)
    x = _in_input(cuda, shape, "bfloat16")
    dy = _in_input(cuda, shape, "bfloat16", seed=9)
    if layout == "nchw":
        dy = dy.contiguous()
    y, saved = norm.instance_norm_act(x, "relu", with_stats=True)
    route = norm.plan_instance_norm_grad(4, 512, 128, 48, x.dtype).route
    assert route == "twopass"
    copies, n = grad.dy_copies, grad.launches_by_route.get(route, 0)
    got = grad(x, dy, saved, "relu")
    assert grad.dy_copies == copies
    assert grad.launches_by_route[route] == n + 1
    _assert_grad_close(got, norm.instance_norm_act_grad_ref(x, dy, saved,
                                                            "relu"))
    assert torch.equal(grad(x, dy, saved, "relu"), got)


def test_instance_norm_grad_constant_plane_drops_the_variance_term(cuda):
    """A constant plane (the variance clamped to 0): the kernel's dx equals
    rstd (g - mean(g)) of the twin, on both routes."""
    from pix2pixhdaudiosr_torch.ops import norm
    x = _in_input(cuda, (2, 16, 8, 8), "float32")
    x[:, 3] = 0.75   # exact sums: E[x^2] - mean^2 is 0
    dy = _in_input(cuda, (2, 16, 8, 8), "float32", seed=9)
    y, saved = norm.instance_norm_act(x, "leaky", with_stats=True)
    assert (saved[1, :, 3] == 0).all()
    want = norm.instance_norm_act_grad_ref(x, dy, saved, "leaky")
    for plan in (norm.plan_instance_norm_grad(2, 8, 8, 16, x.dtype),
                 norm.INPlan("twopass")):
        _assert_grad_close(norm.instance_norm_act_grad(
            x, dy, saved, "leaky", plan=plan), want)


@pytest.mark.parametrize("C", [2, 4, 64])
def test_avg_pool_3s2_grad_on_card_matches_cpu(cuda, C):
    """models/layers.avg_pool_3s2 on a channels_last tensor that requires
    grad: its output channels_last, and its forward and dx on the card
    within 1e-6 of the CPU's, for a grad in either layout (PyTorch's own
    channels_last avg_pool2d backward on CUDA is off by ~max|dx| here)."""
    from pix2pixhdaudiosr_torch.models.layers import avg_pool_3s2
    gen = torch.Generator().manual_seed(C)
    x = torch.randn(2, C, 63, 31, generator=gen)
    dy = torch.randn(2, C, 32, 16, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        for fmt in (torch.contiguous_format, torch.channels_last):
            xx = x.to(dev).contiguous(memory_format=torch.channels_last)
            xx.requires_grad_(True)
            y = avg_pool_3s2(xx)
            assert y.is_contiguous(memory_format=torch.channels_last)
            y.backward(dy.to(dev).contiguous(memory_format=fmt))
            out[(str(dev), fmt)] = (y.detach().cpu(), xx.grad.cpu())
    for fmt in (torch.contiguous_format, torch.channels_last):
        (y0, g0), (y1, g1) = out[("cpu", fmt)], out[("cuda", fmt)]
        torch.testing.assert_close(y1, y0, atol=1e-6, rtol=0)
        torch.testing.assert_close(g1, g0, atol=1e-6, rtol=0)


def test_train_step_on_card_matches_cpu(cuda):
    """One make_train_step step of chip_smoke.TOY_TRAIN on the card against
    the CPU's, f32 with TF32 off (chip_smoke.phase_train_reference: losses
    within rtol 1e-4, grads within 1e-3 max|g| a leaf, params within
    2 lr; every InstanceNorm launch one-pass, and 2 MDCT2 launches on the
    tensor-core route). It raises chip_smoke.SmokeFailure on a miss."""
    import chip_smoke
    res = chip_smoke.phase_train_reference("cuda")
    assert res["in_launches"] == res["in_launches_onepass"] > 0


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


def _conv_in_case(cuda, shape, seed=2):
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    B, C, H, W = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def act():
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, res = act(), act()
    w = te.pack_weights(torch.randn(C, C, 3, 3, generator=gen, device=cuda) * .05)
    bias = torch.randn(C, generator=gen, device=cuda) * .1
    mean = torch.randn(B, C, generator=gen, device=cuda) * .3
    scale = torch.rand(B, C, generator=gen, device=cuda) * 1.5 + .5
    return x, w, bias, mean, scale, res


def _assert_conv_in_close(got, want):
    """y within one bf16 ulp; mean and scale within 1e-4 of the channel's
    magnitude (see test_conv3x3_in_kernel_matches_twin)."""
    y, (m, s) = got
    y_ref, (m_ref, s_ref) = want
    assert y.dtype == torch.bfloat16 and y.shape == y_ref.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _ulp_excess(y, y_ref) <= 0
    assert ((m - m_ref).abs() <= 1e-4 * (m_ref.abs() + 1 / s_ref)).all()
    assert ((s - s_ref).abs() <= 1e-4 * s_ref).all()


@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("prologue", [None, "in_relu", "in_relu_add", "in_add"])
@pytest.mark.parametrize("shape", [(2, 96, 16, 64), (128, 96, 256, 64)])
def test_conv3x3_in_routes_match_twin(cuda, shape, prologue, route):
    """Both routes of B4 at a small shape and the flagship enhancer shape:
    the planner's choice is the wgmma route there; each launch counts in
    `launches`, and in `launches_wgmma` on that route only; the statistics
    are bit-identical over two runs."""
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    B, C, H, W = shape
    args = (*_conv_in_case(cuda, shape), prologue)
    assert te.plan_conv(B, H, W, C, C).route == "wgmma"
    plan = te.plan_conv(B, H, W, C, C, te.device_sms(cuda.index or 0),
                        route=route)
    n, n_wg = te.conv3x3_in.launches, te.conv3x3_in.launches_wgmma
    got = te.conv3x3_in(*args, plan=plan)
    again = te.conv3x3_in(*args, plan=plan)
    assert te.conv3x3_in.launches == n + 2
    assert te.conv3x3_in.launches_wgmma == n_wg + 2 * (route == "wgmma")
    _assert_conv_in_close(got, te.conv3x3_in_ref(*args))
    assert torch.equal(got[0], again[0])
    assert torch.equal(got[1][0], again[1][0])
    assert torch.equal(got[1][1], again[1][1])
    if route == "wgmma" and shape[0] == 2:   # the planner's own choice
        n_wg = te.conv3x3_in.launches_wgmma
        _assert_conv_in_close(te.conv3x3_in(*args), te.conv3x3_in_ref(*args))
        assert te.conv3x3_in.launches_wgmma == n_wg + 1


@pytest.mark.parametrize("B,H", [(3, 16), (1, 255), (3, 256), (264, 16),
                                 (133, 16)])
def test_conv3x3_in_wgmma_plans_match_twin(cuda, B, H):
    """The planner's wgmma plans at shapes that give the kernel other walks
    than the flagship's (on 132 SMs): strips of 1 row (3, 16); units of
    unequal length (1, 255: strips of 2, the last of 1; 3, 256: strips of
    6, the last of 4); more units than blocks, so that a block carries its
    ring from one unit to the next (264, 16: two whole samples a block;
    133, 16: strips of 4, 532 units). The prologue with a residual: y within
    one bf16 ulp of the twin, and the statistics those of the kernel's own
    output within 1e-5; bit-identical run to run. The statistics are not
    held to the twin's here: on planes this small (1024 positions) a few
    1-ulp differences of y from the twin move a channel's mean or scale by
    more than 1e-4 on either route, as the flagship plane (16384) does
    not; test_conv3x3_in_routes_match_twin holds them there."""
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    args = (*_conv_in_case(cuda, (B, 96, H, 64), seed=4), "in_relu_add")
    plan = te.plan_conv(B, H, 64, 96, 96, te.device_sms(cuda.index or 0))
    assert plan.route == "wgmma"
    got = te.conv3x3_in(*args, plan=plan)
    y, (m, s) = got
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _ulp_excess(y, te.conv3x3_in_ref(*args)[0]) <= 0
    yd = y.double()
    m_own = yd.mean((2, 3))
    s_own = ((yd * yd).mean((2, 3)) - m_own ** 2).clamp(min=0).add(1e-5).rsqrt()
    assert ((m - m_own).abs() <= 1e-5 * (m_own.abs() + 1 / s_own)).all()
    assert ((s - s_own).abs() <= 1e-5 * s_own).all()
    again = te.conv3x3_in(*args, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(
        (got[0], *got[1]), (again[0], *again[1])))


@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,co", [
    ((2, 96, 18, 66), 96), ((64, 96, 258, 66), 96), ((2, 96, 10, 66), 192),
    ((140, 96, 4, 66), 96), ((1, 96, 257, 66), 96)])
def test_conv3x3_valid_routes_match_twin(cuda, shape, co, relu, route):
    """Both routes of B5, the flagship shape [64, 96, 258, 66] among them;
    (2, 96, 10, 66) -> 192 takes two N tiles; on the wgmma route
    (140, 96, 4, 66) has more units than blocks and (1, 96, 257, 66) units
    of unequal length. Each launch counts in `launches`, and in
    `launches_wgmma` on the wgmma route only."""
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    from pix2pixhdaudiosr_torch.ops.conv import conv3x3_valid, conv3x3_valid_ref
    B, C, Hp, Wp = shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = (torch.randn(co, C, 3, 3, generator=gen, device=cuda) * .1
         ).to(torch.bfloat16)
    assert te.plan_conv(B, Hp - 2, Wp - 2, C, co).route == "wgmma"
    plan = te.plan_conv(B, Hp - 2, Wp - 2, C, co,
                        te.device_sms(cuda.index or 0), route=route)
    n, n_wg = conv3x3_valid.launches, conv3x3_valid.launches_wgmma
    y = conv3x3_valid(x, w, relu, plan=plan)
    assert conv3x3_valid.launches == n + 1
    assert conv3x3_valid.launches_wgmma == n_wg + (route == "wgmma")
    want = conv3x3_valid_ref(x, w, relu)
    torch.cuda.synchronize()
    assert y.shape == (B, co, Hp - 2, Wp - 2)
    assert _ulp_excess(y, want) <= 0
    if relu:
        assert (y >= 0).all()


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


@pytest.mark.parametrize("route", ["strip", "threepass"])
@pytest.mark.parametrize("shape", [(13824, 1536), (1000, 136), (7, 3),
                                   (5, 1)])
def test_stochastic_quantize_kernel_matches_twin(cuda, shape, route):
    """q and scale bit-identical to the twin on the card, on both routes;
    the dequantized values within one step of x. The strip route is the
    planner's at (13824, 1536) and (1000, 136) (one launch); (7, 3) and
    (5, 1) have no strip (rows of no 16-byte multiple), so there the
    planner's three-launch route runs, on its scalar quantize path (M * N
    not a multiple of 4)."""
    from pix2pixhdaudiosr_torch.ops import quant
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(shape, generator=gen, device=cuda) * 0.02
    plan = (quant.plan_quantize(*shape) if route == "strip"
            else quant.QuantPlan("threepass"))
    assert plan.route == route or shape[1] % 4
    fn = quant.stochastic_quantize_2d
    n, n_route = fn.launches, fn.launches_by_route.get(plan.route, 0)
    q, s = fn(x, 1234, plan)
    assert fn.launches == n + 1
    assert fn.launches_by_route[plan.route] == n_route + 1
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


def test_dp_step_on_card_matches_one_process(cuda, tmp_path):
    """The toy train step (f32) data-parallel over 2 gloo ranks sharing
    cuda:0 (tests/torch_parallel_cases.py) against one process on the
    card, 2 steps on a global batch of 4 with the same mask noise, each
    from the state the one-process step starts from (the seeded init, then
    its `latest` after step 1: from a second step on, Adam turns the first
    step's rounding into whole ~lr steps, so two runs left to go on drift
    apart), held as tests/test_torch_dp.py holds them on the CPU: losses
    within rtol 1e-5; every parameter whose grad is above 1e-3 of its
    leaf's max|g| (not a bias feeding an InstanceNorm) within 1e-3 lr, all
    within 2.2 lr; the Adam moments within 1e-3 (first) and 2e-3 (second)
    of their leaf's max; both ranks equal."""
    import os
    import sys

    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_cases as cases
    rng = np.random.default_rng(5)
    job = dict(device="cuda:0", resume=str(tmp_path), batch={
        k: (rng.standard_normal((4, 480)) * 0.2).astype(np.float32)
        for k in ("label", "image")},
        noise=[np.random.default_rng(20 + i).standard_normal(
            (4, 53, 16, 2)).astype(np.float32) for i in range(2)])
    torch.backends.cudnn.allow_tf32 = False
    one = [cases.train_run(None, job, mode="one", steps=1, save=str(tmp_path)),
           cases.train_run(None, job, mode="one", steps=1, first_noise=1,
                           resume=str(tmp_path))]
    ranks = cases.run_world(2, job, ["dp_card"], timeout=300)
    lr = 2e-4
    for i, want in enumerate(one):
        got = ranks[0]["dp_card"][i]
        assert got["losses"] == ranks[1]["dp_card"][i]["losses"]
        assert got["step"] == want["step"] == i + 1
        for k in want["losses"][0]:
            np.testing.assert_allclose(got["losses"][0][k],
                                       want["losses"][0][k], rtol=1e-5,
                                       err_msg=k)
        cases.close_params(got["states"][0], want["states"][0], want["grads"],
                           want["void"], 1e-3 * lr, 2.2 * lr)
        cases.close_moments(got["states"][0], want["states"][0], want["void"])
