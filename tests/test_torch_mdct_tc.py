"""The arithmetic of the tensor-core MDCT2/IMDCT2 kernels, on the CPU.

csrc/mdct.cu computes both transforms in 3xTF32: every f32 operand is split
as a = hi + lo into tf32 parts and a @ b is summed as lo*hi + hi*lo + hi*hi.
The basis planes come from `mdct_kernels.tf32_split`, which must round as
the card's cvt.rna.tf32.f32 does; the signal side is split in the kernel
(hi rounded to nearest, lo = a - hi truncated to tf32 where the tensor cores
read it). Here a plain emulation of that arithmetic, at the flagship codec
(batch 2, 512/256), is held to the JAX package's fused Pallas kernels in
interpret mode, and the route rule is checked on shapes alone. The card
itself holds the kernels to their twins (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from pix2pixhdaudiosr_tpu.ops.encoding import CodecConfig as JCodecConfig  # noqa: E402
from pix2pixhdaudiosr_tpu.ops.encoding import SpectroCodec as JSpectroCodec  # noqa: E402

from pix2pixhdaudiosr_torch.ops import mdct as tmdct  # noqa: E402
from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk  # noqa: E402
from pix2pixhdaudiosr_torch.ops.encoding import CodecConfig, SpectroCodec  # noqa: E402
from pix2pixhdaudiosr_torch.ops.framing import pad_signal  # noqa: E402
from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2  # noqa: E402
from pix2pixhdaudiosr_torch.ops.window import kbdwin  # noqa: E402

SEG = 32512
MASK = -0x2000  # clears the 13 mantissa bits below tf32's 10


@pytest.fixture
def interpret_pallas(monkeypatch):
    import pix2pixhdaudiosr_tpu.ops.dct_pallas as K
    orig = pl.pallas_call

    def interp_call(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(K.pl, "pallas_call", interp_call)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round f32 to tf32 (10 mantissa bits), to nearest, ties away from
    zero, in float64 arithmetic: an independent statement of cvt.rna."""
    a = np.abs(x.astype(np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    quantum = np.exp2(np.maximum(e, -126) - 10)  # subnormals: fixed quantum
    return np.copysign(np.floor(a / quantum + 0.5) * quantum, x).astype(np.float32)


def _emulate_tc(a: torch.Tensor, planes, bk: int = 32) -> torch.Tensor:
    """What p2p_{mdct2,imdct2}_tc compute for out = a @ bt^T, bt given as
    its tf32 planes: a split as the kernel splits it, three tf32 products a
    32-deep stage (exact products; the stage's sum rounded once to f32), the
    stages summed in f32 in order."""
    hi_b, lo_b = (p.double() for p in planes)
    hi_a = ((_bits(a) + 0x1000) & MASK).view(torch.float32)
    lo_a = (_bits(a - hi_a) & MASK).view(torch.float32)  # truncated
    hi_a, lo_a = hi_a.double(), lo_a.double()
    acc = torch.zeros(a.shape[0], hi_b.shape[0], dtype=torch.float32)
    for k in range(0, a.shape[1], bk):
        s = slice(k, k + bk)
        part = (lo_a[:, s] @ hi_b[:, s].T + hi_a[:, s] @ lo_b[:, s].T
                + hi_a[:, s] @ hi_b[:, s].T)
        acc = acc + part.float()
    return acc


def emulated_mdct2(x_pad, basis, hop, planes=None):
    """The forward kernel: rows (b, t) are frames, K = win, N = n_fft."""
    win, n_fft = basis.shape
    frames = x_pad.unfold(-1, win, hop)
    out = _emulate_tc(frames.reshape(-1, win), planes or mk.mdct2_planes(basis))
    return out.reshape(frames.shape[:-1] + (n_fft,))


def emulated_imdct2(spec, basis, hop, planes=None):
    """The inverse kernel: row (b, j) holds spec[b, j - i, :] at K block i
    (zero outside [0, T)), K = m * n_fft, N = hop; the [B * (T + m - 1),
    hop] result is the un-cropped signal."""
    B, T, n_fft = spec.shape
    m = basis.shape[1] // hop
    padded = torch.nn.functional.pad(spec, (0, 0, m - 1, m - 1))
    rows = torch.cat([padded[:, m - 1 - i: m - 1 - i + T + m - 1]
                      for i in range(m)], dim=-1)
    out = _emulate_tc(rows.reshape(-1, m * n_fft),
                      planes or mk.imdct2_planes(basis, hop))
    return out.reshape(B, (T + m - 1) * hop)


def test_tf32_split_rounds_as_cvt_rna(rng_np):
    """hi: the low 13 mantissa bits zero, equal to round-to-nearest with
    ties away from zero (checked against a float64 statement of it, on
    normals, subnormals and exact ties); x - hi exact in f32; hi + lo within
    2^-22 |x| where lo is not subnormal (|x| >= 2^-100); non-finite values
    pass through."""
    x = (rng_np.standard_normal(20000)
         * np.exp2(rng_np.integers(-60, 60, 20000))).astype(np.float32)
    sub = (rng_np.standard_normal(200) * 2.0 ** -130).astype(np.float32)
    ties = rng_np.integers(0x00800000, 0x7F000000, 200, dtype=np.int64)
    ties = ((ties & ~0x1FFF) | 0x1000).astype(np.int32).view(np.float32)
    x = np.concatenate([x, sub, ties, -ties, [0.0, -0.0]]).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = mk.tf32_split(xt)
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy().view(np.int32),
                                  _rna_reference(x).view(np.int32))
    n = len(ties)
    got = hi.numpy()[-2 * n - 2:-2]
    assert (np.abs(got) > np.abs(np.concatenate([ties, -ties]))).all()
    np.testing.assert_array_equal((xt - hi).double().numpy(),
                                  xt.double().numpy() - hi.double().numpy())
    err = np.abs(xt.double().numpy() - hi.double().numpy() - lo.double().numpy())
    big = np.abs(x.astype(np.float64))
    assert (err <= 2.0 ** -22 * big)[big >= 2.0 ** -100].all()
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi_s, _ = mk.tf32_split(special)
    assert torch.equal(_bits(hi_s), _bits(special))


@pytest.mark.parametrize("win,hop,n_fft,tc", [
    (512, 256, 512, True),    # the flagship codec
    (512, 128, 512, True),
    (64, 32, 64, True),
    (400, 200, 512, True),
    (512, 160, 512, False),   # win % hop != 0: the FFMA route
    (510, 255, 512, False),   # hop % 4 != 0: rows off the 16-byte grid
    (512, 256, 514, False),   # n_fft % 4 != 0
])
def test_route_is_chosen_by_codec_shape(win, hop, n_fft, tc):
    """tc_route admits a codec by its shape alone, and the codec builds the
    kernel's basis planes exactly when it is admitted: [n_fft, win] for the
    forward, [hop, (win / hop) n_fft] for the inverse."""
    assert mk.tc_route(win, hop, n_fft) is tc
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, window=kbdwin(win),
              device="cpu")
    fwd, inv = MDCT2(**kw), IMDCT2(**kw)
    assert fwd.tc is inv.tc is tc
    if not tc:
        assert fwd.planes is None and inv.planes is None
        return
    assert [tuple(p.shape) for p in fwd.planes] == [(n_fft, win)] * 2
    assert [tuple(p.shape) for p in inv.planes] == [(hop, win // hop * n_fft)] * 2
    # the inverse planes regroup the basis: Bt[c, i n_fft + f] = basis[f, i hop + c]
    rebuilt = (inv.planes[0].double() + inv.planes[1].double()).reshape(
        hop, win // hop, n_fft).permute(2, 1, 0).reshape(n_fft, win)
    np.testing.assert_allclose(rebuilt.numpy(), inv.basis.double().numpy(),
                               rtol=2.0 ** -22, atol=0)


def test_emulated_tc_kernels_match_fused_pallas_kernels(rng_np,
                                                        interpret_pallas):
    """The kernels' 3xTF32 arithmetic at the flagship codec, batch 2, within
    atol 1e-5 of fused_mdct2 / fused_imdct2 (the bound the card holds the
    kernels to against their twins)."""
    from pix2pixhdaudiosr_tpu.ops.dct_pallas import fused_imdct2, fused_mdct2
    kw = dict(n_fft=512, hop_length=256, win_length=512, window=kbdwin(512),
              device="cpu")
    fwd, inv = MDCT2(**kw), IMDCT2(**kw)
    x = (rng_np.standard_normal((2, SEG)) * 0.3).astype(np.float32)
    x_pad = pad_signal(torch.from_numpy(x), 256, True)
    got = emulated_mdct2(x_pad, fwd.basis, 256, fwd.planes)
    want = np.asarray(fused_mdct2(jnp.asarray(x_pad.numpy()),
                                  jnp.asarray(fwd.basis.numpy()), hop=256,
                                  win=512, t_tile=128))
    assert got.shape == want.shape == (2, 128, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    spec = torch.from_numpy(np.array(want))
    got = emulated_imdct2(spec, inv.basis, 256, inv.planes)
    want = np.asarray(fused_imdct2(jnp.asarray(want),
                                   jnp.asarray(inv.basis.numpy()), hop=256,
                                   win=512))
    assert got.shape == want.shape == (2, 33024)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_emulated_tc_forward_through_to_spectro(rng_np, monkeypatch):
    """The encode on the kernels' arithmetic against the JAX package's:
    within the encode bound 1e-3, which the dB map sets (it amplifies the
    absolute error of coefficients just above its 1e-7 floor)."""
    x = (rng_np.standard_normal((2, SEG)) * 0.1).astype(np.float32)
    want = np.asarray(JSpectroCodec(JCodecConfig()).to_spectro(jnp.asarray(x))[0])
    codec = SpectroCodec(CodecConfig(), "cpu")
    monkeypatch.setattr(tmdct, "mdct2", emulated_mdct2)
    got = codec.to_spectro(torch.from_numpy(x))[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("win,hop,n_fft", [(400, 200, 512), (512, 128, 512),
                                           (64, 32, 64)])
def test_emulated_tc_kernels_match_twins_on_other_codecs(rng_np, win, hop,
                                                         n_fft):
    """The planes' layouts for win < n_fft and win / hop = 4: the emulated
    kernels within atol 1e-5 of the twins at batch 3, T = 36 or 38
    frames (no tile multiple)."""
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, window=kbdwin(win),
              device="cpu")
    fwd, inv = MDCT2(**kw), IMDCT2(**kw)
    x = torch.from_numpy((rng_np.standard_normal((3, hop * 37)) * 0.3)
                         .astype(np.float32))
    x_pad = pad_signal(x, hop, True)
    spec = emulated_mdct2(x_pad, fwd.basis, hop, fwd.planes)
    want = mk.mdct2_ref(x_pad, fwd.basis, hop)
    assert spec.shape == want.shape == (3, 40 - win // hop, n_fft)
    np.testing.assert_allclose(spec.numpy(), want.numpy(), atol=1e-5, rtol=0)
    wav = emulated_imdct2(want, inv.basis, hop, inv.planes)
    np.testing.assert_allclose(wav.numpy(),
                               mk.imdct2_ref(want, inv.basis, hop).numpy(),
                               atol=1e-5, rtol=0)


def test_plain_tf32_would_miss_the_bound(rng_np):
    """Why three products: at the flagship codec (batch 2) hi*hi alone, a
    plain TF32 product, is off the float64 transform by more than the 1e-5
    the kernels are held to; the 3xTF32 sum is well inside it."""
    kw = dict(n_fft=512, hop_length=256, win_length=512, window=kbdwin(512),
              device="cpu")
    fwd = MDCT2(**kw)
    x = torch.from_numpy((rng_np.standard_normal((2, SEG)) * 0.3)
                         .astype(np.float32))
    x_pad = pad_signal(x, 256, True)
    want = mk.mdct2_ref(x_pad.double(), fwd.basis.double(), 256)
    frames = x_pad.unfold(-1, 512, 256).reshape(-1, 512)
    hi_a = ((_bits(frames) + 0x1000) & MASK).view(torch.float32)
    plain = (hi_a.double() @ fwd.planes[0].double().T).reshape(want.shape)
    split = emulated_mdct2(x_pad, fwd.basis, 256, fwd.planes).double()
    assert (plain - want).abs().max() > 1e-5
    assert (split - want).abs().max() < 1e-6
