"""The port's CUDA kernels against their plain twins, on the card.

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


@pytest.mark.parametrize("win,hop", [(512, 256), (512, 160), (64, 32)])
def test_mdct_kernels_match_twins(cuda, win, hop):
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.framing import pad_signal
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin
    gen = torch.Generator(device=cuda).manual_seed(0)
    kw = dict(n_fft=win, hop_length=hop, win_length=win, window=kbdwin(win),
              device=cuda)
    x = torch.randn(3, hop * 37, generator=gen, device=cuda) * 0.3
    x_pad = pad_signal(x, hop, True).contiguous()
    basis_f, basis_i = MDCT2(**kw).basis, IMDCT2(**kw).basis
    n = mk.mdct2.launches
    spec = mk.mdct2(x_pad, basis_f, hop)
    assert mk.mdct2.launches == n + 1
    torch.testing.assert_close(spec, mk.mdct2_ref(x_pad, basis_f, hop),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(mk.imdct2(spec, basis_i, hop),
                               mk.imdct2_ref(spec, basis_i, hop),
                               atol=1e-5, rtol=0)


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
