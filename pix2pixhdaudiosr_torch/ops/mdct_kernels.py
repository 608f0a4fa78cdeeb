"""The MDCT2 / IMDCT2 kernels (csrc/mdct.cu) and their plain PyTorch twins.

`mdct2` replaces pix2pixhdaudiosr_tpu/ops/dct_pallas.py:fused_mdct2 and
`imdct2` replaces :fused_imdct2 (see csrc/mdct.cu for what bounds them on
the card and how the design answers it). Each wrapper runs its twin for a
tensor on the CPU, launches its CUDA kernel for a tensor on a CUDA device
(counting the launch in `<wrapper>.launches`), and raises for anything
else: there is no fallback from CUDA to the twin.
"""

from __future__ import annotations

import torch

from . import _cuda
from .framing import frame, overlap_add

_MAX_GRID_Z = 65535  # mdct2 launches one grid z-slice per batch row


def mdct2_ref(x_pad: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Twin of `mdct2`: frame, then one f32 matmul.
    [B, L] x [win, n_fft] -> [B, T, n_fft]."""
    return frame(x_pad, basis.shape[0], hop) @ basis


def imdct2_ref(spec: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Twin of `imdct2`: one f32 matmul, then overlap-add.
    [B, T, n_fft] x [n_fft, win] -> [B, (T-1)*hop + win]."""
    return overlap_add(spec @ basis, hop)


def _check_f32_contiguous(name, **tensors):
    for arg, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous float32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")


def mdct2(x_pad: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Windowed DCT-II of the overlapping frames of a padded signal.
    x_pad [B, L] f32, basis [win, n_fft] f32 -> [B, T, n_fft] f32 with
    T = (L - win)//hop + 1. Any hop <= win."""
    if x_pad.device.type == "cpu":
        return mdct2_ref(x_pad, basis, hop)
    _cuda.check_cuda("mdct2", x_pad, basis)
    _check_f32_contiguous("mdct2", x_pad=x_pad, basis=basis)
    if x_pad.dim() != 2 or basis.dim() != 2:
        raise ValueError(f"mdct2: expected [B, L] and [win, n_fft], got "
                         f"{tuple(x_pad.shape)} and {tuple(basis.shape)}")
    B, L = x_pad.shape
    win, n_fft = basis.shape
    if not 0 < hop <= win <= L or B > _MAX_GRID_Z:
        raise ValueError(f"mdct2: need 0 < hop <= win <= L and B <= "
                         f"{_MAX_GRID_Z}, got hop={hop} win={win} L={L} B={B}")
    T = (L - win) // hop + 1
    out = torch.empty(B, T, n_fft, dtype=torch.float32, device=x_pad.device)
    _cuda.launch("p2p_mdct2_f32", x_pad.device, x_pad.data_ptr(),
                 basis.data_ptr(), out.data_ptr(), B, L, T, win, hop, n_fft)
    mdct2.launches += 1
    return out


mdct2.launches = 0


def imdct2(spec: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Inverse basis product with the overlap-add fused in.
    spec [B, T, n_fft] f32, basis [n_fft, win] f32 ->
    [B, (T-1)*hop + win] f32, un-cropped. Any hop <= win."""
    if spec.device.type == "cpu":
        return imdct2_ref(spec, basis, hop)
    _cuda.check_cuda("imdct2", spec, basis)
    _check_f32_contiguous("imdct2", spec=spec, basis=basis)
    if spec.dim() != 3 or basis.dim() != 2 or spec.shape[2] != basis.shape[0]:
        raise ValueError(f"imdct2: expected [B, T, n_fft] and [n_fft, win], "
                         f"got {tuple(spec.shape)} and {tuple(basis.shape)}")
    B, T, n_fft = spec.shape
    win = basis.shape[1]
    if not 0 < hop <= win:
        raise ValueError(f"imdct2: need 0 < hop <= win, got {hop}, {win}")
    out = torch.empty(B, (T - 1) * hop + win, dtype=torch.float32,
                      device=spec.device)
    _cuda.launch("p2p_imdct2_f32", spec.device, spec.data_ptr(),
                 basis.data_ptr(), out.data_ptr(), B, T, n_fft, win, hop)
    imdct2.launches += 1
    return out


imdct2.launches = 0
