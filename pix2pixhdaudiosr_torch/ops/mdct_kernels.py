"""The MDCT2 / IMDCT2 kernels (csrc/mdct.cu) and their plain PyTorch twins.

`mdct2` replaces pix2pixhdaudiosr_tpu/ops/dct_pallas.py:fused_mdct2 and
`imdct2` replaces :fused_imdct2 (see csrc/mdct.cu for what bounds them on
the card and how the design answers it). Each wrapper runs its twin for a
tensor on the CPU, launches a CUDA kernel for a tensor on a CUDA device,
and raises for anything else: there is no fallback from CUDA to the twin.

Two routes on the card, chosen by the codec's shape alone (`tc_route`):
  tensor cores  3xTF32 wgmma (`p2p_mdct2_tc`, `p2p_imdct2_tc`) for
                win % hop == 0, hop % 4 == 0 and n_fft % 4 == 0 (the
                flagship 512/256); the basis enters as K-major tf32 hi/lo
                planes (`mdct2_planes`, `imdct2_planes`), which the codec
                builds once and the wrapper derives when none are given;
  FFMA          the f32 FFMA GEMM (`p2p_mdct2_f32`, `p2p_imdct2_f32`) for
                every other codec (e.g. 512/160).
Every launch counts in `<wrapper>.launches`; tensor-core launches also in
`<wrapper>.launches_tc`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .framing import frame, overlap_add

Planes = Tuple[torch.Tensor, torch.Tensor]

_MAX_GRID_Z = 65535  # the FFMA mdct2 launches one grid z-slice per batch row


def mdct2_ref(x_pad: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Twin of `mdct2`: frame, then one f32 matmul.
    [B, L] x [win, n_fft] -> [B, T, n_fft]."""
    return frame(x_pad, basis.shape[0], hop) @ basis


def imdct2_ref(spec: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Twin of `imdct2`: one f32 matmul, then overlap-add.
    [B, T, n_fft] x [n_fft, win] -> [B, (T-1)*hop + win]."""
    return overlap_add(spec @ basis, hop)


def tf32_split(x: torch.Tensor) -> Planes:
    """(hi, lo) with hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x -
    hi), bit for bit: round to nearest, ties away from zero, to 10 mantissa
    bits (the low 13 bits cleared). x - hi is exact in f32 and
    |x - (hi + lo)| <= 2^-22 |x|. Non-finite values pass through."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        finite = (bits & 0x7F800000) != 0x7F800000
        rounded = (bits + 0x1000) & -0x2000  # ~0x1FFF as int32
        return torch.where(finite, rounded, bits).view(torch.float32)
    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def tc_route(win: int, hop: int, n_fft: int) -> bool:
    """Whether a codec's transforms take the tensor-core kernels: the TPU
    kernels' own condition (win % hop == 0) and 16-byte copies of hop-,
    win- and n_fft-long rows."""
    return hop > 0 and win % hop == 0 and hop % 4 == 0 and n_fft % 4 == 0


def mdct2_planes(basis: torch.Tensor) -> Planes:
    """The forward basis [win, n_fft] as the kernel's K-major B operand,
    transposed to [n_fft, win] and split into tf32 hi and lo planes."""
    return tuple(p.contiguous() for p in tf32_split(basis.t()))


def imdct2_planes(basis: torch.Tensor, hop: int) -> Planes:
    """The inverse basis [n_fft, win] as the kernel's K-major B operand
    Bt[c, i*n_fft + f] = basis[f, i*hop + c], [hop, (win/hop)*n_fft], split
    into tf32 hi and lo planes."""
    n_fft, win = basis.shape
    bt = basis.reshape(n_fft, win // hop, hop).permute(2, 1, 0)
    return tuple(p.reshape(hop, -1).contiguous() for p in tf32_split(bt))


def _check_f32_contiguous(name, **tensors):
    for arg, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous float32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when its data starts on 16 bytes (the copies' unit), else a
    fresh copy (a view into a larger tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_planes(name, planes: Planes, shape) -> None:
    for p in planes:
        if tuple(p.shape) != shape or p.device != planes[0].device:
            raise ValueError(f"{name}: planes must be two {shape} tensors, "
                             f"got {[tuple(q.shape) for q in planes]}")
        _check_f32_contiguous(name, planes=p)


def mdct2(x_pad: torch.Tensor, basis: torch.Tensor, hop: int,
          planes: Optional[Planes] = None) -> torch.Tensor:
    """Windowed DCT-II of the overlapping frames of a padded signal.
    x_pad [B, L] f32, basis [win, n_fft] f32 -> [B, T, n_fft] f32 with
    T = (L - win)//hop + 1. Any hop <= win. `planes`: `mdct2_planes(basis)`,
    used on the tensor-core route (derived here when None)."""
    if x_pad.device.type == "cpu":
        return mdct2_ref(x_pad, basis, hop)
    _cuda.check_cuda("mdct2", x_pad, basis)
    _check_f32_contiguous("mdct2", x_pad=x_pad, basis=basis)
    if x_pad.dim() != 2 or basis.dim() != 2:
        raise ValueError(f"mdct2: expected [B, L] and [win, n_fft], got "
                         f"{tuple(x_pad.shape)} and {tuple(basis.shape)}")
    B, L = x_pad.shape
    win, n_fft = basis.shape
    if not 0 < hop <= win <= L:
        raise ValueError(f"mdct2: need 0 < hop <= win <= L, got hop={hop} "
                         f"win={win} L={L}")
    T = (L - win) // hop + 1
    out = torch.empty(B, T, n_fft, dtype=torch.float32, device=x_pad.device)
    if tc_route(win, hop, n_fft) and L % 4 == 0:
        if planes is None:
            planes = mdct2_planes(basis)
        _check_planes("mdct2", planes, (n_fft, win))
        _cuda.check_cuda("mdct2", x_pad, *planes)
        x = _aligned(x_pad)
        _cuda.launch("p2p_mdct2_tc", x.device, x.data_ptr(),
                     planes[0].data_ptr(), planes[1].data_ptr(),
                     out.data_ptr(), B, L, T, win, hop, n_fft)
        mdct2.launches_tc += 1
    else:
        if B > _MAX_GRID_Z:
            raise ValueError(f"mdct2: B={B} > {_MAX_GRID_Z} on the FFMA route")
        _cuda.launch("p2p_mdct2_f32", x_pad.device, x_pad.data_ptr(),
                     basis.data_ptr(), out.data_ptr(), B, L, T, win, hop,
                     n_fft)
    mdct2.launches += 1
    return out


mdct2.launches = 0
mdct2.launches_tc = 0


def imdct2(spec: torch.Tensor, basis: torch.Tensor, hop: int,
           planes: Optional[Planes] = None) -> torch.Tensor:
    """Inverse basis product with the overlap-add fused in.
    spec [B, T, n_fft] f32, basis [n_fft, win] f32 ->
    [B, (T-1)*hop + win] f32, un-cropped. Any hop <= win. `planes`:
    `imdct2_planes(basis, hop)`, used on the tensor-core route (derived here
    when None)."""
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
    if tc_route(win, hop, n_fft):
        if planes is None:
            planes = imdct2_planes(basis, hop)
        _check_planes("imdct2", planes, (hop, win // hop * n_fft))
        _cuda.check_cuda("imdct2", spec, *planes)
        x = _aligned(spec)
        _cuda.launch("p2p_imdct2_tc", x.device, x.data_ptr(),
                     planes[0].data_ptr(), planes[1].data_ptr(),
                     out.data_ptr(), B, T, n_fft, win, hop)
        imdct2.launches_tc += 1
    else:
        _cuda.launch("p2p_imdct2_f32", spec.device, spec.data_ptr(),
                     basis.data_ptr(), out.data_ptr(), B, T, n_fft, win, hop)
    imdct2.launches += 1
    return out


imdct2.launches = 0
imdct2.launches_tc = 0
