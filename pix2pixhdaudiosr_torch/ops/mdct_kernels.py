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
`<wrapper>.launches_tc`. `imdct2_grad`, the gradient of `imdct2` for
autograd (ops/mdct.py), is a launch of B1's kernel on the transposed
inverse basis, counted on its own.

`mdct2` and `imdct2` are also the operators p2p::mdct2 and p2p::imdct2
(`_cuda.define_op`), which a traced wrapper calls; their FLOP formula,
2 B T win n_fft, is registered for FlopCounterMode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

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
    planes = planes or (None, None)
    if _cuda.tracing():
        return mdct2_op(x_pad, basis, hop, *planes)
    if x_pad.device.type == "cpu":
        return mdct2_ref(x_pad, basis, hop)
    return _mdct2_cuda(x_pad, basis, hop, *planes)


def _mdct2_cuda(x_pad: torch.Tensor, basis: torch.Tensor, hop: int,
                hi: Optional[torch.Tensor] = None,
                lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1's launch, counted (p2p::mdct2's CUDA impl)."""
    out, tc = _launch_mdct2("mdct2", x_pad, basis, hop,
                            None if hi is None else (hi, lo))
    mdct2.launches += 1
    mdct2.launches_tc += tc
    return out


def _launch_mdct2(name: str, x_pad: torch.Tensor, basis: torch.Tensor,
                  hop: int, planes: Optional[Planes]):
    """B1's launch, uncounted: (out, 1 on the tensor-core route else 0)."""
    _cuda.check_cuda(name, x_pad, basis)
    _check_f32_contiguous(name, x_pad=x_pad, basis=basis)
    if x_pad.dim() != 2 or basis.dim() != 2:
        raise ValueError(f"{name}: expected [B, L] and [win, n_fft], got "
                         f"{tuple(x_pad.shape)} and {tuple(basis.shape)}")
    B, L = x_pad.shape
    win, n_fft = basis.shape
    if not 0 < hop <= win <= L:
        raise ValueError(f"{name}: need 0 < hop <= win <= L, got hop={hop} "
                         f"win={win} L={L}")
    T = (L - win) // hop + 1
    out = torch.empty(B, T, n_fft, dtype=torch.float32, device=x_pad.device)
    if tc_route(win, hop, n_fft) and L % 4 == 0:
        if planes is None:
            planes = mdct2_planes(basis)
        _check_planes(name, planes, (n_fft, win))
        _cuda.check_cuda(name, x_pad, *planes)
        x = _aligned(x_pad)
        _cuda.launch("p2p_mdct2_tc", x.device, x.data_ptr(),
                     planes[0].data_ptr(), planes[1].data_ptr(),
                     out.data_ptr(), B, L, T, win, hop, n_fft)
        return out, 1
    if B > _MAX_GRID_Z:
        raise ValueError(f"{name}: B={B} > {_MAX_GRID_Z} on the FFMA route")
    _cuda.launch("p2p_mdct2_f32", x_pad.device, x_pad.data_ptr(),
                 basis.data_ptr(), out.data_ptr(), B, L, T, win, hop, n_fft)
    return out, 0


mdct2.launches = 0
mdct2.launches_tc = 0


def imdct2(spec: torch.Tensor, basis: torch.Tensor, hop: int,
           planes: Optional[Planes] = None) -> torch.Tensor:
    """Inverse basis product with the overlap-add fused in.
    spec [B, T, n_fft] f32, basis [n_fft, win] f32 ->
    [B, (T-1)*hop + win] f32, un-cropped. Any hop <= win. `planes`:
    `imdct2_planes(basis, hop)`, used on the tensor-core route (derived here
    when None)."""
    planes = planes or (None, None)
    if _cuda.tracing():
        return imdct2_op(spec, basis, hop, *planes)
    if spec.device.type == "cpu":
        return imdct2_ref(spec, basis, hop)
    return _imdct2_cuda(spec, basis, hop, *planes)


def _imdct2_cuda(spec: torch.Tensor, basis: torch.Tensor, hop: int,
                 hi: Optional[torch.Tensor] = None,
                 lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B2's launch, counted (p2p::imdct2's CUDA impl)."""
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
        planes = (hi, lo) if hi is not None else imdct2_planes(basis, hop)
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

_PLANES = "Tensor? hi=None, Tensor? lo=None"
mdct2_op = _cuda.define_op(
    f"mdct2(Tensor x_pad, Tensor basis, int hop, {_PLANES}) -> Tensor",
    _mdct2_cuda, lambda x_pad, basis, hop, hi=None, lo=None:
    mdct2_ref(x_pad, basis, hop),
    lambda x_pad, basis, hop, hi=None, lo=None: x_pad.new_empty(
        x_pad.shape[0], (x_pad.shape[1] - basis.shape[0]) // hop + 1,
        basis.shape[1]))
imdct2_op = _cuda.define_op(
    f"imdct2(Tensor spec, Tensor basis, int hop, {_PLANES}) -> Tensor",
    _imdct2_cuda, lambda spec, basis, hop, hi=None, lo=None:
    imdct2_ref(spec, basis, hop),
    lambda spec, basis, hop, hi=None, lo=None: spec.new_empty(
        spec.shape[0], (spec.shape[1] - 1) * hop + basis.shape[1]))


@register_flop_formula([mdct2_op, imdct2_op])
def _basis_product_flops(x_shape, basis_shape, hop, *args, out_shape=None,
                         **kwargs) -> int:
    """2 B T win n_fft: one multiply-add of each frame's window by each
    basis column (MDCT2: x [B, L], out [B, T, n_fft]; IMDCT2: spec
    [B, T, n_fft], basis [n_fft, win])."""
    if len(x_shape) == 3:        # imdct2
        return 2 * x_shape[0] * x_shape[1] * basis_shape[0] * basis_shape[1]
    return 2 * out_shape[0] * out_shape[1] * basis_shape[0] * basis_shape[1]


def imdct2_grad_ref(dy: torch.Tensor, basis_t: torch.Tensor,
                    hop: int) -> torch.Tensor:
    """Twin of `imdct2_grad`: B1's twin on the transposed inverse basis."""
    return mdct2_ref(dy, basis_t, hop)


def imdct2_grad(dy: torch.Tensor, basis_t: torch.Tensor, hop: int,
                planes_t: Optional[Planes] = None) -> torch.Tensor:
    """The gradient of `imdct2` w.r.t. its spectrum: d spec[t] =
    frame(dy)[t] @ basis^T, which is B1's computation, so B1's kernel runs
    it on the transposed inverse basis. dy [B, (T-1)*hop + win] f32 (the
    un-cropped output's gradient), basis_t = basis.t() [win, n_fft] f32 ->
    [B, T, n_fft] f32. `planes_t`: `mdct2_planes(basis_t)`. Counted in
    `imdct2_grad.launches` (and `.launches_tc`), not in mdct2's counts."""
    if dy.device.type == "cpu":
        return imdct2_grad_ref(dy, basis_t, hop)
    out, tc = _launch_mdct2("imdct2_grad", dy, basis_t, hop, planes_t)
    imdct2_grad.launches += 1
    imdct2_grad.launches_tc += tc
    return out


imdct2_grad.launches = 0
imdct2_grad.launches_tc = 0
