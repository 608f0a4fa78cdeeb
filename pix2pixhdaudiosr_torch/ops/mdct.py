"""MDCT2 / IMDCT2 lapped transforms (the DCT-II production codec).

Port of pix2pixhdaudiosr_tpu/ops/mdct.py:56-139 and `_fit_length`
(:177-191). The window multiply, the zero-pad to n_fft and the DCT are
folded into one precomputed float64 basis, cast to f32 on the codec's
device; the transforms themselves run on the kernels of `mdct_kernels`.
Where the codec takes the tensor-core route (`mdct_kernels.tc_route`), the
basis is also split once here into the kernel's K-major tf32 planes.
IMDCT2 is differentiable (`IMDCT2Fn`): its backward is B1's kernel on the
transposed inverse basis, whose planes it also builds once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import framing
from .dct import dct2_basis, dct3_basis
from .mdct_kernels import (imdct2, imdct2_grad, imdct2_planes, mdct2,
                           mdct2_planes, tc_route)
from .window import resolve_window


class _LappedBase:
    def __init__(self, n_fft: int, hop_length: int, win_length: Optional[int],
                 window, center: bool, pad_mode: str):
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        self.center = bool(center)
        self.pad_mode = pad_mode
        w = resolve_window(window, int(win_length) if win_length else self.n_fft)
        self.win_length = len(w)
        self.window = w  # float64 numpy
        if not 0 < self.hop_length <= self.win_length <= self.n_fft:
            raise ValueError(f"need 0 < hop_length <= win_length <= n_fft, got "
                             f"{self.hop_length}, {self.win_length}, {self.n_fft}")
        self.tc = tc_route(self.win_length, self.hop_length, self.n_fft)


class MDCT2(_LappedBase):
    """Forward DCT-II lapped transform: [..., S] -> [..., T, n_fft]."""

    def __init__(self, n_fft=2048, hop_length=None, win_length=None,
                 window=None, center=True, pad_mode="constant",
                 device="cuda"):
        super().__init__(n_fft, hop_length, win_length, window, center, pad_mode)
        basis = dct2_basis(self.n_fft)[: self.win_length, :] / self.n_fft
        self.basis = torch.tensor(self.window[:, None] * basis,
                                  dtype=torch.float32, device=device)
        self.planes = mdct2_planes(self.basis) if self.tc else None
        self.window_t = torch.tensor(self.window, dtype=torch.float32,
                                     device=device)

    def __call__(self, signal: torch.Tensor, return_ola: bool = False):
        """[..., S] -> [..., T, n_fft]; with `return_ola` also the windowed
        frames [..., T, win] of the padded signal (the time-domain
        discriminator's input), framed and windowed in plain torch beside
        B1, which has no frames output (nor has the TPU kernel)."""
        x = framing.pad_signal(signal.float(), self.hop_length, self.center,
                               self.pad_mode)
        lead, L = x.shape[:-1], x.shape[-1]
        out = mdct2(x.reshape(-1, L).contiguous(), self.basis, self.hop_length,
                    self.planes)
        out = out.reshape(lead + out.shape[-2:])
        if not return_ola:
            return out
        frames = framing.frame(x, self.win_length, self.hop_length)
        return out, frames * self.window_t


class IMDCT2(_LappedBase):
    """Inverse of MDCT2: IDCT/2 -> truncate -> window -> overlap-add ->
    center-crop -> out_length fit. [..., T, n_fft] -> [..., S]."""

    def __init__(self, n_fft=2048, hop_length=None, win_length=None,
                 window=None, center=True, pad_mode="constant",
                 out_length=None, device="cuda"):
        super().__init__(n_fft, hop_length, win_length, window, center, pad_mode)
        self.out_length = out_length
        basis = dct3_basis(self.n_fft)[:, : self.win_length] \
            * self.window[None, :] / 2.0
        self.basis = torch.tensor(basis, dtype=torch.float32, device=device)
        self.planes = (imdct2_planes(self.basis, self.hop_length) if self.tc
                       else None)
        # the backward's operand: B1's [win, n_fft] basis and its planes
        self.basis_t = self.basis.t().contiguous()
        self.planes_t = mdct2_planes(self.basis_t) if self.tc else None

    def __call__(self, spec: torch.Tensor) -> torch.Tensor:
        """[..., T, n_fft] -> [..., S], differentiable w.r.t. spec: the
        product and overlap-add through IMDCT2Fn, the center crop and the
        length fit as torch slicing and padding, whose gradients autograd
        pads back."""
        if spec.shape[-1] != self.n_fft:
            raise ValueError(f"spectrogram has {spec.shape[-1]} bins, the "
                             f"codec {self.n_fft}")
        lead, T = spec.shape[:-2], spec.shape[-2]
        out = IMDCT2Fn.apply(spec.float().reshape(-1, T, self.n_fft).contiguous(),
                             self)
        out = out.reshape(lead + out.shape[-1:])
        if self.center:
            out = framing.center_crop(out, self.win_length)
        return _fit_length(out, self.out_length)


def _fit_length(out: torch.Tensor, out_length) -> torch.Tensor:
    """Trim OR zero-pad the reconstruction to out_length (non-dividing codecs
    come up to hop-1 samples short; padding keeps chunked decode segments on
    their exact time base)."""
    if out_length is None:
        return out
    short = out_length - out.shape[-1]
    if short > 0:
        return F.pad(out, (0, short))
    return out[..., :out_length]


class IMDCT2Fn(torch.autograd.Function):
    """`imdct2` (B2) with a gradient: out[b, t*hop + i] = sum_f spec[b, t, f]
    basis[f, i], so d spec[b, t] = frame(dy[b], win, hop)[t] @ basis^T,
    which is B1's computation: `imdct2_grad` (B1's kernel on the codec's
    `basis_t` and `planes_t`; on the CPU B1's twin). dy is the un-cropped
    [B, (T-1)*hop + win] gradient; L = (T-1)*hop + win is a multiple of 4
    wherever win and hop are (the tensor-core route's condition)."""

    @staticmethod
    def forward(ctx, spec: torch.Tensor, codec: "IMDCT2") -> torch.Tensor:
        ctx.codec = codec
        return imdct2(spec, codec.basis, codec.hop_length, codec.planes)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        c = ctx.codec
        return imdct2_grad(dy.float().contiguous(), c.basis_t, c.hop_length,
                           c.planes_t), None
