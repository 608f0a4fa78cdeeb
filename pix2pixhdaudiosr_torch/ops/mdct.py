"""MDCT / IMDCT lapped transforms: the DCT-II production codec (MDCT2,
IMDCT2) and the exact MATLAB-style DCT-IV MDCT (MDCT4, IMDCT4).

Port of pix2pixhdaudiosr_tpu/ops/mdct.py: MDCT2 / IMDCT2 (:56-139),
MDCT4 / IMDCT4 (:142-174), `_fit_length` (:177-191) and the float64 numpy
oracles `mdct4_np` / `imdct4_np` (:198-222), copied. The window multiply,
the zero-pad to n_fft and the DCT are folded into one precomputed float64
basis, cast to f32 on the codec's device; the transforms themselves run on
the kernels of `mdct_kernels` (B1 forward, B2 inverse), whose products are
generic in the basis' width: MDCT4's basis is [win, n_fft/2] and IMDCT4's
[n_fft/2, win]. Where a codec takes the tensor-core route
(`mdct_kernels.tc_route`), its basis is also split once here into the
kernel's K-major tf32 planes. IMDCT2 is differentiable (`IMDCT2Fn`): its
backward is B1's kernel on the transposed inverse basis, whose planes it
also builds once; the JAX package never differentiates MDCT4 / IMDCT4.
MDCT2 / IMDCT2 keep the reference's pluggable `dct_op` / `idct_op`: a given
callable replaces the basis product (then a plain torch path).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import framing
from .dct import dct2_basis, dct3_basis, imdct4_basis, mdct4_basis
from .mdct_kernels import (imdct2, imdct2_grad, imdct2_planes, mdct2,
                           mdct2_planes, tc_route)
from .window import resolve_window


class _LappedBase:
    def __init__(self, n_fft: int, hop_length: int, win_length: Optional[int],
                 window, center: bool, pad_mode: str, cols: Optional[int] = None):
        """`cols`: the spectrum's width, n_fft unless given (MDCT4's
        n_fft/2), which with win and hop decides the kernels' route."""
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
        self.tc = tc_route(self.win_length, self.hop_length,
                           self.n_fft if cols is None else cols)

    def _forward(self, signal: torch.Tensor):
        """Pad `signal` [..., S] as the reference does and run B1 on it:
        ([..., T, cols] f32, the padded signal)."""
        x = framing.pad_signal(signal.float(), self.hop_length, self.center,
                               self.pad_mode)
        lead, L = x.shape[:-1], x.shape[-1]
        out = mdct2(x.reshape(-1, L).contiguous(), self.basis, self.hop_length,
                    self.planes)
        return out.reshape(lead + out.shape[-2:]), x

    def _crop_fit(self, out: torch.Tensor, out_length) -> torch.Tensor:
        if self.center:
            out = framing.center_crop(out, self.win_length)
        return _fit_length(out, out_length)


class MDCT2(_LappedBase):
    """Forward DCT-II lapped transform: [..., S] -> [..., T, n_fft]."""

    def __init__(self, n_fft=2048, hop_length=None, win_length=None,
                 window=None, center=True, pad_mode="constant", dct_op=None,
                 device="cuda"):
        super().__init__(n_fft, hop_length, win_length, window, center, pad_mode)
        self.window_t = torch.tensor(self.window, dtype=torch.float32,
                                     device=device)
        # the reference's pluggable DCT: dct_op takes the windowed frames
        # zero-padded to n_fft and replaces the basis product
        self.dct_op = dct_op
        if dct_op is not None:
            self.basis = self.planes = None
            return
        basis = dct2_basis(self.n_fft)[: self.win_length, :] / self.n_fft
        self.basis = torch.tensor(self.window[:, None] * basis,
                                  dtype=torch.float32, device=device)
        self.planes = mdct2_planes(self.basis) if self.tc else None

    def __call__(self, signal: torch.Tensor, return_ola: bool = False):
        """[..., S] -> [..., T, n_fft]; with `return_ola` also the windowed
        frames [..., T, win] of the padded signal (the time-domain
        discriminator's input), framed and windowed in plain torch beside
        B1, which has no frames output (nor has the TPU kernel)."""
        if self.dct_op is not None:
            x = framing.pad_signal(signal.float(), self.hop_length,
                                   self.center, self.pad_mode)
            wframes = framing.frame(x, self.win_length, self.hop_length) \
                * self.window_t
            out = self.dct_op(F.pad(wframes, (0, self.n_fft - self.win_length)))
            return (out, wframes) if return_ola else out
        out, x = self._forward(signal)
        if not return_ola:
            return out
        frames = framing.frame(x, self.win_length, self.hop_length)
        return out, frames * self.window_t


class IMDCT2(_LappedBase):
    """Inverse of MDCT2: IDCT/2 -> truncate -> window -> overlap-add ->
    center-crop -> out_length fit. [..., T, n_fft] -> [..., S]."""

    def __init__(self, n_fft=2048, hop_length=None, win_length=None,
                 window=None, center=True, pad_mode="constant",
                 out_length=None, idct_op=None, device="cuda"):
        super().__init__(n_fft, hop_length, win_length, window, center, pad_mode)
        self.out_length = out_length
        # the reference's pluggable IDCT: idct_op takes the spectrum and
        # replaces the basis product; the /2, truncation and window follow
        self.idct_op = idct_op
        if idct_op is not None:
            self.window_t = torch.tensor(self.window, dtype=torch.float32,
                                         device=device)
            self.basis = self.planes = self.basis_t = self.planes_t = None
            return
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
        if self.idct_op is not None:
            y = self.idct_op(spec.float()) / 2.0
            y = y[..., : self.win_length] * self.window_t
            return self._crop_fit(framing.overlap_add(y, self.hop_length),
                                  self.out_length)
        lead, T = spec.shape[:-2], spec.shape[-2]
        out = IMDCT2Fn.apply(spec.float().reshape(-1, T, self.n_fft).contiguous(),
                             self)
        return self._crop_fit(out.reshape(lead + out.shape[-1:]),
                              self.out_length)


class MDCT4(_LappedBase):
    """Exact MATLAB-style MDCT: [..., S] -> [..., T, n_fft//2], f32, on B1
    with the [win, n_fft/2] basis window * mdct4_basis(n_fft)[:win]."""

    def __init__(self, n_fft=2048, hop_length=None, win_length=None,
                 window=None, center=True, pad_mode="constant", device="cuda"):
        super().__init__(n_fft, hop_length, win_length, window, center,
                         pad_mode, cols=int(n_fft) // 2)
        basis = self.window[:, None] * mdct4_basis(self.n_fft)[: self.win_length, :]
        self.basis = torch.tensor(basis, dtype=torch.float32, device=device)
        self.planes = mdct2_planes(self.basis) if self.tc else None

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        return self._forward(signal)[0]


class IMDCT4(_LappedBase):
    """Inverse exact MDCT, its 4/n_fft overlap-add scale folded into the
    [n_fft/2, win] basis, on B2; then the center crop and out_length fit.
    [..., T, n_fft//2] -> [..., S], f32."""

    def __init__(self, n_fft=2048, hop_length=None, win_length=None,
                 window=None, center=True, pad_mode="constant",
                 out_length=None, device="cuda"):
        super().__init__(n_fft, hop_length, win_length, window, center,
                         pad_mode, cols=int(n_fft) // 2)
        self.out_length = out_length
        basis = imdct4_basis(self.n_fft)[:, : self.win_length] \
            * self.window[None, :] * (4.0 / self.n_fft)
        self.basis = torch.tensor(basis, dtype=torch.float32, device=device)
        self.planes = (imdct2_planes(self.basis, self.hop_length) if self.tc
                       else None)

    def __call__(self, spec: torch.Tensor) -> torch.Tensor:
        if spec.shape[-1] != self.n_fft // 2:
            raise ValueError(f"spectrogram has {spec.shape[-1]} bins, the "
                             f"codec {self.n_fft // 2}")
        lead, T = spec.shape[:-2], spec.shape[-2]
        out = imdct2(spec.float().reshape(-1, T, self.n_fft // 2).contiguous(),
                     self.basis, self.hop_length, self.planes)
        return self._crop_fit(out.reshape(lead + out.shape[-1:]),
                              self.out_length)


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


# ---------------------------------------------------------------------------
# float64 host oracles (numpy) for the README round-trip parity test
# ---------------------------------------------------------------------------
def mdct4_np(signal: np.ndarray, n_fft: int, hop: int, window: np.ndarray,
             center: bool = True) -> np.ndarray:
    s = np.asarray(signal, np.float64)
    start = hop if center else 0
    extra = s.shape[-1] % hop
    end = start + (hop - extra if extra else 0)
    s = np.pad(s, [(0, 0)] * (s.ndim - 1) + [(start, end)])
    T = (s.shape[-1] - len(window)) // hop + 1
    idx = np.arange(len(window))[None, :] + hop * np.arange(T)[:, None]
    frames = s[..., idx] * window
    return frames @ mdct4_basis(n_fft)[: len(window), :]


def imdct4_np(spec: np.ndarray, n_fft: int, hop: int, window: np.ndarray,
              center: bool = True, out_length: Optional[int] = None) -> np.ndarray:
    y = np.asarray(spec, np.float64) @ imdct4_basis(n_fft)[:, : len(window)]
    y = y * window * (4.0 / n_fft)
    T, win = y.shape[-2], y.shape[-1]
    out = np.zeros(y.shape[:-2] + ((T - 1) * hop + win,))
    for t in range(T):
        out[..., t * hop : t * hop + win] += y[..., t, :]
    if center:
        out = out[..., win // 2 : -(win // 2)]
    if out_length is not None:
        out = out[..., :out_length]
    return out
