"""MDCT2 / IMDCT2 lapped transforms (the DCT-II production codec).

Port of pix2pixhdaudiosr_tpu/ops/mdct.py:56-139 and `_fit_length`
(:177-191). The window multiply, the zero-pad to n_fft and the DCT are
folded into one precomputed float64 basis, cast to f32 on the codec's
device; the transforms themselves run on the kernels of `mdct_kernels`.
Where the codec takes the tensor-core route (`mdct_kernels.tc_route`), the
basis is also split once here into the kernel's K-major tf32 planes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import framing
from .dct import dct2_basis, dct3_basis
from .mdct_kernels import imdct2, imdct2_planes, mdct2, mdct2_planes, tc_route
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

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        x = framing.pad_signal(signal.float(), self.hop_length, self.center,
                               self.pad_mode)
        lead, L = x.shape[:-1], x.shape[-1]
        out = mdct2(x.reshape(-1, L).contiguous(), self.basis, self.hop_length,
                    self.planes)
        return out.reshape(lead + out.shape[-2:])


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

    def __call__(self, spec: torch.Tensor) -> torch.Tensor:
        if spec.shape[-1] != self.n_fft:
            raise ValueError(f"spectrogram has {spec.shape[-1]} bins, the "
                             f"codec {self.n_fft}")
        lead, T = spec.shape[:-2], spec.shape[-2]
        out = imdct2(spec.float().reshape(-1, T, self.n_fft).contiguous(),
                     self.basis, self.hop_length, self.planes)
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
