"""The legacy orthonormal (nils-werner-style) MDCT family: the complex MCLT
(cmdct / icmdct), the orthonormal MDCT / MDST and their inverses, and the
centred lapped spectrograms with perfect reconstruction under a
Princen-Bradley window.

Port of pix2pixhdaudiosr_tpu/ops/legacy.py. The complex float64 bases
(:31-62) and `sine_window` (:142-146) are copied; the one-frame transforms
are f32 real basis products (two for the complex ones, in the JAX form
re + 1j im and re - im). The spectrograms (frames of 2N, hop N, N
columns) run on the codec kernels, B1 forward and B2 inverse
(ops/mdct_kernels.mdct2 / imdct2), with the window folded into the bases:
sqrt(2) Re B scaled by the window forward and sqrt(2) Re Bt times the
window inverse; then the centre crop and the out_length trim.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import framing
from .mdct_kernels import (imdct2, imdct2_planes, mdct2, mdct2_planes,
                           tc_route)
from .window import resolve_window


@functools.lru_cache(maxsize=16)
def _cmdct_basis(two_n: int) -> np.ndarray:
    """Complex basis of the oddly-stacked MCLT: cmdct(x) = x @ B, x in R^{2N},
    B in C^{2N x N}."""
    N = two_n // 2
    n = np.arange(two_n)
    k = np.arange(N)
    n0 = (N + 1) / 2
    pre = np.exp(-1j * np.pi * n / two_n)
    post = np.exp(-1j * np.pi * n0 * (k + 0.5) / N)
    dft = np.exp(-2j * np.pi * np.outer(n, k) / two_n)
    return (pre[:, None] * dft) * post[None, :] * np.sqrt(1 / N)


@functools.lru_cache(maxsize=16)
def _icmdct_basis(N: int) -> np.ndarray:
    """Complex-to-real inverse MCLT basis: icmdct(X) = Re(X @ B) for the
    odd stacking, built by pushing unit vectors through the exact ifft
    formulation."""
    two_n = 2 * N
    n0 = (N + 1) / 2
    n = np.arange(two_n)
    pre = np.exp(1j * np.pi * n0 * n / N)
    post = np.exp(1j * np.pi * (n + n0) / two_n)
    eye = np.eye(N)
    Y = np.zeros((N, two_n), complex)
    Y[:, :N] = eye
    Y[:, N:] = -np.conj(eye[:, ::-1])
    y = np.fft.ifft(Y * pre[None, :], axis=-1) * post[None, :]
    return y * np.sqrt(N)  # [N, 2N]: X @ B maps N coefficients -> 2N samples


# the real f32 planes of the bases, each a function of the transform's size
_PLANES = {
    "cmdct_re": lambda n: _cmdct_basis(n).real,
    "cmdct_im": lambda n: _cmdct_basis(n).imag,
    "mdct": lambda n: np.sqrt(2) * _cmdct_basis(n).real,
    "mdst": lambda n: -np.sqrt(2) * _cmdct_basis(n).imag,
    "icmdct_re": lambda n: _icmdct_basis(n).real,
    "icmdct_im": lambda n: _icmdct_basis(n).imag,
    "imdct": lambda n: np.sqrt(2) * _icmdct_basis(n).real,
    "imdst": lambda n: -np.sqrt(2) * _icmdct_basis(n).imag,
}


@functools.lru_cache(maxsize=32)
def _plane(kind: str, n: int, device: str) -> torch.Tensor:
    return torch.tensor(_PLANES[kind](n), dtype=torch.float32, device=device)


def _product(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x (cast to f32) @ the f32 plane `kind` of size x.shape[-1]."""
    return x.float() @ _plane(kind, x.shape[-1], str(x.device))


def cmdct(x: torch.Tensor) -> torch.Tensor:
    """Complex MCLT over the last axis ([..., 2N] -> [..., N] complex64)."""
    return _product(x, "cmdct_re") + 1j * _product(x, "cmdct_im")


def mdct_ortho(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal MDCT: sqrt(2) Re(cmdct)."""
    return _product(x, "mdct")


def mdst_ortho(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal MDST: -sqrt(2) Im(cmdct)."""
    return _product(x, "mdst")


def icmdct(X: torch.Tensor) -> torch.Tensor:
    """Inverse MCLT ([..., N] complex -> [..., 2N] real)."""
    im = X.imag if X.is_complex() else torch.zeros_like(X)
    return _product(X.real, "icmdct_re") - _product(im, "icmdct_im")


def imdct_ortho(X: torch.Tensor) -> torch.Tensor:
    """Inverse orthonormal MDCT."""
    return _product(X, "imdct")


def imdst_ortho(X: torch.Tensor) -> torch.Tensor:
    return _product(X, "imdst")


# ---------------------------------------------------------------------------
# Lapped spectrograms (50% overlap, centred so the first and last windows
# straddle the signal's ends) on B1 / B2
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _spectrogram_operands(inverse: bool, w_bytes: bytes, frame_length: int,
                          device: str):
    """(basis, planes) of one lapped spectrogram: forward [2N, N] =
    window * sqrt(2) Re B, inverse [N, 2N] = sqrt(2) Re Bt * window, with
    the kernel's tf32 planes where the tensor-core route takes it."""
    w = np.frombuffer(w_bytes, np.float64)
    n, hop = frame_length // 2, frame_length // 2
    if inverse:
        basis = _PLANES["imdct"](n) * w[None, :]
    else:
        basis = w[:, None] * _PLANES["mdct"](frame_length)
    basis = torch.tensor(basis, dtype=torch.float32, device=device)
    if not tc_route(frame_length, hop, n):
        return basis, None
    return basis, (imdct2_planes(basis, hop) if inverse
                   else mdct2_planes(basis))


def mdct_spectrogram(x: torch.Tensor, window, frame_length: int = 2048,
                     center: bool = True) -> torch.Tensor:
    """[..., S] -> [..., T, N] orthonormal lapped MDCT with 50% overlap
    (N = frame_length / 2), on B1."""
    w = resolve_window(window, frame_length)
    hop = frame_length // 2
    padded = framing.pad_signal(x.float(), hop, center)
    basis, planes = _spectrogram_operands(False, w.tobytes(), frame_length,
                                          str(x.device))
    lead, L = padded.shape[:-1], padded.shape[-1]
    out = mdct2(padded.reshape(-1, L).contiguous(), basis, hop, planes)
    return out.reshape(lead + out.shape[-2:])


def imdct_spectrogram(X: torch.Tensor, window, center: bool = True,
                      out_length: Optional[int] = None) -> torch.Tensor:
    """Inverse of mdct_spectrogram, on B2 (overlap-add; perfect
    reconstruction for Princen-Bradley windows such as sine or kbd)."""
    frame_length = 2 * X.shape[-1]
    w = resolve_window(window, frame_length)
    hop = frame_length // 2
    basis, planes = _spectrogram_operands(True, w.tobytes(), frame_length,
                                          str(X.device))
    lead, T = X.shape[:-2], X.shape[-2]
    out = imdct2(X.float().reshape(-1, T, hop).contiguous(), basis, hop,
                 planes)
    out = out.reshape(lead + out.shape[-1:])
    if center:
        out = framing.center_crop(out, frame_length)
    if out_length is not None:
        out = out[..., :out_length]
    return out


def sine_window(N: int) -> np.ndarray:
    """scipy.signal.cosine analog: the Princen-Bradley default the upstream
    nils-werner/mdct uses."""
    return np.sin(np.pi / N * (np.arange(N) + 0.5))
