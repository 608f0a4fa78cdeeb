"""The DCT family: float64 numpy bases and f32 basis products.

Copied from pix2pixhdaudiosr_tpu/ops/dct.py (that package's `ops` imports
jax): the bases (:37-89), the transforms (:95-136) as f32 torch.matmul
against one device-cached basis tensor per (basis, N, device), and the
rfft alternates (:142-156) on torch.fft. Scalings are the reference's:
  * dct_2n(x)  == (1/N) unnormalized DCT-II == scipy.fft.dct(x, 2) / N
  * idct_2n(x) == unnormalized DCT-III == scipy.fft.dct(x, 3), so
                  idct_2n(dct_2n(x)) == 2 x
  * dct_n(x)   == (1/(2N)) unnormalized DCT-II
  * dct2d / idct2d: the same separable over the last two axes.
These are plain matrix products and FFTs, which the JAX package leaves to
XLA outside any Pallas kernel: the caller runs them outside autocast, or
they would round to bf16. The lapped codecs built on these bases
(ops/mdct.py) run on the kernels of ops/mdct_kernels.py instead.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Bases (host, float64)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def dct2_basis(N: int) -> np.ndarray:
    """B[n, k] = 2 cos(pi (2n+1) k / (2N)); x @ B == unnormalized DCT-II."""
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(N, dtype=np.float64)[None, :]
    return 2.0 * np.cos(np.pi * (2 * n + 1) * k / (2 * N))


@functools.lru_cache(maxsize=32)
def dct3_basis(N: int) -> np.ndarray:
    """B[k, n] = (2 - delta_k0) cos(pi (2n+1) k / (2N)); x @ B == unnormalized
    DCT-III."""
    k = np.arange(N, dtype=np.float64)[:, None]
    n = np.arange(N, dtype=np.float64)[None, :]
    b = 2.0 * np.cos(np.pi * (2 * n + 1) * k / (2 * N))
    b[0, :] = 1.0
    return b


@functools.lru_cache(maxsize=32)
def dct4_basis(N: int) -> np.ndarray:
    """B[n, k] = 2 cos(pi (2n+1) (2k+1) / (4N)); orthogonal up to scale."""
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(N, dtype=np.float64)[None, :]
    return 2.0 * np.cos(np.pi * (2 * n + 1) * (2 * k + 1) / (4 * N))


@functools.lru_cache(maxsize=32)
def mdct4_basis(N: int) -> np.ndarray:
    """(N, N/2) forward basis of the reference's exact MATLAB-style MDCT4:
    pre-twiddle exp(-j pi n / N), N-point DFT, post-twiddle
    exp(-j (pi/2N + pi/4)(2k+1)), real part."""
    n = np.arange(N, dtype=np.float64)
    k = np.arange(N // 2, dtype=np.float64)
    exp1 = np.exp(-1j * np.pi / N * n)
    exp2 = np.exp(-1j * (np.pi / (2 * N) + np.pi / 4) * (2 * k + 1))
    dft = np.exp(-2j * np.pi * np.outer(n, k) / N)
    return np.real(exp1[:, None] * dft * exp2[None, :])


@functools.lru_cache(maxsize=32)
def imdct4_basis(N: int) -> np.ndarray:
    """(N/2, N) inverse basis of the reference IMDCT4 core, *excluding* the
    4/N overlap-add scale."""
    k = np.arange(N // 2, dtype=np.float64)
    n = np.arange(N, dtype=np.float64)
    exp1 = np.exp(-1j * (np.pi / (2 * N) + np.pi / 4) * (2 * k + 1))
    exp2 = np.exp(-1j * np.pi / N * n)
    dft = np.exp(-2j * np.pi * np.outer(k, n) / N)
    return np.real(exp1[:, None] * dft * exp2[None, :])


# ---------------------------------------------------------------------------
# Functional transforms (f32 basis products)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def basis_tensor(basis_fn: Callable[[int], np.ndarray], N: int, device: str,
                 div: int = 1) -> torch.Tensor:
    """basis_fn(N) / div, rounded once to f32 on `device` (the JAX package's
    jnp.asarray(basis / div, f32)), cached per (basis, N, device, div)."""
    return torch.tensor(basis_fn(N) / div, dtype=torch.float32, device=device)


def apply_basis(x: torch.Tensor, basis_fn: Callable[[int], np.ndarray],
                div: int = 1) -> torch.Tensor:
    """x @ (basis_fn(N) / div) over the last axis, N = x.shape[-1], in f32."""
    return x @ basis_tensor(basis_fn, x.shape[-1], str(x.device), div)


def _last_then_first(x: torch.Tensor, last_fn, first_fn) -> torch.Tensor:
    """last_fn over the last axis, then first_fn over the one before it."""
    return first_fn(last_fn(x).transpose(-1, -2)).transpose(-1, -2)


def dct_2n(x: torch.Tensor) -> torch.Tensor:
    """(1/N) unnormalized DCT-II over the last axis (DCT_2N_native)."""
    return apply_basis(x, dct2_basis, x.shape[-1])


def idct_2n(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized DCT-III over the last axis, in f32: x @ dct3_basis(N).
    idct_2n(dct_2n(x)) == 2 x (the reference's IDCT_2N_native)."""
    return apply_basis(x, dct3_basis)


def dct_n(x: torch.Tensor) -> torch.Tensor:
    """(1/(2N)) unnormalized DCT-II over the last axis (the native
    extension's 'N' algorithm)."""
    return apply_basis(x, dct2_basis, 2 * x.shape[-1])


def dct2d(x: torch.Tensor) -> torch.Tensor:
    """dct_n over the last axis, then over the one before it."""
    return _last_then_first(x, dct_n, dct_n)


def idct2d(x: torch.Tensor) -> torch.Tensor:
    """The 2-D inverse: idct_2n over the last axis, then the one before."""
    return _last_then_first(x, idct_2n, idct_2n)


# rfft-based alternates (the reference's own algorithm; a cross-check path)
def dct_2n_rfft(x: torch.Tensor) -> torch.Tensor:
    """dct_2n through a 2N-point rfft and a twiddle."""
    N = x.shape[-1]
    xp = torch.cat([x, torch.zeros_like(x)], dim=-1)
    y = torch.fft.rfft(xp, dim=-1)[..., :N] / N
    tw = math.pi * torch.arange(N, dtype=x.dtype, device=x.device) / (2 * N)
    return 2.0 * (y.real * torch.cos(tw) + y.imag * torch.sin(tw))


def idct_2n_rfft(x: torch.Tensor) -> torch.Tensor:
    """idct_2n through a twiddle and a 2N-point irfft."""
    N = x.shape[-1]
    tw = math.pi * torch.arange(N, dtype=x.dtype, device=x.device) / (2 * N)
    c = 2.0 * x * (torch.cos(tw) + 1j * torch.sin(tw))
    cp = torch.cat([c, c.new_zeros(c.shape[:-1] + (1,))], dim=-1)
    return torch.fft.irfft(cp, n=2 * N, dim=-1)[..., :N] * N
