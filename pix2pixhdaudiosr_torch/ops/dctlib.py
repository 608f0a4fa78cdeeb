"""The DREAMPlace-parity transform family: DST, IDST, IDXCT, IDXST, their
2-D combinations, and the Lee-1984 butterfly DCT.

Port of pix2pixhdaudiosr_tpu/ops/dctlib.py. The float64 bases are copied
(:44-77) and applied as f32 basis products (ops/dct.apply_basis, one
device-cached tensor per basis, N and device); the 2-D combinations
(:101-132) are last-axis-then-first-axis compositions; `dct_lee` /
`idct_lee` run the Lee butterfly recursion (:138-198) as the JAX code does,
with `torch.flip` where it reverses an axis. Conventions:
  dst(x)[k]    = -2 sum_n x_n sin(pi (2n+1)(k+1) / (2N))  (-scipy's DST-II)
  idxst(x)[u]  =  sum_i x_i sin(pi i (2u+1) / (2N))
  idxct(x)[u]  =  sum_i x_i cos(pi i (2u+1) / (2N))
  idst(x)      =  the reference's own irfft construction
  dct_lee(x)   =  scipy.fft.dct(x, 2) / 2, power-of-2 N only.
Plain products and element-wise stages, which the JAX package leaves to
XLA: the caller runs them outside autocast.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dct import (_last_then_first, apply_basis, dct2_basis,  # noqa: F401
                  dct3_basis, dct_2n, dct_n, idct_2n)


# ---------------------------------------------------------------------------
# 1D bases (host, float64)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def dst_basis(N: int) -> np.ndarray:
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(N, dtype=np.float64)[None, :]
    return -2.0 * np.sin(np.pi * (2 * n + 1) * (k + 1) / (2 * N))


@functools.lru_cache(maxsize=32)
def idst_basis(N: int) -> np.ndarray:
    u = np.arange(N, dtype=np.float64)[None, :]
    b = np.zeros((N, N))
    b[0, :] = np.cos(np.pi / (2 * N))
    for k in range(1, N):
        b[k, :] = 2.0 * np.cos(np.pi * ((k + 1) + 2 * k * (u + 1)) / (2 * N))
    return b


@functools.lru_cache(maxsize=32)
def idxct_basis(N: int) -> np.ndarray:
    i = np.arange(N, dtype=np.float64)[:, None]
    u = np.arange(N, dtype=np.float64)[None, :]
    return np.cos(np.pi * i * (2 * u + 1) / (2 * N))


@functools.lru_cache(maxsize=32)
def idxst_basis(N: int) -> np.ndarray:
    i = np.arange(N, dtype=np.float64)[:, None]
    u = np.arange(N, dtype=np.float64)[None, :]
    return np.sin(np.pi * i * (2 * u + 1) / (2 * N))


def dst(x: torch.Tensor) -> torch.Tensor:
    return apply_basis(x, dst_basis)


def idst(x: torch.Tensor) -> torch.Tensor:
    return apply_basis(x, idst_basis)


def idxct(x: torch.Tensor) -> torch.Tensor:
    return apply_basis(x, idxct_basis)


def idxst(x: torch.Tensor) -> torch.Tensor:
    return apply_basis(x, idxst_basis)


def idct_n(x: torch.Tensor) -> torch.Tensor:
    """The reference's idct_N: the unnormalized DCT-III, as idct_2n."""
    return idct_2n(x)


# ---------------------------------------------------------------------------
# 2D combinations (last axis first, then the one before it)
# ---------------------------------------------------------------------------
def dst2(x: torch.Tensor) -> torch.Tensor:
    return _last_then_first(x, dst, dst)


def idcct2(x: torch.Tensor) -> torch.Tensor:
    return _last_then_first(x, idxct, idxct)


def idsct2(x: torch.Tensor) -> torch.Tensor:
    return _last_then_first(x, idxct, idxst)


def idcst2(x: torch.Tensor) -> torch.Tensor:
    return _last_then_first(x, idxst, idxct)


def idxst_idct(x: torch.Tensor) -> torch.Tensor:
    return _last_then_first(x, idct_n, idxst)


def idct_idxst(x: torch.Tensor) -> torch.Tensor:
    return _last_then_first(x, idxst, idct_n)


# ---------------------------------------------------------------------------
# Lee-1984 butterfly DCT (power-of-2 N)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def _lee_cos_tables(N: int):
    """Per-level 0.5/cos((2n+1) pi / (2 len)) tables, float64."""
    tables = {}
    size = N
    while size >= 2:
        n = np.arange(size // 2, dtype=np.float64)
        tables[size] = (0.5 / np.cos((2 * n + 1) * np.pi / (2 * size))).astype(np.float64)
        size //= 2
    return tables


@functools.lru_cache(maxsize=64)
def _lee_table(size: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """Level `size` of the tables (the same at every N), cast once to
    dtype on device."""
    return torch.tensor(_lee_cos_tables(size)[size], dtype=dtype, device=device)


def _lee_fwd(x: torch.Tensor, N: int) -> torch.Tensor:
    """T_N(x)[k] = sum_n x[n] cos(pi (2n+1) k / (2N)), recursive."""
    if N == 1:
        return x
    half = N // 2
    head, tail = x[..., :half], x[..., half:].flip(-1)
    g = head + tail
    h = (head - tail) * _lee_table(N, x.dtype, str(x.device))
    tg = _lee_fwd(g, half)
    th = _lee_fwd(h, half)
    # odd outputs: b[k] + b[k+1] (b[half] := 0)
    th_shift = torch.cat([th[..., 1:], torch.zeros_like(th[..., :1])], dim=-1)
    out = torch.stack([tg, th + th_shift], dim=-1)  # interleave even / odd
    return out.reshape(x.shape[:-1] + (N,))


def _lee_inv(y: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of _lee_fwd: recovers x with T_N(x) = y."""
    if N == 1:
        return y
    half = N // 2
    interleaved = y.reshape(y.shape[:-1] + (half, 2))
    e, o = interleaved[..., 0], interleaved[..., 1]
    # undo the odd chain odd[k] = b[k] + b[k+1] (b[half] = 0):
    # b[k] = o[k] - o[k+1] + o[k+2] - ..., an alternating-sign suffix sum
    sign = torch.tensor((-1.0) ** np.arange(half), dtype=y.dtype,
                        device=y.device)
    b = sign * torch.cumsum((o * sign).flip(-1), dim=-1).flip(-1)
    g = _lee_inv(e, half)
    h = _lee_inv(b, half) / _lee_table(N, y.dtype, str(y.device))
    return torch.cat([g + h, (g - h).flip(-1)], dim=-1) * 0.5


def _check_pow2(N: int) -> None:
    if N < 1 or N & (N - 1):
        raise ValueError(f"the Lee butterflies need a power-of-2 length, got {N}")


def dct_lee(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized DCT-II via Lee butterflies: scipy.fft.dct(x, 2) / 2."""
    N = x.shape[-1]
    _check_pow2(N)
    return _lee_fwd(x, N)


def idct_lee(y: torch.Tensor) -> torch.Tensor:
    """Inverse of dct_lee: idct_lee(dct_lee(x)) == x."""
    N = y.shape[-1]
    _check_pow2(N)
    return _lee_inv(y, N)
