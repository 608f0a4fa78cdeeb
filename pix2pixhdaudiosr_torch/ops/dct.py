"""DCT bases, float64 numpy.

Copied from pix2pixhdaudiosr_tpu/ops/dct.py:37-53 (that package's `ops`
imports jax), and `idct_2n` (:104-109) as one f32 torch.matmul. Scalings
are the reference's: x @ dct2_basis(N) is the unnormalized DCT-II,
x @ dct3_basis(N) the unnormalized DCT-III, and dct3(dct2(x) / N) == 2 x.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


@functools.lru_cache(maxsize=8)
def _dct3_tensor(N: int, device: str) -> torch.Tensor:
    return torch.tensor(dct3_basis(N), dtype=torch.float32, device=device)


def idct_2n(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized DCT-III over the last axis, in f32: x @ dct3_basis(N).
    idct_2n(dct_2n(x)) == 2 x (the reference's IDCT_2N_native). A plain
    matmul, as the JAX package leaves it to XLA: the caller runs it outside
    autocast, or it would round to bf16."""
    return x @ _dct3_tensor(x.shape[-1], str(x.device))
