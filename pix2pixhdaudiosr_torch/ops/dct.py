"""DCT bases, float64 numpy.

Copied from pix2pixhdaudiosr_tpu/ops/dct.py:37-53 (that package's `ops`
imports jax). Scalings are the reference's: x @ dct2_basis(N) is the
unnormalized DCT-II, x @ dct3_basis(N) the unnormalized DCT-III, and
dct3(dct2(x) / N) == 2 x.
"""

from __future__ import annotations

import functools

import numpy as np


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
