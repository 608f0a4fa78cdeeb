"""Analysis/synthesis windows, float64 numpy.

Copied from pix2pixhdaudiosr_tpu/ops/window.py (that package's `ops` imports
jax). `kbdwin` is the MATLAB-style Kaiser-Bessel-derived window of the
reference: the square root of the normalized cumulative sum of a Kaiser
window of length N/2+1 with beta = 12*pi, mirrored.
"""

from __future__ import annotations

import numpy as np


def kaiser(M: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window, matching torch.kaiser_window(periodic=False)."""
    if M == 1:
        return np.ones(1, dtype=np.float64)
    n = np.arange(M, dtype=np.float64)
    alpha = (M - 1) / 2.0
    return np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - ((n - alpha) / alpha) ** 2))) / np.i0(beta)


def kbdwin(N: int, beta: float = 12.0, dtype=np.float64) -> np.ndarray:
    """Kaiser-Bessel-derived window of even length N."""
    assert N % 2 == 0, "N must be even"
    w = kaiser(N // 2 + 1, beta * np.pi)
    half = np.sqrt(np.cumsum(w) / np.sum(w))[:-1]
    return np.concatenate([half, half[::-1]]).astype(dtype)


def resolve_window(window, win_length: int, dtype=np.float64) -> np.ndarray:
    """None -> ones; callable -> window(win_length); array -> as-is."""
    if window is None:
        return np.ones(win_length, dtype=dtype)
    if callable(window):
        return np.asarray(window(win_length), dtype=dtype)
    w = np.asarray(window, dtype=dtype)
    assert w.shape == (win_length,), (w.shape, win_length)
    return w
