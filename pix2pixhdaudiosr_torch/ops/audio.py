"""Audio utilities: dB conversion, STFT power spectrogram, the polyphase
sinc resampler (host and device), and the LSD metric's window.

Port of pix2pixhdaudiosr_tpu/ops/audio.py. `resample_np` and its kernel
bank are numpy, copied (that package's `ops` imports jax); `resample`
(:106-123) frames the padded signal at stride p against the [q, K] bank
in one f32 product, a plain product as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .window import kbdwin


def amplitude_to_db(x: torch.Tensor, multiplier: float = 20.0,
                    amin: float = 1e-7, db_multiplier: float = 1.0) -> torch.Tensor:
    """torchaudio.functional.amplitude_to_DB with top_db=None:
    multiplier * log10(max(x, amin)) - multiplier * db_multiplier."""
    return multiplier * torch.log10(torch.clamp(x, min=amin)) - multiplier * db_multiplier


def db_to_amplitude(x: torch.Tensor, ref: float = 10.0, power: float = 0.5) -> torch.Tensor:
    """torchaudio.functional.DB_to_amplitude: ref * (10^(0.1 x))^power."""
    return ref * torch.pow(10.0, 0.1 * x * power)


def spectrogram_power(x: torch.Tensor, n_fft: int, hop_length: int,
                      win_length: int, window: np.ndarray,
                      center: bool = True) -> torch.Tensor:
    """|STFT|^2 matching torchaudio.functional.spectrogram(power=2,
    normalized=False, pad=0), as the LSD metric uses it.
    [..., L] -> [..., n_fft//2 + 1, T]."""
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(lead + (-1,))
    if win_length < n_fft:  # torch.stft zero-pads the window symmetrically
        left = (n_fft - win_length) // 2
        window = np.pad(window, (left, n_fft - win_length - left))
    frames = x.unfold(-1, n_fft, hop_length) * torch.as_tensor(
        window, dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return power.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Polyphase sinc resampling (torchaudio sinc_interp_hann parity), numpy
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = 6,
                         rolloff: float = 0.99) -> Tuple[np.ndarray, int, int, int]:
    """torchaudio-style polyphase kernel bank: (kernels[q, width*2 + p],
    width, p, q) with p = reduced orig, q = reduced new."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    p, q = int(orig_freq) // gcd, int(new_freq) // gcd
    base_freq = min(p, q) * rolloff
    width = int(math.ceil(lowpass_filter_width * p / base_freq))
    idx = np.arange(-width, width + p, dtype=np.float64)[None, :] / p
    t = (-np.arange(q, dtype=np.float64)[:, None] / q + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    tpi = t * np.pi
    kernels = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernels = kernels * win * (base_freq / p)
    return kernels.astype(np.float64), width, p, q


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int,
                lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """Host (numpy) polyphase resample, torchaudio parity. x: [..., L]."""
    if orig_freq == new_freq:
        return x
    kernels, width, p, q = sinc_resample_kernel(orig_freq, new_freq,
                                                lowpass_filter_width, rolloff)
    L = x.shape[-1]
    target_len = int(math.ceil(L * q / p))
    xp = np.pad(np.asarray(x, np.float64),
                [(0, 0)] * (x.ndim - 1) + [(width, width + p)])
    n_frames = (xp.shape[-1] - kernels.shape[1]) // p + 1
    idx = p * np.arange(n_frames)[:, None] + np.arange(kernels.shape[1])[None, :]
    frames = xp[..., idx]                              # [..., n_frames, K]
    out = np.einsum("...fk,qk->...fq", frames, kernels)  # [..., n_frames, q]
    out = out.reshape(x.shape[:-1] + (n_frames * q,))[..., :target_len]
    return out.astype(x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32)


@functools.lru_cache(maxsize=16)
def _bank_tensor(orig_freq: int, new_freq: int, lowpass_filter_width: int,
                 rolloff: float, device: str) -> torch.Tensor:
    """The kernel bank's transpose [K, q] in f32 on `device`, cached."""
    kernels = sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width,
                                   rolloff)[0]
    return torch.tensor(kernels.T, dtype=torch.float32, device=device)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Device polyphase resample, torchaudio parity: [..., L] f32 ->
    [..., ceil(L q / p)], the frames of the padded signal at stride p
    (`unfold`) times the [q, K] kernel bank, output sample j q + i the
    dot of frame j with kernel i."""
    if orig_freq == new_freq:
        return x
    _, width, p, q = sinc_resample_kernel(orig_freq, new_freq,
                                          lowpass_filter_width, rolloff)
    bank = _bank_tensor(int(orig_freq), int(new_freq), lowpass_filter_width,
                        rolloff, str(x.device))
    target_len = int(math.ceil(x.shape[-1] * q / p))
    frames = F.pad(x, (width, width + p)).unfold(-1, bank.shape[0], p)
    out = frames @ bank                                # [..., n_frames, q]
    return out.reshape(x.shape[:-1] + (-1,))[..., :target_len]


def lsd_window(win_length: int) -> np.ndarray:
    """The kbd window the LSD metric uses."""
    return kbdwin(win_length)
