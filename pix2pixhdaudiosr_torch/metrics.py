"""Evaluation metrics: MSE, SNR, LSD and segmental SNR.

Port of pix2pixhdaudiosr_tpu/metrics.py:26-99: sr renormalized to the hr
mean/std, SNR in dB for sr and lr against hr, LSD from the log10 power STFT
at 2x the model's n_fft/hop/win with a kbd window, and the numpy segmental
SNR that fills the reference's dead SSNR slots; `append_csv_row` writes
the eval.csv rows of the training and evaluate CLIs.
"""

from __future__ import annotations

import csv
from typing import Dict, Tuple

import numpy as np
import torch

from .ops.audio import spectrogram_power
from .ops.window import kbdwin


def renormalize(hr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Match x to hr's mean/std along the last axis."""
    x = (x - x.mean(-1, keepdim=True)) / x.std(-1, correction=0, keepdim=True)
    return x * hr.std(-1, correction=0, keepdim=True) + hr.mean(-1, keepdim=True)


def lsd(hr: torch.Tensor, x: torch.Tensor, n_fft: int, hop_length: int,
        win_length: int, center: bool = True) -> float:
    """Log-spectral distance of x against hr (no renormalization)."""
    window = kbdwin(2 * win_length)
    spec = [torch.log10(spectrogram_power(s, 2 * n_fft, 2 * hop_length,
                                          2 * win_length, window, center)
                        + 1e-6) for s in (hr, x)]
    return float(torch.sqrt(((spec[0] - spec[1]) ** 2).mean(-2)).mean())


def compute_metrics(hr_audio: torch.Tensor, lr_audio: torch.Tensor,
                    sr_audio: torch.Tensor, n_fft: int, hop_length: int,
                    win_length: int, center: bool = True
                    ) -> Tuple[float, float, float, float, float, float, float]:
    """(mse, snr_sr, snr_lr, ssnr_sr, ssnr_lr, 0, lsd) over [B, L] tensors."""
    hr = hr_audio.float()
    lr = lr_audio.float()
    sr = renormalize(hr, sr_audio.float())
    energy = (hr ** 2).sum(-1)
    mse = ((sr - hr) ** 2).mean()
    snr_sr = (10 * torch.log10(energy / ((sr - hr) ** 2).sum(-1))).mean()
    snr_lr = (10 * torch.log10(energy / ((lr - hr) ** 2).sum(-1))).mean()
    lsd_sr = lsd(hr, sr, n_fft, hop_length, win_length, center)
    ssnr_sr = segmental_snr(hr.cpu().numpy(), sr.cpu().numpy())
    ssnr_lr = segmental_snr(hr.cpu().numpy(), lr.cpu().numpy())
    return (float(mse), float(snr_sr), float(snr_lr), ssnr_sr, ssnr_lr,
            0.0, lsd_sr)


def segmental_snr(hr_audio, sr_audio, frame_length: int = 1536,
                  hop: int = 768, min_db: float = -10.0,
                  max_db: float = 35.0, active_db: float = -40.0) -> float:
    """Frame-wise segmental SNR in dB: ~32 ms frames, per-frame SNR clamped
    to [min_db, max_db], averaged over frames whose energy is above
    `active_db` dBFS of the reference peak. numpy, host-side."""
    hr = np.asarray(hr_audio, np.float32).reshape(-1)
    sr = np.asarray(sr_audio, np.float32).reshape(-1)
    n = min(hr.size, sr.size)
    hr, sr = hr[:n], sr[:n]
    if n < frame_length:
        return 0.0
    starts = np.arange(0, n - frame_length + 1, hop)
    idx = starts[:, None] + np.arange(frame_length)[None]
    hf, sf = hr[idx], sr[idx]
    sig = np.sum(hf * hf, axis=1)
    err = np.sum((sf - hf) ** 2, axis=1)
    peak = max(np.max(np.abs(hr)), 1e-9)
    active = 10 * np.log10(sig / (frame_length * peak * peak) + 1e-12) > active_db
    if not active.any():
        return 0.0
    snr = 10 * np.log10((sig + 1e-12) / (err + 1e-12))
    return float(np.mean(np.clip(snr[active], min_db, max_db)))


def append_csv_row(path: str, row: Dict[str, float]) -> None:
    """Append one row to a csv file, with a header line if it is empty."""
    with open(path, "a") as f:
        w = csv.DictWriter(f, fieldnames=row.keys())
        if f.tell() == 0:
            w.writeheader()
        w.writerow(row)
