"""Waveform <-> normalized 2-channel MDCT spectrogram codec.

Port of pix2pixhdaudiosr_tpu/ops/encoding.py:37-206 (`CodecConfig`, and of
`SpectroCodec` the serving half: `to_spectro`, `denormalize`, `imdct_eval`).

Layout as in the JAX package: spectrograms are [B, F(freq), T(frames), C],
phase tensors [B, F, T]. Randomness is explicit: `to_spectro` takes the
raw standard-normal mask draw as `noise=` or draws it from `generator=`
(JAX's draws cannot be reproduced by torch; tests feed them in).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .audio import amplitude_to_db, db_to_amplitude
from .mdct import IMDCT2, MDCT2
from .window import kbdwin


@dataclass(frozen=True)
class CodecConfig:
    n_fft: int = 512
    hop_length: int = 256
    win_length: int = 512
    center: bool = True
    segment_length: int = 32512
    up_ratio: float = 6.0
    alpha: float = 0.6
    min_value: float = 1e-7
    explicit_encoding: bool = True
    mask_mode: Optional[str] = "mode2"   # None | mode0 | mode1 | mode2
    phase_encoding_mode: Optional[str] = None


class SpectroCodec:
    """MDCT2/IMDCT2 with the kbd window on one device."""

    def __init__(self, cc: CodecConfig, device="cuda"):
        if not cc.explicit_encoding and cc.phase_encoding_mode not in (None, "scale"):
            raise NotImplementedError(
                f"phase_encoding_mode={cc.phase_encoding_mode!r} is a training "
                f"option; it comes with the train step (ROADMAP A7)")
        self.cc = cc
        self.device = torch.device(device)
        self.window = kbdwin(cc.win_length)
        kw = dict(n_fft=cc.n_fft, hop_length=cc.hop_length,
                  win_length=cc.win_length, window=self.window,
                  center=cc.center, device=device)
        self.mdct = MDCT2(**kw)
        self.imdct_seg = IMDCT2(out_length=cc.segment_length, **kw)

    def mask_size(self, n_freq: int) -> int:
        """Bins replaced by noise: the top (1 - 1/up_ratio) of the axis."""
        return int(n_freq * (1 - 1 / self.cc.up_ratio))

    # ------------------------------------------------------------------
    def to_spectro(self, audio: torch.Tensor, mask: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """[B, S] waveform -> (log_spectro [B,F,T,C], pha [B,F,T], norm_param).

        With mask=True the top `mask_size` bins are replaced by noise built
        from a standard-normal draw of shape [B, mask_size, T, C]: `noise`
        if given, else drawn from `generator`. The min/max normalization is
        over the whole batch."""
        cc = self.cc
        spectro = self.mdct(audio).transpose(-1, -2)  # [B, F, T]

        if cc.explicit_encoding:
            neg = 0.5 * (torch.abs(spectro) - spectro)
            pos = spectro + neg
            ch0 = amplitude_to_db(cc.alpha * pos + (1 - cc.alpha) * neg, 20.0, cc.min_value, 1.0)
            ch1 = amplitude_to_db((1 - cc.alpha) * pos + cc.alpha * neg, 20.0, cc.min_value, 1.0)
            log_spectro = torch.stack([ch0, ch1], dim=-1)  # [B, F, T, 2]
        else:
            log_spectro = amplitude_to_db(torch.abs(spectro) + cc.min_value,
                                          20.0, cc.min_value, 1.0)[..., None]
        pha = torch.sign(spectro)
        if not cc.explicit_encoding and cc.phase_encoding_mode == "scale":
            pha = pha * 0.5

        mean = log_spectro.mean()
        std = torch.sqrt(log_spectro.var(correction=0))
        amax = log_spectro.max()
        amin = log_spectro.min()
        log_spectro = (log_spectro - amin) / (amax - amin)

        if mask:
            b, f, t, c = log_spectro.shape
            shape = (b, self.mask_size(f), t, c)
            if noise is None:
                noise = torch.randn(shape, generator=generator,
                                    device=self.device, dtype=log_spectro.dtype)
            elif tuple(noise.shape) != shape:
                raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
            noise = noise.to(log_spectro)
            nmin, nmax = noise.min(), noise.max()
            if cc.mask_mode == "mode0":
                noise = noise / (nmax - nmin)
            elif cc.mask_mode == "mode1":
                noise = (noise - nmin) / (nmax - nmin)
                signs = torch.randint(0, 2, shape, generator=generator,
                                      device=self.device)
                noise = noise * (2 * signs.to(noise) - 1)
            elif cc.mask_mode == "mode2":
                noise = (noise - nmin) / (nmax - nmin)
            elif cc.mask_mode is None:
                noise = torch.zeros_like(noise)
            else:
                raise ValueError(f"unknown mask_mode {cc.mask_mode!r}")
            log_spectro = torch.cat([log_spectro[:, : f - shape[1]], noise], dim=1)

        norm_param = {"max": amax, "min": amin, "mean": mean, "std": std}
        return log_spectro, pha, norm_param

    # ------------------------------------------------------------------
    def denormalize(self, log_spectro: torch.Tensor, norm_param) -> torch.Tensor:
        spectro = torch.abs(log_spectro) * (norm_param["max"] - norm_param["min"]) \
            + norm_param["min"]
        return db_to_amplitude(spectro, 10.0, 0.5) - self.cc.min_value

    def imdct_eval(self, spectro: torch.Tensor, pha: torch.Tensor, norm_param,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The eval/generate inverse: denormalize, recombine the channels as
        (ch0 + ch1) with sign(ch0 - ch1) as pseudo-phase, splice the true
        phase below bin int(F / up_ratio), IMDCT to segment_length, / 2.
        Callers scale by sqrt(up_ratio - 1)."""
        cc = self.cc
        device_spec = self.denormalize(spectro, norm_param)
        cut = int(pha.shape[-2] * (1 / cc.up_ratio))
        if cc.explicit_encoding:
            pseudo = torch.sign(device_spec[..., 0] - device_spec[..., 1])
            mag = device_spec[..., 0] + device_spec[..., 1]  # [B, F, T]
        else:
            mag = device_spec[..., 0]
            signs = torch.randint(0, 2, pha.shape, generator=generator,
                                  device=self.device)
            pseudo = 2 * signs.to(pha) - 1
        if cc.up_ratio > 1:
            pha = torch.cat([pha[..., :cut, :], pseudo[..., cut:, :]], dim=-2)
        return self.imdct_seg((mag * pha).transpose(-1, -2)) / 2.0
