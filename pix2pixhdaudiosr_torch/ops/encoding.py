"""Waveform <-> normalized 2-channel MDCT spectrogram codec.

Port of pix2pixhdaudiosr_tpu/ops/encoding.py:37-206: `CodecConfig` and
`SpectroCodec` (`to_spectro` with its random phase encodings and
`return_frames`, `denormalize`, `imdct_eval`, and the train step's
inverses `to_frames` and `to_audio`).

Layout as in the JAX package: spectrograms are [B, F(freq), T(frames), C],
phase tensors [B, F, T]. Randomness is explicit: each draw is taken as an
argument (the mask's standard-normal `noise=`, the phase encoding's
`phase_noise=`, `to_audio`'s pseudo-phase `signs=`) or drawn from
`generator=` (JAX's draws cannot be reproduced by torch; tests feed them
in). `to_frames` and `to_audio` are differentiable and compute in f32:
callers run them outside autocast, as the JAX step runs them on an f32 G
output.

Data parallelism: `to_spectro` and `to_audio` take the `group` of ranks
over which the global batch is split (parallel/mesh.py; each rank holds
its equal share of the rows, in rank order). The normalization's mean,
variance, max and min are then taken over the whole batch (all-reduced),
and every draw is made at the global batch's shape from the generator on
every rank, each rank keeping its own rows: a split step normalizes and
draws exactly as one process does on the whole batch. `group=None` (or a
group of one rank) is the one-process computation, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .audio import amplitude_to_db, db_to_amplitude
from .dct import idct_2n
from .mdct import IMDCT2, MDCT2
from .window import kbdwin

# the random phase encodings (pha times a draw of its shape); "scale"
# halves pha, and any other mode leaves it as it is, as in the JAX package
RANDOM_PHASE_ENCODINGS = ("uni_dist", "norm_dist", "norm_dist2")


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


def _split(group) -> bool:
    return group is not None and group.size > 1


def _global_shape(shape, group) -> Tuple[int, ...]:
    """The whole batch's shape of a rank's rows `shape`."""
    if not _split(group):
        return tuple(shape)
    return (shape[0] * group.size, *shape[1:])


def _own_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of a whole-batch tensor."""
    if not _split(group):
        return x
    return x.chunk(group.size)[group.rank]


def batch_moments(x: torch.Tensor, group):
    """(mean, std, max, min) of x over the whole batch: as torch takes them
    in one process, or over the group's ranks (a SUM all-reduce for the
    mean, then one of the squared deviations from it: the two passes of
    torch.var, not E[x^2] - mean^2, which cancels at dB magnitudes; MAX of
    (max, -min))."""
    if not _split(group):
        return (x.mean(), torch.sqrt(x.var(correction=0)), x.max(), x.min())
    count = x.numel() * group.size
    mean = group.all_reduce_sum(x.sum()) / count
    var = group.all_reduce_sum(((x - mean) ** 2).sum()) / count
    top = group.all_reduce_max(torch.stack([x.max(), -x.min()]))
    return mean, torch.sqrt(var), top[0], -top[1]


class SpectroCodec:
    """MDCT2/IMDCT2 with the kbd window on one device."""

    def __init__(self, cc: CodecConfig, device="cuda"):
        self.cc = cc
        self.device = torch.device(device)
        self.window = kbdwin(cc.win_length)
        kw = dict(n_fft=cc.n_fft, hop_length=cc.hop_length,
                  win_length=cc.win_length, window=self.window,
                  center=cc.center, device=device)
        self.mdct = MDCT2(**kw)
        self.imdct = IMDCT2(**kw)
        self.imdct_seg = IMDCT2(out_length=cc.segment_length, **kw)

    def mask_size(self, n_freq: int) -> int:
        """Bins replaced by noise: the top (1 - 1/up_ratio) of the axis."""
        return int(n_freq * (1 - 1 / self.cc.up_ratio))

    # ------------------------------------------------------------------
    def to_spectro(self, audio: torch.Tensor, mask: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   return_frames: bool = False,
                   phase_noise: Optional[torch.Tensor] = None,
                   group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """[B, S] waveform -> (log_spectro [B,F,T,C], pha [B,F,T], norm_param).

        With mask=True the top `mask_size` bins are replaced by noise built
        from a standard-normal draw of shape [B, mask_size, T, C]: `noise`
        if given, else drawn from `generator`. The min/max normalization is
        over the whole batch. With `return_frames`, norm_param["frames"]
        holds the windowed frames [B, T, win] (MDCT2's return_ola). Without
        explicit encoding, the random phase encodings scale pha by a draw of
        its shape: uniform (uni_dist), min/max-normalized normal
        (norm_dist) or |normal| (norm_dist2), the raw draw `phase_noise` if
        given, else drawn from `generator`. With a `group` of ranks that
        split the batch, `audio` is this rank's rows, the statistics are
        the whole batch's, and `noise` and `phase_noise` (given or drawn)
        are the whole batch's draws, of which this rank keeps its rows."""
        cc = self.cc
        if return_frames:
            spec_tn, frames = self.mdct(audio, return_ola=True)
        else:
            spec_tn, frames = self.mdct(audio), None
        spectro = spec_tn.transpose(-1, -2)  # [B, F, T]

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
        if not cc.explicit_encoding and cc.phase_encoding_mode is not None:
            pha = self._encode_phase(pha, phase_noise, generator, group)

        mean, std, amax, amin = batch_moments(log_spectro, group)
        log_spectro = (log_spectro - amin) / (amax - amin)

        if mask:
            b, f, t, c = log_spectro.shape
            shape = _global_shape((b, self.mask_size(f), t, c), group)
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
            log_spectro = torch.cat([log_spectro[:, : f - shape[1]],
                                     _own_rows(noise, group)], dim=1)

        norm_param = {"max": amax, "min": amin, "mean": mean, "std": std}
        if return_frames:
            norm_param["frames"] = frames
        return log_spectro, pha, norm_param

    def _encode_phase(self, pha: torch.Tensor, draw: Optional[torch.Tensor],
                      generator: Optional[torch.Generator],
                      group=None) -> torch.Tensor:
        mode = self.cc.phase_encoding_mode
        if mode == "scale":
            return pha * 0.5
        if mode not in RANDOM_PHASE_ENCODINGS:
            return pha
        shape = _global_shape(pha.shape, group)
        if draw is None:
            sample = torch.rand if mode == "uni_dist" else torch.randn
            draw = sample(shape, generator=generator, device=pha.device,
                          dtype=pha.dtype)
        elif tuple(draw.shape) != shape:
            raise ValueError(f"phase_noise shape {tuple(draw.shape)} != "
                             f"{shape}")
        draw = draw.to(pha)
        if mode == "norm_dist":
            draw = (draw - draw.min()) / (draw.max() - draw.min())
        elif mode == "norm_dist2":
            draw = draw.abs()
        return pha * _own_rows(draw, group)

    # ------------------------------------------------------------------
    def denormalize(self, log_spectro: torch.Tensor, norm_param) -> torch.Tensor:
        spectro = torch.abs(log_spectro) * (norm_param["max"] - norm_param["min"]) \
            + norm_param["min"]
        return db_to_amplitude(spectro, 10.0, 0.5) - self.cc.min_value

    def _combine_explicit(self, spectro: torch.Tensor) -> torch.Tensor:
        """(ch0 - ch1) / (2 alpha - 1): the signed magnitude [B, F, T]."""
        return (spectro[..., 0] - spectro[..., 1]) / (2 * self.cc.alpha - 1)

    def to_frames(self, log_spectro: torch.Tensor, norm_param
                  ) -> Optional[torch.Tensor]:
        """The raw IDCT frames (no window, no overlap-add) of a G output, for
        the match loss and the time-domain discriminator: [B, T, n_fft], or
        None without explicit encoding."""
        if not self.cc.explicit_encoding:
            return None
        spectro = self._combine_explicit(self.denormalize(log_spectro, norm_param))
        return idct_2n(spectro.transpose(-1, -2))

    def to_audio(self, log_spectro: torch.Tensor, norm_param,
                 pha: Optional[torch.Tensor] = None,
                 signs: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 group=None) -> torch.Tensor:
        """The HiFi-GAN discriminator's waveform of a G output: denormalize,
        recombine (explicit: _combine_explicit; else channel 0 times pha,
        whose bins from int(F / up_ratio) up take a random sign, 2 * signs -
        1, with `signs` a {0, 1} draw of pha's shape, given or drawn from
        `generator`), the un-segmented IMDCT2, times sqrt(up_ratio - 1).
        [B, F, T, C] -> [B, (T - 1) * hop] (centered). With a `group`
        (to_spectro), `signs` is the whole batch's draw, of which this rank
        keeps its rows."""
        cc = self.cc
        spectro = self.denormalize(log_spectro, norm_param)
        if cc.explicit_encoding:
            spectro = self._combine_explicit(spectro)  # [B, F, T]
        else:
            spectro = spectro[..., 0]
            if cc.up_ratio > 1:
                cut = int(pha.shape[-2] * (1 / cc.up_ratio))
                if signs is None:
                    signs = torch.randint(0, 2, _global_shape(pha.shape, group),
                                          generator=generator,
                                          device=pha.device)
                pseudo = 2 * _own_rows(signs, group).to(pha) - 1
                pha = torch.cat([pha[..., :cut, :], pseudo[..., cut:, :]], dim=-2)
            spectro = spectro * pha
        audio = self.imdct(spectro.transpose(-1, -2))
        return math.sqrt(cc.up_ratio - 1) * audio

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
