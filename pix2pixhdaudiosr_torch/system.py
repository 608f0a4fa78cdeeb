"""The serving half of the Pix2PixHD audio-SR system.

Port of the serving subset of pix2pixhdaudiosr_tpu/system.py:
`frames_for`, `n_frames`, `spectro_shape` (:51-138), `encode_input` for the
lr side (:170-185) and `inference` (:371-383). The generator is an
nn.Module that holds its weights (the JAX package passes a param tree);
it runs in the compute dtype, on a channels_last view of the NHWC
spectrogram.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .models.generator import build_generator
from .ops.encoding import CodecConfig, SpectroCodec


class Pix2PixHDSystem:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.codec = SpectroCodec(CodecConfig(
            n_fft=cfg.n_fft, hop_length=cfg.hop_length,
            win_length=cfg.win_length, center=cfg.center,
            segment_length=cfg.segment_length, up_ratio=cfg.up_ratio,
            alpha=cfg.alpha, min_value=cfg.min_value,
            explicit_encoding=cfg.explicit_encoding, mask_mode=cfg.mask_mode,
            phase_encoding_mode=cfg.phase_encoding_mode), device=device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        # built unallocated; fill with load_state_dict / init_normal_
        self.netG = build_generator(
            cfg.net_g, cfg.netg_input_nc, cfg.output_nc, cfg.ngf,
            cfg.n_downsample_global, cfg.n_blocks_global,
            cfg.n_local_enhancers, cfg.n_blocks_local,
            deconv_mode="torch" if cfg.torch_deconv else "same",
            device="meta").to_empty(device=self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def frames_for(seg: int, hop: int, win: int, center: bool) -> int:
        """Frame count of a `seg`-sample signal under the reference pad rule."""
        start = hop if center else 0
        extra = seg % hop
        end = start + (hop - extra if extra else 0)
        return (seg + start + end - win) // hop + 1

    @property
    def n_frames(self) -> int:
        """Frame count of one segment: 128 for the default config."""
        return self.frames_for(self.cfg.segment_length, self.cfg.hop_length,
                               self.cfg.win_length, self.cfg.center)

    def spectro_shape(self, batch: int) -> Tuple[int, int, int, int]:
        cfg = self.cfg
        c = 2 if cfg.explicit_encoding else 1
        stride = 2 ** cfg.n_downsample_global
        if cfg.net_g == "local":
            stride *= 2 ** cfg.n_local_enhancers
        if self.n_frames % stride:
            raise ValueError(
                f"segment_length {cfg.segment_length} gives {self.n_frames} "
                f"frames, not divisible by the generator stride {stride}; "
                f"pick segment_length = (16k-1)*hop like the default")
        return (batch, cfg.n_fft, self.n_frames, c)

    # ------------------------------------------------------------------
    def encode_input(self, lr_audio: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """The lr side of the reference encode: always masked."""
        return self.codec.to_spectro(lr_audio, mask=True, noise=noise,
                                     generator=generator)

    @torch.no_grad()
    def inference(self, lr_audio: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        """[B, S] lr waveform -> (sr_spectro f32 [B,F,T,C], lr_pha,
        lr_norm_param, lr_spectro). The G input is cast to the compute
        dtype and the G output to f32, as in the JAX package."""
        lr_spec, lr_pha, lr_norm = self.encode_input(lr_audio, noise, generator)
        g_in = lr_spec.to(self.dtype).permute(0, 3, 1, 2)  # channels_last view
        sr = self.netG(g_in).permute(0, 2, 3, 1).float()
        return sr, lr_pha, lr_norm, lr_spec
