"""The one-file test dataset of the generate CLI.

Port of pix2pixhdaudiosr_tpu/data/dataset.py:132-161 (`AudioTestDataset`):
one file, resampled down to the low rate and back up (or only up, with
is_lr_input), chopped into consecutive segment_length windows. Resampling
is the numpy polyphase `resample_np`.
"""

from __future__ import annotations

import numpy as np

from ..ops.audio import resample_np
from .wavio import read_wav


class AudioTestDataset:
    def __init__(self, dataroot: str, lr_sampling_rate: int,
                 hr_sampling_rate: int, segment_length: int,
                 is_lr_input: bool = False):
        self.segment_length = segment_length
        wav, rate = read_wav(dataroot)
        self.raw_audio = wav[0]
        self.in_sampling_rate = rate
        self.audio_len = len(self.raw_audio)
        self.dataroot = dataroot
        if is_lr_input:
            self.lr_audio = resample_np(self.raw_audio, rate, hr_sampling_rate)
        else:
            lo = resample_np(self.raw_audio, rate, lr_sampling_rate)
            self.lr_audio = resample_np(lo, lr_sampling_rate, hr_sampling_rate)
        n = len(self.lr_audio)
        num_seg = max(1, int(np.ceil(n / segment_length)))
        padded = np.pad(self.lr_audio, (0, num_seg * segment_length - n))
        self.segments = padded.reshape(num_seg, segment_length).astype(np.float32)

    def __len__(self) -> int:
        return self.segments.shape[0]
