"""WAV decode/encode, numpy only.

Copied from pix2pixhdaudiosr_tpu/data/wavio.py (that package's `data`
imports jax): a RIFF/WAVE parser for PCM 8/16/24/32 and float32/64, and a
PCM16 writer. `.flac` files decode through data/flac.py.
"""

from __future__ import annotations

import os
import struct
import wave
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    num_frames: int
    num_channels: int
    bits_per_sample: int
    audio_format: int          # 1 = PCM, 3 = IEEE float
    data_offset: int           # byte offset of the sample data in the file


def wav_info(path: str) -> WavInfo:
    if os.path.splitext(path)[1].lower() == ".flac":
        from .flac import flac_info
        fi = flac_info(path)
        return WavInfo(fi.sample_rate, fi.num_frames, fi.num_channels,
                       fi.bits_per_sample, 1, fi.data_offset)
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"no data chunk in {path}")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                if size % 2:
                    f.read(1)
            elif cid == b"data":
                if fmt is None:
                    raise ValueError(f"data before fmt in {path}")
                audio_format, n_ch, rate, _, _, bits = struct.unpack(
                    "<HHIIHH", fmt[:16])
                if audio_format == 0xFFFE and len(fmt) >= 40:  # extensible
                    audio_format = struct.unpack("<H", fmt[24:26])[0]
                frames = size // (n_ch * (bits // 8))
                return WavInfo(rate, frames, n_ch, bits, audio_format, f.tell())
            else:
                f.seek(size + (size % 2), os.SEEK_CUR)


def _decode(raw: bytes, info: WavInfo) -> np.ndarray:
    bits, fmt = info.bits_per_sample, info.audio_format
    if fmt == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif fmt == 1 and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif fmt == 1 and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x ^ 0x800000) - 0x800000  # sign extend
        x = x.astype(np.float32) / 8388608.0
    elif fmt == 1 and bits == 8:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif fmt == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif fmt == 3 and bits == 64:
        x = np.frombuffer(raw, "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported wav format {fmt}/{bits}")
    return x.reshape(-1, info.num_channels).T  # [C, T]


def read_wav(path: str, frame_offset: int = 0,
             num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Returns ([channels, frames] float32 in [-1, 1], sample_rate). Reads
    only the frames asked for: `num_frames` (all if None) from
    `frame_offset`, clipped to the file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flac":
        from .flac import read_flac
        return read_flac(path, frame_offset=frame_offset,
                         num_frames=num_frames)
    if ext != ".wav":
        raise ValueError(f"{ext} input is not supported; convert {path} to "
                         f".wav or .flac")
    info = wav_info(path)
    bpf = info.num_channels * (info.bits_per_sample // 8)
    start = min(max(frame_offset, 0), info.num_frames)
    n = info.num_frames - start if num_frames is None \
        else min(num_frames, info.num_frames - start)
    with open(path, "rb") as f:
        f.seek(info.data_offset + start * bpf)
        raw = f.read(n * bpf)
    return _decode(raw, info), info.sample_rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """PCM16 writer. audio: [C, T] or [T]."""
    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[None]
    pcm = np.clip(a.T * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
