"""Signal padding, overlapping framing and overlap-add.

Port of pix2pixhdaudiosr_tpu/ops/framing.py:21-86. The JAX package frames
with gcd(win, hop)-sample cells because a strided gather is the wrong shape
for XLA; here `Tensor.unfold` and `F.fold` (the reference's own operators)
do the same for any hop, including win % hop != 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PAD_MODES = ("constant", "reflect", "replicate")


def pad_signal(signal: torch.Tensor, hop: int, center: bool,
               pad_mode: str = "constant") -> torch.Tensor:
    """Start pad of `hop` when centered, end pad to the next hop multiple
    (plus the start pad) — the reference MDCT pre-pad."""
    s = signal.shape[-1]
    start = hop if center else 0
    extra = s % hop
    end = start + (hop - extra if extra else 0)
    if start == 0 and end == 0:
        return signal
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {_PAD_MODES}")
    if pad_mode == "constant":
        return F.pad(signal, (start, end))
    flat = signal.reshape(-1, 1, s)
    return F.pad(flat, (start, end), mode=pad_mode).reshape(
        signal.shape[:-1] + (s + start + end,))


def frame(signal: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """[..., L] -> [..., T, win] with T = (L - win)//hop + 1."""
    if signal.shape[-1] < win:
        raise ValueError(f"signal too short to frame: L={signal.shape[-1]}, "
                         f"win={win}")
    return signal.unfold(-1, win, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, win] -> [..., (T-1)*hop + win]."""
    T, win = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    out_len = (T - 1) * hop + win
    cols = frames.reshape(-1, T, win).transpose(1, 2)
    out = F.fold(cols, output_size=(1, out_len), kernel_size=(1, win),
                 stride=(1, hop))
    return out.reshape(lead + (out_len,))


def center_crop(signal: torch.Tensor, win: int) -> torch.Tensor:
    """Remove win//2 samples from both ends."""
    return signal[..., win // 2: -(win // 2)]
