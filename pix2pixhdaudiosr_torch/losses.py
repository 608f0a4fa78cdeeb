"""GAN objectives.

Port of pix2pixhdaudiosr_tpu/losses.py: the LSGAN / BCE loss over the
multiscale discriminator's nested outputs, discriminator feature matching,
the frame-overlap match loss, and the loss filter. Every loss is computed
in f32 whatever the dtype of the predictions.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _single_gan_loss(pred: torch.Tensor, target_is_real: bool,
                     use_lsgan: bool) -> torch.Tensor:
    pred = pred.float()
    target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
    if use_lsgan:
        return torch.mean((pred - target) ** 2)
    eps = 1e-7
    p = torch.clamp(pred, eps, 1 - eps)
    return -torch.mean(target * torch.log(p) + (1 - target) * torch.log(1 - p))


def gan_loss(preds: Sequence[Sequence[torch.Tensor]], target_is_real: bool,
             use_lsgan: bool = True) -> torch.Tensor:
    """Sum of the per-scale losses on each scale's final score map."""
    loss = 0.0
    for scale in preds:
        loss = loss + _single_gan_loss(scale[-1], target_is_real, use_lsgan)
    return loss


def feature_matching_loss(pred_fake: Sequence[Sequence[torch.Tensor]],
                          pred_real: Sequence[Sequence[torch.Tensor]],
                          n_layers_d: int, num_d: int,
                          lambda_feat: float) -> torch.Tensor:
    """L1 over the D intermediates, each weighted 4/(n_layers+1) * 1/num_D
    * lambda. pred_real is a constant target: the caller detaches it."""
    feat_w = 4.0 / (n_layers_d + 1)
    d_w = 1.0 / num_d
    loss = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            l1 = torch.mean(torch.abs(pred_fake[i][j].float()
                                      - pred_real[i][j].float()))
            loss = loss + d_w * feat_w * l1 * lambda_feat
    return loss


def match_loss(sr_frames: torch.Tensor, window: torch.Tensor,
               win_length: int, lambda_mat: float) -> torch.Tensor:
    """Overlap-consistency MSE between the second half of frame t and the
    first half of frame t+1, each re-windowed. sr_frames: [B, T, n_fft]."""
    half = win_length // 2
    w = window.to(sr_frames.dtype)
    a = sr_frames[..., :-1, half:win_length] * w[:half]
    b = sr_frames[..., 1:, :half] * w[half:win_length]
    return torch.mean((a.float() - b.float()) ** 2) * lambda_mat


LOSS_NAMES = ("G_GAN", "G_GAN_Feat", "G_VGG", "G_mat", "G_GAN_t",
              "D_real_t", "D_fake_t", "D_real", "D_fake")


def loss_filter_flags(use_gan_feat_loss: bool, use_vgg_loss: bool,
                      use_match_loss: bool, use_time_loss: bool):
    """Which of LOSS_NAMES a configuration reports."""
    return (True, use_gan_feat_loss, use_vgg_loss, use_match_loss,
            use_time_loss, use_time_loss, use_time_loss, True, True)


def filter_losses(losses: dict, flags) -> dict:
    return {n: losses[n] for n, f in zip(LOSS_NAMES, flags) if f}
