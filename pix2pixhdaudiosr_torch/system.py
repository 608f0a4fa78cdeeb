"""The Pix2PixHD audio-SR system: serving and the GAN train step.

Port of pix2pixhdaudiosr_tpu/system.py: `_maybe_remat` (:38-49, as
`remat_forward`), `frames_for`, `n_frames`, `spectro_shape` (:51-138),
`encode_input` (:170-185), `_time_frames` and `_time_d_apply`
(:191-205), `losses_and_grads` (:208-351: LSGAN and feature matching,
the match loss, the time-domain and HiFi-GAN discriminators' losses, the
fake pool's pooled pair, the feature encoder netE, --remat_g),
`_visual_slices` (:353-369), `inference` (:371-383) and
`sample_features` (:385-402). Nets are nn.Modules that hold their
weights (the JAX package passes param trees); they run in the compute
dtype, on a channels_last view of the NHWC spectrogram.

`netG` is the generator `inference` serves: it carries `--fused_enhancer`
and `--int8_trunk`, whose kernels have no backward. A training system
(cfg.is_train) adds `netG_train`, the plain generator the train step
differentiates, sharing netG's parameter tensors (netG itself when neither
flag is set), `netD`, and with --use_time_D / --use_hifigan_D `time_D` /
`hifigan_D` (else None), and with --instance_feat / --label_feat the
feature encoder `netE` (else None), which the G optimizer trains; the JAX
package's pair is netG / netG_infer. Each net's input width is what flax
infers from the tensors the JAX step feeds it (the spectrogram's channels,
2 with explicit encoding, else 1; + 1 without --no_instance; + feat_num
for G with features), not --input_nc.
Training keeps f32 parameters and computes in the compute dtype under
autocast, as flax's dtype=bf16 modules do from f32 params; so does
`inference` on a training system (the in-training eval). The codec half
of the optional losses (to_frames, to_audio, the dB of the time-domain
frames) runs in f32 outside autocast, as the JAX step runs it on the f32 G
output; only the discriminators' forwards run in the compute dtype.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .losses import (LOSS_NAMES, feature_matching_loss, filter_losses,
                     gan_loss, loss_filter_flags, match_loss)
from .models.discriminator import build_discriminator
from .models.generator import build_generator
from .models.hifigan_d import build_hifigan_discriminator
from .ops.audio import amplitude_to_db
from .ops.encoding import CodecConfig, SpectroCodec

def spectro_channels(cfg) -> int:
    """Channels of the codec's spectrogram: 2 with explicit encoding, else 1."""
    return 2 if cfg.explicit_encoding else 1


def g_input_nc(cfg) -> int:
    """G's input channels, as flax infers them from the JAX package's G
    input: the spectrogram's, + 1 without --no_instance, + feat_num with
    features (not --input_nc, which flax never reads)."""
    return (spectro_channels(cfg) + (0 if cfg.no_instance else 1)
            + (cfg.feat_num if cfg.use_features else 0))


# (condition on the config, what it asks for, why the JAX step fails on it)
JAX_UNTRAINABLE = (
    (lambda c: c.use_features and c.load_features,
     "--load_features",
     "G takes feat_num feature channels that no step builds (netE is off "
     "and the batch carries no feature map)"),
    (lambda c: c.output_nc != spectro_channels(c),
     "--output_nc differing from the spectrogram's channels (2 with "
     "--explicit_encoding, else 1)",
     "D's fake pair (label + G output) and real pair (label + target) "
     "differ in width"),
)


def check_trainable(cfg) -> None:
    """Raise ValueError for a config the JAX package's train step does not
    run either (it fails there on a tensor's width)."""
    for cond, what, why in JAX_UNTRAINABLE:
        if cond(cfg):
            raise ValueError(
                f"{what}: {why}; the JAX package's train step fails on this "
                f"config too, so pix2pixhdaudiosr_torch does not train it")


# the ops whose outputs --remat_g dots keeps (jax.checkpoint_policies
# .dots_saveable: the matmul and conv outputs); everything else, the
# InstanceNorm kernels' outputs included, is recomputed in the backward
_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_forward(fn, remat: Optional[str]):
    """fn's output, rematerialized in the backward per the --remat_g mode:
    "" / None runs fn as it is; "full" saves nothing of it (non-reentrant
    torch.utils.checkpoint, which keeps the RNG state); "dots" saves the
    outputs of convolution, mm, bmm and addmm and recomputes the rest."""
    if not remat:
        return fn()
    if remat == "full":
        return checkpoint(fn, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat mode: {remat!r}")


def share_parameters(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Make every parameter of dst the very Parameter of src under its
    name (the two nets have one param tree)."""
    params = dict(src.named_parameters())
    for prefix, module in dst.named_modules():
        for key in module._parameters:
            module._parameters[key] = params[f"{prefix}.{key}" if prefix else key]


def generator_stride(cfg) -> int:
    """Input frames per frame of the generator's coarsest grid."""
    stride = 2 ** cfg.n_downsample_global
    if cfg.net_g == "local":
        stride *= 2 ** cfg.n_local_enhancers
    return stride


def make_codec(cfg, device) -> SpectroCodec:
    """The codec of a config (its segment_length sets the inverse's crop)."""
    return SpectroCodec(CodecConfig(
        n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length, center=cfg.center,
        segment_length=cfg.segment_length, up_ratio=cfg.up_ratio,
        alpha=cfg.alpha, min_value=cfg.min_value,
        explicit_encoding=cfg.explicit_encoding, mask_mode=cfg.mask_mode,
        phase_encoding_mode=cfg.phase_encoding_mode), device=device)


class Pix2PixHDSystem:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # the ranks that split a train step's batch (parallel/dp.py); None:
        # this process trains on the whole batch
        self.data_group = None
        self.codec = make_codec(cfg, device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        if cfg.is_train:
            check_trainable(cfg)
        c = spectro_channels(cfg)
        self.g_input_nc = g_input_nc(cfg)
        # built unallocated; fill with load_state_dict / init_normal_
        self.netG = self._generator(cfg.fused_enhancer, cfg.int8_trunk)
        if not cfg.is_train:
            return
        self.netG.to(memory_format=torch.channels_last)
        self.netG_train = self.netG
        if cfg.fused_enhancer or cfg.int8_trunk:
            self.netG_train = self._generator(False, False)
            share_parameters(self.netG_train, self.netG)
        self.netD = build_discriminator(
            2 * c + (0 if cfg.no_instance else 1), cfg.ndf, cfg.n_layers_d,
            use_sigmoid=cfg.no_lsgan, num_d=cfg.num_d,
            get_interm_feat=not cfg.no_gan_feat_loss, device="meta"
        ).to_empty(device=self.device).to(memory_format=torch.channels_last)
        # the time-domain D sees [B, T, n_fft, 2]: the dB of the lr frames
        # and of the tested frames
        self.time_D = build_discriminator(
            2, cfg.ndf, cfg.n_layers_d, use_sigmoid=cfg.no_lsgan,
            num_d=cfg.num_d, get_interm_feat=False, device="meta"
        ).to_empty(device=self.device).to(
            memory_format=torch.channels_last) if cfg.use_time_d else None
        self.hifigan_D = build_hifigan_discriminator(
            cfg, device="meta").to_empty(device=self.device) \
            if cfg.use_hifigan_d else None
        # the feature encoder on the target spectrogram (JAX system.py:95-100)
        self.netE = build_generator(
            "encoder", c, cfg.feat_num, cfg.nef, cfg.n_downsample_e, 0, 0, 0,
            device="meta").to_empty(device=self.device).to(
            memory_format=torch.channels_last) \
            if cfg.use_features and not cfg.load_features else None
        self.flags = loss_filter_flags(not cfg.no_gan_feat_loss,
                                       not cfg.no_vgg_loss, cfg.use_match_loss,
                                       cfg.use_hifigan_d or cfg.use_time_d)
        self.loss_names = [n for n, f in zip(LOSS_NAMES, self.flags) if f]

    def g_nets(self) -> Dict[str, torch.nn.Module]:
        """The nets the G optimizer trains by their JAX param-tree key:
        "G" (netG_train) and, with features, "E" (netE)."""
        return {k: n for k, n in (("G", self.netG_train), ("E", self.netE))
                if n is not None}

    def d_nets(self) -> Dict[str, torch.nn.Module]:
        """Every discriminator of a training system by its JAX param-tree
        key ("D", "time_D", "hifigan_D"): what the D optimizer trains."""
        return {k: n for k, n in (("D", self.netD), ("time_D", self.time_D),
                                  ("hifigan_D", self.hifigan_D))
                if n is not None}

    def _generator(self, fused: bool, int8: bool) -> torch.nn.Module:
        cfg = self.cfg
        return build_generator(
            cfg.net_g, self.g_input_nc, cfg.output_nc, cfg.ngf,
            cfg.n_downsample_global, cfg.n_blocks_global,
            cfg.n_local_enhancers, cfg.n_blocks_local,
            deconv_mode="torch" if cfg.torch_deconv else "same",
            fused_enh_blocks=fused, int8_trunk=int8,
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
        stride = generator_stride(cfg)
        if self.n_frames % stride:
            raise ValueError(
                f"segment_length {cfg.segment_length} gives {self.n_frames} "
                f"frames, not divisible by the generator stride {stride}; "
                f"pick segment_length = (16k-1)*hop like the default")
        return (batch, cfg.n_fft, self.n_frames, c)

    # ------------------------------------------------------------------
    def encode_input(self, lr_audio: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     group=None):
        """The lr side of the reference encode: always masked; with
        --use_time_D on a training system, norm_param["frames"] too. With
        `group`, over the whole batch split over its ranks
        (codec.to_spectro)."""
        return self.codec.to_spectro(lr_audio, mask=True, noise=noise,
                                     generator=generator,
                                     return_frames=self._need_frames,
                                     group=group)

    def encode_target(self, hr_audio: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      group=None):
        """The hr side of the reference encode: never masked (the random
        phase encodings draw from `generator`)."""
        return self.codec.to_spectro(hr_audio, mask=False, generator=generator,
                                     return_frames=self._need_frames,
                                     group=group)

    @property
    def _need_frames(self) -> bool:
        return self.cfg.is_train and self.cfg.use_time_d

    @torch.no_grad()
    def inference(self, lr_audio: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  feat_map: Optional[torch.Tensor] = None):
        """[B, S] lr waveform -> (sr_spectro f32 [B,F,T,C], lr_pha,
        lr_norm_param, lr_spectro). With features, `feat_map` ([B, F, T,
        feat_num], e.g. from sample_features) is concatenated onto the G
        input, which a feature config's G needs: without it the input is
        too narrow, and the JAX package's inference fails the same way.
        The G input is cast to the compute dtype and the G output to f32,
        as in the JAX package; a training system's G (f32 parameters) runs
        under autocast."""
        lr_spec, lr_pha, lr_norm = self.encode_input(lr_audio, noise, generator)
        g_in = lr_spec if feat_map is None else torch.cat(
            [lr_spec, feat_map.to(lr_spec)], dim=-1)
        if g_in.shape[-1] != self.g_input_nc:
            raise ValueError(
                f"G takes {self.g_input_nc} input channels, got "
                f"{g_in.shape[-1]}: a feature config (--instance_feat / "
                f"--label_feat) needs feat_map (sample_features); the JAX "
                f"package's inference fails without it as well")
        g_in = g_in.to(self.dtype).permute(0, 3, 1, 2)  # channels_last view
        with self._autocast() if self.cfg.is_train else contextlib.nullcontext():
            sr = self.netG(g_in).permute(0, 2, 3, 1).float()
        return sr, lr_pha, lr_norm, lr_spec

    def sample_features(self, inst: np.ndarray, cluster_path: str,
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Style sampling from precomputed k-means clusters on the host
        (numpy, as in the JAX package): for each instance id, one random
        cluster center of its label (the id, or id // 1000 from 1000 up),
        drawn from `rng` (default: a numpy generator seeded with cfg.seed),
        broadcast over the region. inst: [B, H, W] int ids; returns
        [B, H, W, feat_num] float32, zero where an id's label has no
        clusters."""
        clusters = np.load(cluster_path, allow_pickle=True).item()
        rng = rng or np.random.default_rng(self.cfg.seed)
        b, h, w = inst.shape
        feat = np.zeros((b, h, w, self.cfg.feat_num), np.float32)
        for i in np.unique(inst):
            label = int(i) if i < 1000 else int(i) // 1000
            if label not in clusters:
                continue
            centers = clusters[label]
            pick = centers[rng.integers(0, centers.shape[0])]
            feat[inst == i] = pick[: self.cfg.feat_num]
        return feat

    # ------------------------------------------------------------------
    def _autocast(self):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def d_apply(self, label_spec: torch.Tensor, image_spec: torch.Tensor):
        """netD on the NHWC pair concat(label, image) in the compute dtype."""
        x = torch.cat([label_spec, image_spec], dim=-1).to(self.dtype)
        return self.netD(x.permute(0, 3, 1, 2))

    def encode_features(self, spec: torch.Tensor,
                        inst: Optional[torch.Tensor]) -> torch.Tensor:
        """netE on an NHWC spectrogram in the compute dtype (under autocast),
        pooled over the instance ids `inst` ([B, H, W]; None: unpooled):
        [B, H, W, feat_num] in the compute dtype."""
        with self._autocast():
            feat = self.netE(spec.to(self.dtype).permute(0, 3, 1, 2), inst)
        return feat.permute(0, 2, 3, 1)

    def time_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """sqrt(up_ratio - 1) * window * the raw IDCT frames of a G output
        (codec.to_frames): [B, T, n_fft], f32."""
        scale = float(np.sqrt(self.cfg.up_ratio - 1).astype(np.float32))
        return scale * self.codec.mdct.window_t * frames

    def time_d_input(self, label_frames: torch.Tensor,
                     test_frames: torch.Tensor) -> torch.Tensor:
        """The time-domain D's pair [B, T, n_fft, 2]: the dB of |frames| of
        the label and of the tested signal, in f32."""
        mv = self.cfg.min_value
        return torch.stack([amplitude_to_db(label_frames.abs(), 20.0, mv, 1.0),
                            amplitude_to_db(test_frames.abs(), 20.0, mv, 1.0)],
                           dim=-1)

    def time_d_apply(self, x: torch.Tensor):
        """time_D on a time_d_input pair, in the compute dtype."""
        return self.time_D(x.to(self.dtype).permute(0, 3, 1, 2))

    def hifigan_d_apply(self, wav: torch.Tensor):
        """hifigan_D on a waveform [B, S], in the compute dtype."""
        return self.hifigan_D(wav[:, None, :].to(self.dtype))

    def losses_and_grads(self, batch: Dict[str, torch.Tensor],
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         pooled_fake: Optional[torch.Tensor] = None,
                         with_visuals: bool = False,
                         grads: Tuple[str, ...] = ("G", "D")
                         ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """One GAN step's losses, with the grads of the nets named in
        `grads` left in the .grad of their parameters (netG_train and netE
        for "G"; netD, time_D and hifigan_D for "D"; set anew, not
        accumulated; every other .grad is None).
        batch: {"label": lr [B, S], "image": hr [B, S]}; the lr mask noise
        is `noise` or drawn from `generator` (so are the random phase
        encodings' draws and, without explicit encoding, to_audio's
        pseudo-phase). D's fake term runs on `pooled_fake`
        ([B, F, T, 2C], the fake pool's pairs) where one is given, else on
        the pair of this step's G output; the time-domain and HiFi-GAN Ds
        always see this step's G output.

        With netE, the G input is the lr spectrogram and netE's pooled
        encoding of the hr one (instance ids lr_pha + 1); D sees the raw
        lr spectrogram. With cfg.remat_g, the G forward (netE's included)
        is rematerialized in the backward (remat_forward); the mask noise
        is drawn in the encode, before it, so the recompute draws nothing.

        Every loss is computed whatever `grads` holds, as in the JAX
        package, whose pool steps differentiate one net each and return
        all the losses. G runs forward once. The G losses are
        differentiated w.r.t. a detached leaf of the G output
        (torch.autograd.grad, so no discriminator's .grad takes anything
        from them) and pulled back through G; the D losses see the detached
        output. D's forward on the real pair runs once: its detached
        features are the feature-matching target, and it carries the grad
        of D_real. So a step runs 1 G and 3 D forwards, and 3 of each
        optional D. The codec half of the optional losses (the G output's
        frames and waveform) runs once, in f32 outside autocast, and its
        detached value feeds the D side (JAX computes it again there from
        the same input and rng, to the same value).
        Under data parallelism (`data_group`: parallel/dp.py) `batch` is
        this rank's rows of the global batch and `noise` the global batch's
        draw: the encode normalizes over the whole batch and every draw is
        the whole batch's (codec.to_spectro); each loss and grad is this
        rank's local mean, whose mean over the ranks (equal shares) is the
        global one; the returned losses are that mean, the same on every
        rank.
        Returns (the filtered losses, detached f32 scalars;
        {"sr": G output [B,F,T,C] f32, "fake_pair": the D input pair of
        this step's G output, and with `with_visuals` "visuals":
        visual_slices' first-sample [F, T] arrays})."""
        cfg = self.cfg
        use_lsgan = not cfg.no_lsgan
        train_g, train_d = "G" in grads, "D" in grads
        group = self.data_group
        with torch.no_grad():
            lr_spec, lr_pha, lr_norm = self.encode_input(batch["label"], noise,
                                                         generator, group)
            hr_spec, hr_pha, hr_norm = self.encode_target(batch["image"],
                                                          generator, group)
        for p in (q for nets in (self.g_nets(), self.d_nets())
                  for net in nets.values() for q in net.parameters()):
            p.grad = None
        zero = torch.zeros((), device=self.device)

        def g_forward():
            g_in = lr_spec.to(self.dtype)
            if self.netE is not None:
                # the encoder's instance map is lr_pha shifted to ids >= 0
                feat = self.encode_features(hr_spec, (lr_pha + 1.0).to(
                    torch.int32))
                g_in = torch.cat([g_in, feat.to(self.dtype)], dim=-1)
            out = self.netG_train(g_in.permute(0, 3, 1, 2))
            return out.permute(0, 2, 3, 1).float()

        with self._autocast():
            with torch.set_grad_enabled(train_g):
                sr = remat_forward(g_forward, cfg.remat_g if train_g else None)
            sr_leaf = sr.detach().requires_grad_(train_g)
            with torch.set_grad_enabled(train_d):
                pred_real = self.d_apply(lr_spec, hr_spec)
            with torch.set_grad_enabled(train_g):
                pred_fake = self.d_apply(lr_spec, sr_leaf)
                parts = {"G_GAN": gan_loss(pred_fake, True, use_lsgan),
                         "G_GAN_Feat": zero, "G_VGG": zero, "G_mat": zero,
                         "G_GAN_t": zero}
                if not cfg.no_gan_feat_loss:
                    target = [[f.detach() for f in scale] for scale in pred_real]
                    parts["G_GAN_Feat"] = feature_matching_loss(
                        pred_fake, target, cfg.n_layers_d, cfg.num_d,
                        cfg.lambda_feat)
        time_x = wav = None
        with torch.set_grad_enabled(train_g):
            with torch.autocast(self.device.type, enabled=False):
                if cfg.explicit_encoding and (cfg.use_match_loss
                                              or cfg.use_time_d):
                    frames = self.codec.to_frames(sr_leaf, lr_norm)
                    if cfg.use_match_loss:
                        parts["G_mat"] = match_loss(
                            frames, self.codec.mdct.window_t, cfg.win_length,
                            cfg.lambda_mat)
                if cfg.use_time_d:
                    time_x = self.time_d_input(lr_norm["frames"],
                                               self.time_frames(frames))
                if cfg.use_hifigan_d:
                    wav = self.codec.to_audio(sr_leaf, lr_norm, pha=lr_pha,
                                              generator=generator,
                                              group=group)
            with self._autocast():
                if time_x is not None:
                    parts["G_GAN_t"] = parts["G_GAN_t"] + gan_loss(
                        self.time_d_apply(time_x), True, use_lsgan) * cfg.lambda_time
                if wav is not None:
                    parts["G_GAN_t"] = parts["G_GAN_t"] + gan_loss(
                        self.hifigan_d_apply(wav), True, use_lsgan) * cfg.lambda_time
        if train_g:
            g_total = sum(parts[k] for k in ("G_GAN", "G_mat", "G_GAN_Feat",
                                             "G_VGG", "G_GAN_t"))
            (sr_bar,) = torch.autograd.grad(g_total, sr_leaf)
            sr.backward(sr_bar)

        sr_d = sr.detach()
        fake_pair = torch.cat([lr_spec, sr_d], dim=-1)
        real_x = None if time_x is None else self.time_d_input(
            lr_norm["frames"], hr_norm["frames"])
        with self._autocast(), torch.set_grad_enabled(train_d):
            d_in = fake_pair if pooled_fake is None else pooled_fake
            pred_fake = self.netD(d_in.to(self.dtype).permute(0, 3, 1, 2))
            parts["D_fake"] = gan_loss(pred_fake, False, use_lsgan)
            parts["D_real"] = gan_loss(pred_real, True, use_lsgan)
            parts["D_fake_t"] = parts["D_real_t"] = zero
            for fake_in, real_in, apply in (
                    (time_x, real_x, self.time_d_apply),
                    (wav, batch["image"], self.hifigan_d_apply)):
                if fake_in is None:
                    continue
                parts["D_fake_t"] = parts["D_fake_t"] + gan_loss(
                    apply(fake_in.detach()), False, use_lsgan) * cfg.lambda_time
                parts["D_real_t"] = parts["D_real_t"] + gan_loss(
                    apply(real_in), True, use_lsgan) * cfg.lambda_time
        if train_d:
            ((parts["D_fake"] + parts["D_real"]) * 0.5
             + (parts["D_fake_t"] + parts["D_real_t"]) * 0.5).backward()

        losses = filter_losses({k: v.detach() for k, v in parts.items()},
                               self.flags)
        if group is not None and group.size > 1:
            # one all-reduce: the mean of the ranks' local means
            mean = group.all_reduce_sum(torch.stack(
                [v.float() for v in losses.values()])) / group.size
            losses = dict(zip(losses, mean.unbind()))
        aux = {"sr": sr_d, "fake_pair": fake_pair}
        if with_visuals:
            aux["visuals"] = self.visual_slices(lr_spec, sr_d, hr_spec, hr_pha)
        return losses, aux

    def visual_slices(self, lr_spec: torch.Tensor, sr: torch.Tensor,
                      hr_spec: torch.Tensor, hr_pha: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """First-sample [F, T] visual tensors: the channel-mean magnitudes of
        lr, sr and hr, and with explicit encoding the sr pseudo-phase
        sign(sr0 - sr1), the hr phase and their difference."""
        if not self.cfg.explicit_encoding:
            return {"label": lr_spec[0, :, :, 0], "generated": sr[0, :, :, 0],
                    "real": hr_spec[0, :, :, 0]}
        sr_pha = torch.sign(sr[0, :, :, 0] - sr[0, :, :, 1])
        return {"label": 0.5 * (lr_spec[0, :, :, 0] + lr_spec[0, :, :, 1]),
                "generated": 0.5 * (sr[0, :, :, 0] + sr[0, :, :, 1]),
                "real": 0.5 * (hr_spec[0, :, :, 0] + hr_spec[0, :, :, 1]),
                "label_pha": hr_pha[0] - sr_pha, "generated_pha": sr_pha,
                "real_pha": hr_pha[0]}
