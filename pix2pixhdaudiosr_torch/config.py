"""Configuration system (a copy of pix2pixhdaudiosr_tpu/config.py, kept in
the port so that it loads nothing of the JAX package).

Mirrors the reference three-tier argparse registry
(reference options/base_options.py:11-72, options/train_options.py:5-55,
options/test_options.py:4-17) and the compile-time audio constants
(reference options/audio_config.py:1-12) as one frozen dataclass with a CLI
override layer and `opt.txt` provenance dump
(reference options/base_options.py:98-107).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Audio constants (reference options/audio_config.py:1-12)
# ---------------------------------------------------------------------------
N_FFT = 512
HOP_LENGTH = 256
WIN_LENGTH = 512
LR_SAMPLE_RATE = 8000
HR_SAMPLE_RATE = 48000
BINS = 128
assert BINS % 16 == 0  # must be divisible by 16 so conv down/upsampling round-trips
CENTER = True
if CENTER:
    FRAME_LENGTH = (BINS - 1) * HOP_LENGTH  # 32512
else:
    FRAME_LENGTH = (BINS - 1) * HOP_LENGTH + WIN_LENGTH


@dataclass(frozen=True)
class Config:
    """All experiment options. Field names follow the reference flags."""

    # --- experiment specifics (reference options/base_options.py:13-23)
    name: str = "audiosr_tpu"
    checkpoints_dir: str = "./checkpoints"
    model: str = "pix2pixHD"
    norm: str = "instance"            # instance | batch
    use_dropout: bool = False
    data_type: int = 32
    verbose: bool = False
    fp16: bool = False                 # reference AMP flag; here: bf16 compute
    seed: int = 1234
    is_train: bool = True

    # --- input/output sizes (reference options/base_options.py:26-31)
    batch_size: int = 1
    label_nc: int = 0
    input_nc: int = 2
    output_nc: int = 2

    # --- inputs (reference options/base_options.py:34-41)
    dataroot: str = ""
    eval_dataroot: str = ""
    serial_batches: bool = False
    n_threads: int = 2
    max_dataset_size: int = 2**63 - 1
    alpha: float = 0.6                 # phase encoding factor

    # --- generator (reference options/base_options.py:48-54)
    net_g: str = "global"             # global | local | encoder
    ngf: int = 64
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    niter_fix_global: int = 0

    # --- instance-wise features (reference options/base_options.py:57-64)
    no_instance: bool = True
    instance_feat: bool = False
    label_feat: bool = False
    feat_num: int = 3
    load_features: bool = False
    n_downsample_e: int = 4
    nef: int = 16
    n_clusters: int = 10

    # --- mask options (reference options/base_options.py:67-70)
    mask: bool = False
    mask_mode: Optional[str] = None   # None | mode0 | mode1 | mode2
    explicit_encoding: bool = False
    min_value: float = 1e-7

    # --- display / cadence (reference options/train_options.py:8-15)
    display_freq: int = 100
    print_freq: int = 100
    save_latest_freq: int = 500
    save_epoch_freq: int = 10
    eval_freq: int = 2000
    no_html: bool = False
    debug: bool = False
    abs_spectro: bool = False
    tf_log: bool = False

    # --- training (reference options/train_options.py:18-29)
    continue_train: bool = False
    load_pretrain: str = ""
    which_epoch: str = "latest"
    phase: str = "train"
    niter: int = 100
    niter_decay: int = 100
    beta1: float = 0.5
    lr: float = 0.0002
    validation_split: float = 0.05
    val_indices: Optional[str] = None
    eval_size: int = 100
    phase_encoding_mode: Optional[str] = None

    # --- discriminators (reference options/train_options.py:32-44)
    num_d: int = 2
    n_layers_d: int = 3
    ndf: int = 64
    lambda_feat: float = 10.0
    lambda_mat: float = 10.0
    lambda_time: float = 0.4
    no_gan_feat_loss: bool = False
    no_vgg_loss: bool = True
    use_match_loss: bool = False
    no_lsgan: bool = False
    pool_size: int = 0
    use_hifigan_d: bool = False
    use_time_d: bool = False

    # --- STFT params (reference options/train_options.py:47-54)
    lr_sampling_rate: int = LR_SAMPLE_RATE
    hr_sampling_rate: int = HR_SAMPLE_RATE
    segment_length: int = FRAME_LENGTH
    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    win_length: int = WIN_LENGTH
    center: bool = True
    is_lr_input: bool = False

    # --- test-only (reference options/test_options.py:6-16)
    results_dir: str = "./results"
    how_many: int = 50
    cluster_path: str = "features_clustered_010.npy"
    use_encoded_image: bool = False

    # --- TPU-native additions (no reference analog; see SURVEY.md §2.3)
    mesh_shape: Tuple[int, ...] = (-1,)     # -1: all visible devices on one axis
    mesh_axes: Tuple[str, ...] = ("data",)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    frames_per_segment: int = BINS
    zero_opt_state: bool = False     # ZeRO-1 moment sharding (parallel/zero.py)
    fsdp: bool = False     # FSDP/ZeRO-3 param+moment sharding (parallel/fsdp.py)
    tp_shards: int = 1    # Megatron TP over resblock channels at inference
    #                       (parallel/tp.py shard_generator_params; the 730M
    #                       default G motivates it — SURVEY.md §2.3)
    cp_shards: int = 1    # frame-axis context-parallel SEAMLESS long-audio
    #                       inference (parallel/halo.py): the whole file is
    #                       one spectrogram sharded over frames, vs the
    #                       reference's independent chunks with audible seams
    #                       (reference generate_audio.py:43-47)
    remat_g: str = ""     # rematerialize the G forward in the backward:
    #                       "" (off), "full", or "dots" (keep MXU outputs).
    #                       Bit-exact grads; trades HBM capacity for ~8-20%
    #                       step time on v5e (BASELINE.md remat experiment) —
    #                       for models too large to train without it
    hifigan_scales: int = 3  # MSD scale count for --use_hifigan_D (the
    #                          reference's submodule exposes the same
    #                          constructor knobs; defaults = HiFi-GAN paper)
    hifigan_periods: str = "2,3,5,7,11"  # MPD periods, comma-separated
    adam_mu_bf16: bool = False  # store the Adam FIRST moment in bf16
    #                             (optax mu_dtype; nu stays f32 for update
    #                             precision). A memory knob for
    #                             beyond-flagship models: saves 4 bytes/param
    #                             of optimizer state (~2.9 GB on the 730M
    #                             default G) — see benchmarks/trainstep_hbm.py
    #                             for the measured flagship-step effect
    fast_conv: bool = True  # Toeplitz lane-packing for the tiny-channel
    #                         final convs (models/layers.py conv_toeplitz_t;
    #                         exact to f32 roundoff; --no_fast_conv disables)
    torch_deconv: bool = False  # bit-exact torch ConvTranspose2d semantics
    #                             for checkpoints imported from the reference
    #                             (tools/import_torch_checkpoint.py; flax's
    #                             SAME deconv crop is one pixel off torch's)
    int8_trunk: bool = False  # int8-MXU compute for the coarse-trunk
    #                           resblocks at inference (ops/quant.py
    #                           int8_resblock_stack). The int8 dot itself
    #                           runs 2.4x the bf16 MXU rate, but on v5e the
    #                           in-graph quantization overheads make the
    #                           full forward SLOWER (58.2 vs 50.7 ms at
    #                           batch 128 — BASELINE.md); opt-in only.
    fused_enhancer: bool = False  # Pallas fused enhancer-resblock chain at
    #                               inference (ops/enhancer_pallas.py; bf16,
    #                               batch a multiple of 128 required).
    #                               Default OFF: on v5e the measured win over
    #                               XLA's lowering is within noise (see
    #                               BASELINE.md round-2 kernel campaign);
    #                               kept as a tested option for future chips

    # ------------------------------------------------------------------
    @property
    def up_ratio(self) -> float:
        return self.hr_sampling_rate / self.lr_sampling_rate

    @property
    def netg_input_nc(self) -> int:
        nc = self.label_nc if self.label_nc != 0 else self.input_nc
        if not self.no_instance:
            nc += 1
        if self.use_features:
            nc += self.feat_num
        return nc

    @property
    def netd_input_nc(self) -> int:
        nc = (self.label_nc if self.label_nc != 0 else self.input_nc) + self.output_nc
        if not self.no_instance:
            nc += 1
        return nc

    @property
    def use_features(self) -> bool:
        return self.instance_feat or self.label_feat

    @property
    def expr_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.name)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def apply_debug(self) -> "Config":
        """--debug semantics (reference train.py:72-77)."""
        if not self.debug:
            return self
        return self.replace(display_freq=1, print_freq=1, niter=1, niter_decay=0,
                            max_dataset_size=10)

    def save_opt_txt(self) -> str:
        """Persist all options, `opt.txt` parity (reference options/base_options.py:98-107)."""
        os.makedirs(self.expr_dir, exist_ok=True)
        path = os.path.join(self.expr_dir, "opt.txt")
        if self.continue_train:
            return path
        with open(path, "w") as f:
            f.write("------------ Options -------------\n")
            for k, v in sorted(dataclasses.asdict(self).items()):
                f.write("%s: %s\n" % (k, v))
            f.write("-------------- End ----------------\n")
        return path


# ---------------------------------------------------------------------------
# CLI layer
# ---------------------------------------------------------------------------

# Reference flags that have no meaning on this runtime, accepted so the
# reference's committed recipes (README.md:138-171, train_script.sh,
# test/ablation_study*.sh — all of which pass --gpu_id/--fp16/...) run
# verbatim. Each entry: flag -> (argparse default, notice printed when the
# user sets a non-default value). They are parsed, reported, and dropped —
# never stored in Config. (reference options/base_options.py:14,22,27-28,
# 36,38,44; options/test_options.py:6-16)
_IGNORED_REFERENCE_FLAGS = {
    "gpu_ids": ("0", "device selection is JAX's (JAX_PLATFORMS, --mesh_shape)"),
    "local_rank": (0, "multi-host setup is jax.distributed "
                      "(parallel/mesh.py:initialize_distributed)"),
    "loadSize": (1024, "image-path flag; the audio pipeline has no resize"),
    "fineSize": (512, "image-path flag; the audio pipeline has no crop"),
    "resize_or_crop": ("scale_width", "image-path flag"),
    "no_flip": (False, "image-path flag; audio is never flipped"),
    "display_winsize": (512, "image-path display flag"),
    "ntest": (None, "the eval CLI evaluates the whole validation set "
                    "(cap the corpus with --max_dataset_size)"),
    "aspect_ratio": (1.0, "image-path flag"),
    "export_onnx": (None, "ONNX/TRT export is replaced by XLA AOT: "
                          "tools/aot_engine.py"),
    "engine": (None, "TRT engines are replaced by XLA AOT: tools/aot_engine.py"),
    "onnx": (None, "ONNX/TRT is replaced by XLA AOT: tools/aot_engine.py"),
}

_FLAG_ALIASES = {
    # reference spelling -> dataclass field
    "batchSize": "batch_size",
    "nThreads": "n_threads",
    "netG": "net_g",
    "num_D": "num_d",
    "n_layers_D": "n_layers_d",
    "n_downsample_E": "n_downsample_e",
    "no_ganFeat_loss": "no_gan_feat_loss",
    "use_hifigan_D": "use_hifigan_d",
    "use_time_D": "use_time_d",
    "isTrain": "is_train",
}


def build_parser(defaults: Optional[Config] = None) -> argparse.ArgumentParser:
    cfg = defaults or Config()
    p = argparse.ArgumentParser(description=__doc__)
    for f in dataclasses.fields(Config):
        default = getattr(cfg, f.name)
        names = ["--" + f.name]
        for alias, target in _FLAG_ALIASES.items():
            if target == f.name:
                names.append("--" + alias)
        if f.type in ("bool", bool):
            # accept both --flag and --no_flag for every boolean, so the
            # reference recipes' --no_instance / --center style always works
            p.add_argument(*names, dest=f.name, action="store_true",
                           default=default)
            p.add_argument(*("--no_" + n[2:] for n in names), dest=f.name,
                           action="store_false", default=default)
        elif f.name in ("mesh_shape", "mesh_axes"):
            p.add_argument(*names, dest=f.name, type=str, default=None)
        else:
            typ = type(default) if default is not None else str
            p.add_argument(*names, dest=f.name, type=typ, default=default)
    for flag, (default, _) in _IGNORED_REFERENCE_FLAGS.items():
        if isinstance(default, bool):
            p.add_argument("--" + flag, dest="_ignored_" + flag,
                           action="store_true", default=default)
        else:
            typ = type(default) if default is not None else str
            p.add_argument("--" + flag, dest="_ignored_" + flag, type=typ,
                           default=default)
    return p


def parse_config(argv=None, defaults: Optional[Config] = None,
                 is_train: bool = True, save: bool = True) -> Config:
    """Parse CLI args to a Config; prints and persists opt.txt like
    reference options/base_options.py:74-108."""
    ns = build_parser(defaults).parse_args(argv)
    kw = vars(ns)
    for flag, (default, note) in _IGNORED_REFERENCE_FLAGS.items():
        value = kw.pop("_ignored_" + flag)
        if value != default:
            print(f"[config] --{flag} {value}: ignored on this runtime — {note}")
    if kw.get("mesh_shape") is None:
        kw["mesh_shape"] = (defaults or Config()).mesh_shape
    elif isinstance(kw["mesh_shape"], str):
        kw["mesh_shape"] = tuple(int(x) for x in kw["mesh_shape"].split(",") if x)
    if kw.get("mesh_axes") is None:
        kw["mesh_axes"] = (defaults or Config()).mesh_axes
    elif isinstance(kw["mesh_axes"], str):
        kw["mesh_axes"] = tuple(x for x in kw["mesh_axes"].split(",") if x)
    cfg = Config(**kw).replace(is_train=is_train)
    cfg = cfg.apply_debug()
    if cfg.remat_g not in ("", "full", "dots"):
        # reject typos at parse time — otherwise the error only fires when
        # the first train step is traced, minutes into a TPU run
        raise SystemExit(f"--remat_g must be 'full' or 'dots', "
                         f"got {cfg.remat_g!r}")
    print("------------ Options -------------")
    for k, v in sorted(dataclasses.asdict(cfg).items()):
        print("%s: %s" % (k, v))
    print("-------------- End ----------------")
    if save:
        cfg.save_opt_txt()
    return cfg
