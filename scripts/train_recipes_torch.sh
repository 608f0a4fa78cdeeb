#!/bin/bash
# Experiment recipes on the PyTorch port: scripts/train_recipes.sh with
# train.py, eval_matric.py and generate_audio.py swapped for their
# jax-free twins (train_torch.py, eval_matric_torch.py,
# generate_audio_torch.py); every command is the original's.
# Sources: the reference's train_script.sh (all families),
#          test/ablation_study.sh  (2x ladder, lr 24 kHz),
#          test/ablation_study1.sh (4x ladder, lr 12 kHz).
# Generator param counts match the reference ladder exactly:
#   G9L3@64 = 730,713,346   G7L3@64 = 579,710,210   G5L3@64 = 428,707,074
#   G3L2@64 = 277,408,770   G3L2@48 = 156,050,690   G3L2@32 = 69,363,202
#   G3L2@24 = 39,020,930    G3L2@16 = 17,346,306    G3L2@8  = 4,339,330
#   marginal: +75,501,568 per global block, +295,168 per local block
# D @ (4ch in, ndf 64, 3 layers, num_D 2) = 5,531,522
#
# $HIFITTS / $VCTK point at the dataset roots. The reference's --fp16 maps
# to the port's default bf16 compute (no flag needed); the CLIs run on the
# card (--device cuda, their default), and torchrun with --tp_shards /
# --cp_shards spreads a run over ranks in place of --gpu_id.
set -e

# Some reference recipes load checkpoints that no recipe in the committed
# reference train_script.sh produces either (hifitts_vctk_pha2_*_6x at its
# lines 83/89, VCTK_hifitts_G3L2_48ngf_time_D at line 96 — runs from outside
# the script). Names are kept verbatim for parity; `run_if_ckpt` skips such a
# step with a warning instead of letting set -e abort the remaining families.
run_if_ckpt() {
  local ckpt="$1"; shift
  if [ -d "$ckpt" ]; then
    "$@"
  else
    echo "SKIP (pretrain checkpoint $ckpt not found — produced outside" \
         "the committed reference script; train it or drop --load_pretrain):" \
         "$*" >&2
  fi
}

COMMON="--no_instance --no_vgg_loss --label_nc 0 --output_nc 2 --input_nc 2 \
 --nThreads 16 --mask --mask_mode mode2 --netG local --abs_spectro --center \
 --explicit_encoding --validation_split 0.01"

# Single-channel (implicit / magnitude-only) variant of COMMON — the
# reference's early train_script.sh families use output_nc/input_nc 1.
COMMON1="--no_instance --no_vgg_loss --label_nc 0 --output_nc 1 --input_nc 1 \
 --nThreads 16 --mask --validation_split 0.01"

# =====================================================================
# Family A — phase-encoding ablations (train_script.sh:1-7)
# =====================================================================
python train_torch.py --name mdct_explicit_phase_coding_mode0 --dataroot "$VCTK/wav48" \
  $COMMON1 --batchSize 10 --explicit_encoding --mask_mode mode0
python train_torch.py --name mdct_explicit_phase_coding_mode1 --dataroot "$VCTK/wav48" \
  $COMMON1 --batchSize 10 --explicit_encoding --mask_mode mode1
python train_torch.py --name mdct_implicit_phase_coding --dataroot "$VCTK/wav48" \
  --no_instance --no_vgg_loss --label_nc 0 --output_nc 2 --input_nc 2 \
  --nThreads 16 --mask --validation_split 0.01 \
  --batchSize 10 --instance_feat --feat_num 1
python train_torch.py --name mdct_implicit_phase_coding_mask0 --dataroot "$VCTK/wav48" \
  --no_instance --no_vgg_loss --label_nc 0 --output_nc 2 --input_nc 2 \
  --nThreads 16 --mask --mask_mode mode0 --validation_split 0.01 \
  --batchSize 10 --instance_feat --feat_num 1

# =====================================================================
# Family B — codec / segment variants (train_script.sh mdct_2048,
# mdct_hifitts_pretrain @ segment_length 25500)
# =====================================================================
python train_torch.py --name mdct_2048 --dataroot "$VCTK/wav48" \
  $COMMON1 --batchSize 8 --mask_mode mode0 --n_fft 2048 --win_length 2048
python train_torch.py --name mdct_hifitts_pretrain --dataroot "$HIFITTS/audio.csv" \
  $COMMON1 --batchSize 30 --mask_mode mode2 --segment_length 25500
python train_torch.py --name mdct_VCTK_with_pretrain_glob --dataroot "$VCTK/wav48" \
  $COMMON1 --batchSize 30 --mask_mode mode2 --segment_length 25500 \
  --load_pretrain ./checkpoints/mdct_hifitts_pretrain --niter 50 --niter_decay 50

# =====================================================================
# Family C — HiFi-TTS pretrain ladder (train_script.sh "ablation study"):
# every generator size the reference pretrains, incl. the 730M DEFAULT.
# =====================================================================
python train_torch.py --name mdct_hifitts_pretrain_explict_pha2 --dataroot "$HIFITTS/audio.csv" \
  $COMMON --batchSize 32 --niter 20 --niter_decay 10
# G: 730,713,346 D: 5,531,522   (netG local default = G9L3 @ ngf 64)

for CONF in "G7L3:7:3:64" "G5L3:5:3:64" "G3L2:3:2:64" "G3L2_48ngf:3:2:48" \
            "G3L2_32ngf:3:2:32" "G3L2_24ngf:3:2:24" "G3L2_16ngf:3:2:16" \
            "G3L2_8ngf:3:2:8"; do
  IFS=: read -r TAG GB LB NGF <<< "$CONF"
  python train_torch.py --name "mdct_hifitts_pha2_${TAG}" --dataroot "$HIFITTS/audio.csv" \
    $COMMON --batchSize 32 --niter 10 --niter_decay 0 \
    --n_blocks_global "$GB" --n_blocks_local "$LB" --ngf "$NGF"
done
# G7L3: 579,710,210  G5L3: 428,707,074  G3L2: 277,408,770
# 48ngf: 156,050,690  32ngf: 69,363,202  24ngf: 39,020,930
# 16ngf: 17,346,306   8ngf: 4,339,330    (D always 5,531,522)

# =====================================================================
# Family D — up-ratio finetune ladders from the pretrained 730M default
# (train_script.sh mdct_VCTK_with_pretrain_explict_pha_{2x,3x,4x,6x})
# =====================================================================
for RATE in 24000:2x 16000:3x 12000:4x 8000:6x; do
  IFS=: read -r SR TAG <<< "$RATE"
  python train_torch.py --name "mdct_VCTK_with_pretrain_explict_pha_${TAG}" \
    --dataroot "$VCTK/wav48" \
    --load_pretrain ./checkpoints/mdct_hifitts_pretrain_explict_pha2 --continue_train \
    $COMMON --batchSize 32 --niter 20 --niter_decay 10 --lr_sampling_rate "$SR"
done

# =====================================================================
# Family E — depth/width ablation finetunes at 2x and 4x
# (test/ablation_study.sh = 2x @ lr 24 kHz; ablation_study1.sh = 4x @ 12 kHz)
# =====================================================================
for SRTAG in "24000:2x" "12000:4x"; do
  IFS=: read -r SR UP <<< "$SRTAG"
  for CONF in "G7L3:7:3:64" "G5L3:5:3:64" "G3L2:3:2:64" "G3L2_48ngf:3:2:48"; do
    IFS=: read -r TAG GB LB NGF <<< "$CONF"
    python train_torch.py --name "hifitts_vctk_pha2_${TAG}_${UP}" \
      --dataroot "$VCTK/train.csv" \
      --load_pretrain "./checkpoints/mdct_hifitts_pha2_${TAG}" \
      $COMMON --batchSize 32 --niter 20 --niter_decay 10 --validation_split 0 \
      --n_blocks_global "$GB" --n_blocks_local "$LB" --ngf "$NGF" \
      --lr_sampling_rate "$SR" --save_epoch_freq 30
  done
done

# =====================================================================
# Family F — flagship 6x production pipeline with match loss
# (train_script.sh mdct_hifitts_phaloss_* && hifitts_vctk_phaloss_*)
# =====================================================================
python train_torch.py --name mdct_hifitts_phaloss_G3L2_48ngf_6x --dataroot "$HIFITTS/audio.csv" \
  $COMMON --batchSize 64 --niter 50 --niter_decay 50 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --use_match_loss \
  --save_epoch_freq 40 --save_latest_freq 2000
python train_torch.py --name hifitts_vctk_phaloss_G3L2_48ngf_6x --dataroot "$VCTK/train.csv" \
  --load_pretrain ./checkpoints/mdct_hifitts_phaloss_G3L2_48ngf_6x \
  $COMMON --batchSize 64 --niter 100 --niter_decay 50 --validation_split 0 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --use_match_loss \
  --save_epoch_freq 40 --save_latest_freq 2000
run_if_ckpt ./checkpoints/hifitts_vctk_pha2_G3L2_48ngf_6x \
python train_torch.py --name VCTK_G3L2_48ngf --dataroot "$VCTK/wav48" \
  --load_pretrain ./checkpoints/hifitts_vctk_pha2_G3L2_48ngf_6x \
  $COMMON --batchSize 64 --niter 50 --niter_decay 50 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --use_match_loss \
  --eval_freq 5000 --save_latest_freq 2000 --save_epoch_freq 20
run_if_ckpt ./checkpoints/hifitts_vctk_pha2_G3L2_48ngf_6x \
python train_torch.py --name VCTK_G3L2_48ngf_match_loss_mse --dataroot "$VCTK/wav48" \
  --load_pretrain ./checkpoints/hifitts_vctk_pha2_G3L2_48ngf_6x \
  $COMMON --batchSize 32 --niter 50 --niter_decay 50 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --use_match_loss \
  --eval_freq 5000 --save_latest_freq 2000 --save_epoch_freq 20

# ---- VCTK 16 kHz -> 48 kHz (3x) production variant (README.md:137-153)
python train_torch.py --name VCTK_G3L2_48ngf_3x --dataroot "$VCTK/wav48" \
  $COMMON --batchSize 64 --niter 50 --niter_decay 50 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --lr_sampling_rate 16000

# =====================================================================
# Family G — time-domain discriminator variants (train_script.sh
# hifitts_G3L2_48ngf_time_D / _time_loss(hifigan) / VCTK time_D+match /
# G5L3 time_D @ lambda 5)
# =====================================================================
python train_torch.py --name hifitts_G3L2_48ngf_time_D --dataroot "$HIFITTS/audio.csv" \
  $COMMON --batchSize 32 --niter 100 --niter_decay 50 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --use_time_D --lambda_time 10 \
  --eval_freq 5000 --save_latest_freq 2000 --save_epoch_freq 20
python train_torch.py --name hifitts_G3L2_48ngf_time_loss --dataroot "$HIFITTS/audio.csv" \
  $COMMON --batchSize 32 --niter 100 --niter_decay 50 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --use_hifigan_D \
  --eval_freq 5000 --save_latest_freq 2000 --save_epoch_freq 20
run_if_ckpt ./checkpoints/VCTK_hifitts_G3L2_48ngf_time_D \
python train_torch.py --name VCTK_hifitts_G3L2_48ngf_time_D_match --dataroot "$VCTK/train.csv" \
  --load_pretrain ./checkpoints/VCTK_hifitts_G3L2_48ngf_time_D --continue_train \
  $COMMON --batchSize 64 --niter 50 --niter_decay 0 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 \
  --use_time_D --lambda_time 10 --use_match_loss \
  --eval_freq 5000 --save_latest_freq 2000 --save_epoch_freq 20
python train_torch.py --name VCTK_hifitts_G5L3_48ngf_log_time_D_3 --dataroot "$VCTK/train.csv" \
  $COMMON --batchSize 64 --niter 30 --niter_decay 20 \
  --n_blocks_global 5 --n_blocks_local 3 --ngf 48 --use_time_D --lambda_time 5 \
  --eval_freq 8000 --save_latest_freq 2000 --save_epoch_freq 20

# =====================================================================
# Family H — evaluation + generation (train_script.sh eval/generate recipes)
# =====================================================================
python eval_matric_torch.py --name eval_hifitts_vctk_phaloss_G3L2_48ngf_6x \
  --dataroot "$VCTK/test.csv" \
  --load_pretrain ./checkpoints/hifitts_vctk_phaloss_G3L2_48ngf_6x \
  $COMMON --batchSize 64 --niter 1 --validation_split 0 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48
python generate_audio_torch.py --name gen_hifitts_vctk_phaloss_G3L2_48ngf_6x \
  --dataroot "$VCTK/wav48/p225/p225_002.wav" \
  --load_pretrain ./checkpoints/hifitts_vctk_phaloss_G3L2_48ngf_6x \
  $COMMON --batchSize 4 --serial_batches --phase test --validation_split 0 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48
python generate_audio_torch.py --name pha2_G3L2_48_2x_gen \
  --dataroot "$VCTK/wav48/p227/p227_004.wav" \
  --load_pretrain ./checkpoints/hifitts_vctk_pha2_G3L2_48ngf_2x \
  $COMMON --batchSize 4 --serial_batches --phase test --validation_split 0 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48 --lr_sampling_rate 24000
run_if_ckpt ./checkpoints/VCTK_G3L2_48ngf_match_loss_mse \
python generate_audio_torch.py --name GEN_VCTK_G3L2_48ngf_match_loss_mse \
  --dataroot ./test/test.wav \
  --load_pretrain ./checkpoints/VCTK_G3L2_48ngf_match_loss_mse \
  $COMMON --batchSize 4 --serial_batches --phase test --validation_split 0 \
  --n_blocks_global 3 --n_blocks_local 2 --ngf 48
