#!/bin/bash
# Real-speech micro-soak on the PyTorch port: scripts/realspeech_soak.sh
# with train.py, eval_matric.py and tools/prep_realspeech.py swapped for
# their jax-free twins (train_torch.py, eval_matric_torch.py,
# tools/prep_realspeech_torch.py); every command is the original's.
#
# tools/prep_realspeech_torch.py windows the reference checkout's
# committed real 48 kHz speech (test/test.wav +
# generated/GEN_VCTK_G3L2_48ngf/hr_audio.wav; pass `--ref DIR`, which
# the script hands to the tool with its other arguments) into 160
# flagship-shaped segments with two held-out tails that share no samples
# with training. CORPUS and CKPT keep the original's defaults: set both.
# Recipe = the flagship VCTK_G3L2_48ngf production config
# (scripts/train_recipes_torch.sh Family F) at micro-corpus scale:
# 128 train / 32 val files, batch 64 -> 2 steps/epoch, 200 epochs,
# fix-global 30, LR decay from epoch 150.
set -e

CORPUS=${CORPUS:-/tmp/realspeech}
CKPT=${CKPT:-/tmp/realspeech_ck}
NAME=${NAME:-rs_soak}
# add --include_sr_variants to prep for the augmented
# (data-limited-hypothesis) variant: the same held-out files either way.
python tools/prep_realspeech_torch.py --out "$CORPUS" "$@"

FLAGSHIP="--no_instance --no_vgg_loss --label_nc 0 --output_nc 2 --input_nc 2 \
 --nThreads 16 --mask --mask_mode mode2 --netG local --abs_spectro --center \
 --explicit_encoding --n_blocks_global 3 --n_blocks_local 2 --ngf 48 \
 --use_match_loss"

python train_torch.py --name "$NAME" --checkpoints_dir "$CKPT" \
  --dataroot "$CORPUS/train" $FLAGSHIP \
  --batchSize 64 --niter 150 --niter_decay 50 --niter_fix_global 30 \
  --validation_split 0.2 --eval_freq 1280 --eval_size 32 \
  --save_latest_freq 2560 --save_epoch_freq 100 --print_freq 256

# Held-out eval: the two tail files, never seen in training.
python eval_matric_torch.py --name "${NAME}_eval" --checkpoints_dir "$CKPT" \
  --dataroot "$CORPUS/eval" --load_pretrain "$CKPT/$NAME" $FLAGSHIP \
  --batchSize 2 --niter 1 --validation_split 0
