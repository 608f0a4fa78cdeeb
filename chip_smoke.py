#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pix2pixhdaudiosr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from pix2pixhdaudiosr_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch twin at the flagship shapes
     (MDCT2/IMDCT2 at atol 1e-5 in f32, on the tensor-core route at batch
     128 and 1 (512/256) and on the FFMA route at 512/160; InstanceNorm at
     every flagship (H, W, C), within one bf16 ulp (+1e-6 near zero) in
     bf16 and at atol 1e-5 in f32, every call on the one-pass route and two
     runs bit-identical, and on a same-mode deconv crop read in place
     (timed per shape beside the two-pass kernels); the fused conv3x3_in at
     [128, 96, 256, 64] bf16 for each prologue on both routes (wgmma, the
     planner's choice, and mma.sync), y within one bf16 ulp (+1e-6
     max(1, max|y|) near zero), its mean and scale within 1e-4 of the
     channel's magnitude and bit-identical over two runs, each call
     counted on its route;
     conv3x3_valid at [64, 96, 258, 66] with and without ReLU on both
     routes, within one bf16 ulp (+ the same floor), both routes timed
     beside F.conv2d (B5) and cuDNN's bare conv (B4), with each entry's
     bound and share of it; the stochastic quantizer at [13824, 1536]
     (a flagship trunk conv weight as 2-D) and [1000, 136] on the
     planner's strip route (one launch, one read of x) and on the
     three-launch route, each call counted on its route, q and scale
     bit-identical and q * scale within one step of x, both routes timed
     (CUDA events; device time with the L2 evicted) beside the bound and
     its share), and time both with
     CUDA events, beside one PyTorch call computing the same function where
     there is one (library_ms) and the kernel's bound (bound_ms: bytes over
     HBM bandwidth or operations over their peak rate, the larger); then
     the int8 trunk conv at [128, 1536, 16, 4] bf16: its int32 accumulator
     on the card equal to the CPU's; and B2's backward (imdct2_grad: B1's
     kernel on the transposed inverse basis) at the HiFi-GAN recipe's
     [32, 128, 512] f32 against autograd through imdct2's twin (atol 1e-5
     max|dspec|, on the tensor-core route, and through ops/mdct.IMDCT2Fn
     with the codec's crop), timed beside its twin and autograd through
     the twin; B3's cross-shard entries (instance_moments,
     instance_apply: the context-parallel InstanceNorm's local moments and
     its normalize from all-reduced ones) at two flagship CP blocks
     ([1, 48, 512, 256], [1, 96, 256, 128]), a TP shape ([16, 768, 16,
     4]), a long file's block ([1, 48, 512, 2816]) and the trunk's
     [1, 1536, 16, 8] in f32 and bf16: the moments within 1e-6 of float64
     moments relative to each plane's scale (or no farther than the twin's
     f32 reduction) and bit-identical over two calls, the apply
     within 1e-5 (f32) and one bf16 ulp (bf16) of its twin, both composed
     as close to the one-launch norm's twin, a cropped view read in place
     with its contiguous copy's bits, a shard count of 3 the bits of the
     mean's apply, the arrival counts back at 0 and one CUDA kernel a call
     each (torch.profiler); each timed by events and by device time, L2
     warm and cold, beside its twin, its bound, torch.var_mean (the
     moments) and F.batch_norm (the apply at one sample);
  4. write a 5 s synthetic 48 kHz wav;
  5. build the flagship generator (LocalEnhancer G3L2, ngf 48, 156,050,690
     parameters) with seeded N(0, 0.02) weights, saved and loaded as .pth;
  6. run the port's generate CLI on it (bf16, batch 16), then with
     --fused_enhancer at batch 128 (the JAX gate needs B % 128), then with
     --data_type 8 --int8_trunk at batch 16, every kernel launch counter
     set to 0 just before each run;
  7. check their outputs (finite, right lengths, 48 kHz), that every
     kernel of each run was launched during it, that every MDCT2/IMDCT2
     launch took the tensor-core route (the `launches_tc` counters), that
     every InstanceNorm launch took the one-pass route (`launches_onepass`),
     that every conv3x3_in launch took the wgmma route (`launches_wgmma`),
     and that the quantized run printed "int8 weight quantization enabled";
     hold the CUDA serve path against the same path on the CPU in f32 on
     one segment, stage by stage; hold the fused G output against the
     unfused one on the card (bf16, one batch of 128, max|diff| <= 0.05
     max|unfused|), and the --int8_trunk and --data_type 8 G outputs
     against the plain one (correlation >= 0.99);
  8. time the batch-128 serve forward (encode + G + decode) in bf16, plain,
     --fused_enhancer and --int8_trunk in turns (plain, fused, int8, int8,
     fused, plain), and plain and int8 at batch 1 (plain, int8, int8,
     plain); trace one forward of each path with torch.profiler (device
     time by kernel) and count each kernel's launches in one forward, every
     InstanceNorm launch on the one-pass route (plain 22, fused 17, int8
     22) and the fused forward's 4 conv3x3_in launches on the wgmma route;
     print B3's time against its bound a shape, with its calls in a
     plain forward, and the flagship's int8 size against f32 and bf16;
  9. B3 with its gradient (models/layers.InstanceNormAct: the kernel
     forward, which saves each plane's mean and variance, and the backward
     kernel of csrc/instance_norm_bwd.cu) at the 6 generator, the 6
     discriminator and the 6 time-domain discriminator InstanceNorm shapes
     at batch 64, f32 and bf16: y against
     the twin (1e-5 in f32, one bf16 ulp in bf16), the saved statistics
     against the twin's, dx against the backward's twin and against
     autograd through the forward's twin (1e-4 max|dx| in f32, one bf16
     ulp + that floor in bf16), one backward launch a call on the
     planner's route and no dy copy, two runs bit-identical, 0 elements
     whose slope from the recomputed x^ differs from the slope read off
     y; the same checks with dy NCHW (as the reflect pad's backward and
     the feature-matching L1 hand it), read in place, its dx equal to its
     channels_last copy's; the backward kernel timed a shape in bf16
     (CUDA events; device time with the L2 warm and with it evicted
     before each call, the share of the bound read from the latter) on
     every route the shape has (one-pass, one-pass at a 16-byte tile,
     two-pass), dy channels_last and NCHW, beside its twin, the closed
     form, autograd through the twin and through F.instance_norm (the
     library yardstick) and its bound (3 planes; the 4-plane figure of
     earlier records beside it); then the
     same checks at the 10 shapes Family A's netE (nef 16) and G (ngf 64)
     add, at its batch 10, each route printed, the kernels timed without
     the yardsticks;
 10. one train step of a toy config (n_fft 64, LocalEnhancer ngf 4,
     PatchGAN ndf 4), CUDA against CPU in f32, plain, then with the
     recipes' --use_match_loss --use_time_D --lambda_time 10 (the frames'
     floor --min_value at 1e-3) and with --use_hifigan_D (TOY_RECIPES):
     every loss within rtol 1e-4 (+ 1e-9) of a CPU step on the card's
     InstanceNorm outputs (plain: of the independent CPU step too); B3's
     output at each of the step's InstanceNorm inputs within 4x the
     twin's distance (+ 1e-5) of a float64 InstanceNorm;
     against a CPU step that takes the card's InstanceNorm outputs, and
     one that takes the twin's at the card's inputs, every grad leaf
     within 1e-3 max|g| (a conv bias feeding an InstanceNorm, whose exact
     grad is 0, within 1e-3 of its net's max) and every updated weight
     within 2 lr (two opposite Adam steps); against the independent CPU
     step, D's grads within the same bound, time_D's and hifigan_D's
     within 1e-3 of their net's max, and G's within 40x the bound (with
     --use_time_D, of G's max); each CPU step on the card step's branch
     of every InstanceNorm activation and of the time-domain D's dB
     floor, where an element within rounding of a kink may fall either
     side (the independent step on its own branches is printed too); the
     backward kernel launched once for each InstanceNorm of the card step,
     with the HiFi-GAN D IMDCT2 and its backward once each, and G's grad
     from G_GAN_t alone not 0. The plain step also replays the card's
     encoder output into a CPU step and reads every generator conv output
     and the feature-matching L1's signs of both steps (the G-grad gap);
     the same reading of a toy step with the feature encoder netE
     (TOY_FEAT: --instance_feat), netE's grads against netE's max;
 11. the flagship train step (G and the 2-scale PatchGAN at ndf 64, bf16
     compute, f32 params and Adam moments) at batch 64 through
     trainer.make_train_step: 2 warm-up and 5 timed steps (ms/step,
     segments/s, peak GiB), B3 launches a step (40, all one-pass), its
     backward kernel's (40, shape by shape as the forward's; by route, and
     no dy copied: the 12 NCHW dy are read in place) and B1 tensor-core
     launches a step (2), every loss finite and every parameter moved,
     and a torch.profiler trace of one step split into forward, backward
     and optimizer, with the InstanceNorm backward's device ms (kernels
     and copies) and share, each kernel counted once (a CUPTI marker that
     shares an operator's id adds none) and the split held to itself and
     to CUDA events around the traced step (trace_problems: the parts
     within 1% of the kernels' sum, the device busy within 1.05x the
     events' span); then the two recipe steps at full
     width: --use_match_loss --use_time_D --lambda_time 10 at batch 64 and
     --use_hifigan_D at batch 32 (RECIPES), each the same measurements,
     every parameter of every net moved, launches a step as
     expected_step_launches (time-D: B3 and its backward 58, B1 2;
     HiFi-GAN: B3 40, B1 2, B2 1 and its backward 1, all on the fast
     routes) and the optional losses' codec half in f32 in the bf16 step;
     then the flagship step with each memory knob (KNOBS: --remat_g full,
     --remat_g dots, --adam_mu_bf16), the same measurements, B3 62 a step
     under remat (G's 22 recomputed; the backward 40), each remat step's
     peak at least REMAT_SAVING_GIB below the plain step's, and G's Adam
     moments 6 bytes a parameter with --adam_mu_bf16 (8 plain); and the remat
     grads on the card (batch 16) against the card's plain step: in f32
     within 4x the widest gap of three plain runs (+ 1e-6 of a net's
     max|g|), in bf16 read, and in bf16 each of G's 22 InstanceNorm inputs
     that --remat_g full and dots recompute in the backward equal to the
     forward's bit for bit (remat_norm_inputs);
 12. the training CLI (python -m pix2pixhdaudiosr_torch.train_loop) at
     flagship width on a synthetic wav corpus: 2 steps at batch 2 (B3 and
     its backward 80 launches each), then the generate CLI on the
     latest_net_G.pth it saved; then the CLI with the time-D recipe's
     flags for 2 steps at batch 2 and --continue_train from its `latest`
     (G, D and time_D equal to the saved weights before the first step);
     then Family A's instance-feature recipe (FAMILY_A, batch 10, netE at
     nef 16, G ngf 64, implicit encoding, --mask with no mode) through the
     CLI on 10 FLAC files: 2 steps and a resumed third, every decode on
     the native route, B3 and its backward as many a step as G, netE and
     3 D forwards hold InstanceNorms, G, netE and D equal to the saved
     weights before the resumed run's first step; then the converged-
     quality gate (tests/test_quality_gate.py: GATE_FLAGS on its 8-tone
     corpus, 32 steps at batch 4, an eval every 4 steps) through the CLI
     in f32 (TF32 off, as the CLI sets it): eval.csv's LSD and SNR meet
     the JAX gate's three thresholds (the last LSD below 2.8, more than
     0.4 below the first at its least, an SNR above the first), and every
     step launches B1 2, B3 and its backward 21 each, every eval batch B1
     1, B3 9, B2 1, each launch on the route its planner gives the shape
     (the trajectory and the leg's seconds printed: [quality gate]);
     then the flagship soak (phase_flagship_soak): the flagship recipe of
     scripts/realspeech_soak_torch.sh (tools/flagship_soak_torch.py,
     SOAK_FLAGS, bf16) at half its schedule (100 epochs of 2 steps at
     batch 64, fix-global to epoch 15, decay from 76) through the CLI on
     a seeded 160-file harmonic corpus, SIGINT after epoch 10 and
     --continue_train; every step launches B1 2, B3 and its backward 40,
     every eval batch B1 1, B3 22, B2 1, each on its planner's route; the
     fix-global switch printed once, after epoch 15; both learning rates
     0 after the last epoch; G, D and both Adams bit-equal to the saved
     state before the first resumed step; eval.csv within soak_misses'
     thresholds; then on the two held-out 3 s files the generate CLI on
     the trained G plain, --fused_enhancer (batch 128), --int8_trunk and
     --data_type 8 and on phase 5's seeded G (B1 1, B2 1 on the tensor
     cores, B3 22, fused B3 17 and B4 4 a file), held to serve_misses
     against the lowpassed input's and the untrained G's LSD
     ([flagship soak]; its checkpoints deleted);
 13. the CLIs at their default behaviours, flagship width, on 8 one-second
     files, FLAC (written by the port's write_flac) and wav: where
     matplotlib or PIL is missing, the training and generate CLIs without
     --no_html stop before any work, naming the package and --no_html
     (checked, and the runs below take --no_html); the training CLI with
     --validation_split 0.25 --eval_freq 2 --eval_size 0 --display_freq 2
     --tf_log (3 steps, an eval of one batch after each): eval.csv's 3
     rows finite, IMDCT2 launched once an eval batch and all on the
     tensor-core route, InstanceNorm 40 a step + 22 an eval batch (all
     one-pass), its backward 40 a step and none in an eval, MDCT2 2 a step
     + 1 an eval batch, an event file, and with
     the gallery web/index.html; one eval pass and a flagship train state's
     save and restore timed; a run in a process of its own sent SIGINT
     after its first loss line (latest and epoch-1 files, iter.txt
     "2,0"), then --continue_train from it ("Resuming from epoch 2", G
     equal to the saved one before the first step, the step count going
     on); 2 steps with --pool_size 2 (InstanceNorm 80 a step, its backward
     40) and the pool's host round trip at batch 64; the evaluate CLI on
     the training run's latest (B1, B2, B3 launches an eval batch, no
     backward); generate without
     --no_html (the gallery's lable_* images, or the stop);
 14. FLAC input's host time: one decode of a 5 s 48 kHz file, a batch of
     64 segments from one-second FLAC files without the resample cache,
     with it cold and warm, on the native route (the port's C++ decode and
     resample, runtime/native_audio.py; its OpenMP team at the default
     size and at 1) and on the Python route (data/flac.py's decoder, numpy
     resample_np); every FLAC decode of the run before it on the native
     route, and one item of each route equal within 1e-5.
 15. (run after phase 8) the serving parallel modes: generate --cp_shards
     4 in this process (one rank, one shard: the seamless full-length
     forward; B1, B2 and B3's cross-shard entries launched, no one- or
     two-pass B3); CP at 4 ranks and TP at 2 ranks, each a process of this
     script (`--rank-worker cp|tp`) joined over gloo on cuda:0 (ranks
     sharing a card cannot use NCCL) with a wall limit of its own, a rank
     that fails or hangs failing the phase: every layer kind at flagship
     width split over the ranks against its unsharded output in f32 within
     1e-5 max|y| (CP: the enhancer's and the trunk's layers and the pool;
     TP: a trunk and an enhancer resblock), the flagship G in f32 and bf16
     against the plain G in one process within 2x its rounding floor (how
     far the plain G's own output moves for a one-ulp change of its input
     or its InstanceNorms on the two-pass route; 1e-5 max|y| is read
     beside it), the cross-shard entries launched on every CP rank and
     none of the one-launch norm, B3 at C/N channels on the TP ranks, the
     gloo transport's bytes and each rank's wall time, and the generate
     CLI at those ranks (rank 0 writes the file). In the CP world, dp x cp
     serving: the 4 ranks as a 2 x 2 data x cp mesh
     (parallel.mesh.make_serving_layout), 2 seeded segments, each rank's
     block [1, 512, 64, 2] through make_cp_generator(..., batch_group=data),
     the G in f32 and bf16 against the plain G within 2x its rounding
     floor, B3m/B3a launched on every rank and no one-launch B3. In the TP
     world, the int8 trunk (--int8_trunk) under TP: each split trunk conv's
     int32 accumulator and scale equal to the one-rank conv's on the same
     input, 6 int8 convs a forward a rank and every InstanceNorm on B3's
     one-pass route (the trunk's at C/N = 768 channels), the G against the
     one-rank int8 G (bf16: correlation >= 0.99; f32: within 2x the plain
     G's floor), and generate --int8_trunk --tp_shards 2 (rank 0 writes
     the file). Each leg prints each rank's gloo bytes, wall ms and peak
     GiB. Then a bf16 timing leg,
     the one-rank CP forward of a 60 s synthetic file (11,264 frames): the
     G's wall ms, B3m + B3a device ms a forward and the kernels each
     cp_instance_norm call launches (torch.profiler), failing unless each
     is one B3m and one B3a kernel with no copy before the 5 cropped
     views.
 16. (after phase 15) the training half of the parallel modes. First, in
     this process, the reference's default G (G9L3 at ngf 64, G730:
     730,713,346 parameters checked on the card, seeded N(0, 0.02)):
     served at batch 128 in bf16 (system.inference + codec.imdct_eval; B1
     1, B3 36, B2 1 a forward, each launch's route printed, ms a batch by
     CUDA events, peak GiB), its f32 G at batch 1 against the CPU twin
     within 2x its rounding floor (rounding_floor), its GAN step at the
     recipe's batch 32 in bf16 (B1 2, B3 54, B3' 54 a step, ms/step, peak
     GiB, every loss finite), and B3 / B3' timed at its InstanceNorm
     planes beside their bounds (g730_in_timing). Then 2 ranks of this
     script (`--rank-worker dp|zero|fsdp`) sharing cuda:0 over gloo, at
     flagship width (PatchGAN ndf 64; the G 156,050,690 parameters, cut in
     the parity legs to one resblock in the trunk and one in the enhancer,
     DP_PARITY_DEPTH: 70,998,530), a wall
     limit of their own. Parity leg (f32, TF32 off, cuDNN's heuristic and
     deterministic algorithms, parity_cudnn; in this process each net runs
     on the ranks' row blocks, rank_blocks, so every row's forward is the
     one it has on its rank): 2 steps on a global batch of 8 (4 a rank)
     with the same
     mask noise, against the same steps in this process, each from the
     state that this process's step starts from (the seeded init; its
     `latest` after step 1 restored into another init and the mode
     applied: from a second step on, Adam makes whole ~lr steps of the
     first step's rounding, so 2 steps run on apart drift by up to ~4 lr),
     kind by kind (parity_bounds): G and D parameters within DP_PARAM_LR
     lr where the reference's grad is above 1e-3 of its leaf's max|g|
     (the conv biases feeding an InstanceNorm left out: there a step is
     the sign of rounding), each Adam moment within DP_MOMENT_REL of its
     leaf's max, the losses within DP_FLOOR_FACTOR x the rounding floor's
     and equal on both ranks; the rounding floor (this process's steps on
     the rows in 3 orders: as given, reversed, halves swapped, every batch
     sum reordered) within the same bounds, and 3 planted faults of the
     dp step (grads left unreduced; summed, not averaged; rounded to bf16
     before and after the all-reduce) beyond them;
     ZeRO's and FSDP's slices per shard_dim and the bytes held between
     steps (ZeRO: the moments about half; FSDP: the parameters too);
     ZeRO's `latest` restored in this process to the same third step
     (parity_bounds; losses rtol 1e-4). Timing leg (bf16): a batch of 64,
     32 a rank, 1 warm-up and 1 timed step a mode, every count set to 0
     just before them: per rank the step's wall time, gloo bytes
     (Group.traffic), peak CUDA memory and launches a step, B1 2 (on the
     tensor cores), B3 40 (one-pass) and B3' 40 asserted; FSDP's and DP's
     rank peaks printed side by side, and FSDP's gathered-bytes peak (it
     gathers a unit at a time: parallel/fsdp.py) within its two largest
     units' bytes. In the dp and fsdp worlds, last, the 730M G's step at 16
     rows a rank of a global 32 (bf16, one step after one warm-up,
     g730_rank): each rank's peak GiB, the bytes it holds between steps,
     FSDP's gathered-bytes peak (within its two largest units), gloo bytes
     and launches (B1 2, B3 54, B3' 54) a step, every rank's losses finite
     and equal; an FSDP rank's peak at least G730_FSDP_SAVING_GIB below
     every DP rank's and its parameter and moment bytes between steps at
     most G730_HELD_SHARE of DP's (g730_checks). In the dp world,
     the recipes under DP (DP_RECIPES: the time-D + match step and the
     HiFi-GAN D, f32, the parity leg's batch and depth): one step from the
     seeded init against the same step in this process (its rounding
     floor from the rows in DP_ORDERS), every kind within parity_bounds
     and the floor too (the time-domain D on the one-process step's
     branches of the dB floor, in every order and on each rank's rows:
     card_floor; the rank's step on its own branches read beside it, and
     the same step with its grads left unreduced beyond the bounds of G's
     kinds), the losses
     within DP_FLOOR_FACTOR x the floor's and equal on both ranks, B1, B3
     and B3' (and for HiFi-GAN B2 and B2') launched on each rank, with
     each rank's wall ms, gloo bytes and peak GiB. Then the training
     CLI under 2 ranks (`--rank-worker cli`, the launcher's variables as
     torchrun sets them) with --zero_opt_state, 2 steps on phase 12's
     corpus and --continue_train for 2 more (G and D equal to the saved
     ones before its first step).
 16b. (after phase 16) the long tail, which no serve or train path calls
     (phase_long_tail): MDCT4 -> IMDCT4 at the README recipe (1024/512
     kbd, [64, 130816]) and at 512/256 ([128, 32512]), and the legacy
     MCLT spectrogram round trip at 2048 with a sine window ([16,
     130816]), on B1 / B2: each output within 1e-5 of max|y| of its CPU
     twin on the same input, the round trip's MSE < 1e-10, one B1 and one
     B2 launch a transform on the tensor-core route, each direction timed;
     every transform of ops/dct.py and ops/dctlib.py at [64, 512] within
     1e-5 of max|y| of the CPU's (the Lee pair within twice the CPU's
     distance of the float64 recursion) and the Lee DCT against the basis
     product; the device resampler on the 5 s wav (48k -> 8k -> 48k)
     against resample_np; VGG19 (models/vgg.py) at [4, 3, 224, 224] f32
     within 1e-4 of each slice's max of the CPU's, one forward timed; the
     UI model's single_forward at the flagship config (bf16, [1, 512, 128,
     2]) bit-equal to system.netG (else within one bf16 ulp, said), 22
     one-pass B3 launches;
 17. (run last) the tools and entry points: torch.library.opcheck of every
     p2p operator's CUDA and fake impl at a flagship shape (op_case), each
     operator's output the eager wrapper's bits; the import round trip:
     the seeded flagship G under the reference's keys (reference_keys,
     built here) saved as a .pth, tools/import_torch_checkpoint_torch.py on
     it, generate_audio_torch.py --torch_deconv on the 5 s wav, its
     sr_audio.wav and float output bit-equal to the G loaded directly, B1,
     B3 and B2 launched on their fast routes; the AOT engine
     (tools/aot_engine_torch.py) at batch 4 with --out and at batch 128:
     export seconds, FLOPs (FlopCounterMode), peak GiB, engine and eager
     ms/call, the saved engine loaded and run in a process that imports
     only torch, the package and this script (jax blocked): one forward's
     launches (every kernel's counts reset and read there) B1 1
     and B3 22 on eager's routes and no other kernel's, its output within
     one bf16 ulp of eager's; file-to-file serving of the 5 s wav and a
     60 s one by the generate CLI: the wall time of generate_audio_torch.py
     in a process of its own (interpreter start, imports, CUDA context and
     the kernel library's load included; the checkpoint read from a warm
     page cache), 2 runs, beside a process's start-up alone (interpreter,
     imports, CUDA context, kernel library); in this process (warm) by
     utils/profiling.StepTimer (1 warm-up, 3 timed runs), then one run
     under utils/profiling.trace: the host ms of its spans (read +
     resample, load, serve, metrics, write) and the device ms of its
     kernels and copies.
Each phase prints its seconds ([phase] lines), and the script its total
([total], before the two JSON lines).
The line before the last is {"kernels": [...]} (`launches` from one
serve forward, for the InstanceNorm backward, which serving never
launches, from one flagship train step, and for B2's backward from one
HiFi-GAN recipe step; `serve_launches` from one plain serve forward,
`train_launches_per_step` from one flagship train step,
`recipe_launches_per_step` from one step of each recipe,
`knob_launches_per_step` from one step of each memory knob and
`family_a_launches_per_step` from one step of Family A's CLI run,
`dp_launches_per_step` from one bf16 step of phase 16 on rank 0, a mode
each; `g730_serve_launches` and `g730_launches_per_step` from one forward
and one step of phase 16's 730M G; `export_launches` from one forward of phase 17's exported engine;
`soak_launches` from one step, one eval batch and one plain serve of a
held-out file of phase 12's flagship soak;
for B3's cross-shard entries, from the one-rank generate --cp_shards
4 run);
the last line is {"ok": true, "device": {...}}. Without CUDA, or without the package beside
it, the script exits non-zero and prints no result. f32 comparisons run
with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 both False).
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_run")           # listed in .gitignore

SEG = 32512
# __graft_entry__._flagship_cfg as generate flags
FLAGSHIP = ["--netG", "local", "--ngf", "48", "--n_blocks_global", "3",
            "--n_blocks_local", "2", "--n_downsample_global", "4",
            "--n_local_enhancers", "1", "--input_nc", "2", "--output_nc", "2",
            "--label_nc", "0", "--no_instance", "--explicit_encoding",
            "--mask_mode", "mode2", "--compute_dtype", "bfloat16"]
# every distinct (H, W, C) an InstanceNorm of the flagship generator sees
IN_SHAPES = [(512, 128, 48), (256, 64, 96), (128, 32, 192), (64, 16, 384),
             (32, 8, 768), (16, 4, 1536)]
KERNELS = {
    "mdct2": ("pix2pixhdaudiosr_torch/csrc/mdct.cu",
              "pix2pixhdaudiosr_tpu/ops/dct_pallas.py:85"),
    "imdct2": ("pix2pixhdaudiosr_torch/csrc/mdct.cu",
               "pix2pixhdaudiosr_tpu/ops/dct_pallas.py:134"),
    # B2's gradient: B1's kernel on the transposed inverse basis (XLA
    # differentiates the JAX package's inverse, ops/mdct.py:120-139)
    "imdct2_grad": ("pix2pixhdaudiosr_torch/csrc/mdct.cu",
                    "pix2pixhdaudiosr_tpu/ops/dct_pallas.py:134"),
    "instance_norm_act": ("pix2pixhdaudiosr_torch/csrc/instance_norm.cu",
                          "pix2pixhdaudiosr_tpu/ops/norm_pallas.py:49"),
    # B3's gradient: the TPU kernel has none (XLA differentiates
    # pix2pixhdaudiosr_tpu/models/layers.py:189-208)
    "instance_norm_act_grad": ("pix2pixhdaudiosr_torch/csrc/instance_norm_bwd.cu",
                               "pix2pixhdaudiosr_tpu/ops/norm_pallas.py:49"),
    "conv3x3_in": ("pix2pixhdaudiosr_torch/csrc/conv3x3_wgmma.cu",
                   "pix2pixhdaudiosr_tpu/ops/enhancer_pallas.py:182"),
    "conv3x3_valid": ("pix2pixhdaudiosr_torch/csrc/conv3x3_wgmma.cu",
                      "pix2pixhdaudiosr_tpu/ops/conv_pallas.py:78"),
    "stochastic_quantize_2d": ("pix2pixhdaudiosr_torch/csrc/quant.cu",
                               "pix2pixhdaudiosr_tpu/ops/quant.py:152"),
    # B3's cross-shard entries: the moments pmean'd under CP
    # (pix2pixhdaudiosr_tpu/models/layers.py:189-208), then the normalize
    "instance_moments": ("pix2pixhdaudiosr_torch/csrc/instance_norm.cu",
                         "pix2pixhdaudiosr_tpu/ops/norm_pallas.py:49"),
    "instance_apply": ("pix2pixhdaudiosr_torch/csrc/instance_norm.cu",
                       "pix2pixhdaudiosr_tpu/ops/norm_pallas.py:49"),
}
# the flagship enhancer resblock activation [B, C, H, W]
ENH_SHAPE = (128, 96, 256, 64)
FUSED = ["--fused_enhancer", "--batchSize", "128"]
QUANT = ["--data_type", "8", "--int8_trunk"]
# the flagship trunk resblock activation [B, C, H, W], and one trunk conv
# weight [Co, Ci, 3, 3] seen as the flax kernel's 2-D view [9 Ci, Co]
TRUNK_SHAPE = (128, 1536, 16, 4)
TRUNK_W2D = (9 * 1536, 1536)
# NVIDIA's published H100 SXM rates (dense) that a kernel's bound is reckoned
# at: HBM bytes/s; TF32, bf16 tensor-core and f32 FFMA FLOP/s; int32 ops/s
# outside the tensor cores (half the f32 issue rate)
HBM_BPS = 3.35e12
TF32_FLOPS, BF16_FLOPS, F32_FLOPS, INT32_OPS = 495e12, 989e12, 67e12, 33.5e12


# InstanceNorm launches in one batch-128 serve forward of each path
IN_LAUNCHES = {"plain": 22, "fused_enhancer": 17, "int8_trunk": 22}
# every distinct (H, W, C) an InstanceNorm of the flagship discriminator sees
# on a [B, 512, 128, 4] pair: scale 1, then scale 0
D_IN_SHAPES = [(129, 33, 128), (65, 17, 256), (66, 18, 512), (65, 17, 128),
               (33, 9, 256), (34, 10, 512)]
# the time-domain discriminator's (--use_time_D) on its [B, 2, T, n_fft]
# = [B, 2, 128, 512] input: D's shapes with H and W swapped
TIME_D_IN_SHAPES = [(w, h, c) for h, w, c in D_IN_SHAPES]
TRAIN_BATCH = 64
# a train step's InstanceNorm launches: 22 in G and 6 in each of 3 D
# forwards; its MDCT2 launches: the lr and the hr encode
TRAIN_IN_LAUNCHES, TRAIN_MDCT_LAUNCHES = 40, 2
# and the time-domain D's (--use_time_D): 6 in each of its 3 forwards
TIME_D_IN_LAUNCHES = 18
# the recipe steps at full width (scripts/train_recipes.sh): the VCTK time-D
# + match loss run (:168-171) at batch 64, the HiFi-GAN D run (:162-164) at
# batch 32
RECIPES = ((["--use_match_loss", "--use_time_D", "--lambda_time", "10"],
            TRAIN_BATCH), (["--use_hifigan_D"], 32))
# the recipes' flags for the CUDA-vs-CPU toy step; the time-domain D's with
# the frames' dB floor (--min_value) at 1e-3, since at 1e-7 its grads follow
# the f32 rounding of the frames just above the floor, which weigh 8.7/f
# (tests/test_torch_match_time_d.py)
TOY_RECIPES = (RECIPES[0][0] + ["--min_value", "1e-3"], RECIPES[1][0])
# the in-training eval's launches a validation batch (trainer.make_eval_step):
# B3 in G's forward (as a plain serve forward), B1 for the lr encode, B2 for
# the inverse
EVAL_IN_LAUNCHES = IN_LAUNCHES["plain"]
EVAL_MDCT_LAUNCHES, EVAL_IMDCT_LAUNCHES = 1, 1
# a fake-pool step: g_step and d_step each run 1 G and 3 D forwards
# (trainer.make_pool_steps, every loss computed by both); the InstanceNorm
# backward runs where one net is differentiated: g_step through G (22) and
# D on its output (6), d_step through D on the real and the pooled pair (12)
POOL_IN_LAUNCHES = 2 * TRAIN_IN_LAUNCHES
POOL_IN_GRAD_LAUNCHES = TRAIN_IN_LAUNCHES
# phase 13's corpus: 8 files; a 0.25 validation split keeps 2 for the eval
# (one batch of 2) and leaves 6, 3 steps at batch 2
CLI_FILES, CLI_STEPS = 8, 3
# the flagship G's InstanceNorms by (H, W, C) in one forward: 22
G_IN_BY_SHAPE = {(512, 128, 48): 2, (256, 64, 96): 7, (128, 32, 192): 2,
                 (64, 16, 384): 2, (32, 8, 768): 2, (16, 4, 1536): 7}
# the memory knobs' legs of the flagship train step (batch 64); each remat
# mode's peak must sit REMAT_SAVING_GIB below the plain step's (an H100,
# bf16, tools/remat_peak.py: full and dots 0.82 GiB below it)
KNOBS = (["--remat_g", "full"], ["--remat_g", "dots"], ["--adam_mu_bf16"])
REMAT_SAVING_GIB = 0.5
# the batch of the remat grads' card-against-card reading
REMAT_BATCH = 16
# Family A's instance-feature recipe (scripts/train_recipes.sh:50-54,
# mdct_implicit_phase_coding): implicit encoding, --mask with no
# --mask_mode, netE at nef 16 with 4 downsamples, the default
# GlobalGenerator (ngf 64, 4 downsamples, 9 resblocks) and D, batch 10;
# with --input_nc 1 --output_nc 1 (the widths of the family's other runs,
# :44-45) where the script says 2: implicit encoding makes a 1-channel
# spectrogram, and with a 2-channel G output the D pairs differ in width,
# on which the JAX package's train step fails (system.JAX_UNTRAINABLE)
FAMILY_A = ["--no_instance", "--no_vgg_loss", "--label_nc", "0",
            "--output_nc", "1", "--input_nc", "1", "--mask",
            "--instance_feat", "--feat_num", "1"]
FAMILY_A_BATCH = 10
# the InstanceNorm shapes netE (nef 16) and G (ngf 64) add: netE's down
# and up paths, then G's
FAMILY_A_IN_SHAPES = [(512, 128, 16), (256, 64, 32), (128, 32, 64),
                      (64, 16, 128), (32, 8, 256), (512, 128, 64),
                      (256, 64, 128), (128, 32, 256), (64, 16, 512),
                      (32, 8, 1024)]
# the toy CUDA-vs-CPU step's feature encoder
TOY_FEAT = ["--instance_feat", "--feat_num", "3", "--nef", "4",
            "--n_downsample_E", "2"]
# the CUDA-vs-CPU train step: tests/test_torch_train_step.py's toy config
# (n_fft 64, 480-sample segments, LocalEnhancer ngf 4, PatchGAN ndf 4), f32
TOY_SEG = 480
# the CUDA-vs-CPU train step's G grads, card against an independent CPU
# step, within this many times 1e-3 max|g| a leaf: 2x the 20.1 read on an
# H100, which one element of the feature-matching L1 makes: |D(fake) -
# D(real)| there is within rounding of 0 and takes opposite signs in the
# two steps (phase 10's fm_l1_sign_flips), a jump in its subgradient that
# a 2e-6 perturbation of G's conv outputs on the CPU alone reproduces
INDEPENDENT_G_LIMIT = 40
TOY_TRAIN = ["--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
             "--n_blocks_global", "1", "--n_local_enhancers", "1",
             "--n_blocks_local", "1", "--input_nc", "2", "--output_nc", "2",
             "--label_nc", "0", "--no_instance", "--explicit_encoding",
             "--mask_mode", "mode2", "--compute_dtype", "float32",
             "--n_fft", "64", "--hop_length", "32", "--win_length", "64",
             "--segment_length", str(TOY_SEG), "--ndf", "4",
             "--n_layers_D", "3", "--batchSize", "2"]


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def reset_counts(fn) -> None:
    """Set every count of a kernel wrapper (launches, by route and by
    shape, and the backward's dy copies) to 0."""
    for attr in list(vars(fn)):
        if attr.startswith(("launches", "dy_copies")):
            value = getattr(fn, attr)
            if isinstance(value, dict):
                value.clear()
            else:
                setattr(fn, attr, 0)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, tries: int = 5, cold: bool = False) -> float:
    """Mean device time of the kernels fn() launches, in ms, from
    torch.profiler: unlike cuda_ms, it leaves out the host time between
    launches, which is most of a call where the kernel is short. The
    first traced run is a warm-up, and a trace that comes back without
    kernels (a process's first often does, a later one now and then) is
    taken again, up to `tries` times. With `cold`, a 128 MB fill before
    each call evicts the 50 MB L2 (inputs that fit it would otherwise be
    read from it, faster than the HBM bound), and the fill's own kernel is
    left out of the sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda") if cold else None
    for attempt in range(tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush.fill_(attempt)
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not (cold and "FillFunctor" in e.key))
        if attempt > 0 and total > 0:
            return total / 1e3 / iters
    raise SmokeFailure(f"{tries} profiler traces came back without kernels")


def bound(n_bytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over HBM
    bandwidth and its operations over their peak rate."""
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, ops / rate * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def bf16_ulp(v):
    """One bf16 ulp at each |v| (2^(exponent - 7)), as f32."""
    import torch
    a = v.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def ulp_excess(got, want, floor: float = 1e-6) -> float:
    """max(|got - want| - floor - one bf16 ulp of the larger): <= 0 when
    every element agrees within one ulp. The floor covers values near zero,
    where the ulp is smaller than the f32 sums' own rounding."""
    import torch
    return ((got.float() - want.float()).abs() - floor
            - torch.maximum(bf16_ulp(got), bf16_ulp(want))).max().item()


def conv_floor(want) -> float:
    """The near-zero floor of a conv check: 1e-6 max(1, max|want|), since
    the f32 accumulation's rounding scales with the partial sums' size."""
    return 1e-6 * max(1.0, want.float().abs().max().item())


# ---------------------------------------------------------------------------
def phase_kernels(dev, batch: int = 128, in_batch: int = 16):
    """Each kernel against its twin; returns {name: record} and details."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.framing import pad_signal
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin

    gen = torch.Generator(device=dev).manual_seed(0)
    rec, detail = {}, {}
    # the flagship codec on the tensor-core route at batch 128 and 1, and
    # 512/160 (win % hop != 0) on the FFMA route
    for win, hop, b in ((512, 256, batch), (512, 256, 1), (512, 160, 8)):
        w = kbdwin(win)
        fwd = MDCT2(n_fft=512, hop_length=hop, win_length=win, window=w,
                    device=dev)
        inv = IMDCT2(n_fft=512, hop_length=hop, win_length=win, window=w,
                     device=dev)
        x = torch.randn(b, SEG, generator=gen, device=dev) * 0.3
        x_pad = pad_signal(x, hop, True).contiguous()
        n_tc = mk.mdct2.launches_tc, mk.imdct2.launches_tc
        spec = mk.mdct2(x_pad, fwd.basis, hop, fwd.planes)
        wav = mk.imdct2(spec, inv.basis, hop, inv.planes)
        tc = (mk.mdct2.launches_tc - n_tc[0], mk.imdct2.launches_tc - n_tc[1])
        err_f = (spec - mk.mdct2_ref(x_pad, fwd.basis, hop)).abs().max().item()
        err_i = (wav - mk.imdct2_ref(spec, inv.basis, hop)).abs().max().item()
        torch.cuda.synchronize()
        route = "tensor-core" if fwd.tc else "FFMA"
        print(f"[kernels] {win}/{hop} B={b} ({route} route): mdct2 max|err| "
              f"{err_f:.3e}, imdct2 max|err| {err_i:.3e}")
        check(tc == ((1, 1) if fwd.tc else (0, 0)), f"{win}/{hop}: "
              f"tensor-core launches {tc}, expected the {route} route")
        check(err_f <= 1e-5, f"mdct2 {win}/{hop} B={b} disagrees: {err_f}")
        check(err_i <= 1e-5, f"imdct2 {win}/{hop} B={b} disagrees: {err_i}")
        T, flop = spec.shape[1], 2 * spec.numel() * win
        basis_bytes = 4 * win * 512 * (2 if fwd.tc else 1)
        for name, err, run, plain, lib, io_bytes in (
                ("mdct2", err_f,
                 lambda: mk.mdct2(x_pad, fwd.basis, hop, fwd.planes),
                 lambda: mk.mdct2_ref(x_pad, fwd.basis, hop),
                 lambda: torch.matmul(x_pad.unfold(-1, win, hop), fwd.basis),
                 4 * (x_pad.numel() + spec.numel())),
                ("imdct2", err_i,
                 lambda: mk.imdct2(spec, inv.basis, hop, inv.planes),
                 lambda: mk.imdct2_ref(spec, inv.basis, hop),
                 lambda: F.fold((spec @ inv.basis).transpose(1, 2),
                                (1, wav.shape[1]), (1, win), stride=(1, hop)),
                 4 * (spec.numel() + wav.numel()))):
            r = dict(shape=f"B={b} T={T} {win}/{hop} f32", route=route,
                     max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                     library_ms=cuda_ms(lib), device_ms=device_ms(run),
                     plain_device_ms=device_ms(plain),
                     library_device_ms=device_ms(lib),
                     **bound(io_bytes + basis_bytes, 3 * flop, TF32_FLOPS))
            print(f"[kernels] {name} {r['shape']}: " + json.dumps(r))
            detail[f"{name} {win}/{hop} B={b}"] = r
            if (hop, b) == (256, batch):
                rec[name] = r

    rec["imdct2_grad"] = phase_imdct2_grad(dev, gen)
    detail["imdct2_grad"] = rec["imdct2_grad"]
    rec["instance_norm_act"], in_detail = phase_instance_norm(
        dev, gen, batch, in_batch)
    detail.update(in_detail)
    return rec, detail


def phase_imdct2_grad(dev, gen, batch: int = RECIPES[1][1]) -> dict:
    """B2's backward (mdct_kernels.imdct2_grad: B1's kernel on the codec's
    transposed inverse basis) at the HiFi-GAN recipe's [batch, 128, 512],
    f32: against autograd through imdct2's twin within atol 1e-5
    max|dspec|, on the tensor-core route; then through ops/mdct.IMDCT2Fn
    (the codec's un-segmented inverse, crop and all) against autograd
    through the twin, at the same tolerance. Timed with CUDA events beside
    its twin (B1's twin on basis^T) and the library yardstick (autograd
    through the twin: fold's backward and a matmul)."""
    import torch
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops import framing
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin
    hop, win = 256, 512
    inv = IMDCT2(n_fft=512, hop_length=hop, win_length=win, window=kbdwin(win),
                 device=dev)
    spec = torch.randn(batch, 128, 512, generator=gen, device=dev) * 0.3
    dy = torch.randn(batch, 127 * hop + win, generator=gen, device=dev)
    n, n_tc = mk.imdct2_grad.launches, mk.imdct2_grad.launches_tc
    got = mk.imdct2_grad(dy, inv.basis_t, hop, inv.planes_t)
    launched = (mk.imdct2_grad.launches - n, mk.imdct2_grad.launches_tc - n_tc)
    sr = spec.detach().requires_grad_(True)
    y_ref = mk.imdct2_ref(sr, inv.basis, hop)
    (want,) = torch.autograd.grad(y_ref, sr, dy, retain_graph=True)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    # the Function on the codec's path: crop, kernel forward, kernel backward
    dyc = dy[:, win // 2: -(win // 2)].contiguous()
    sk = spec.detach().requires_grad_(True)
    (got_fn,) = torch.autograd.grad(inv(sk), sk, dyc)
    sr2 = spec.detach().requires_grad_(True)
    (want_fn,) = torch.autograd.grad(
        framing.center_crop(mk.imdct2_ref(sr2, inv.basis, hop), win), sr2, dyc)
    err_fn = (got_fn - want_fn).abs().max().item()
    torch.cuda.synchronize()
    check(launched == (1, 1), f"imdct2_grad: launches (all, tensor-core) "
          f"{launched}, expected one on the tensor-core route")
    check(err <= 1e-5 * scale and err_fn <= 1e-5 * want_fn.abs().max().item(),
          f"imdct2_grad disagrees with autograd through the twin: {err}, "
          f"through IMDCT2Fn {err_fn} (max|dspec| {scale})")
    flop = 2 * spec.numel() * win
    r = dict(shape=f"B={batch} T=128 512/256 f32", route="tensor-core",
             max_abs_err=err, max_abs_err_function=err_fn, max_abs_dspec=scale,
             ms=cuda_ms(lambda: mk.imdct2_grad(dy, inv.basis_t, hop, inv.planes_t)),
             plain_ms=cuda_ms(lambda: mk.imdct2_grad_ref(dy, inv.basis_t, hop)),
             library_ms=cuda_ms(lambda: torch.autograd.grad(
                 y_ref, sr, dy, retain_graph=True)),
             device_ms=device_ms(
                 lambda: mk.imdct2_grad(dy, inv.basis_t, hop, inv.planes_t)),
             **bound(4 * (dy.numel() + spec.numel()) + 2 * 4 * win * 512,
                     3 * flop, TF32_FLOPS))
    print("[kernels] imdct2_grad " + json.dumps(r))
    return r


def phase_instance_norm(dev, gen, batch: int, in_batch: int):
    """B3 at every flagship (H, W, C): against its twin at batch `in_batch`
    in f32 (atol 1e-5) and bf16 (one ulp), ReLU and none, every call on the
    one-pass route and two runs bit-identical; then a same-mode deconv crop
    read in place. Timed at batch `batch` in bf16 beside the two-pass
    kernels, the twin, F.instance_norm and the bound. Returns the record
    of the largest shape and one row a shape."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import norm

    fn, worst, rows = norm.instance_norm_act, 0.0, {}
    for H, W, C in IN_SHAPES:
        x = (torch.randn(in_batch, C, H, W, generator=gen, device=dev) * 2 + 0.5
             ).contiguous(memory_format=torch.channels_last)
        xb = x.to(torch.bfloat16)
        n1 = fn.launches_onepass
        for act in ("relu", "none"):
            got = fn(x, act)
            err32 = (got - norm.instance_norm_act_ref(x, act)).abs().max().item()
            gb = fn(xb, act)
            over = ulp_excess(gb, norm.instance_norm_act_ref(xb, act))
            check(got.is_contiguous(memory_format=torch.channels_last),
                  "instance_norm_act lost channels_last")
            check(err32 <= 1e-5, f"IN f32 {(H, W, C)} {act}: {err32}")
            check(over <= 0, f"IN bf16 {(H, W, C)} {act}: beyond 1 ulp by {over}")
            check(torch.equal(fn(xb, act), gb),
                  f"IN bf16 {(H, W, C)} {act}: two runs differ")
            worst = max(worst, err32)
        check(fn.launches_onepass - n1 == 6,
              f"IN {(H, W, C)}: {6 - fn.launches_onepass + n1} of 6 calls "
              f"took the two-pass route")
        print(f"[kernels] IN B={in_batch} (H,W,C)={(H, W, C)}: f32 within "
              f"1e-5, bf16 within 1 ulp, one-pass, bit-identical")
        del x, xb, got, gb
        xb = torch.randn(batch, C, H, W, generator=gen, device=dev,
                         dtype=torch.bfloat16).contiguous(
                             memory_format=torch.channels_last)
        plan = norm.plan_instance_norm(batch, H, W, C, xb.dtype)

        def two_pass():
            norm._launch_twopass(xb, torch.empty_like(xb), "none", 1e-5)
        # act "none" is the function F.instance_norm computes; one read and
        # one write of x, ~8 f32 operations an element
        row = dict(shape=f"B={batch} bf16", route=plan.route,
                   plan=plan._asdict(),
                   ms=cuda_ms(lambda: fn(xb, "none"), iters=10),
                   device_ms=device_ms(lambda: fn(xb, "none"), iters=10),
                   relu_ms=cuda_ms(lambda: fn(xb, "relu"), iters=10),
                   two_pass_ms=cuda_ms(two_pass, iters=10),
                   two_pass_device_ms=device_ms(two_pass, iters=10),
                   plain_ms=cuda_ms(lambda: norm.instance_norm_act_ref(
                       xb, "none"), iters=5),
                   library_ms=cuda_ms(lambda: F.instance_norm(xb), iters=10),
                   **bound(2 * 2 * xb.numel(), 8 * xb.numel(), F32_FLOPS))
        rows[(H, W, C)] = row
        print(f"[kernels] instance_norm_act {H}x{W}x{C}: " + json.dumps(row))
        del xb

    # the enhancer's deconv output [B, 48, 513, 129] cropped to 512 x 128
    for dtype in (torch.float32, torch.bfloat16):
        full = (torch.randn(in_batch, 48, 513, 129, generator=gen, device=dev)
                ).to(dtype).contiguous(memory_format=torch.channels_last)
        crop = full[..., :512, :128]
        n1 = fn.launches_onepass
        got = fn(crop, "relu")
        want = norm.instance_norm_act_ref(crop, "relu")
        err = (got.float() - want.float()).abs().max().item()
        ok = (err <= 1e-5 if dtype == torch.float32
              else ulp_excess(got, want) <= 0)
        same = torch.equal(fn(crop.contiguous(
            memory_format=torch.channels_last), "relu"), got)
        print(f"[kernels] IN cropped view {list(crop.shape)} strides "
              f"{crop.stride()} {dtype}: max|err| {err:.3e}, equal to its "
              f"contiguous copy: {same}")
        check(fn.launches_onepass - n1 == 2, "IN cropped view: two-pass route")
        check(ok, f"IN cropped view {dtype}: {err}")
        check(same, f"IN cropped view {dtype}: differs from its copy")
        del full, crop, got, want
    big = rows[IN_SHAPES[0]]
    return dict(big, max_abs_err=worst), {
        f"instance_norm_act {H}x{W}x{C}": r for (H, W, C), r in rows.items()}


def phase_conv_kernels(dev):
    """conv3x3_in (every prologue), conv3x3_valid (ReLU off and on), each
    on both routes, and the stats-only InstanceNorm entry against their
    twins at the flagship enhancer shape, bf16; returns {name: record} and
    details. The planner's route (wgmma) is the record's; the mma.sync
    route is timed beside it in the same call."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import enhancer as te
    from pix2pixhdaudiosr_torch.ops.conv import conv3x3_valid, conv3x3_valid_ref
    from pix2pixhdaudiosr_torch.ops.norm import instance_stats, instance_stats_ref

    B, C, H, W = ENH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(5)

    def act(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, res = act(ENH_SHAPE), act(ENH_SHAPE)
    w = te.pack_weights(torch.randn(C, C, 3, 3, generator=gen, device=dev) * .05)
    bias = torch.randn(C, generator=gen, device=dev) * .1
    mean = torch.randn(B, C, generator=gen, device=dev) * .3
    scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + .5
    sms = te.device_sms(torch.cuda.current_device())
    plans = {r: te.plan_conv(B, H, W, C, C, sms, route=r)
             for r in ("wgmma", "mma_sync")}
    check(te.plan_conv(B, H, W, C, C, sms) == plans["wgmma"],
          f"conv3x3_in {list(ENH_SHAPE)}: the planner chose "
          f"{te.plan_conv(B, H, W, C, C, sms).route}, not the wgmma route")
    fn = te.conv3x3_in
    rec, detail, worst = {}, {}, 0.0
    for prologue in te.PROLOGUES:
        args = (x, w, bias, mean, scale, res, prologue)
        y_ref, (m_ref, s_ref) = te.conv3x3_in_ref(*args)
        row = dict(shape=f"{list(ENH_SHAPE)} bf16")
        for route, plan in plans.items():
            n, n_wg = fn.launches, fn.launches_wgmma
            y, (m, s) = fn(*args, plan=None if route == "wgmma" else plan)
            y2, (m2, s2) = fn(*args, plan=None if route == "wgmma" else plan)
            torch.cuda.synchronize()
            check(fn.launches - n == 2 and fn.launches_wgmma - n_wg
                  == 2 * (route == "wgmma"), f"conv3x3_in {prologue}: "
                  f"{fn.launches_wgmma - n_wg} of 2 launches on the wgmma "
                  f"route, {route} expected")
            over = ulp_excess(y, y_ref, conv_floor(y_ref))
            # a one-ulp flip of y moves the mean by ulp / (H * W) however
            # small the mean is, so mean is held against |mean| + std
            m_rel = ((m - m_ref).abs() / (m_ref.abs() + 1 / s_ref)).max().item()
            s_rel = ((s - s_ref).abs() / s_ref).max().item()
            err = (y.float() - y_ref.float()).abs().max().item()
            same = (torch.equal(y, y2) and torch.equal(m, m2)
                    and torch.equal(s, s2))
            print(f"[kernels] conv3x3_in {prologue} ({route}): max|err| "
                  f"{err:.3e}, beyond 1 ulp by {over:.3e}; mean rel "
                  f"{m_rel:.2e}, scale rel {s_rel:.2e}; two runs "
                  f"{'bit-identical' if same else 'DIFFER'}")
            check(over <= 0, f"conv3x3_in {prologue} ({route}): beyond 1 ulp "
                  f"by {over}")
            check(m_rel <= 1e-4 and s_rel <= 1e-4, f"conv3x3_in {prologue} "
                  f"({route}) stats: mean {m_rel}, scale {s_rel}")
            check(same, f"conv3x3_in {prologue} ({route}): two runs differ")
            key = "" if route == "wgmma" else "mma_sync_"
            row.update({f"{key}max_abs_err": err, f"{key}mean_rel": m_rel,
                        f"{key}scale_rel": s_rel})
            if route == "wgmma":
                worst = max(worst, err)
            del y, y2
        row["ms"] = cuda_ms(lambda: fn(*args))
        row["mma_sync_ms"] = cuda_ms(lambda: fn(*args, plan=plans["mma_sync"]))
        row["plain_ms"] = cuda_ms(lambda: te.conv3x3_in_ref(*args), iters=5)
        detail[f"conv3x3_in {prologue}"] = row
        del y_ref
    main = detail["conv3x3_in in_relu"]
    # no single PyTorch call computes conv + prologue + IN partial sums: no
    # library_ms. For scale, not a check: cuDNN's bf16 conv alone, on an
    # already padded channels_last input (no pad, bias, prologue or
    # statistics), with the algorithm search on as generate serves
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect").contiguous(
        memory_format=torch.channels_last)
    wc = te.unpack_weights(w).contiguous(memory_format=torch.channels_last)
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    main["cudnn_bf16_conv_ms"] = cuda_ms(lambda: F.conv2d(xp, wc))
    torch.backends.cudnn.benchmark = searched
    del xp
    # in_relu reads x (bf16) and writes y; 9 taps of C x C MACs a position
    main.update(bound(2 * 2 * x.numel(), 2 * 9 * C * x.numel(), BF16_FLOPS))
    main.update(route="wgmma", plan=plans["wgmma"]._asdict(),
                share_of_bound=main["bound_ms"] / main["ms"],
                mma_sync_share_of_bound=main["bound_ms"] / main["mma_sync_ms"],
                speedup_vs_mma_sync=main["mma_sync_ms"] / main["ms"])
    print("[kernels] conv3x3_in in_relu: " + json.dumps(main))
    rec["conv3x3_in"] = dict(main, max_abs_err=worst, library_ms=None)

    xp = act((64, C, H + 2, W + 2))
    wk = te.unpack_weights(w).contiguous()
    vplans = {r: te.plan_conv(64, H, W, C, C, sms, route=r)
              for r in ("wgmma", "mma_sync")}
    check(te.plan_conv(64, H, W, C, C, sms) == vplans["wgmma"],
          "conv3x3_valid: the planner did not choose the wgmma route")
    worst = 0.0
    for relu in (False, True):
        y_ref = conv3x3_valid_ref(xp, wk, relu)
        row = dict(shape=f"[64, {C}, {H + 2}, {W + 2}] bf16")
        for route, plan in vplans.items():
            n, n_wg = conv3x3_valid.launches, conv3x3_valid.launches_wgmma
            y = conv3x3_valid(xp, wk, relu,
                              plan=None if route == "wgmma" else plan)
            torch.cuda.synchronize()
            check(conv3x3_valid.launches - n == 1 and conv3x3_valid.launches_wgmma
                  - n_wg == (route == "wgmma"), f"conv3x3_valid relu={relu}: "
                  f"not on the {route} route")
            over = ulp_excess(y, y_ref, conv_floor(y_ref))
            err = (y.float() - y_ref.float()).abs().max().item()
            print(f"[kernels] conv3x3_valid relu={relu} ({route}): max|err| "
                  f"{err:.3e}, beyond 1 ulp by {over:.3e}")
            check(over <= 0, f"conv3x3_valid relu={relu} ({route}): beyond 1 "
                  f"ulp by {over}")
            row["max_abs_err" if route == "wgmma" else "mma_sync_max_abs_err"] = err
            if route == "wgmma":
                worst = max(worst, err)
        row["ms"] = cuda_ms(lambda: conv3x3_valid(xp, wk, relu))
        row["mma_sync_ms"] = cuda_ms(lambda: conv3x3_valid(
            xp, wk, relu, plan=vplans["mma_sync"]))
        row["plain_ms"] = cuda_ms(lambda: conv3x3_valid_ref(xp, wk, relu),
                                  iters=5)
        detail[f"conv3x3_valid relu={relu}"] = row
    # without ReLU the function is F.conv2d on the padded input
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    main = detail["conv3x3_valid relu=False"]
    main["library_ms"] = cuda_ms(lambda: F.conv2d(xp, wk))
    torch.backends.cudnn.benchmark = searched
    n_out = xp.shape[0] * C * H * W
    main.update(bound(2 * (xp.numel() + n_out), 2 * 9 * C * n_out, BF16_FLOPS))
    main.update(route="wgmma", plan=vplans["wgmma"]._asdict(),
                share_of_bound=main["bound_ms"] / main["ms"],
                mma_sync_share_of_bound=main["bound_ms"] / main["mma_sync_ms"],
                speedup_vs_mma_sync=main["mma_sync_ms"] / main["ms"],
                vs_library=main["library_ms"] / main["ms"])
    print("[kernels] conv3x3_valid relu=False: " + json.dumps(main))
    rec["conv3x3_valid"] = dict(main, max_abs_err=worst)

    m, s = instance_stats(x)
    m_ref, s_ref = instance_stats_ref(x)
    err = max((m - m_ref).abs().max().item(), ((s - s_ref) / s_ref).abs().max().item())
    check(err <= 1e-5, f"instance_stats disagrees with its twin: {err}")
    detail["instance_stats"] = dict(
        shape=f"{list(ENH_SHAPE)} bf16", max_err=err,
        ms=cuda_ms(lambda: instance_stats(x)),
        plain_ms=cuda_ms(lambda: instance_stats_ref(x), iters=5))
    print(f"[kernels] instance_stats: max err {err:.2e}")
    return rec, detail


def phase_quant_kernels(dev):
    """The stochastic quantizer against its twin: N(0, 0.02) (the flagship
    init) at a trunk conv weight's 2-D shape, and a ragged shape; q and
    scale bit-identical, q * scale within one step of x (+1e-6 for the
    product's rounding). Then the int8 trunk conv at the flagship trunk
    shape: the card's int32 accumulator equal to the CPU's, and its time
    beside cuDNN's bf16 conv on the same activation (reflect pad + conv +
    bias, as the plain trunk serves it). Returns {name: record}, details."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(9)
    rec, detail = {}, {}
    fn = quant.stochastic_quantize_2d
    for shape in (TRUNK_W2D, (1000, 136)):
        x = torch.randn(shape, generator=gen, device=dev) * 0.02
        q_ref, s_ref = quant.stochastic_quantize_2d_ref(x, 1234)
        plan = quant.plan_quantize(*shape)
        check(plan.route == "strip", f"stochastic_quantize_2d {shape}: the "
              f"planner's route is {plan.route}, not the strip route")
        row = dict(plan=plan._asdict())
        for name, p in (("strip", plan),
                        ("threepass", quant.QuantPlan("threepass"))):
            n1, n2 = fn.launches, fn.launches_by_route.get(name, 0)
            q, s = fn(x, 1234, p)
            torch.cuda.synchronize()
            check(fn.launches - n1 == 1
                  and fn.launches_by_route[name] - n2 == 1,
                  f"stochastic_quantize_2d {shape}: one call left the "
                  f"{name} route")
            err = max((q.int() - q_ref.int()).abs().max().item(),
                      (s - s_ref).abs().max().item())
            steps = ((q.float() * s - x).abs() / s).max().item()
            print(f"[kernels] stochastic_quantize_2d {list(shape)} {name}: "
                  f"max|err| {err}, max|q*s - x| {steps:.6f} steps")
            check(torch.equal(q, q_ref) and torch.equal(s, s_ref),
                  f"stochastic_quantize_2d {shape} {name}: not "
                  f"bit-identical ({err})")
            check(steps <= 1 + 1e-6, f"stochastic_quantize_2d {shape} "
                  f"{name}: {steps} steps from x")
            row[name] = dict(
                max_abs_err=err, max_steps=steps,
                ms=cuda_ms(lambda: fn(x, 1234, p)),
                cold_device_ms=device_ms(lambda: fn(x, 1234, p), cold=True))
        # reads x (f32) and writes q (int8) and a scale a column; ~30
        # integer ops an element for the hashes. No PyTorch call computes it.
        n = shape[0] * shape[1]
        row.update(bound(5 * n + 4 * shape[1], 30 * n, INT32_OPS),
                   plain_ms=cuda_ms(lambda: quant.stochastic_quantize_2d_ref(
                       x, 1234), iters=5))
        for name in ("strip", "threepass"):
            row[name]["share_of_bound"] = (row["bound_ms"]
                                           / row[name]["cold_device_ms"])
        print(f"[kernels] stochastic_quantize_2d {list(shape)} timing "
              + json.dumps(row))
        detail[f"stochastic_quantize_2d {list(shape)}"] = row
    main = detail[f"stochastic_quantize_2d {list(TRUNK_W2D)}"]
    rec["stochastic_quantize_2d"] = dict(
        max_abs_err=main["strip"]["max_abs_err"], ms=main["strip"]["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None)

    B, C, H, W = TRUNK_SHAPE
    cpu = torch.Generator().manual_seed(10)
    x = torch.randn(TRUNK_SHAPE, generator=cpu).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn(C, C, 3, 3, generator=cpu) * 0.02).to(torch.bfloat16)
    b = torch.zeros(C, dtype=torch.bfloat16)
    kq, sw = quant.quantize_conv_weight(w)
    t0 = time.perf_counter()
    acc, sx = quant.conv3x3_int8_acc(x, kq)
    cpu_s = time.perf_counter() - t0
    xc, wc, bc = x.to(dev), w.to(dev), b.to(dev)
    kq_c, sw_c = quant.quantize_conv_weight(wc)
    acc_c, sx_c = quant.conv3x3_int8_acc(xc, kq_c)
    torch.cuda.synchronize()
    same = (torch.equal(kq_c.cpu(), kq) and torch.equal(sw_c.cpu(), sw)
            and torch.equal(acc_c.cpu(), acc) and sx_c.item() == sx.item())
    print(f"[kernels] conv3x3_int8 {list(TRUNK_SHAPE)} bf16: int32 "
          f"accumulator on the card {'equals' if same else 'DIFFERS FROM'} "
          f"the CPU's (CPU {cpu_s:.1f} s)")
    check(same, "conv3x3_int8: the card's accumulator differs from the CPU's")
    del acc, acc_c
    cols = torch.zeros(B * H * W, 9 * C, dtype=torch.int8, device=dev)
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    detail["conv3x3_int8"] = dict(
        shape=f"{list(TRUNK_SHAPE)} bf16",
        ms=cuda_ms(lambda: quant.conv3x3_int8(xc, kq_c, sw_c, bc)),
        int_mm_ms=cuda_ms(lambda: torch._int_mm(cols, kq_c.t())),
        quantize_weight_ms=cuda_ms(lambda: quant.quantize_conv_weight(wc)),
        cudnn_bf16_ms=cuda_ms(lambda: F.conv2d(
            F.pad(xc, (1, 1, 1, 1), mode="reflect"), wc, bc)))
    torch.backends.cudnn.benchmark = searched
    print("[kernels] conv3x3_int8 timing " + json.dumps(detail["conv3x3_int8"]))
    return rec, detail


def write_synthetic_wav(path: str, seconds: float = 5.0, rate: int = 48000):
    import numpy as np
    from pix2pixhdaudiosr_torch.data.wavio import write_wav
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * rate)) / rate
    x = sum(0.2 / k * np.sin(2 * np.pi * 220 * k * t) for k in range(1, 9))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(t.size)
    write_wav(path, x.astype(np.float32), rate)
    return t.size


def flagship_generator_pth(expr_dir: str, seed: int = 0) -> str:
    """Flagship G with N(0, 0.02) weights from `seed`, saved as
    <expr_dir>/latest_net_G.pth."""
    import torch
    from pix2pixhdaudiosr_torch.models.generator import (build_generator,
                                                         init_normal_)
    from pix2pixhdaudiosr_torch.utils.checkpoint import save_generator
    net = build_generator("local", 2, 2, 48, 4, 3, 1, 2, device="meta")
    net = net.to_empty(device="cpu")
    n = sum(p.numel() for p in net.parameters())
    check(n == 156_050_690, f"flagship G has {n} parameters")
    init_normal_(net, torch.Generator().manual_seed(seed))
    return save_generator(net, os.path.join(expr_dir, "latest_net_G.pth"))


def phase_generate(dev, counters, wav: str, n_in: int, extra=(),
                   expect=()) -> dict:
    """One run of the generate CLI; every counter in `counters` must move,
    and every line in `expect` must be among what it printed."""
    import numpy as np
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.data.wavio import read_wav

    argv = ["--name", "smoke", "--checkpoints_dir", WORK, "--dataroot", wav,
            "--load_pretrain", os.path.join(WORK, "smoke"), "--batchSize",
            "16", "--no_html", "--device", dev, *FLAGSHIP, *extra]
    for fn in counters.values():
        reset_counts(fn)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        audio = generate.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches_tc = {k: fn.launches_tc for k, fn in counters.items()
                   if hasattr(fn, "launches_tc")}
    onepass = {k: fn.launches_onepass for k, fn in counters.items()
               if hasattr(fn, "launches_onepass")}
    wgmma = {k: fn.launches_wgmma for k, fn in counters.items()
             if hasattr(fn, "launches_wgmma")}
    sys.stdout.write(out.getvalue())
    print(f"[generate{' ' + ' '.join(extra) if extra else ''}] "
          f"{seconds:.1f} s, launches {launches}, on the tensor-core route "
          f"{launches_tc}, on the one-pass route {onepass}, on the wgmma "
          f"route {wgmma}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by the generate run")
    # the flagship codec (512/256) takes the tensor-core MDCT kernels only
    for k, n in launches_tc.items():
        check(n == launches[k], f"{k}: {launches[k] - n} of {launches[k]} "
              f"launches took the FFMA route, not the tensor-core route")
    # every flagship InstanceNorm shape takes the one-pass route
    for k, n in onepass.items():
        check(n == launches[k], f"{k}: {launches[k] - n} of {launches[k]} "
              f"launches took the two-pass route")
    # every flagship enhancer conv takes the wgmma route
    for k, n in wgmma.items():
        check(n == launches[k], f"{k}: {launches[k] - n} of {launches[k]} "
              f"launches took the mma.sync route")
    for line in expect:
        check(line in out.getvalue().splitlines(),
              f"the generate run did not print {line!r}")
    check(bool(np.isfinite(audio).all()), "generate produced non-finite audio")
    check(float(np.abs(audio).max()) > 0, "generate produced silence")
    sr, rate = read_wav(os.path.join(WORK, "smoke", "sr_audio.wav"))
    check(rate == 48000, f"sr_audio.wav at {rate} Hz")
    check(sr.shape[1] >= n_in, f"sr_audio.wav has {sr.shape[1]} < {n_in}")
    with open(os.path.join(WORK, "smoke", "metric.txt")) as f:
        vals = [float(v) for v in f.read().split("\n")[1].split(",")]
    check(all(np.isfinite(vals)), f"metric.txt not finite: {vals}")
    return dict(launches=launches, launches_tc=launches_tc,
                launches_onepass=onepass, launches_wgmma=wgmma,
                seconds=seconds, metric=vals)


def phase_reference(dev) -> dict:
    """The CUDA serve path against the same path on the CPU (kernel twins),
    f32, one segment, same weights and noise, stage by stage:
      encode  lr spectrogram, atol 1e-3: values in [0, 1], but the dB
              encode turns the MDCT's ~1e-9 absolute rounding on
              coefficients just above the 1e-7 floor into ~0.1 dB, ~6e-4
              of the batch's ~150 dB range;
      G       sr spectrogram, atol 1e-3 (f32 rounding through 32 conv/IN
              layers, each IN dividing by a per-channel std);
      decode  imdct_eval of the CPU's sr spectrogram on both devices,
              atol 1e-4 * max|wav| (the dB decode's 10^(x/20) gain over the
              batch's ~150 dB range).
    The decode is fed one spectrogram because its pseudo-phase
    sign(ch0 - ch1) flips on bins where the two channels agree to within
    the G stage's rounding; each flip is a legitimate +-2*mag step."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.generate import load_system

    cfg = parse_config(["--name", "smoke", "--checkpoints_dir", WORK,
                        "--load_pretrain", os.path.join(WORK, "smoke"),
                        *FLAGSHIP, "--compute_dtype", "float32"],
                       is_train=False, save=False)
    lr = torch.randn(1, SEG, generator=torch.Generator().manual_seed(1)) * 0.1
    noise = torch.randn(1, 426, 128, 2, generator=torch.Generator()
                        .manual_seed(7))
    res = {}
    for d in ("cpu", dev):
        system = load_system(cfg, torch.device(d))
        with torch.no_grad():
            sr, pha, norm, lr_spec = system.inference(lr.to(d), noise.to(d))
        res[d] = (system, sr, pha, norm, lr_spec)
    cpu, gpu = res["cpu"], res[dev]
    err = {"encode": (gpu[4].cpu() - cpu[4]).abs().max().item(),
           "G": (gpu[1].cpu() - cpu[1]).abs().max().item()}
    wavs = [s.codec.imdct_eval(cpu[1].abs().to(s.device), cpu[2].to(s.device),
                               {k: v.to(s.device) for k, v in cpu[3].items()}
                               ).cpu() for s in (cpu[0], gpu[0])]
    err["decode"] = (wavs[1] - wavs[0]).abs().max().item()
    bound = {"encode": 1e-3, "G": 1e-3,
             "decode": 1e-4 * wavs[0].abs().max().item()}
    print(f"[reference] CUDA vs CPU, f32, one segment: max|err| {err} "
          f"(bounds {bound})")
    for k in err:
        check(err[k] <= bound[k], f"CUDA {k} disagrees with the CPU: "
              f"{err[k]} > {bound[k]}")
    check(bool(torch.isfinite(gpu[1]).all()), "CUDA G output not finite")
    return err


def flagship_system(dev, extra=()):
    """The flagship system in bf16 as generate loads it, with `extra`
    flags. Its netG switches paths in place: `fused_enh_blocks` for the
    fused enhancer section, the global trunk's `int8_blocks` for the int8
    trunk (set_path)."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.generate import load_system

    cfg = parse_config(["--name", "smoke", "--checkpoints_dir", WORK,
                        "--load_pretrain", os.path.join(WORK, "smoke"),
                        *FLAGSHIP, *extra], is_train=False, save=False)
    return load_system(cfg, torch.device(dev))


def seeded_batch(system, dev, batch: int):
    """A seeded lr batch [batch, SEG] and its mask noise."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    lr = torch.randn(batch, SEG, generator=gen, device=dev) * 0.1
    b, f, t, c = system.spectro_shape(batch)
    noise = torch.randn(b, system.codec.mask_size(f), t, c, generator=gen,
                        device=dev)
    return lr, noise


def set_path(system, fused: bool = False, int8: bool = False) -> None:
    system.netG.fused_enh_blocks = fused
    getattr(system.netG, "global").int8_blocks = int8


def phase_fused_vs_plain(system, lr, noise) -> dict:
    """Fused against unfused G output on the card: bf16, one batch, the
    same weights and noise; bound max|diff| <= 0.05 max|unfused| (the JAX
    package's own bound, tests/test_enhancer_pallas.py:110)."""
    import torch
    from pix2pixhdaudiosr_torch.ops import enhancer

    out = {}
    for fused in (False, True):
        set_path(system, fused=fused)
        fn = enhancer.conv3x3_in
        n, n_wg = fn.launches, fn.launches_wgmma
        with torch.no_grad():
            out[fused] = system.inference(lr, noise=noise)[0]
        check(fn.launches - n == 4 * fused,
              f"fused={fused}: conv3x3_in launched {fn.launches - n}x")
        check(fn.launches_wgmma - n_wg == fn.launches - n,
              f"fused={fused}: {fn.launches - n - fn.launches_wgmma + n_wg} "
              f"conv3x3_in launches took the mma.sync route")
    set_path(system)
    scale = out[False].abs().max().item()
    err = (out[True] - out[False]).abs().max().item()
    res = dict(max_abs_diff=err, max_abs_unfused=scale, ratio=err / scale,
               bound=0.05)
    print("[fused vs plain] " + json.dumps(res))
    check(bool(torch.isfinite(out[True]).all()), "fused G output not finite")
    check(err <= 0.05 * scale, f"fused G output off the unfused: {err} > "
          f"0.05 * {scale}")
    return res


def phase_quant_vs_plain(system, dq_system, lr, noise) -> dict:
    """--int8_trunk G (the same system, trunk switched to int8) and
    --data_type 8 G (dq_system, loaded with the flag) against the plain G on
    the card: bf16, one batch, the same weights and noise; correlation
    >= 0.99, the JAX package's own bound (tests/test_quant.py:47, :114).
    Also prints max|diff| / max|plain|."""
    import torch
    from pix2pixhdaudiosr_torch.ops import quant

    n_convs = 2 * getattr(system.netG, "global").n_blocks
    out = {}
    for name, sys_, int8 in (("plain", system, False),
                             ("int8_trunk", system, True),
                             ("data_type_8", dq_system, False)):
        set_path(sys_, int8=int8)
        n = quant.conv3x3_int8.launches
        with torch.no_grad():
            out[name] = sys_.inference(lr, noise=noise)[0].double()
        launched = quant.conv3x3_int8.launches - n
        check(launched == (n_convs if int8 else 0),
              f"{name}: conv3x3_int8 launched {launched}x")
    set_path(system)
    plain = out["plain"].flatten()
    scale = plain.abs().max().item()
    res = {}
    for name in ("int8_trunk", "data_type_8"):
        got = out[name].flatten()
        check(bool(torch.isfinite(got).all()), f"{name} G output not finite")
        corr = torch.corrcoef(torch.stack([got, plain]))[0, 1].item()
        res[name] = dict(corr=corr, ratio=(got - plain).abs().max().item()
                         / scale, bound_corr=0.99)
        print(f"[{name} vs plain] " + json.dumps(res[name]))
        check(corr >= 0.99, f"{name} G output correlates {corr} < 0.99 with "
              f"the plain G")
    return res


def phase_serve_timing(system, lr, noise, counters) -> dict:
    """ms/batch, frames/s and peak GiB of the serve forward at batch 128,
    plain, fused and int8 trunk in turns (plain, fused, int8, int8, fused,
    plain), 5 forwards after 2 warm-ups each; plain and int8 at batch 1 in
    turns (plain, int8, int8, plain), 20 forwards after 3 warm-ups; then one
    traced forward of each path at batch 128, and the launches of each
    kernel wrapper in `counters` during one untraced forward."""
    import torch
    t = system.n_frames
    paths = {"plain": {}, "fused_enhancer": dict(fused=True),
             "int8_trunk": dict(int8=True)}

    def timed(lr_, noise_, order, iters, warmup):
        def serve():
            with torch.no_grad():
                sr, pha, norm, _ = system.inference(lr_, noise=noise_)
                return system.codec.imdct_eval(torch.abs(sr), pha, norm)
        runs = {name: [] for name in order}
        for name in order:
            set_path(system, **paths[name])
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(serve, iters=iters, warmup=warmup)
            runs[name].append((ms, torch.cuda.max_memory_allocated() / 2**30))
        res = {}
        for name, rs in runs.items():
            ms = sum(r[0] for r in rs) / len(rs)
            res[name] = dict(batch=lr_.shape[0], ms_per_batch=ms,
                             ms_runs=[r[0] for r in rs],
                             frames_per_s=lr_.shape[0] * t / (ms / 1e3),
                             peak_gib=max(r[1] for r in rs))
            print(f"[serve {name} b{lr_.shape[0]}] " + json.dumps(res[name]))
        return res, serve

    res, serve = timed(lr, noise, ("plain", "fused_enhancer", "int8_trunk",
                                   "int8_trunk", "fused_enhancer", "plain"),
                       iters=5, warmup=2)
    res["batch1"], _ = timed(lr[:1], noise[:1], ("plain", "int8_trunk",
                                                 "int8_trunk", "plain"),
                             iters=20, warmup=3)
    for name in paths:
        set_path(system, **paths[name])
        res[name]["profile"] = profile_serve(serve)
        print(f"[profile {name}] " + json.dumps(res[name]["profile"]))
        for fn in counters.values():
            reset_counts(fn)
        serve()
        res[name]["launches"] = {k: fn.launches for k, fn in counters.items()}
        inorm = counters["instance_norm_act"]
        res[name]["in_launches_onepass"] = inorm.launches_onepass
        res[name]["in_launches_by_shape"] = {
            f"{h}x{w}x{c}": n for (h, w, c), n in inorm.launches_by_shape.items()}
        print(f"[launches {name} b{lr.shape[0]}] "
              + json.dumps(res[name]["launches"]) + " InstanceNorm one-pass "
              + json.dumps(res[name]["in_launches_onepass"]) + " by shape "
              + json.dumps(res[name]["in_launches_by_shape"]))
        check(inorm.launches == inorm.launches_onepass == IN_LAUNCHES[name],
              f"{name}: {inorm.launches} InstanceNorm launches, "
              f"{inorm.launches_onepass} one-pass; expected "
              f"{IN_LAUNCHES[name]}, all one-pass")
        conv = counters["conv3x3_in"]
        res[name]["conv3x3_in_launches_wgmma"] = conv.launches_wgmma
        want = 4 if name == "fused_enhancer" else 0
        check(conv.launches == conv.launches_wgmma == want,
              f"{name}: {conv.launches} conv3x3_in launches, "
              f"{conv.launches_wgmma} on the wgmma route; expected {want}, "
              f"all on the wgmma route")
    set_path(system)
    return res


def phase_sizes(pth: str) -> dict:
    """quantized_size_bytes of the flagship generator (int8 weights, f32
    scales and biases) against its f32 and bf16 sizes."""
    import torch
    from pix2pixhdaudiosr_torch.ops.quant import (quantize_state_dict,
                                                  quantized_size_bytes)
    state = torch.load(pth, map_location="cpu", weights_only=True)
    n = sum(t.numel() for t in state.values())
    qstate, scales = quantize_state_dict(state)
    res = dict(f32_bytes=4 * n, bf16_bytes=2 * n,
               int8_bytes=quantized_size_bytes(qstate),
               scale_bytes=sum(s.numel() * 4 for s in scales.values()
                               if s is not None))
    print("[sizes] " + json.dumps(res))
    return res


def profile_serve(serve, top: int = 16) -> dict:
    """One traced serve forward: the device total of its kernels against
    the forward's host wall time, and the `top` kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' device time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return dict(host_wall_ms=wall, device_ms=sum(
        e.self_device_time_total for e in kernels) / 1e3, top=[
        [e.key[:80], e.self_device_time_total / 1e3, e.count]
        for e in kernels[:top]])


def b3_per_shape(detail: dict, calls: dict) -> dict:
    """One row per flagship InstanceNorm shape: its calls in one plain
    batch-128 forward; kernel ms by CUDA events (host time of the wrapper
    included) and by the profiler (device time), the two-pass kernels'
    device ms, library and bound ms; and calls x (device ms - bound), the
    device time the forward loses to the kernel there."""
    rows = {}
    for H, W, C in IN_SHAPES:
        d, key = detail[f"instance_norm_act {H}x{W}x{C}"], f"{H}x{W}x{C}"
        n = calls.get(key, 0)
        rows[key] = dict(calls=n, route=d["route"], ms=d["ms"],
                         device_ms=d["device_ms"],
                         two_pass_device_ms=d["two_pass_device_ms"],
                         bound_ms=d["bound_ms"], library_ms=d["library_ms"],
                         share_of_bound=d["bound_ms"] / d["device_ms"],
                         lost_ms=n * (d["device_ms"] - d["bound_ms"]))
        print(f"[B3 {key}] " + json.dumps(rows[key]))
    total = {k: sum(r["calls"] * r[k] for r in rows.values())
             for k in ("device_ms", "two_pass_device_ms", "bound_ms")}
    total["calls"] = sum(r["calls"] for r in rows.values())
    print("[B3 plain forward] " + json.dumps(total))
    return dict(rows, total=total)


# ---------------------------------------------------------------------------
def in_grad_check(x, act: str, dy) -> dict:
    """B3's Function (the kernel forward, the backward kernel) at x: y
    within 1e-5 of the twin's in f32 and one bf16 ulp in bf16 (as phase 3);
    the forward's saved statistics against the twin's (mean within 1e-5,
    variance within 1e-5 relative); dx within 1e-4 max|dx| in f32, one bf16
    ulp + that floor in bf16, of the backward's twin on the same x, dy and
    saved statistics, and of autograd through the forward's twin in f32
    with the activation's slope read off the kernel's y (as the closed form
    reads it); one backward launch and no copy of dy (channels_last or
    NCHW, read in place). Returns the errors, `ok`, `slope_flips`
    (elements whose slope, taken by the kernel from the recomputed x^,
    differs from the slope read off y: must be 0) and `side_flips`
    (elements on another side of 0 in the kernel's y than in the twin's: a
    value within rounding of 0)."""
    import torch
    from pix2pixhdaudiosr_torch.models.layers import InstanceNormAct
    from pix2pixhdaudiosr_torch.ops import norm
    grad = norm.instance_norm_act_grad
    xk = x.detach().requires_grad_(True)
    y = InstanceNormAct.apply(xk, act)
    _, saved = y.grad_fn.saved_tensors
    n, copies = grad.launches, grad.dy_copies
    (dx,) = torch.autograd.grad(y, xk, dy)
    launched, copied = grad.launches - n, grad.dy_copies - copies
    x = x.detach()
    want = norm.instance_norm_act_grad_ref(x, dy, saved, act)
    g = dy.float()
    if act == "relu":
        g = g * (y > 0)
    elif act == "leaky":
        g = torch.where(y >= 0, g, 0.2 * g)
    xr = x.float().requires_grad_(True)
    (want_ad,) = torch.autograd.grad(norm.instance_norm_act_ref(xr, "none"),
                                     xr, g)
    y_twin = norm.instance_norm_act_ref(x, act)
    mean, var = norm.instance_mean_var_ref(x)
    # x^ = (x - mean) rstd with rstd > 0: its sign is that of x - mean
    centred = x.float() - saved[0][:, :, None, None]
    if act == "relu":
        slope_flips = int(((y > 0) != (centred > 0)).sum())
    elif act == "leaky":
        slope_flips = int(((y >= 0) != (centred >= 0)).sum())
    else:
        slope_flips = 0
    scale = want.float().abs().max().item()
    scale_ad = want_ad.abs().max().item()
    res = dict(y_max_abs_err=(y.float() - y_twin.float()).abs().max().item(),
               max_abs_err=(dx.float() - want.float()).abs().max().item(),
               autograd_max_abs_err=(dx.float() - want_ad).abs().max().item(),
               max_abs_dx=scale,
               mean_max_abs_err=(saved[0] - mean).abs().max().item(),
               var_max_rel_err=((saved[1] - var).abs().max()
                                / var.abs().max().clamp_min(1e-30)).item(),
               launches=launched, dy_copies=copied, slope_flips=slope_flips,
               side_flips=int(((y > 0) != (y_twin > 0)).sum())
               if act != "none" else 0)
    ok = (launched == 1 and copied == 0 and slope_flips == 0
          and res["mean_max_abs_err"] <= 1e-5
          and res["var_max_rel_err"] <= 1e-5)
    if x.dtype == torch.float32:
        res["ok"] = (ok and res["y_max_abs_err"] <= 1e-5
                     and res["max_abs_err"] <= 1e-4 * scale
                     and res["autograd_max_abs_err"] <= 1e-4 * scale_ad)
    else:
        res["y_ulp_excess"] = ulp_excess(y, y_twin)
        res["ulp_excess"] = ulp_excess(dx, want, 1e-4 * scale)
        res["autograd_ulp_excess"] = ulp_excess(dx, want_ad, 1e-4 * scale_ad)
        res["ok"] = ok and all(res[k] <= 0 for k in (
            "y_ulp_excess", "ulp_excess", "autograd_ulp_excess"))
    check(dx.dtype == x.dtype and dx.shape == x.shape,
          f"dx {dx.dtype} {tuple(dx.shape)} for x {x.dtype} {tuple(x.shape)}")
    return res


def in_grad_bound(x) -> dict:
    """The backward's bound: 3 planes of x's bytes (x and dy read, dx
    written), ~20 f32 operations an element."""
    return bound(3 * x.element_size() * x.numel(), 20 * x.numel(), F32_FLOPS)


def phase_in_grad(dev, batch: int = TRAIN_BATCH, groups=None,
                  yardsticks: bool = True) -> dict:
    """B3 with its gradient at every training InstanceNorm shape (the
    generator's with relu and none, the discriminator's and the time-domain
    discriminator's with leaky), batch
    `batch`, f32 and bf16: in_grad_check (y, the saved statistics, dx
    against the backward's twin and autograd through the forward's twin, 0
    slope flips), each backward launch counted on the planner's route, and
    two runs of the backward kernel bit-identical. In bf16 a shape the
    backward kernel is timed (CUDA events; profiler device time with the L2
    warm, and evicted before each call for the share of the bound) on its
    route and on the other route where the shape has one, beside its twin,
    the closed form (instance_norm_act_backward), autograd through the
    forward's twin and, as the library yardstick, autograd through
    F.instance_norm and the activation; with the bound of 3 planes (and the
    4-plane figure of earlier records, x, y and dy read). `groups`:
    (shapes, activations) pairs in place of the flagship's; without
    `yardsticks` the twin, closed-form, autograd and library timings are
    left out (the checks and the kernel's own timings stay)."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import norm
    gen = torch.Generator(device=dev).manual_seed(12)
    fn, grad, rows = norm.instance_norm_act, norm.instance_norm_act_grad, {}
    for shapes, acts in groups or ((IN_SHAPES, ("relu", "none")),
                                   (D_IN_SHAPES + TIME_D_IN_SHAPES, ("leaky",))):
        for H, W, C in shapes:
            row = {}
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(batch, C, H, W, generator=gen, device=dev) * 2
                     + 0.5).to(dtype).contiguous(memory_format=torch.channels_last)
                dy = torch.randn(x.shape, generator=gen, device=dev).to(
                    dtype).contiguous(memory_format=torch.channels_last)
                plan = norm.plan_instance_norm_grad(batch, H, W, C, dtype)
                fplan = norm.plan_instance_norm(batch, H, W, C, dtype)
                for act in acts:
                    n1 = fn.launches_onepass
                    n2 = grad.launches_by_route.get(plan.route, 0)
                    r = in_grad_check(x, act, dy)
                    check(fn.launches_onepass - n1 == (fplan.route == "onepass"),
                          f"IN grad {(H, W, C)}: the forward left the "
                          f"{fplan.route} route")
                    check(grad.launches_by_route.get(plan.route, 0) - n2 == 1,
                          f"IN grad {(H, W, C)}: the backward left the "
                          f"{plan.route} route")
                    row[f"{str(dtype)[6:]} {act}"] = r
                    check(r["ok"], f"IN grad {(H, W, C)} {dtype} {act}: {r}")
                # dy as the reflect pad's backward and the feature-matching
                # L1 hand it: NCHW, read in place on the planner's route
                dy_nchw = dy.contiguous()
                r = in_grad_check(x, acts[0], dy_nchw)
                row[f"{str(dtype)[6:]} {acts[0]} nchw dy"] = r
                check(r["ok"], f"IN grad {(H, W, C)} {dtype} NCHW dy: {r}")
                y, saved = fn(x, acts[0], with_stats=True)

                def run(plan=plan, dy=dy):
                    return grad(x, dy, saved, acts[0], plan=plan)
                check(torch.equal(run(), run()),
                      f"IN grad {(H, W, C)} {dtype}: two runs differ")
                check(torch.equal(run(dy=dy_nchw), run()),
                      f"IN grad {(H, W, C)} {dtype}: an NCHW dy's dx differs "
                      f"from its channels_last copy's")
                if dtype == torch.bfloat16:
                    row.update(forward_route=fplan.route,
                               forward_ms=cuda_ms(lambda: fn(x, acts[0])),
                               route=plan.route, plan=plan._asdict(),
                               backward_ms=cuda_ms(run),
                               backward_device_ms=device_ms(run),
                               backward_cold_device_ms=device_ms(run, cold=True),
                               **in_grad_bound(x))
                    # every route the shape has, dy channels_last and NCHW:
                    # device time with the L2 cold and warm, share of the
                    # bound from the cold one
                    routes = {"twopass": norm.INPlan("twopass")}
                    for narrow in (False, True):
                        p = norm.plan_instance_norm_grad(
                            batch, H, W, C, dtype, narrow=narrow)
                        if p.route == "onepass":
                            narrow_tile = p.tile * x.element_size() < 32
                            routes["onepass" + " narrow" * narrow_tile] = p
                    row["routes"] = {}
                    for name, p in routes.items():
                        for layout, d in (("nhwc", dy), ("nchw", dy_nchw)):
                            cold = device_ms(lambda: run(p, d), cold=True)
                            row["routes"][f"{name} {layout} dy"] = dict(
                                plan=p._asdict(), cold_device_ms=cold,
                                device_ms=device_ms(lambda: run(p, d)),
                                share_of_bound=row["bound_ms"] / cold)
                    row["nchw_dy_cold_device_ms"] = row["routes"][
                        f"{next(k for k, p in routes.items() if p == plan)}"
                        f" nchw dy"]["cold_device_ms"]
                    row["share_of_bound"] = (row["bound_ms"]
                                             / row["backward_cold_device_ms"])
                    row["max_abs_err"] = max(v["max_abs_err"] for k, v in
                                             row.items() if k.startswith("bfloat16"))
                    if not yardsticks:
                        del x, dy, dy_nchw, y, saved
                        continue
                    row["twin_ms"] = cuda_ms(
                        lambda: norm.instance_norm_act_grad_ref(
                            x, dy, saved, acts[0]), iters=5, warmup=1)
                    row["closed_form_ms"] = cuda_ms(
                        lambda: norm.instance_norm_act_backward(x, y, dy, acts[0]),
                        iters=5, warmup=1)
                    xr = x.detach().requires_grad_(True)
                    yr = norm.instance_norm_act_ref(xr, acts[0])
                    row["twin_autograd_ms"] = cuda_ms(
                        lambda: torch.autograd.grad(yr, xr, dy, retain_graph=True),
                        iters=5, warmup=1)
                    # the library yardstick: autograd through F.instance_norm
                    # and the activation
                    yl = norm.activate(F.instance_norm(xr), acts[0])
                    row["library_backward_ms"] = cuda_ms(
                        lambda: torch.autograd.grad(yl, xr, dy, retain_graph=True),
                        iters=10, warmup=2)
                    row["bound_4planes_ms"] = 4 * 2 * x.numel() / HBM_BPS * 1e3
                    del xr, yr, yl
                del x, dy, dy_nchw, y, saved
            rows[f"{H}x{W}x{C}"] = row
            print(f"[in grad] {H}x{W}x{C} B={batch}: " + json.dumps(row))
    torch.cuda.empty_cache()
    return rows


def in_backward_per_step(in_grad: dict, train: dict) -> dict:
    """The InstanceNorm backward's times (phase 9, bf16, a shape) summed
    over one flagship train step's calls (phase 11's launches by shape):
    the backward kernel (CUDA events, device time with the L2 warm and
    cold), the closed form,
    autograd through F.instance_norm (the library yardstick) and the
    bound; and the shapes where the kernel is not faster than the library."""
    keys = {"kernel_ms": "backward_ms", "kernel_device_ms": "backward_device_ms",
            "kernel_cold_device_ms": "backward_cold_device_ms",
            "closed_form_ms": "closed_form_ms",
            "library_ms": "library_backward_ms", "bound_ms": "bound_ms"}
    out = dict({k: 0.0 for k in keys}, calls=0.0)
    for shape, calls in train["in_by_shape_per_step"].items():
        row = in_grad[shape]
        for k, src in keys.items():
            out[k] += calls * row[src]
        out["calls"] += calls
    out["not_faster_than_library"] = [
        shape for shape, row in in_grad.items()
        if row["backward_ms"] >= row["library_backward_ms"]]
    return out


def norm_fed_biases(net, prefix: str = "") -> set:
    """Names of the conv biases that feed an InstanceNorm (a ConvIN with
    norm, every ConvTransposeIN): the norm cancels a per-channel shift, so
    their exact grad is 0 and what a step computes there is rounding."""
    from pix2pixhdaudiosr_torch.models.layers import ConvIN, ConvTransposeIN
    names = set()
    for name, m in net.named_modules():
        if isinstance(m, ConvTransposeIN):
            names.add(f"{prefix}{name}.ConvTranspose_0.bias")
        elif isinstance(m, ConvIN) and m.norm:
            names.add(f"{prefix}{name}.Conv_0.bias")
    return names


def grad_worst_of_bound(got: dict, want: dict, void: set, rel: float = 1e-3):
    """(worst err / bound, its leaf name) over the leaves of one net: every
    leaf within rel of its own max|g|, a leaf in `void` (norm_fed_biases)
    within rel of the net's max|g|."""
    net_max = max(v.abs().max().item() for v in want.values())
    worst = (0.0, "")
    for name, w in want.items():
        scale = net_max if name in void else w.abs().max().item()
        err = (got[name].cpu() - w.cpu()).abs().max().item()
        worst = max(worst, (err / (rel * scale), name))
    return worst


def in_f64(x, act: str):
    """act(InstanceNorm(x)), eps 1e-5, in float64 with a two-pass variance:
    the witness that the kernel's and the twin's f32 rounding is read
    against."""
    from pix2pixhdaudiosr_torch.ops.norm import activate
    xd = x.double()
    mean = xd.mean(dim=(2, 3), keepdim=True)
    var = ((xd - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return activate((xd - mean) / (var + 1e-5).sqrt(), act)


def in_witness(calls) -> dict:
    """At each InstanceNorm input of a recorded step, (x, kernel y, act),
    the distance of the kernel's y and of the f32 twin's (on the CPU) from
    in_f64, and the plane's worst conditioning: max |mean| / std, which
    E[x^2] - mean^2 in f32 loses precision to as its square."""
    import torch
    from pix2pixhdaudiosr_torch.ops.norm import instance_norm_act_ref
    rows = []
    for x, y, act in calls:
        xc = x.cpu()
        want = in_f64(xc, act)
        xd = xc.double()
        cond = (xd.mean(dim=(2, 3)).abs()
                / xd.std(dim=(2, 3), correction=0).clamp_min(1e-30))
        rows.append(dict(
            shape=list(x.shape), act=act,
            kernel_f64=(y.cpu().double() - want).abs().max().item(),
            twin_f64=(instance_norm_act_ref(xc, act).double() - want
                      ).abs().max().item(),
            cond=cond.max().item()))
    worst = max(rows, key=lambda r: max(r["kernel_f64"], r["twin_f64"]))
    return dict(worst=worst, calls=rows,
                kernel_f64=max(r["kernel_f64"] for r in rows),
                twin_f64=max(r["twin_f64"] for r in rows))


def card_branch_in(calls, source: str, flips: list = None):
    """(forward, backward) of InstanceNorm for a CPU step that follows a
    card step's activation branches: call by call, the card's recorded
    (x, y, act) give each element's branch (y >= 0 for leaky, y > 0 for
    relu, as the kernels select), which the CPU step's output and its
    backward take. An element within rounding of the kink can take either
    branch in two f32 steps, and the grads of the two differ by a jump
    (ROADMAP §C), so two steps are compared on the same branches.
    source: the output is the card's y ("card"), else the branch of the
    twin's pre-activation InstanceNorm of the card's x ("card_x") or of the
    CPU step's own x ("own"). The statistics are the twin's of its own x,
    the backward the twin's with dy times the card's slope. `flips`, if
    given, gets each call's count of elements whose own branch differs."""
    import torch
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act_grad_ref,
                                                 instance_norm_act_ref)
    it, slopes = iter(calls), {}

    def forward(x, act, with_stats=False):
        xk, yk, act_k = next(it)
        check(act_k == act and yk.shape == x.shape, "the CPU step's "
              "InstanceNorm calls differ from the card step's")
        y_own, saved = instance_norm_act_ref(x, "none", with_stats=True)
        yk, slope = yk.cpu(), None
        if act != "none":
            keep = yk >= 0 if act == "leaky" else yk > 0
            slope = torch.where(keep, 1.0, 0.2 if act == "leaky" else 0.0)
            if flips is not None:
                own = y_own >= 0 if act == "leaky" else y_own > 0
                flips.append(int((own != keep).sum()))
        if source == "card":
            y = yk
        else:
            y = y_own if source == "own" else instance_norm_act_ref(
                xk.cpu(), "none")
            y = y if slope is None else (y * slope).to(y.dtype)
        if not with_stats:
            return y
        slopes[saved.data_ptr()] = slope
        return y, saved

    def backward(x, dy, saved, act):
        check(saved.data_ptr() in slopes, "an InstanceNorm backward without "
              "its forward")
        slope = slopes.pop(saved.data_ptr())
        return instance_norm_act_grad_ref(
            x, dy if slope is None else dy * slope, saved, "none")
    return forward, backward


def card_floor(floors, min_value: float):
    """system.time_d_input for a CPU step that takes a card step's branch
    of the time-domain D's dB floor, call by call: 20 log10 of |frames|
    where the card's |frames| >= min_value (floors: its recorded masks of
    the label's and the tested frames), of min_value elsewhere, minus 20,
    as amplitude_to_db computes it. An element within rounding of the floor
    takes either branch in two f32 steps, and its grad jumps by
    8.7 / min_value (ROADMAP §C)."""
    import torch
    it = iter(floors)

    def time_d_input(label_frames, test_frames):
        keep = next(it)
        return torch.stack([20.0 * torch.log10(torch.where(
            k.to(f.device), f.abs(), min_value)) - 20.0
            for k, f in zip(keep, (label_frames, test_frames))], dim=-1)
    return time_d_input


def record_floors(system, floors: list) -> None:
    """Make system.time_d_input append, call by call, its branch of the
    dB floor to `floors` (the masks |frames| >= min_value of the label's
    and the tested frames, card_floor's input) before it computes as it
    does."""
    time_d_input, floor = system.time_d_input, system.cfg.min_value

    def spy(label, test):
        floors.append(tuple(f.detach().abs() >= floor for f in (label, test)))
        return time_d_input(label, test)
    system.time_d_input = spy


def floor_rows(floors: list, rows) -> list:
    """Recorded dB-floor branches (record_floors) of the batch's `rows`
    (an index list, or a slice), in that order, call by call."""
    return [tuple(k[rows] for k in call) for call in floors]


def _cpu(tree):
    """A codec result (tensors, dicts of tensors, tuples) on the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.detach().cpu() if hasattr(tree, "detach") else tree


def _max_err(a, b) -> float:
    return (a.detach().cpu() - b.detach().cpu()).abs().max().item()


def conv_gap(card, cpu) -> list:
    """Call by call, the generator's conv outputs of two steps: [name,
    max|card - cpu|, that over max|cpu|]."""
    return [[name, _max_err(a, b), _max_err(a, b) / b.abs().max().item()]
            for (name, a), (_, b) in zip(card, cpu)]


def g_gan_t_grad(system, batch, noise) -> float:
    """max |grad| over G's parameters of the optional discriminators' G
    loss (G_GAN_t) alone, on the system's device: it is 0 if that loss
    does not reach G (a codec inverse without a gradient)."""
    import torch
    from pix2pixhdaudiosr_torch.losses import gan_loss
    cfg = system.cfg
    with torch.no_grad():
        lr_spec, lr_pha, lr_norm = system.encode_input(batch["label"], noise)
    sr = system.netG_train(lr_spec.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
    loss = 0.0
    if cfg.use_time_d:
        frames = system.time_frames(system.codec.to_frames(sr, lr_norm))
        loss = loss + gan_loss(system.time_d_apply(system.time_d_input(
            lr_norm["frames"], frames)), True)
    if cfg.use_hifigan_d:
        loss = loss + gan_loss(system.hifigan_d_apply(
            system.codec.to_audio(sr, lr_norm, pha=lr_pha)), True)
    grads = torch.autograd.grad(loss, list(system.netG_train.parameters()))
    return max(g.abs().max().item() for g in grads)


def phase_train_reference(dev, extra=(), diagnose: bool = False) -> dict:
    """One make_train_step step of TOY_TRAIN + `extra` on the card against
    the same step on the CPU (kernel twins), f32 with TF32 off, from the same
    weights, batch and mask noise. Losses within rtol 1e-4 of the CPU
    step's. At each InstanceNorm input of the card's step the kernel's
    output sits within 4x the f32 twin's distance (+ 1e-5) of a float64
    InstanceNorm (in_witness). The card step's grads are read against three
    CPU steps:
      one that takes each InstanceNorm output from the card's step (call by
      call, in forward order), the arithmetic of every other layer its own,
      and one that takes the twin's output at the card step's InstanceNorm
      input: every grad leaf within 1e-3 max|g| (grad_worst_of_bound) of
      each (with --use_time_D, G's leaves within 1e-3 of G's max), and
      every updated parameter within 2 lr (two opposite steps where a grad
      is rounding) of the first;
      the independent CPU step, its own arithmetic throughout: D's within
      the same bound, time_D's and hifigan_D's within 1e-3 of their net's
      max|g|, G's within INDEPENDENT_G_LIMIT of the bound. The two steps'
      InstanceNorm inputs differ already (in_in_max_abs_err), by the
      rounding of the layers before them, and G's grads at this toy size
      amplify that.
    Each of the three takes the card step's branch of every InstanceNorm's
    activation (card_branch_in) and of the time-domain D's dB floor
    (card_floor); branch_flips and floor_flips count the elements where
    the independent step's own branch differs, and the independent step
    on its own branches is read beside it (..._own_branches).
    With `diagnose`, a fourth CPU step takes the card step's encoder output
    (lr and hr), its own arithmetic after it: every generator conv output
    of the card step is read against it and against the independent step's
    (conv_gap), which names where the two independent steps part, and its
    grads against the card's (grad_worst_of_bound_replay_encoder).
    Also the card step's launches: every InstanceNorm of the step records
    a gradient, so its backward kernel launches as often as its forward;
    MDCT2 twice on the tensor-core route; with --use_hifigan_D, IMDCT2 and
    its backward once each, and G's grad from G_GAN_t alone not 0."""
    import torch
    from pix2pixhdaudiosr_torch import system as system_mod
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.models import layers
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import (imdct2, imdct2_grad,
                                                         mdct2)
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = parse_config(TOY_TRAIN + list(extra), is_train=True, save=False)
    cpu = torch.Generator().manual_seed(2)
    batch = {k: torch.randn(2, TOY_SEG, generator=cpu) * 0.2
             for k in ("label", "image")}
    init = Pix2PixHDSystem(cfg, device="cpu")
    init_state(init, 0)
    b, f, t, c = init.spectro_shape(2)
    noise = torch.randn(b, init.codec.mask_size(f), t, c,
                        generator=torch.Generator().manual_seed(3))
    nets = ("G", *(("E",) if init.netE is not None else ()), *init.d_nets())

    def run(d, in_fn, in_grad=None, encoded=None, floors=None):
        """One step on device d, InstanceNorm outputs through in_fn (the
        forward of layers.InstanceNormAct, which the train step runs) and
        its backward through in_grad if given; the encoder's (lr, hr)
        results `encoded` in place of its own if given; the time-domain D's
        dB floor on the branches `floors` (card_floor) if given. Records the
        encoder's results, every generator conv output and the dB floor's
        branches."""
        system = Pix2PixHDSystem(cfg, device=d)
        state = init_state(system, 0)
        system.netG_train.load_state_dict(init.netG_train.state_dict())
        for key, net in system.d_nets().items():
            net.load_state_dict(init.d_nets()[key].state_dict())
        if system.netE is not None:
            system.netE.load_state_dict(init.netE.state_dict())
        enc, convs, fm_signs = [], [], []
        for i, side in enumerate(("encode_input", "encode_target")):
            fn = getattr(system, side)
            if encoded is not None:
                fn = (lambda r: lambda *a, **k: r)(_cpu(encoded[i]))
            setattr(system, side, (lambda fn: lambda *a, **k: (
                enc.append(fn(*a, **k)) or enc[-1]))(fn))
        hooks = [m.register_forward_hook(
            (lambda n: lambda m, i, o: convs.append((n, o.detach())))(name))
            for name, m in system.netG_train.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        layers.instance_norm_act = in_fn
        layers.instance_norm_act_grad = in_grad or instance_norm_act_grad
        fm_loss = system_mod.feature_matching_loss
        own_floors = []
        if floors is None:
            record_floors(system, own_floors)
        else:
            system.time_d_input = card_floor(floors, cfg.min_value)

        def fm_spy(fake, real, *args):
            """The signs of the feature-matching L1's differences."""
            fm_signs.extend(torch.sign(f.detach().float() - r.float()).cpu()
                            for sf, sr in zip(fake, real)
                            for f, r in zip(sf[:-1], sr[:-1]))
            return fm_loss(fake, real, *args)
        system_mod.feature_matching_loss = fm_spy
        try:
            losses, _ = make_train_step(system)(
                state, {k: v.to(d) for k, v in batch.items()}, noise.to(d))
        finally:
            layers.instance_norm_act = instance_norm_act
            layers.instance_norm_act_grad = instance_norm_act_grad
            system_mod.feature_matching_loss = fm_loss
            del system.time_d_input
            for h in hooks:
                h.remove()
        named = {**system.g_nets(), **system.d_nets()}
        return dict(losses={k: float(v) for k, v in losses.items()},
                    grads={f"{p}.{n}": w.grad.detach().cpu() for p, net in
                           named.items() for n, w in net.named_parameters()},
                    params={f"{p}.{n}": w.detach().cpu() for p, net in
                            named.items() for n, w in net.named_parameters()},
                    encoded=enc, convs=convs, fm_signs=fm_signs,
                    floors=own_floors, system=system)

    def recorder(calls):
        def fn(x, act, **kw):
            out = instance_norm_act(x, act, **kw)
            y = out[0] if isinstance(out, tuple) else out
            calls.append((x.detach(), y.detach(), act))
            return out
        return fn

    card_in, cpu_in = [], []
    for fn in (instance_norm_act, instance_norm_act_grad, mdct2, imdct2,
               imdct2_grad):
        reset_counts(fn)
    got = run(dev, recorder(card_in))
    res = dict(flags=list(extra), in_launches=instance_norm_act.launches,
               in_launches_onepass=instance_norm_act.launches_onepass,
               in_grad_launches=instance_norm_act_grad.launches,
               in_grad_launches_by_route=dict(
                   instance_norm_act_grad.launches_by_route),
               mdct2_launches_tc=mdct2.launches_tc,
               imdct2_launches_tc=imdct2.launches_tc,
               imdct2_grad_launches=imdct2_grad.launches,
               imdct2_grad_launches_tc=imdct2_grad.launches_tc)
    if cfg.use_time_d or cfg.use_hifigan_d:
        res["g_gan_t_grad_max"] = g_gan_t_grad(
            got["system"], {k: v.to(dev) for k, v in batch.items()},
            noise.to(dev))
    want = run("cpu", recorder(cpu_in))
    same = run("cpu", *card_branch_in(card_in, "card"),
               floors=got["floors"])
    twin = run("cpu", *card_branch_in(card_in, "card_x"),
               floors=got["floors"])
    flips = []
    aligned = run("cpu", *card_branch_in(card_in, "own", flips),
                  floors=got["floors"])
    res["branch_flips"] = sum(flips)
    res["floor_flips"] = sum(int((a.cpu() != b).sum()) for ca, cb in zip(
        got["floors"], want["floors"]) for a, b in zip(ca, cb))
    res["sign_flips"] = sum(int(((a.cpu() > 0) != (b > 0)).sum())
                            for (_, a, act), (_, b, _) in zip(card_in, cpu_in)
                            if act != "none")
    # the two independent steps' InstanceNorm inputs and outputs, call by call
    res["in_in_max_abs_err"] = max((a.cpu() - b).abs().max().item()
                                   for (a, _, _), (b, _, _) in zip(card_in, cpu_in))
    res["in_out_max_abs_err"] = max((a.cpu() - b).abs().max().item()
                                    for (_, a, _), (_, b, _) in zip(card_in, cpu_in))
    witness = in_witness(card_in)
    res["in_f64"] = {k: witness[k] for k in ("kernel_f64", "twin_f64", "worst")}
    res["loss_rel_err"] = {k: abs(got["losses"][k] - v) / abs(v)
                           for k, v in want["losses"].items()}
    res["loss_rel_err_card_in"] = {k: abs(got["losses"][k] - v) / abs(v)
                                   for k, v in same["losses"].items()}
    void = set().union(*(norm_fed_biases(net, f"{key}.") for key, net in
                         (*init.g_nets().items(), *init.d_nets().items())))

    def worst(other, rel_net=()):
        """grad_worst_of_bound of the card step against `other`, a net;
        the nets in `rel_net` with every leaf read against the net's max."""
        out = {}
        for net in nets:
            pick = {k: v for k, v in other["grads"].items()
                    if k.startswith(net + ".")}
            g = {k: v for k, v in got["grads"].items() if k.startswith(net + ".")}
            out[net] = grad_worst_of_bound(g, pick, set(pick) if net in rel_net
                                           else void)
        return out
    # with the time-domain D, G's grads against the replayed steps are read
    # against G's max: its loss reads the G output through 10^(x/20) and the
    # dB of the frames, so the final conv's rounding moves the small leaves
    # (enh1_final's bias: 1.85x their own bound on an H100)
    g_rel = ("G",) if cfg.use_time_d else ()
    # netE's leaves against netE's max: its output bias sums the pooled
    # grads over every pixel, which nearly cancel (two f32 steps on the CPU
    # part by ~1e-3 of that leaf, tests/test_torch_feature_encoder.py)
    if init.netE is not None:
        g_rel += ("E",)
        res["pha_flips"] = int((got["encoded"][0][1].cpu()
                                != want["encoded"][0][1]).sum())
    res["grad_worst_of_bound"] = worst(same, g_rel)
    res["grad_worst_of_bound_twin_at_card_inputs"] = worst(twin, g_rel)
    if g_rel:
        res["grad_worst_of_leaf_bound_card_in"] = worst(same)
    # the independent step on the card's branches (checked; with the
    # time-domain D, G's leaves against G's max, as above), and on its own
    # (read: one element within rounding of a kink moves time_D's grads by
    # 4.5e-3 of their max, ROADMAP §C)
    res["grad_worst_of_bound_independent"] = worst(aligned, g_rel)
    res["grad_worst_of_net_max_independent"] = worst(aligned, nets)
    res["grad_worst_of_bound_independent_own_branches"] = worst(want)
    res["grad_worst_of_net_max_independent_own_branches"] = worst(want, nets)
    if diagnose:
        replayed = run("cpu", instance_norm_act, encoded=got["encoded"])
        res["encode_max_abs_err"] = {
            side: _max_err(a[0], b[0]) for side, a, b in
            zip(("lr", "hr"), got["encoded"], want["encoded"])}
        res["conv_gap_independent"] = conv_gap(got["convs"], want["convs"])
        # elements of the feature-matching L1's |fake - real| whose sign
        # differs between the two independent steps: each moves the L1's
        # subgradient by 2 w / N, whatever the size of the rounding
        res["fm_l1_sign_flips"] = [
            int((a != b).sum()) for a, b in zip(got["fm_signs"],
                                                want["fm_signs"])]
        res["conv_gap_replay_encoder"] = conv_gap(got["convs"],
                                                  replayed["convs"])
        res["grad_worst_of_bound_replay_encoder"] = worst(replayed)
        res["loss_rel_err_replay_encoder"] = {
            k: abs(got["losses"][k] - v) / abs(v)
            for k, v in replayed["losses"].items()}
        del replayed
    res["param_max_abs_err"] = max((got["params"][k] - v).abs().max().item()
                                   for k, v in same["params"].items())
    res["losses"] = got["losses"]
    print("[train reference] CUDA vs CPU, f32: " + json.dumps(res))
    print("[train reference] InstanceNorm against float64, call by call: "
          + json.dumps(witness["calls"]))
    # every loss within rtol 1e-4 (+ 1e-9 for a loss near 0) of the CPU
    # step on the card's InstanceNorm outputs; of the independent step's
    # too for the plain step, whose losses do not go through the codec
    # inverse (it maps the G output's rounding through 10^(x/20) of a
    # 140 dB range: 16x)
    for key in ("loss_rel_err_card_in",) + (("loss_rel_err",) if not extra
                                            else ()):
        ref = same if key == "loss_rel_err_card_in" else want
        check(all(abs(got["losses"][k] - v) <= 1e-4 * abs(v) + 1e-9
                  for k, v in ref["losses"].items()),
              f"train step losses off the CPU's: {key} {res[key]}")
    for r in witness["calls"]:
        check(r["kernel_f64"] <= 4 * r["twin_f64"] + 1e-5,
              f"B3 off float64 by more than 4x the twin's distance: {r}")
    for key in ("grad_worst_of_bound", "grad_worst_of_bound_twin_at_card_inputs"):
        check(all(w <= 1 for w, _ in res[key].values()),
              f"train step grads off the CPU's: {key} {res[key]}")
    indep, net_max = (res["grad_worst_of_bound_independent"],
                      res["grad_worst_of_net_max_independent"])
    check(indep["D"][0] <= 1 and indep["G"][0] <= INDEPENDENT_G_LIMIT
          and all(net_max[k][0] <= 1 for k in nets if k not in ("G", "D")),
          f"train step grads off the independent CPU step's: {indep}, "
          f"of the net's max: {net_max}")
    # two Adam steps of lr in opposite directions, and the weights' rounding
    check(res["param_max_abs_err"] <= 2 * cfg.lr * (1 + 1e-3),
          f"updated params off the CPU's by {res['param_max_abs_err']}")
    n_inv = int(cfg.use_hifigan_d)
    check(res["in_launches"] == res["in_launches_onepass"] > 0
          and res["in_grad_launches"] == res["in_launches"]
          and res["mdct2_launches_tc"] == TRAIN_MDCT_LAUNCHES
          and res["imdct2_launches_tc"] == n_inv
          and res["imdct2_grad_launches"] == res["imdct2_grad_launches_tc"]
          == n_inv, f"toy train step launches: {res}")
    if "g_gan_t_grad_max" in res:
        check(res["g_gan_t_grad_max"] > 0, "G_GAN_t gives G no gradient")
    return res


def _phase_of(event) -> str:
    """forward, backward or optimizer: the part of a train step that a
    profiler event belongs to, by its outermost enclosing event."""
    while event.cpu_parent is not None:
        event = event.cpu_parent
    if event.name.startswith("autograd::engine::evaluate_function"):
        return "backward"
    if event.name.startswith("Optimizer."):
        return "optimizer"
    return "forward"


def _is_annotation(event) -> bool:
    """A user range mirrored on the device timeline (record_function, as
    torch.optim wraps step in): it spans kernels, so it is not one."""
    return (getattr(event, "is_user_annotation", False)
            or event.key.startswith("Optimizer."))


def _is_runtime(event) -> bool:
    """A CUDA runtime or driver call, or a CUPTI marker, on the host
    timeline (cudaLaunchKernel, cuLaunchKernel, "Command Buffer Full"),
    not an operator."""
    name = event.name
    return (name.startswith("cuda") or name == "Command Buffer Full"
            or (name.startswith("cu") and name[2:3].isupper()))


def _owners(events) -> list:
    """The CPU events whose kernels a trace counts, one per correlation id.
    The profiler hands a kernel to every CPU event whose id equals the
    kernel's launching operator's id, and a runtime call or a CUPTI marker
    numbers its events in another sequence that can meet an operator's:
    torch.optim's launch bursts fill the command buffer, and each "Command
    Buffer Full" marker that met the id of a foreach op of the Adam step
    took that op's kernels a second time (the time-D + match step's
    optimizer part read 14.52-18.16 ms against its kernels' 4.33, H100).
    Of the events sharing an id, an operator owns the kernels."""
    from torch.autograd import DeviceType
    owners = {}
    for e in events:
        if e.device_type == DeviceType.CUDA or not e.kernels:
            continue
        held = owners.get(e.id)
        if held is None or (_is_runtime(held) and not _is_runtime(e)):
            owners[e.id] = e
    return list(owners.values())


def trace_split(events) -> dict:
    """A traced step's device time from its profiler events (prof.events()):
    kernel_ms, the sum of its kernels' and copies' durations (the device
    events that are not user ranges, _is_annotation); busy_ms, the time
    the device ran one or more of them (the union of their intervals: the
    HiFi-GAN D's grouped convs run on 16 side streams beside the step's
    own, so there the sum exceeds the step's span); parts_ms, kernel_ms by
    the part of the step whose outermost event launched each kernel
    (_phase_of), each kernel counted once, under the operator that owns it
    (_owners); part_kernels, {part: {kernel: [ms, calls]}}; streams, the
    device streams that ran a kernel. A user range mirrored on the device
    (torch.optim's "Optimizer.step#...") can come back as a kernel of the
    CPU event that opened it, spanning the kernels under it and the idle
    time between them: it is no kernel, so the parts leave it out
    (range_ms: what it would have added)."""
    from torch.autograd import DeviceType
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not _is_annotation(e)]
    ranges = {e.name for e in events if e.device_type == DeviceType.CUDA
              and _is_annotation(e)}
    parts = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    part_kernels = {k: {} for k in parts}
    range_ms = 0.0
    for e in _owners(events):
        for k in e.kernels:
            ms = k.duration / 1e3
            if k.name in ranges:
                range_ms += ms
                continue
            part = _phase_of(e)
            parts[part] += ms
            row = part_kernels[part].setdefault(k.name[:60], [0.0, 0])
            row[0] += ms
            row[1] += 1
    busy, end = 0.0, None
    for s, t in sorted((e.time_range.start, e.time_range.end)
                       for e in on_device):
        if end is None or s > end:
            busy, end = busy + (t - s), t
        elif t > end:
            busy, end = busy + (t - end), t
    return dict(kernel_ms=sum(e.self_device_time_total
                              for e in on_device) / 1e3,
                busy_ms=busy / 1e3, parts_ms=parts,
                part_kernels=part_kernels, range_ms=range_ms,
                streams=len({getattr(e, "device_resource_id", None)
                             for e in on_device}))


def trace_problems(split: dict, event_ms: float) -> list:
    """What makes a traced step's split (trace_split) disagree with itself
    or with the step's own CUDA-event time: its parts not summing to its
    kernels within 1% (a kernel counted twice, or under no part), or the
    device busy beyond 1.05x the time between the events around the step
    (no kernel of the step runs outside them; on one stream busy_ms is
    the kernels' sum)."""
    out = []
    parts, total = sum(split["parts_ms"].values()), split["kernel_ms"]
    if abs(parts - total) > 0.01 * total:
        out.append(f"its parts sum to {parts:.3f} ms, its kernels to "
                   f"{total:.3f} ms")
    if split["busy_ms"] > 1.05 * event_ms:
        out.append(f"its kernels keep the device busy {split['busy_ms']:.3f} "
                   f"ms, beyond 1.05x its {event_ms:.3f} ms by CUDA events")
    return out


def profile_train_step(run_step, top: int = 16) -> dict:
    """One traced train step, CUDA events around it inside the trace: its
    time by those events (event_ms), the device time of its kernels
    (busy_ms: the time the device ran one or more; kernel_ms, their sum;
    the two are equal on one stream) and by
    part (forward, backward, optimizer: trace_split) with each part's top
    4 kernels by device time, what disagrees (trace_problems, which the
    caller checks), the InstanceNorm forward's device time (under the
    Function's op), its backward's (under the autograd node
    InstanceNormActBackward) with its share and its kernels by name (ms,
    calls), and the `top` kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):  # a trace may come back without kernels (kernel_ms 0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            run_step()
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        split = trace_split(events)
        if split["kernel_ms"] > 0:
            break
    else:
        raise SmokeFailure("3 profiler traces of a train step came back "
                           "without kernels")
    event_ms = start.elapsed_time(end)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not _is_annotation(e)),
                     key=lambda e: -e.self_device_time_total)
    in_fwd, in_bwd, in_kernels = 0.0, 0.0, {}
    for e in _owners(events):
        ms = e.self_device_time_total / 1e3
        outer = e
        while outer.cpu_parent is not None:
            outer = outer.cpu_parent
        # the Function's forward is the op "InstanceNormAct", its backward
        # the autograd node "InstanceNormActBackward"
        if "InstanceNormActBackward" in outer.name:
            in_bwd += ms
            for k in e.kernels:
                row = in_kernels.setdefault(k.name[:70], [0.0, 0])
                row[0] += k.duration / 1e3
                row[1] += 1
        elif "InstanceNormAct" in outer.name:
            in_fwd += ms
    return dict(host_wall_ms=wall, event_ms=event_ms,
                busy_ms=split["busy_ms"], kernel_ms=split["kernel_ms"],
                streams=split["streams"], parts_ms=split["parts_ms"],
                range_ms=split["range_ms"],
                problems=trace_problems(split, event_ms),
                parts_top={k: sorted(([n, *v] for n, v in rows.items()),
                                     key=lambda r: -r[1])[:4]
                           for k, rows in split["part_kernels"].items()},
                in_forward_ms=in_fwd,
                in_backward_ms=in_bwd,
                in_backward_share=in_bwd / split["kernel_ms"],
                in_backward_kernels=sorted(([k, *v] for k, v in in_kernels.items()),
                                           key=lambda r: -r[1]),
                top=[[e.key[:80], e.self_device_time_total / 1e3, e.count]
                     for e in kernels[:top]])


def dy_layouts(run_step) -> dict:
    """The dy that autograd hands the InstanceNorm backward in one step, by
    (H, W, C), dtype and strides, with how many of them the wrapper copied
    (ops/norm._readable_dy)."""
    import torch
    from pix2pixhdaudiosr_torch.ops import norm
    seen, readable = {}, norm._readable_dy

    def spy(x, dy, vectors):
        out = readable(x, dy, vectors)
        B, C, H, W = x.shape
        key = f"{H}x{W}x{C} {str(dy.dtype)[6:]} strides {tuple(dy.stride())}"
        row = seen.setdefault(key, dict(calls=0, copied=0))
        row["calls"] += 1
        row["copied"] += int(out[0] is not dy)
        return out
    norm._readable_dy = spy
    try:
        run_step()
        torch.cuda.synchronize()  # a trace after this starts on an idle card
    finally:
        norm._readable_dy = readable
    return seen


def expected_step_launches(cfg) -> dict:
    """A flagship train step's launches by kernel (all on the fast route):
    B3 and its backward 40, + 18 with the time-domain D (6 in each of its 3
    forwards); with --remat_g, B3 22 more (G's, recomputed in the
    backward); B1 2 (the lr and the hr encode); with the HiFi-GAN D, B2 1
    (to_audio of the G output, whose detached value feeds the D side) and
    its backward 1."""
    n_in = TRAIN_IN_LAUNCHES + TIME_D_IN_LAUNCHES * cfg.use_time_d
    n_inv = int(cfg.use_hifigan_d)
    n_remat = sum(G_IN_BY_SHAPE.values()) if cfg.remat_g else 0
    return {"instance_norm_act": n_in + n_remat,
            "instance_norm_act_grad": n_in,
            "mdct2": TRAIN_MDCT_LAUNCHES, "imdct2": n_inv, "imdct2_grad": n_inv}


def spy_codec_dtypes(system) -> dict:
    """Record, for every call of the codec half of the optional losses
    (codec.to_frames, the time-domain D's f32 pair, codec.to_audio's
    IMDCT2 input and output), the dtypes it produced: each must be
    float32 in a bf16 step. Returns the dict the records land in."""
    seen = {}

    def note(key, t):
        seen.setdefault(key, set()).add(str(t.dtype)[6:])
        return t
    codec = system.codec
    to_frames, time_d_input, imdct = (codec.to_frames, system.time_d_input,
                                      codec.imdct)
    codec.to_frames = lambda *a, **k: note("to_frames", to_frames(*a, **k))
    system.time_d_input = lambda *a, **k: note("time_d_input",
                                               time_d_input(*a, **k))
    codec.imdct = lambda spec: note("imdct2_out", imdct(note("imdct2_in", spec)))
    return seen


def opt_state_bytes(opt) -> int:
    """Bytes of an optimizer's moments (every state tensor but the step)."""
    import torch
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for k, t in st.items() if torch.is_tensor(t) and k != "step")


def flagship_train_batch(dev, batch: int, seed: int = 4) -> dict:
    """A seeded batch of hr tones and their noisy lr, [batch, SEG] on dev."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(SEG, device=dev) / 48000
    f0 = 100 + 400 * torch.rand(batch, 1, generator=gen, device=dev)
    hr = 0.3 * torch.sin(2 * torch.pi * f0 * t) + 0.01 * torch.randn(
        batch, SEG, generator=gen, device=dev)
    return {"image": hr, "label": hr + 0.05 * torch.randn(
        batch, SEG, generator=gen, device=dev)}


def phase_train_step(dev, counters, extra=(), batch: int = TRAIN_BATCH) -> dict:
    """The flagship train step (+ the recipe flags `extra`) at `batch`
    through trainer.make_train_step: seeded N(0, 0.02) weights, a seeded
    batch of lr and hr waveforms, a mask-noise generator a step. 2 warm-up
    and 5 timed steps (CUDA events around each), every kernel counter set
    to 0 just before the warm-up and read just after the last step; then
    one traced step. Checks: every loss finite each step, every parameter
    of every net moved, each kernel's launches a step as
    expected_step_launches (B3 all one-pass, its backward shape by shape
    as the forward's, by route and the dy copies reported; MDCT2, IMDCT2
    and IMDCT2's backward on the tensor-core route), no launch of the
    serving-only kernels, the optional losses' codec half in f32, and the
    traced step consistent with itself and its CUDA events
    (trace_problems: its parts within 1% of its kernels' sum, the device
    busy within 1.05x the events' span).
    With --remat_g, B3's forward launches G's 22 again a step (shape by
    shape, the backward's + G's); the Adams' moment bytes are read (with
    --adam_mu_bf16 G's are 6 bytes a parameter, else 8)."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state, make_train_step

    # earlier phases' systems (the spies close reference cycles over them)
    # must be gone before the peak is read
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    cfg = parse_config([*FLAGSHIP, "--batchSize", str(batch), *extra],
                       is_train=True, save=False)
    system = Pix2PixHDSystem(cfg, device=dev)
    state = init_state(system, 0)
    n_params = {k: sum(p.numel() for p in net.parameters()) for k, net in
                (("G", system.netG_train), *system.d_nets().items())}
    check((n_params["G"], n_params["D"]) == (156_050_690, 5_531_522),
          f"parameters {n_params}")
    dtypes = spy_codec_dtypes(system)
    data = flagship_train_batch(dev, batch)
    step = make_train_step(system)
    params = [p for net in (system.netG_train, *system.d_nets().values())
              for p in net.parameters()]
    before = [p.detach().clone() for p in params]
    seeds = iter(range(1000))

    def run_step():
        noise_gen = torch.Generator(device=dev).manual_seed(next(seeds))
        return step(state, data, noise_gen)[0]

    for fn in counters.values():
        reset_counts(fn)
    losses = [run_step() for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        losses.append(run_step())
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_steps = len(losses)
    launches = {k: fn.launches for k, fn in counters.items()}
    inorm, grad = counters["instance_norm_act"], counters["instance_norm_act_grad"]
    res = dict(flags=list(extra), batch=batch, params=n_params,
               params_g=n_params["G"], params_d=n_params["D"], steps=n_steps,
               ms_per_step=sum(ms) / len(ms), ms_runs=ms,
               segments_per_s=batch / (sum(ms) / len(ms) / 1e3),
               peak_gib=peak, launches=launches,
               launches_per_step={k: n / n_steps for k, n in launches.items()},
               tc_launches_per_step={
                   k: counters[k].launches_tc / n_steps
                   for k in ("mdct2", "imdct2", "imdct2_grad") if k in counters},
               in_launches_per_step=inorm.launches / n_steps,
               in_onepass_per_step=inorm.launches_onepass / n_steps,
               in_by_shape_per_step={f"{h}x{w}x{c}": n / n_steps for (h, w, c), n
                                     in inorm.launches_by_shape.items()},
               mdct2_tc_per_step=counters["mdct2"].launches_tc / n_steps,
               in_grad_per_step=grad.launches / n_steps,
               in_grad_by_route_per_step={
                   k: n / n_steps for k, n in grad.launches_by_route.items()},
               in_grad_dy_copies_by_shape_per_step={
                   f"{h}x{w}x{c}": n / n_steps for (h, w, c), n
                   in grad.dy_copies_by_shape.items()},
               codec_dtypes={k: sorted(v) for k, v in dtypes.items()},
               opt_state_bytes={"G": opt_state_bytes(state.opt_g),
                                "D": opt_state_bytes(state.opt_d)},
               losses=[{k: float(v) for k, v in l.items()} for l in losses])
    moved = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, params))
    res["params_moved"], res["param_tensors"] = moved, len(before)
    del before
    counts = {k: (fn.launches, getattr(fn, "launches_tc", None))
              for k, fn in counters.items()}
    remat = {k: n * n_steps for k, n in G_IN_BY_SHAPE.items()} \
        if cfg.remat_g else {}
    shapes_ok = ({k: n for k, n in inorm.launches_by_shape.items()}
                 == {k: n + remat.get(k, 0) for k, n
                     in grad.launches_by_shape.items()})
    onepass = inorm.launches_onepass
    if not extra:
        res["in_grad_dy_layouts"] = dy_layouts(run_step)
    res["profile"] = profile_train_step(run_step)
    print(f"[train step{' ' + ' '.join(extra) if extra else ''}] "
          + json.dumps(res))
    check(all(all(map(lambda v: v == v and abs(v) != float("inf"), l.values()))
              for l in res["losses"]), "a train-step loss is not finite")
    check(moved == res["param_tensors"], f"{res['param_tensors'] - moved} "
          f"parameter tensors did not move")
    check(not res["profile"]["problems"], f"the traced step: "
          f"{'; '.join(res['profile']['problems'])}")
    want = expected_step_launches(cfg)
    for k, fn in counters.items():
        n, n_tc = counts[k]
        check(n == want.get(k, 0) * n_steps, f"the train step launched {k} "
              f"{n}x in {n_steps} steps, expected {want.get(k, 0)} a step")
        check(n_tc is None or n_tc == n, f"{k}: {n_tc} of {n} launches on "
              f"the tensor-core route")
    check(onepass == counts["instance_norm_act"][0],
          f"InstanceNorm: {onepass} of {counts['instance_norm_act'][0]} "
          f"launches one-pass")
    # the backward kernel takes every InstanceNorm backward of the step:
    # as many launches as forwards, shape by shape (the closed form is on
    # no path: layers.InstanceNormAct calls instance_norm_act_grad only),
    # less G's recomputed forwards under --remat_g
    check(shapes_ok, f"InstanceNorm backward by shape {grad.launches_by_shape}"
          f", the forward's {inorm.launches_by_shape}")
    # every dy autograd hands the backward is read in place: the plain
    # step's 12 NCHW ones (G's reflect pads, D's feature-matching L1) too
    print(f"[in grad] the step's InstanceNorm backward "
          f"{' '.join(extra) or 'plain'}: "
          f"{res['profile']['in_backward_ms']:.3f} device ms (kernels and "
          f"copies), dy copies a step "
          f"{res['in_grad_dy_copies_by_shape_per_step']}")
    if not extra:
        check(not res["in_grad_dy_copies_by_shape_per_step"],
              f"the plain step copied dy: "
              f"{res['in_grad_dy_copies_by_shape_per_step']}")
    check(res["opt_state_bytes"]["G"]
          == (6 if cfg.adam_mu_bf16 else 8) * n_params["G"],
          f"G's Adam moments take {res['opt_state_bytes']['G']} bytes for "
          f"{n_params['G']} parameters")
    check(all(v == ["float32"] for v in res["codec_dtypes"].values())
          and ("to_frames" in dtypes) == (cfg.use_match_loss or cfg.use_time_d)
          and ("imdct2_out" in dtypes) == cfg.use_hifigan_d,
          f"the optional losses' codec half: {res['codec_dtypes']}")
    del system, state, data, run_step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def remat_norm_inputs(system, data, noise, mode: str) -> tuple:
    """The InstanceNorm inputs of the G forward (netE's included) in one
    system.losses_and_grads under --remat_g `mode`, keyed by call order:
    (the forward's, the backward's recompute's), each a list of copies of
    the inputs of models/layers.instance_norm_act (the entry of the
    InstanceNormAct Function) made while the function that
    system.remat_forward rematerializes runs. The recompute must reproduce
    the forward bit for bit, as the JAX package's remat does."""
    from pix2pixhdaudiosr_torch import system as system_mod
    from pix2pixhdaudiosr_torch.models import layers
    calls, inside = [], [False]
    norm, remat = layers.instance_norm_act, system_mod.remat_forward

    def spy_norm(x, act, **kw):
        if inside[0]:
            calls.append(x.detach().clone())
        return norm(x, act, **kw)

    def spy_remat(fn, how):
        def flagged():
            inside[0] = True
            try:
                return fn()
            finally:
                inside[0] = False
        return remat(flagged, how)

    cfg = system.cfg
    layers.instance_norm_act, system_mod.remat_forward = spy_norm, spy_remat
    system.cfg = cfg.replace(remat_g=mode)
    try:
        system.losses_and_grads(data, noise=noise)
    finally:
        layers.instance_norm_act, system_mod.remat_forward = norm, remat
        system.cfg = cfg
    half = len(calls) // 2
    return calls[:half], calls[half:]


def remat_forward_check(first: list, again: list, n_norms: int) -> dict:
    """remat_norm_inputs' two lists read against each other: both hold
    n_norms calls, and how many are torch.equal, with the first that is
    not (its order, shape, elements that differ and their largest gap)."""
    import torch
    equal = [a.shape == b.shape and bool(torch.equal(a, b))
             for a, b in zip(first, again)]
    out = dict(calls=[len(first), len(again)], equal=sum(equal),
               first_differing=None)
    if False in equal:
        i = equal.index(False)
        a, b = first[i], again[i]
        out["first_differing"] = dict(index=i, shape=list(a.shape)) if (
            a.shape != b.shape) else dict(
            index=i, shape=list(a.shape), elements=int((a != b).sum()),
            max_abs=(a.float() - b.float()).abs().max().item())
    out["ok"] = (len(first) == len(again) == n_norms
                 and out["equal"] == n_norms)
    return out


def phase_remat_grads(dev, batch: int = REMAT_BATCH) -> dict:
    """The flagship step's losses_and_grads (seeded weights, batch and mask
    noise) on the card, three times plain, then with --remat_g full and
    dots, in f32 and in bf16, cuDNN timing its algorithms (as the rest of
    phase 11). Each net's gap between two runs is its worst leaf's
    max|a - b| over the net's max|g|; the card's plain runs differ
    (reflect-pad backward atomics, and in f32 the forward too), so in f32
    the remat runs' gap to the first plain run must stay within 4x the
    widest gap of the three plain pairs + 1e-6. The bf16 grads are read,
    not held: a bf16 step's grads follow its forward's rounding, and
    --remat_g full runs G's forward on other cuDNN algorithms than the
    plain step (system._same_convs; G's gap 0.14 of its max on an H100,
    the plain pairs 0.010; before, on the timed ones, 0.10 and 0.0099 in
    two calls). What holds bf16 is the forward: in one more
    step for each mode, every InstanceNorm input of G that the backward
    recomputes must equal the forward's bit for bit (remat_norm_inputs,
    remat_forward_check), as the JAX package's remat does. B3 launches 40
    a plain run and 62 a remat run (G's 22 recomputed), its backward 40
    each."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state

    def gap(a, b):
        out = {}
        for k in a:
            scale = max(g.abs().max().item() for g in a[k])
            out[k] = max((x - y).abs().max().item()
                         for x, y in zip(a[k], b[k])) / scale
        return out

    torch.backends.cudnn.benchmark = True
    res = dict(batch=batch)
    for dtype in ("float32", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = parse_config([*FLAGSHIP, "--batchSize", str(batch),
                            "--compute_dtype", dtype], is_train=True,
                           save=False)
        system = Pix2PixHDSystem(cfg, device=dev)
        init_state(system, 0)
        data = flagship_train_batch(dev, batch, seed=8)
        b, f, t, c = system.spectro_shape(batch)
        noise = torch.randn(b, system.codec.mask_size(f), t, c, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(9))
        nets = {**system.g_nets(), **system.d_nets()}

        def grads(mode):
            system.cfg = cfg.replace(remat_g=mode)
            for fn in (instance_norm_act, instance_norm_act_grad):
                reset_counts(fn)
            losses, _ = system.losses_and_grads(data, noise=noise)
            torch.cuda.synchronize()
            return ({k: float(v) for k, v in losses.items()},
                    {k: [p.grad.detach().clone() for p in net.parameters()]
                     for k, net in nets.items()},
                    (instance_norm_act.launches, instance_norm_act_grad.launches))

        plain = [grads("") for _ in range(3)]
        remat = {m: grads(m) for m in ("full", "dots")}
        system.cfg = cfg
        base = plain[0][1]
        pairs = [gap(plain[i][1], plain[j][1]) for i, j in ((0, 1), (0, 2), (1, 2))]
        spread = {k: max(p[k] for p in pairs) for k in base}
        row = dict(plain_gaps=pairs, plain_spread=spread,
                   plain_launches=[r[2] for r in plain])
        for mode, run in remat.items():
            row[mode] = dict(
                gap=gap(base, run[1]),
                bit_identical=all(torch.equal(x, y) for k in base
                                  for x, y in zip(base[k], run[1][k])),
                loss_max_rel_err=max(abs(v - plain[0][0][k])
                                     / abs(plain[0][0][k])
                                     for k, v in run[0].items()),
                launches=run[2])
        if dtype == "bfloat16":
            n_norms = sum(count_norms(net) for net in system.g_nets().values())
            row["forward_recompute"] = {}
            for mode in ("full", "dots"):
                t1 = time.perf_counter()
                r = remat_forward_check(*remat_norm_inputs(
                    system, data, noise, mode), n_norms)
                row["forward_recompute"][mode] = dict(
                    r, seconds=time.perf_counter() - t1)
        res[dtype] = row
        del system, plain, remat, base, data
    print("[remat grads] " + json.dumps(res))
    for dtype in ("float32", "bfloat16"):
        row = res[dtype]
        for mode in ("full", "dots"):
            r = row[mode]
            check(dtype != "float32" or all(
                r["gap"][k] <= 4 * row["plain_spread"][k] + 1e-6
                for k in r["gap"]), f"--remat_g {mode} grads off the plain "
                f"step's in f32: {r['gap']}, plain runs {row['plain_spread']}")
            check(r["launches"] == (TRAIN_IN_LAUNCHES
                                    + sum(G_IN_BY_SHAPE.values()),
                                    TRAIN_IN_LAUNCHES),
                  f"--remat_g {mode}: B3 / its backward launched "
                  f"{r['launches']}")
        check(all(n == (TRAIN_IN_LAUNCHES, TRAIN_IN_LAUNCHES)
                  for n in row["plain_launches"]),
              f"plain: B3 / its backward launched {row['plain_launches']}")
    for mode, r in res["bfloat16"]["forward_recompute"].items():
        check(r["ok"], f"--remat_g {mode} in bf16: the backward's recompute "
              f"of G's InstanceNorm inputs differs from the forward's: {r}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def count_norms(net) -> int:
    """InstanceNorms in one forward of net (a ConvIN with norm, every
    ConvTransposeIN)."""
    from pix2pixhdaudiosr_torch.models.layers import ConvIN, ConvTransposeIN
    return sum(isinstance(m, ConvTransposeIN)
               or (isinstance(m, ConvIN) and m.norm) for m in net.modules())


def phase_family_a(dev, counters) -> dict:
    """Family A's instance-feature recipe (FAMILY_A) through the training
    CLI on a corpus of FLAC files (the port's write_flac): 2 steps at batch
    10 over 10 files, 2 epochs, `latest` saved at each end, then
    --continue_train for a third. Checks: netE built and trained (its file
    written), every decode of the run on the native route, B3 and its
    backward launched a step as many times as G, netE and 3 D forwards hold
    InstanceNorms, B1 2 a step, and before the resumed run's first step G,
    netE and D equal to the saved weights."""
    import numpy as np
    import torch
    from pix2pixhdaudiosr_torch import train_loop
    from pix2pixhdaudiosr_torch.data import flac
    corpus = os.path.join(WORK, "family_a")
    os.makedirs(corpus)
    for i in range(2):
        flac.write_flac(os.path.join(corpus, f"a{i}.flac"),
                        synthetic_audio(1.0, 180 + 70 * i, 20 + i), 48000)
    for i in range(2, FAMILY_A_BATCH):     # the same bytes, 10 files
        shutil.copy(os.path.join(corpus, f"a{i % 2}.flac"),
                    os.path.join(corpus, f"a{i}.flac"))
    expr = os.path.join(WORK, "family_a_run")
    argv = ["--name", "family_a_run", "--checkpoints_dir", WORK, "--dataroot",
            corpus, "--device", dev, *FAMILY_A, "--batchSize",
            str(FAMILY_A_BATCH), "--niter_decay", "0", "--no_html",
            "--validation_split", "0", "--print_freq", str(FAMILY_A_BATCH),
            "--save_latest_freq", "0", "--save_epoch_freq", "1"]
    before = dict(flac.decodes)
    state, out, secs = run_cli(train_loop.main, [*argv, "--niter", "2"],
                               counters)
    launches = {k: fn.launches for k, fn in counters.items()}
    system = state.system
    n_params = {k: sum(p.numel() for p in net.parameters()) for k, net in
                (*system.g_nets().items(), *system.d_nets().items())}
    norms = {k: count_norms(net) for k, net in (*system.g_nets().items(),
                                                ("D", system.netD))}
    per_step = norms["G"] + norms["E"] + 3 * norms["D"]
    decodes = {k: flac.decodes[k] - before[k] for k in before}
    check(system.netE is not None and state.step == 2,
          f"Family A: netE {system.netE is not None}, {state.step} steps")
    check(decodes == {"native": 2 * FAMILY_A_BATCH, "python": 0},
          f"Family A's FLAC decodes by route: {decodes}")
    check(launches["instance_norm_act"] == 2 * per_step
          and launches["instance_norm_act_grad"] == 2 * per_step
          and launches["mdct2"] == 2 * TRAIN_MDCT_LAUNCHES,
          f"Family A launches {launches}, expected {per_step} B3 a step")
    saved = {k: torch.load(os.path.join(expr, f"latest_net_{k}.pth"),
                           weights_only=True) for k in ("G", "E", "D")}
    del state, system
    first = {}
    make_step = train_loop.make_train_step

    def hooked(system):
        step = make_step(system)

        def first_step(state, *args, **kw):
            if not first:
                nets = {**system.g_nets(), **system.d_nets()}
                first["equal"] = {k: all(torch.equal(v.cpu(), saved[k][n])
                                         for n, v in nets[k].state_dict().items())
                                  for k in saved}
                first["step"] = state.step
            return step(state, *args, **kw)
        return first_step

    train_loop.make_train_step = hooked
    try:
        state, out2, secs2 = run_cli(train_loop.main, [*argv, "--niter", "3",
                                                        "--continue_train"])
    finally:
        train_loop.make_train_step = make_step
    losses = [ln for ln in (out + out2).splitlines() if ln.startswith("(epoch")]
    check(first.get("equal") == {k: True for k in saved} and first["step"] == 2
          and state.step == 3, f"the resumed Family A run: before its first "
          f"step {first}, ended at step {state.step}")
    check(len(losses) == 3 and all(np.isfinite(float(v)) for ln in losses
                                   for v in ln.split(") ")[1].split()[1::2]),
          f"Family A's loss lines: {losses}")
    res = dict(seconds=secs, resume_seconds=secs2, params=n_params,
               norms=norms, launches=launches,
               launches_per_step={k: n / 2 for k, n in launches.items()},
               decodes=decodes,
               resumed_equal=first["equal"], final_step=state.step,
               log=losses)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    print("[family a] " + json.dumps(res))
    return res


def phase_train_cli(dev, counters, wav: str, n_in: int) -> dict:
    """The training CLI at flagship width: 2 steps at batch 2 over a corpus
    of 4 synthetic wavs, saving `latest` once; then the generate CLI serves
    the latest_net_G.pth it wrote. B3 and B1 must launch in the training
    run (counters set to 0 just before it)."""
    from pix2pixhdaudiosr_torch import train_loop

    corpus = os.path.join(WORK, "corpus")
    os.makedirs(corpus, exist_ok=True)
    for i in range(4):
        write_synthetic_wav(os.path.join(corpus, f"c{i}.wav"), seconds=1.0 + 0.1 * i)
    argv = ["--name", "train", "--checkpoints_dir", WORK, "--dataroot", corpus,
            "--device", dev, *FLAGSHIP, "--batchSize", "2", "--niter", "1",
            "--niter_decay", "0", "--no_html", "--validation_split", "0",
            "--print_freq", "2", "--save_latest_freq", "4",
            "--save_epoch_freq", "0"]
    for fn in counters.values():
        reset_counts(fn)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train_loop.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("(epoch")
             or ln.startswith("saving") or ln.startswith("training on")]
    print("[train cli] " + "\n[train cli] ".join(lines))
    expr = os.path.join(WORK, "train")
    check(state.step == 2, f"the training CLI took {state.step} steps")
    check(launches["instance_norm_act"] == 2 * TRAIN_IN_LAUNCHES
          and launches["instance_norm_act_grad"] == 2 * TRAIN_IN_LAUNCHES
          and launches["mdct2"] == 2 * TRAIN_MDCT_LAUNCHES,
          f"training CLI launches {launches}")
    for part in ("net_G", "net_D", "optim"):
        check(os.path.exists(os.path.join(expr, f"latest_{part}.pth")),
              f"the training CLI saved no latest_{part}.pth")
    gen = phase_generate(dev, {k: counters[k] for k in ("mdct2", "imdct2",
                                                        "instance_norm_act")},
                         wav, n_in, ["--load_pretrain", expr])
    res = dict(seconds=seconds, launches=launches, generate=gen,
               log=lines)
    print("[train cli] " + json.dumps(dict(seconds=seconds, launches=launches,
                                           generate_metric=gen["metric"])))
    return res


def phase_recipe_cli(dev, counters) -> dict:
    """The training CLI at flagship width with the VCTK recipe's
    --use_match_loss --use_time_D --lambda_time 10 (RECIPES[0]): 2 steps
    at batch 2 over 4 files (one epoch, `latest` saved at its end), B3 and
    its backward 58 launches a step, B1 2, the optional losses in the loss
    lines and latest_net_time_D.pth written; then --continue_train from it
    for a second epoch: before its first step G, D and time_D equal the
    saved weights, and the step count goes on from the saved one."""
    import torch
    from pix2pixhdaudiosr_torch import train_loop
    corpus = os.path.join(WORK, "recipe_corpus")
    write_cli_corpus(corpus, 4)
    expr = os.path.join(WORK, "recipe")
    argv = ["--name", "recipe", "--checkpoints_dir", WORK, "--dataroot",
            corpus, "--device", dev, *FLAGSHIP, *RECIPES[0][0], "--batchSize",
            "2", "--niter_decay", "0", "--no_html", "--validation_split", "0",
            "--print_freq", "2", "--save_latest_freq", "0",
            "--save_epoch_freq", "1"]
    state, out, secs = run_cli(train_loop.main, [*argv, "--niter", "1"],
                               counters)
    want = expected_step_launches(state.system.cfg)
    launches = {k: fn.launches for k, fn in counters.items()}
    check(state.step == 2, f"the recipe run took {state.step} steps")
    check(all(launches[k] == 2 * want.get(k, 0) for k in launches),
          f"recipe CLI launches {launches}, expected 2x {want}")
    check(all(f"{k}: " in out for k in ("G_mat", "G_GAN_t", "D_real_t",
                                        "D_fake_t")),
          "the recipe run's loss lines lack the optional losses")
    saved = {k: torch.load(os.path.join(expr, f"latest_net_{k}.pth"),
                           weights_only=True) for k in ("G", "D", "time_D")}
    del state
    first = {}
    make_step = train_loop.make_train_step

    def hooked(system):
        step = make_step(system)

        def first_step(state, *args, **kw):
            if not first:
                nets = {"G": system.netG_train, **system.d_nets()}
                first["equal"] = {k: all(torch.equal(v.cpu(), saved[k][n])
                                         for n, v in nets[k].state_dict().items())
                                  for k in saved}
                first["step"] = state.step
            return step(state, *args, **kw)
        return first_step

    train_loop.make_train_step = hooked
    try:
        state, out2, secs2 = run_cli(train_loop.main, [*argv, "--niter", "2",
                                                        "--continue_train"])
    finally:
        train_loop.make_train_step = make_step
    check("Resuming from epoch 2 at iteration 0" in out2.splitlines(),
          "the recipe run did not resume from epoch 2")
    check(first.get("equal") == {k: True for k in saved} and first["step"] == 2
          and state.step == 4, f"the resumed recipe run: before its first "
          f"step {first}, ended at step {state.step}")
    res = dict(seconds=secs, resume_seconds=secs2, launches=launches,
               resumed_equal=first["equal"], final_step=state.step)
    del state
    torch.cuda.empty_cache()
    print("[recipe cli] " + json.dumps(res))
    return res


# The converged-quality gate: the JAX package's tests/test_quality_gate.py
# (its Config as the CLI's flags, its corpus, its thresholds), which
# tests/test_torch_quality_gate.py runs on the port's CPU and phase 12 on
# the card
GATE_FLAGS = [
    "--name", "qgate", "--netG", "global", "--ngf", "16",
    "--n_downsample_global", "2", "--n_blocks_global", "2", "--ndf", "8",
    "--n_layers_D", "2", "--num_D", "2", "--input_nc", "2", "--output_nc",
    "2", "--label_nc", "0", "--batchSize", "4", "--explicit_encoding",
    "--mask_mode", "mode2", "--no_instance", "--no_vgg_loss",
    "--use_match_loss", "--niter", "32", "--niter_decay", "0",
    "--save_epoch_freq", str(10 ** 6), "--save_latest_freq", str(10 ** 9),
    "--print_freq", str(10 ** 9), "--display_freq", str(10 ** 9),
    "--eval_freq", "16", "--validation_split", "0.25", "--eval_size", "2",
    "--nThreads", "2", "--seed", "7", "--compute_dtype", "float32",
    "--no_html"]
GATE_STEPS, GATE_EVALS = 32, 8
GATE_FINAL_LSD, GATE_LSD_GAIN = 2.8, 0.4


def write_gate_corpus(wav_dir: str) -> None:
    """The gate's corpus (a copy of tests/test_quality_gate.py's
    _make_corpus, seed 42): 8 one-second 48 kHz harmonic tones, f0 220 +
    35 i, written by the port's write_wav."""
    import numpy as np
    from pix2pixhdaudiosr_torch.data.wavio import write_wav
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(42)
    for i in range(8):
        t = np.arange(48000) / 48000.0
        f0 = 220.0 + 35.0 * i
        x = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.28)) / k
                for k in range(1, 40) if f0 * k < 20000)
        x = (0.35 * x / np.max(np.abs(x))).astype(np.float32)
        write_wav(os.path.join(wav_dir, f"h{i}.wav"), x, 48000)


def gate_misses(lsds: list, snrs: list) -> list:
    """The JAX gate's conditions (tests/test_quality_gate.py:58-64) that an
    eval.csv trajectory misses."""
    if len(lsds) < 2:
        return [f"{len(lsds)} eval rows"]
    return [what for what, ok in (
        (f"final LSD {lsds[-1]} not below {GATE_FINAL_LSD}",
         lsds[-1] < GATE_FINAL_LSD),
        (f"LSD improved by {lsds[0] - min(lsds)}, not more than "
         f"{GATE_LSD_GAIN}", lsds[0] - min(lsds) > GATE_LSD_GAIN),
        (f"no SNR above the first {snrs[0]}", max(snrs) > snrs[0])) if not ok]


def planned_launches(train: bool, g_norms: int, d_norms: int) -> dict:
    """What one gate train step (train) or eval batch launches, by kernel,
    given the InstanceNorms of a G and of a D forward (count_norms): B1 2
    a step and 1 an eval batch, B2 1 an eval batch; B3 (and in a step its
    backward) once per InstanceNorm of G and, in a step, of D's three
    forwards."""
    n_in = g_norms + 3 * d_norms if train else g_norms
    return {"mdct2": TRAIN_MDCT_LAUNCHES if train else 1,
            "imdct2": 0 if train else 1,
            "instance_norm_act": n_in,
            "instance_norm_act_grad": n_in if train else 0,
            "imdct2_grad": 0}


def check_planned_routes(what: str, delta: dict, cfg, batch: int,
                         want: dict) -> None:
    """One step's or eval batch's counts ({kernel: {count: value}}, from
    counts set to 0 just before it) against planned_launches' `want`, each
    on its planner's route: B1 / B2 on the tensor cores where
    mdct_kernels.tc_route admits the codec; B3 one-pass for the shapes
    plan_instance_norm sends there, B3's backward by
    plan_instance_norm_grad's route, at the batch and f32."""
    import torch
    from pix2pixhdaudiosr_torch.ops import mdct_kernels, norm
    got = {k: delta[k]["launches"] for k in want}
    check(got == want, f"{what}: launches {got}, planned {want}")
    tc = mdct_kernels.tc_route(cfg.win_length, cfg.hop_length, cfg.n_fft)
    for k in ("mdct2", "imdct2"):
        check(delta[k]["launches_tc"] == want[k] * tc,
              f"{what}: {k} {delta[k]['launches_tc']} of {want[k]} on the "
              f"tensor-core route (tc_route {tc})")
    f32 = torch.float32
    fwd = delta["instance_norm_act"]
    onepass = sum(n for (H, W, C), n in fwd["launches_by_shape"].items()
                  if norm.plan_instance_norm(batch, H, W, C, f32).route
                  == "onepass")
    check(fwd["launches_onepass"] == onepass,
          f"{what}: B3 {fwd['launches_onepass']} one-pass launches, its "
          f"planner {onepass} (shapes {fwd['launches_by_shape']})")
    bwd = delta["instance_norm_act_grad"]
    routes = {}
    for (H, W, C), n in bwd["launches_by_shape"].items():
        r = norm.plan_instance_norm_grad(batch, H, W, C, f32).route
        routes[r] = routes.get(r, 0) + n
    check(bwd["launches_by_route"] == routes,
          f"{what}: B3's backward by route {bwd['launches_by_route']}, its "
          f"planner {routes}")


def planned_wrap(counters, calls: list, faults: list, what: str):
    """A wrapper `wrap(make, train)` of train_loop.make_train_step (train
    True) or make_eval_step whose calls each set every count of
    `counters` to 0 just before and hold the call's launches to
    planned_launches (from count_norms of the built G and D) on the
    planners' routes (check_planned_routes), at the call's batch. Each
    call appends (train, {kernel: launches}) to `calls` and a miss to
    `faults`."""
    def wrap(make, train):
        def made(system):
            fn = make(system)
            want = planned_launches(train, count_norms(system.netG_train),
                                    count_norms(system.netD))

            def call(*args, **kw):
                for counter in counters.values():
                    reset_counts(counter)
                out = fn(*args, **kw)
                batch = (args[1]["label"] if train else args[0]).shape[0]
                kind = "step" if train else "eval"
                label = f"{what} {kind} call {len(calls)}"
                calls.append((train, {k: c.launches
                                      for k, c in counters.items()}))
                try:
                    check_planned_routes(label, {k: vars(c) for k, c
                                                 in counters.items()},
                                         system.cfg, batch, want)
                except SmokeFailure as e:
                    faults.append(str(e))
                return out
            return call
        return made
    return wrap


def phase_quality_gate(dev, counters) -> dict:
    """The converged-quality gate through the training CLI on `dev`
    (GATE_FLAGS on write_gate_corpus, f32; on the card TF32 off as the CLI
    sets it): eval.csv meets the JAX gate's thresholds (gate_misses), and
    each of the 32 steps and 8 eval batches launches planned_launches on
    the planners' routes (planned_wrap). Prints the LSD and SNR
    trajectory and the leg's seconds."""
    from pix2pixhdaudiosr_torch import train_loop
    corpus = os.path.join(WORK, "gate_corpus")
    write_gate_corpus(corpus)
    argv = [*GATE_FLAGS, "--checkpoints_dir", WORK, "--dataroot", corpus,
            "--device", dev]
    calls, faults = [], []
    wrap = planned_wrap(counters, calls, faults, "gate")
    makers = (train_loop.make_train_step, train_loop.make_eval_step)
    train_loop.make_train_step = wrap(makers[0], True)
    train_loop.make_eval_step = wrap(makers[1], False)
    try:
        t0 = time.perf_counter()
        state, out = run_quiet(train_loop.main, argv)
        seconds = time.perf_counter() - t0
    finally:
        train_loop.make_train_step, train_loop.make_eval_step = makers
    path = os.path.join(WORK, "qgate", "eval.csv")
    with open(path) as f:
        rows = list(csv.DictReader(f))
    lsds = [float(r["lsd"]) for r in rows]
    snrs = [float(r["snr"]) for r in rows]
    kinds = [train for train, _ in calls]
    res = dict(seconds=seconds, lsd=lsds, snr=snrs, steps=state.step,
               eval_batches=kinds.count(False))
    print("[quality gate] " + json.dumps(res))
    check(state.step == GATE_STEPS and len(lsds) == GATE_EVALS,
          f"the gate took {state.step} steps and wrote {len(lsds)} eval rows")
    check(kinds.count(True) == GATE_STEPS
          and res["eval_batches"] == GATE_EVALS,
          f"the gate ran {len(calls)} counted steps and eval batches")
    check(not faults, f"the gate's launches: {faults[:3]} ({len(faults)} "
          f"calls off plan)")
    misses = gate_misses(lsds, snrs)
    check(not misses, f"the quality gate on {dev}: {misses}; LSD {lsds}, "
          f"SNR {snrs}")
    del state
    return res


def soak_counters() -> dict:
    """The kernel wrappers whose counts the flagship soak reads (train
    steps, eval batches, the serve chain's ways)."""
    from pix2pixhdaudiosr_torch.ops.enhancer import conv3x3_in
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import (imdct2, imdct2_grad,
                                                         mdct2)
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    return {"mdct2": mdct2, "imdct2": imdct2, "imdct2_grad": imdct2_grad,
            "instance_norm_act": instance_norm_act,
            "instance_norm_act_grad": instance_norm_act_grad,
            "conv3x3_in": conv3x3_in}


# a held-out file's serve (3 s: one batch) by way: B1, B2 and B3 (the
# fused way: B3 17 and B4 4)
SOAK_SERVE_LAUNCHES = {
    way: {"mdct2": 1, "imdct2": 1, "conv3x3_in": 4 if way == "fused" else 0,
          "instance_norm_act": IN_LAUNCHES["fused_enhancer" if way == "fused"
                                           else "plain"]}
    for way in ("plain", "fused", "int8_trunk", "data_type_8", "untrained")}


def phase_flagship_soak(dev, counters, work: str, untrained: str = None,
                        fault: str = None) -> dict:
    """The flagship recipe (tools/flagship_soak_torch.py: SOAK_FLAGS at
    HALF_SCHEDULE, 100 epochs of 2 steps at batch 64, bf16) through the
    training CLI on write_soak_corpus, SIGINT after epoch 10 and
    --continue_train (train_leg), then the serve chain on its
    latest_net_G.pth (serve_chain: the held-out files plain, fused, int8
    trunk, --data_type 8, beside the untrained G in `untrained`, else a
    seeded one, and the lowpassed input). Fails unless every step and
    eval batch launches planned_launches on the planners' routes
    (planned_wrap), every serve SOAK_SERVE_LAUNCHES with B1 and B2 on the
    tensor cores, the schedule holds (train_leg's misses: the switch once
    after epoch 15, both learning rates 0 at the end, the resumed state
    bit-equal to the saved one), eval.csv meets soak_misses and the
    serves serve_misses. `fault` is train_leg's. Deletes `work`."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import flagship_soak_torch as soak
    corpus = os.path.join(work, "soak_corpus")
    calls, faults = [], []
    serves = {}

    @contextlib.contextmanager
    def around(way):
        for counter in counters.values():
            reset_counts(counter)
        yield
        got = {k: c.launches for k, c in counters.items()
               if k in SOAK_SERVE_LAUNCHES[way]}
        tc = {k: counters[k].launches_tc for k in ("mdct2", "imdct2")}
        serves.setdefault(way, got)
        if got != SOAK_SERVE_LAUNCHES[way] or tc != {"mdct2": 1, "imdct2": 1}:
            faults.append(f"serve {way}: launches {got} (tensor cores {tc}), "
                          f"planned {SOAK_SERVE_LAUNCHES[way]}")

    try:
        soak.write_soak_corpus(corpus)
        if untrained is None:
            untrained = os.path.join(work, "untrained")
            os.makedirs(untrained)
            flagship_generator_pth(untrained)
        flags = [*soak.SOAK_FLAGS, *soak.HALF_SCHEDULE, *soak.soak_saves(100),
                 "--name", "soak", "--checkpoints_dir", work, "--dataroot",
                 os.path.join(corpus, "train")]
        leg = soak.train_leg(flags, dev, soak.HALF_INTERRUPT_EPOCH,
                             planned_wrap(counters, calls, faults, "soak"),
                             fault)
        expr = os.path.join(work, "soak")
        soak.prune(expr)
        serve = soak.serve_chain(dev, expr, untrained,
                                 os.path.join(corpus, "eval"), work, around)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kinds = [train for train, _ in calls]
    res = dict(leg, serve=serve, fault=fault, launches=dict(
        step=next(n for train, n in calls if train),
        eval_batch=next(n for train, n in calls if not train),
        serve_file=serves))
    res["misses"] = dict(schedule=leg["misses"],
                         convergence=soak.soak_misses(leg["lsd"], leg["snr"]),
                         serve=soak.serve_misses(serve["files"]))
    print("[flagship soak] " + json.dumps(res))
    check(kinds.count(True) == leg["steps"]
          and kinds.count(False) == len(leg["lsd"]),
          f"the soak ran {kinds.count(True)} counted steps and "
          f"{kinds.count(False)} eval batches for {leg['steps']} steps and "
          f"{len(leg['lsd'])} eval rows")
    check(not faults, f"the soak's launches: {faults[:3]} ({len(faults)} "
          f"calls off plan)")
    for kind, misses in res["misses"].items():
        check(not misses, f"the flagship soak's {kind}: {misses}")
    return res


def synthetic_audio(seconds: float, f0: float, seed: int, rate: int = 48000):
    """A seeded harmonic tone with noise, f32 in [-1, 1]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = sum(0.2 / k * np.sin(2 * np.pi * f0 * k * t) for k in range(1, 6))
    return (x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def write_cli_corpus(corpus: str, n: int) -> list:
    """n one-second 48 kHz files, alternately FLAC (the port's write_flac)
    and wav; returns their paths."""
    from pix2pixhdaudiosr_torch.data.flac import write_flac
    from pix2pixhdaudiosr_torch.data.wavio import write_wav
    os.makedirs(corpus, exist_ok=True)
    paths = []
    for i in range(n):
        x = synthetic_audio(1.0, 150 + 40 * i, i)
        path = os.path.join(corpus, f"c{i}.{'flac' if i % 2 == 0 else 'wav'}")
        (write_flac if path.endswith(".flac") else write_wav)(path, x, 48000)
        paths.append(path)
    return paths


def gallery_missing() -> list:
    """The HTML gallery's packages that do not import here."""
    import importlib.util
    return [m for m in ("matplotlib", "PIL")
            if importlib.util.find_spec(m) is None]


def run_cli(main, argv, counters=None):
    """main(argv) with its stdout captured (and echoed); every counter in
    `counters` set to 0 just before. Returns (result, stdout, seconds)."""
    for fn in (counters or {}).values():
        reset_counts(fn)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    seconds = time.perf_counter() - t0
    sys.stdout.write(out.getvalue())
    return res, out.getvalue(), seconds


def check_gallery_stop(main, argv, missing) -> str:
    """A run that wants the gallery stops before any work, naming the
    missing package and --no_html."""
    try:
        main(argv)
    except SystemExit as e:
        msg = str(e)
    else:
        raise SmokeFailure("a run that wants the gallery did not stop")
    check(missing[0] in msg and "--no_html" in msg,
          f"the gallery stop does not name {missing[0]} and --no_html: {msg}")
    return msg


def check_finite_csv(path: str, n_rows: int) -> list:
    import csv
    import numpy as np
    with open(path) as f:
        rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    check(len(rows) == n_rows, f"{path}: {len(rows)} rows, expected {n_rows}")
    check(all(np.isfinite(list(r.values())).all() for r in rows),
          f"{path}: a row is not finite: {rows}")
    return rows


def sigint_run(argv, expr: str) -> dict:
    """The training CLI in a process of its own: SIGINT once its first loss
    line is out, as Ctrl+C would. It must save `latest` and the epoch tag,
    set iter.txt to the next epoch, and exit 0."""
    import signal
    import threading
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "pix2pixhdaudiosr_torch.train_loop",
         *argv], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    timer = threading.Timer(300, proc.kill)
    timer.start()
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if not sent and line.startswith("(epoch"):
                proc.send_signal(signal.SIGINT)
                sent = True
        rc = proc.wait()
    finally:
        timer.cancel()
        proc.kill()
    tail = "\n".join(lines[-20:])
    check(sent and rc == 0, f"the interrupted run: rc {rc}, SIGINT sent "
          f"{sent}; its output ends:\n{tail}")
    check("You pressed Ctrl+C!" in lines and any(
        ln.startswith("exiting and saving the model at epoch 1") for ln in lines),
        f"the interrupted run printed no save:\n{tail}")
    for tag in ("latest", "1"):
        for part in ("net_G", "net_D", "optim"):
            check(os.path.exists(os.path.join(expr, f"{tag}_{part}.pth")),
                  f"the interrupted run saved no {tag}_{part}.pth")
    with open(os.path.join(expr, "iter.txt")) as f:
        cursor = f.read().strip()
    check(cursor == "2,0", f"iter.txt after Ctrl+C is {cursor!r}, not '2,0'")
    return dict(lines=[ln for ln in lines if ln.startswith(("(epoch", "You",
                                                            "exiting"))],
                iter_txt=cursor)


def phase_cli(dev, counters) -> dict:
    """The CLIs at their default behaviours, flagship width, on a corpus of
    FLAC and wav files (write_cli_corpus): see the module docstring, phase
    13. Every launch count checked is of one run, its counters set to 0
    just before it."""
    import numpy as np
    import torch
    from pix2pixhdaudiosr_torch import evaluate, generate, train_loop
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt

    corpus = os.path.join(WORK, "cli_corpus")
    write_cli_corpus(corpus, CLI_FILES)
    missing = gallery_missing()
    res = dict(gallery_missing=missing)
    common = ["--checkpoints_dir", WORK, "--dataroot", corpus, "--device",
              dev, *FLAGSHIP, "--batchSize", "2", "--print_freq", "2",
              "--niter_decay", "0"]
    one_epoch, two_epochs = ["--niter", "1"], ["--niter", "2"]
    cadence = ["--validation_split", "0.25", "--eval_freq", "2",
               "--eval_size", "0", "--display_freq", "2", "--tf_log",
               "--save_latest_freq", "0", "--save_epoch_freq", "1"]
    if missing:
        res["train_stop"] = check_gallery_stop(
            train_loop.main, ["--name", "nogallery", *common, *one_epoch,
                              *cadence], missing)
        print(f"[cli] the gallery's packages are absent here ({missing}): "
              f"the training run without --no_html stopped with: "
              f"{res['train_stop']}")
    html = ["--no_html"] if missing else []

    # training with the eval, display and event cadences every step
    expr = os.path.join(WORK, "cli")
    state, out, secs = run_cli(train_loop.main, [
        "--name", "cli", *common, *one_epoch, *cadence, *html], counters)
    launches = {k: fn.launches for k, fn in counters.items()}
    inorm, mdct, imdct, grad = (counters[k] for k in (
        "instance_norm_act", "mdct2", "imdct2", "instance_norm_act_grad"))
    steps, n_eval = state.step, CLI_STEPS   # one eval batch a step
    check(steps == CLI_STEPS, f"the training CLI took {steps} steps")
    rows = check_finite_csv(os.path.join(expr, "eval.csv"), n_eval)
    check(imdct.launches == imdct.launches_tc == n_eval * EVAL_IMDCT_LAUNCHES,
          f"IMDCT2: {imdct.launches} launches, {imdct.launches_tc} on the "
          f"tensor-core route, for {n_eval} eval batches")
    want_in = steps * TRAIN_IN_LAUNCHES + n_eval * EVAL_IN_LAUNCHES
    check(inorm.launches == inorm.launches_onepass == want_in,
          f"InstanceNorm: {inorm.launches} launches ({inorm.launches_onepass}"
          f" one-pass), expected {want_in}")
    check(grad.launches == steps * TRAIN_IN_LAUNCHES,
          f"InstanceNorm backward: {grad.launches} launches, expected "
          f"{steps * TRAIN_IN_LAUNCHES} (none in an eval)")
    want_mdct = steps * TRAIN_MDCT_LAUNCHES + n_eval * EVAL_MDCT_LAUNCHES
    check(mdct.launches == mdct.launches_tc == want_mdct,
          f"MDCT2: {mdct.launches} launches ({mdct.launches_tc} tensor-core)"
          f", expected {want_mdct}")
    events = os.listdir(os.path.join(expr, "logs"))
    check(any(e.startswith("events.out.tfevents") for e in events),
          f"--tf_log wrote no event file: {events}")
    if not missing:
        check(os.path.exists(os.path.join(expr, "web", "index.html")),
              "the training run wrote no web/index.html")
    res["train"] = dict(seconds=secs, steps=steps, launches=launches,
                        eval_rows=rows)

    # host times: one eval pass, and a flagship train state saved and
    # restored
    from pix2pixhdaudiosr_torch.data.dataset import AudioDataset, Loader
    from pix2pixhdaudiosr_torch.data.filelist import discover_files
    from pix2pixhdaudiosr_torch.generate import seeded_noise
    from pix2pixhdaudiosr_torch.trainer import make_eval_step
    system = state.system
    files = discover_files(corpus)
    val = AudioDataset(corpus, 8000, 48000, SEG, files=files[:2])
    eval_step = make_eval_step(system)
    noise = seeded_noise(system, 0)
    t0 = time.perf_counter()
    train_loop.eval_model(system, eval_step, Loader(val, [0, 1], 2,
                          shuffle=False, drop_last=False), noise)
    torch.cuda.synchronize()
    res["eval_pass_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_train_state(state, expr, "timing")
    res["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ckpt.load_train_state(state, "timing", expr)
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    want = ({f"G.{k}" for k in system.netG_train.state_dict()}
            | {f"D.{k}" for k in system.netD.state_dict()} | {"step"})
    check(want <= loaded, f"the restore missed {sorted(want - loaded)[:5]}")
    del state, system, eval_step
    torch.cuda.empty_cache()

    # Ctrl+C, then --continue_train from what it saved
    iexpr = os.path.join(WORK, "interrupted")
    plain = ["--validation_split", "0", "--save_latest_freq", "0",
             "--save_epoch_freq", "0", "--no_html"]
    res["sigint"] = sigint_run(["--name", "interrupted", *common, *two_epochs,
                                *plain], iexpr)
    saved_g = torch.load(os.path.join(iexpr, "latest_net_G.pth"),
                         weights_only=True)
    saved_step = torch.load(os.path.join(iexpr, "latest_optim.pth"),
                            weights_only=True)["step"]
    first = {}
    make_step = train_loop.make_train_step

    def hooked(system):
        step = make_step(system)

        def first_step(state, *args, **kw):
            if not first:
                first["equal"] = all(
                    torch.equal(v.cpu(), saved_g[k]) for k, v in
                    system.netG_train.state_dict().items())
                first["step"] = state.step
            return step(state, *args, **kw)
        return first_step

    train_loop.make_train_step = hooked
    try:
        state, out, secs = run_cli(train_loop.main, [
            "--name", "interrupted", *common, *two_epochs, *plain,
            "--continue_train"])
    finally:
        train_loop.make_train_step = make_step
    lines = out.splitlines()
    check("Resuming from epoch 2 at iteration 0" in lines
          and "restored checkpoint 'latest'" in lines,
          "the resumed run did not resume from epoch 2")
    check(first.get("equal") and first.get("step") == saved_step,
          f"before its first step the resumed run holds G equal to the saved "
          f"one: {first.get('equal')}, step {first.get('step')} (saved "
          f"{saved_step})")
    per_epoch = CLI_FILES // 2
    check(state.step == saved_step + per_epoch,
          f"the resumed run ended at step {state.step}, not {saved_step} + "
          f"{per_epoch}")
    res["resume"] = dict(seconds=secs, saved_step=saved_step,
                         final_step=state.step)
    del state
    torch.cuda.empty_cache()

    # the fake pool: 2 steps, each a G step and a D step on the pooled pair
    state, out, secs = run_cli(train_loop.main, [
        "--name", "pool", *common, *one_epoch, *plain, "--pool_size", "2",
        "--max_dataset_size", "4"], counters)
    check(state.step == 2, f"the pool run took {state.step} steps")
    check(inorm.launches == inorm.launches_onepass == 2 * POOL_IN_LAUNCHES
          and grad.launches == 2 * POOL_IN_GRAD_LAUNCHES,
          f"pool run: {inorm.launches} InstanceNorm launches and "
          f"{grad.launches} of its backward, expected {2 * POOL_IN_LAUNCHES} "
          f"and {2 * POOL_IN_GRAD_LAUNCHES}")
    res["pool"] = dict(seconds=secs, launches={k: fn.launches for k, fn
                                               in counters.items()})
    del state
    torch.cuda.empty_cache()
    res["pool_round_trip_ms"] = pool_round_trip_ms(dev)

    # the evaluate CLI on the training run's latest
    rows, out, secs = run_cli(evaluate.main, [
        "--name", "evaluate", "--checkpoints_dir", WORK, "--dataroot", corpus,
        "--load_pretrain", expr, "--device", dev, *FLAGSHIP, "--batchSize",
        "2", "--niter", "1"], counters)
    n_batches = CLI_FILES // 2
    check(len(rows) == 1 and np.isfinite(list(rows[0].values())).all(),
          f"evaluate rows {rows}")
    check_finite_csv(os.path.join(WORK, "evaluate", "eval.csv"), 1)
    check(imdct.launches == imdct.launches_tc == n_batches * EVAL_IMDCT_LAUNCHES
          and mdct.launches == mdct.launches_tc == n_batches * EVAL_MDCT_LAUNCHES
          and inorm.launches == inorm.launches_onepass
          == n_batches * EVAL_IN_LAUNCHES and grad.launches == 0,
          f"evaluate launches {[(fn.launches, getattr(fn, 'launches_tc', getattr(fn, 'launches_onepass', None))) for fn in counters.values()]} for {n_batches} batches")
    res["evaluate"] = dict(seconds=secs, rows=rows, launches={
        k: fn.launches for k, fn in counters.items()})

    # generate without --no_html
    wav = os.path.join(corpus, "c1.wav")
    gen_argv = ["--name", "gallery", "--checkpoints_dir", WORK, "--dataroot",
                wav, "--load_pretrain", expr, "--batchSize", "16",
                "--device", dev, *FLAGSHIP]
    if missing:
        res["generate_stop"] = check_gallery_stop(generate.main, gen_argv,
                                                  missing)
        print(f"[cli] the gallery's packages are absent here ({missing}): "
              f"generate without --no_html stopped with: "
              f"{res['generate_stop']}")
    else:
        run_cli(generate.main, gen_argv)
        imgs = os.listdir(os.path.join(WORK, "gallery", "web", "images"))
        check({"epoch001_lable_spectro.jpg", "epoch001_lable_hist.jpg"}
              <= set(imgs), f"generate's gallery holds {imgs}")
    print("[cli] " + json.dumps(res))
    return res


def pool_round_trip_ms(dev, batch: int = TRAIN_BATCH) -> float:
    """The fake pool's host round trip at the flagship pair [batch, 512, 128,
    4] f32: device -> host, ImagePool.query (full pool), host -> device."""
    import torch
    from pix2pixhdaudiosr_torch.utils.image_pool import ImagePool
    pair = torch.randn(batch, 512, 128, 4, device=dev)
    pool = ImagePool(batch, 0)
    pool.query(pair.cpu().numpy())           # fills the pool
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = torch.from_numpy(pool.query(pair.cpu().numpy())).to(dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del pair, back
    return min(times)


def phase_flac() -> dict:
    """Host time of FLAC input: one decode of a 5 s 48 kHz file, and one
    flagship batch (TRAIN_BATCH segments) from a corpus of one-second FLAC
    files through the Loader (2 threads, as --nThreads), without the
    resample cache, with it cold and with it warm; on the native route
    (runtime/native_audio.py: C++ decode and resample), with its OpenMP
    team at the default size and at 1 thread (2 runs each in turns, the
    fastest kept beside the runs), and on the Python route (data/flac.py's
    decoder, numpy resample_np). Before the Python route
    runs, every FLAC decode of the run so far must have taken the native
    route. An item (the dataset's first draw, no thread) by the native
    route equals the Python route's within 1e-5, uncached and cached."""
    import numpy as np
    from pix2pixhdaudiosr_torch.data import flac
    from pix2pixhdaudiosr_torch.data.dataset import AudioDataset, Loader
    from pix2pixhdaudiosr_torch.ops.audio import resample_np
    from pix2pixhdaudiosr_torch.runtime import native_audio
    check(flac.decodes["python"] == 0,
          f"{flac.decodes['python']} FLAC decodes of this run took the "
          f"Python route ({flac.decodes['native']} the native one)")
    corpus = os.path.join(WORK, "flac_corpus")
    os.makedirs(corpus)
    five = os.path.join(WORK, "five.flac")
    flac.write_flac(five, synthetic_audio(5.0, 220, 0), 48000)
    res = dict(cores=os.cpu_count())
    native_audio.library()  # built and loaded before any timing
    for route, native in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        wav, rate = flac.read_flac(five, use_native=native)
        res[f"decode_5s_{route}_s"] = time.perf_counter() - t0
        check(rate == 48000 and wav.shape == (1, 240000),
              f"{wav.shape} at {rate}")
    one = os.path.join(corpus, "f0.flac")
    flac.write_flac(one, synthetic_audio(1.0, 330, 1), 48000)
    for i in range(1, TRAIN_BATCH):    # the same bytes, TRAIN_BATCH files
        shutil.copy(one, os.path.join(corpus, f"f{i}.flac"))
    read_flac, resample = flac.read_flac, native_audio.resample
    items = {}

    def timed_batch(name: str, route: str, cache):
        """One Loader batch's seconds, appended to res[batch_<name>_<route>
        _s_runs]; the dataset's first item kept by (name, native|python)."""
        ds = AudioDataset(corpus, 8000, 48000, SEG, cache_dir=cache)
        loader = Loader(ds, range(len(ds)), TRAIN_BATCH, shuffle=False)
        t0 = time.perf_counter()
        batch = next(iter(loader))
        res.setdefault(f"batch_{name}_{route}_s_runs", []).append(
            time.perf_counter() - t0)
        check(batch["image"].shape == (TRAIN_BATCH, SEG), "FLAC batch shape")
        items[name, route.split("_")[0]] = AudioDataset(
            corpus, 8000, 48000, SEG, cache_dir=cache)[0]

    caches = (("no_cache", False), ("cold_cache", True), ("warm_cache", True))
    try:
        # the native routes twice each, in turns: the OpenMP team at the
        # default size, then at 1 thread
        for i, route in enumerate(("native", "native_omp1") * 2):
            native_audio.set_threads(1 if route == "native_omp1" else 0)
            for name, cached in caches:
                timed_batch(name, route, os.path.join(WORK, f"cache_{i}")
                            if cached else None)
        native_audio.set_threads(0)
        flac.read_flac = lambda *a, **k: read_flac(*a, **k, use_native=False)
        native_audio.resample = resample_np
        for name, cached in caches:
            timed_batch(name, "python", os.path.join(WORK, "cache_python")
                        if cached else None)
    finally:
        native_audio.set_threads(0)
        flac.read_flac, native_audio.resample = read_flac, resample
    for key in [k for k in res if k.endswith("_runs")]:
        res[key[:-5]] = min(res[key])
    for name, _ in caches:
        a, b = items[name, "native"], items[name, "python"]
        err = max(float(np.abs(a[k] - b[k]).max()) for k in ("image", "label"))
        res[f"native_vs_python_{name}_max_abs_err"] = err
        check(err <= 1e-5, f"native and Python items differ by {err}")
    print("[flac] " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# The serving parallel modes (parallel/): B3's cross-shard entries, CP in one
# process, CP at 4 ranks and TP at 2 ranks sharing cuda:0 over gloo.
# the cross-shard InstanceNorm entries' shapes: two flagship CP blocks (the
# enhancer's and the trunk head's at 256 and 128 frames) and the trunk
# resblocks' 1536 channels over 2 TP ranks at batch 16
CP_IN_SHAPES = [(1, 48, 512, 256), (1, 96, 256, 128), (16, 768, 16, 4)]
# and, timed beside them, a long file's enhancer block at one of 4 ranks
# (60 s: 11,264 frames, 2,816 a rank; 138 MB in bf16, beyond the L2) and
# the trunk's last block of the 256-frame one (192 vectors a position)
CP_IN_TIMED = CP_IN_SHAPES + [(1, 48, 512, 2816), (1, 1536, 16, 8)]
CP_SHARDS, TP_SHARDS = 4, 2
# the flagship G's total stride (2^4 downsamples x 2^1 enhancer)
G_STRIDE = 32
# phase 15's bf16 timing leg: a file this long, one rank
CP_LONG_SECONDS = 60.0
# a rank of the multi-rank phases: its own wall limit, seconds
RANK_LIMIT = 420
# dp x cp serving in phase 15's 4-rank world: the data x cp mesh
# (parallel.mesh.make_serving_layout) and its batch: 2 seeded segments,
# each split into 2 blocks of 64 frames
DP_CP, DP_CP_BATCH = (2, 2), 2
# the int8 trunk under TP in phase 15's 2-rank world: its convs a forward
# (the flagship trunk's 3 resblocks x 2)
INT8_TP_CONVS = 6


def one_rank_group(dev):
    """The group of a world of this process alone (CP with one shard)."""
    import torch
    from pix2pixhdaudiosr_torch.parallel import mesh
    return mesh.make_group(mesh.World(0, 1, None, torch.device(dev)), 1)


def moments_f64(x):
    """The mean and E[x^2] of each plane of x [B, C, H, W] in float64."""
    import torch
    xd = x.double()
    return torch.stack((xd.mean(dim=(2, 3)), (xd * xd).mean(dim=(2, 3))))


def moments_err(got, exact) -> float:
    """The moments' error relative to each plane's scale: |mean - mean64|
    over the plane's RMS, sqrt(E[x^2]), and |E[x^2] - E64[x^2]| over
    E64[x^2] (a mean near 0 is rounded at the scale of the values summed,
    not at its own); the largest over every plane."""
    import torch
    scale = torch.stack((exact[1].sqrt(), exact[1]))
    return ((got.double() - exact).abs() / scale).max().item()


def kernels_per_call(fn, calls: int = 4, tries: int = 8) -> list:
    """The names of the CUDA kernels one call of fn() launches, from
    torch.profiler over `calls` calls. A trace can lose the kernels that
    run while its tracing is still starting or already stopping, so the
    calls are framed by `pad` spin kernels on each side (torch.cuda._sleep,
    left out of the names), each side synchronised. A trace whose kernels
    still do not divide evenly among the calls, or that lost every spin of
    the closing frame, is taken again, up to `tries` times; then all its
    names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pad, spin = 4, 200_000  # ~0.1 ms a spin

    def frame():
        for _ in range(pad):
            torch.cuda._sleep(spin)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            frame()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            frame()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events if "spin_kernel" not in e.name]
        closed = bool(events) and "spin_kernel" in events[-1].name
        if closed and names and len(names) % calls == 0:
            return names[:len(names) // calls]
    return names


def cropped_like(x):
    """x's values in a view cropped out of a larger channels_last tensor
    (one row above, two frames left, one row and three frames beyond), as
    a same-mode deconv's CP output is: the start and the pitches move."""
    import torch
    B, C, H, W = x.shape
    big = torch.empty(B, C, H + 2, W + 5, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last).zero_()
    view = big[..., 1:H + 1, 2:W + 2]
    view.copy_(x)
    return view


def phase_cp_kernels(dev):
    """B3's cross-shard entries (instance_moments, instance_apply) against
    their twins at CP_IN_TIMED, bf16 and f32: the moments within 1e-6 of
    float64 moments relative to each plane's scale (`moments_err`; or no
    farther than the twin's f32 reduction, where that is farther) and the
    same bits over two calls, the apply (from the twin's moments,
    ReLU and none) within one bf16 ulp in bf16 and 1e-5 in f32, the two
    composed (one shard) as close to the one-launch norm's twin, a cropped
    view read in place giving its contiguous copy's bits, the apply of 3
    shards' summed moments (count 3) the bits of the apply of their mean,
    every arrival count back at 0, and one CUDA kernel a call of each
    (torch.profiler). Each timed with CUDA events (events ms) and by its
    kernel's device time, L2 warm and cold, beside its twin and its bound
    (bytes at 3.35 TB/s), the moments also beside torch.var_mean (the
    library yardstick: the same two moments of each plane), the apply at
    one sample beside F.batch_norm on [1, C, H, W] with the moments'
    mean and variance (one call, without the activation, which would be a
    second). Returns {name: record of the first shape in bf16} and one row
    a shape."""
    import torch
    import torch.nn.functional as F
    from pix2pixhdaudiosr_torch.ops import norm
    gen = torch.Generator(device=dev).manual_seed(11)
    rec, detail = {}, {}
    for shape in CP_IN_TIMED:
        B, C, H, W = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(
                dtype).contiguous(memory_format=torch.channels_last)
            got = norm.instance_moments(x)
            want = norm.instance_moments_ref(x)
            exact = moments_f64(x)
            m_err = moments_err(got, exact)
            twin_err = moments_err(want, exact)
            check(m_err <= max(1e-6, twin_err), f"instance_moments {shape} "
                  f"{dtype}: relative error {m_err} against float64 (the "
                  f"twin's {twin_err})")
            check(torch.equal(norm.instance_moments(x), got),
                  f"instance_moments {shape} {dtype}: two calls differ")
            a_err = 0.0
            for act in ("relu", "none"):
                y = norm.instance_apply(x, want, act)
                ref = norm.instance_apply_ref(x, want, act)
                if dtype == torch.float32:
                    a_err = max(a_err, (y - ref).abs().max().item())
                    check(a_err <= 1e-5, f"instance_apply {shape} f32 {act}: "
                          f"{a_err}")
                else:
                    over = ulp_excess(y, ref)
                    a_err = max(a_err, (y.float() - ref.float()).abs().max().item())
                    check(over <= 0, f"instance_apply {shape} bf16 {act}: "
                          f"beyond 1 ulp by {over}")
            # one shard: the kernels' own moments, then the apply, against
            # the one-launch norm's twin
            y = norm.instance_apply(x, got, "relu")
            ref = norm.instance_norm_act_ref(x, "relu")
            check((y - ref).abs().max().item() <= 1e-5
                  if dtype == torch.float32 else ulp_excess(y, ref) <= 0,
                  f"one-shard moments + apply at {shape} {dtype} disagree "
                  f"with instance_norm_act's twin")
            xc = cropped_like(x)
            check(torch.equal(norm.instance_moments(xc), got)
                  and torch.equal(norm.instance_apply(xc, got, "relu"), y),
                  f"a cropped view at {shape} {dtype} does not give its "
                  f"contiguous copy's bits")
            summed = got + got + got
            check(torch.equal(norm.instance_apply(x, summed, "relu", count=3),
                              norm.instance_apply(x, summed / torch.full_like(
                                  summed, 3), "relu")),
                  f"instance_apply {shape} {dtype} count 3 is not the apply "
                  f"of the summed moments divided by 3")
            torch.cuda.synchronize()
            arrivals = norm.moments_workspace(
                x.device, torch.cuda.current_stream().cuda_stream)[1]
            check(int(arrivals.count_nonzero()) == 0, "instance_moments left "
                  "an arrival count that is not 0")
            per_call = {
                "instance_moments": kernels_per_call(
                    lambda: norm.instance_moments(x)),
                "instance_apply": kernels_per_call(
                    lambda: norm.instance_apply(x, got, "relu", count=2))}
            for name, kernels in per_call.items():
                check(len(kernels) == 1, f"{name} {shape} {dtype} launched "
                      f"{kernels} a call, expected one kernel")
            nb = x.numel() * x.element_size()
            key = f"{B}x{C}x{H}x{W} {str(dtype)[6:]}"
            mean, var = norm.mean_var(got)

            def batch_norm():
                return F.batch_norm(x.view(1, B * C, H, W), mean.view(-1),
                                    var.view(-1), training=False, eps=1e-5)
            rows = {
                "instance_moments": dict(
                    max_abs_err=(got - want).abs().max().item(),
                    max_rel_err_f64=m_err, twin_max_rel_err_f64=twin_err,
                    ms=cuda_ms(lambda: norm.instance_moments(x)),
                    device_ms=device_ms(lambda: norm.instance_moments(x)),
                    cold_device_ms=device_ms(
                        lambda: norm.instance_moments(x), cold=True),
                    plain_ms=cuda_ms(lambda: norm.instance_moments_ref(x),
                                     iters=5),
                    library_ms=cuda_ms(lambda: torch.var_mean(
                        x, dim=(2, 3))),
                    plan=norm.plan_instance_moments(B, H, W, C, x.dtype)._asdict(),
                    **bound(nb + 4 * got.numel(), 3 * x.numel(), F32_FLOPS)),
                "instance_apply": dict(
                    max_abs_err=a_err,
                    ms=cuda_ms(lambda: norm.instance_apply(x, want, "relu")),
                    device_ms=device_ms(
                        lambda: norm.instance_apply(x, want, "relu")),
                    cold_device_ms=device_ms(
                        lambda: norm.instance_apply(x, want, "relu"),
                        cold=True),
                    plain_ms=cuda_ms(lambda: norm.instance_apply_ref(
                        x, want, "relu"), iters=5),
                    library_ms=cuda_ms(batch_norm) if B == 1 else None,
                    plan=norm.plan_instance_apply(B, H, W, C, x.dtype)._asdict(),
                    **bound(2 * nb + 4 * got.numel(), 8 * x.numel(),
                            F32_FLOPS)),
            }
            for name, r in rows.items():
                r.update(shape=key, kernels_per_call=per_call[name],
                         share_of_bound=r["bound_ms"] / r["ms"],
                         cold_share_of_bound=r["bound_ms"]
                         / r["cold_device_ms"])
                detail[f"{name} {key}"] = r
                print(f"[kernels] {name} {key}: " + json.dumps(r))
                if shape == CP_IN_SHAPES[0] and dtype == torch.bfloat16:
                    rec[name] = r
            del x, xc, got, want
    return rec, detail


def full_length_spec(system, wav: str, shards: int):
    """The whole file's lr spectrogram as cp_generate encodes it for
    `shards` ranks (f32 [1, 512, T, 2], T a multiple of shards x 32), and
    the full-length system it was encoded with."""
    import torch
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.data.dataset import AudioTestDataset
    cfg = system.cfg
    lr = AudioTestDataset(wav, cfg.lr_sampling_rate, cfg.hr_sampling_rate,
                          cfg.segment_length).lr_audio
    need, t = generate.plan_cp_padding(lr.size, cfg.hop_length,
                                       cfg.win_length, cfg.center, shards,
                                       G_STRIDE)
    full = generate.full_length_system(system, need)
    lr_full = torch.zeros(1, need, device=system.device)
    lr_full[0, :lr.size] = torch.from_numpy(lr)
    shape = (1, full.codec.mask_size(cfg.n_fft), t, 2)
    with torch.no_grad():
        spec = full.encode_input(lr_full, noise=generate.seeded_noise(
            full, cfg.seed)(0, shape))[0]
    return full, spec.contiguous()


def unsharded_forward(system, spec):
    """The plain generator (no cp, no tp) on spec NHWC: f32 NHWC."""
    import torch
    with torch.no_grad():
        return system.netG(spec.to(system.dtype).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).float()


def ulp_reading(got, want) -> dict:
    """How far a forward's output is from the reference's: max|err|,
    its share of max|want|, the largest error in ulps of the larger value,
    and the share of elements beyond one ulp."""
    err = (got - want).abs()
    ulp = __import__("torch").maximum(bf16_ulp(got), bf16_ulp(want))
    return dict(max_abs_err=err.max().item(),
                rel_to_max=err.max().item() / want.abs().max().item(),
                max_ulps=(err / ulp).max().item(),
                share_beyond_1_ulp=(err > ulp).float().mean().item())


def rounding_floor(system, spec, want) -> dict:
    """How far the plain generator's output (`want`, on spec) moves under
    changes of rounding alone, which is what splitting it over ranks
    makes: the input scaled by 1 + 2^-23 (one f32 ulp) and every
    InstanceNorm on the two-pass route (the same statistics summed in
    another order); `floor` is the larger. At flagship width with seeded
    weights the generator amplifies a one-ulp change of its input to
    ~6e-5 of max|y| in f32 and ~0.08 in bf16 (an H100, this script)."""
    from pix2pixhdaudiosr_torch.ops import norm
    moved = unsharded_forward(system, spec * (1 + 2 ** -23))
    plan = norm.plan_instance_norm
    norm.plan_instance_norm = lambda *a, **k: norm.INPlan("twopass")
    try:
        two = unsharded_forward(system, spec)
    finally:
        norm.plan_instance_norm = plan
    r = dict(input_ulp=(moved - want).abs().max().item(),
             two_pass_in=(two - want).abs().max().item())
    r["floor"] = max(r.values())
    return r


def check_against_floor(what: str, reading: dict, floor: dict,
                        scale: float) -> None:
    """A split forward's output within 2x the rounding floor of the plain
    one (it changes the rounding in more places than either change of the
    floor alone: every layer's conv shapes, every InstanceNorm's sums, the
    all-reduce's order); 1e-5 max|y| is read beside it."""
    reading["floor"] = floor
    reading["within_2x_floor"] = reading["max_abs_err"] <= 2 * floor["floor"]
    reading["within_1e-5_of_max"] = reading["max_abs_err"] <= 1e-5 * scale
    check(reading["within_2x_floor"], f"{what}: max|err| "
          f"{reading['max_abs_err']} beyond 2x the rounding floor {floor}")


def cp_norm_profile(run) -> dict:
    """One traced run() (torch.profiler, CPU and CUDA) with each call of
    models/layers.cp_instance_norm in a range of its own: the calls, those
    on a cropped view, the CUDA kernels that ran inside each call's range
    on the device timeline (B3m's and B3a's kernels, and any copy of its
    input, by name), the copy kernels among them and the device ms of the
    others (B3m + B3a), over the run and by the input's shape [C, H, W]
    (moments, apply and copy ms summed over that shape's calls; a kernel
    named *apply* or *finalize* is the apply's); and every kernel of the
    run by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from pix2pixhdaudiosr_torch.models import layers
    inner, cropped, shapes = layers.cp_instance_norm, [], []

    def traced(x, act, cp):
        cropped.append(not x.is_contiguous(memory_format=torch.channels_last))
        shapes.append("x".join(str(d) for d in x.shape[1:]))
        with record_function("cp_instance_norm"):
            return inner(x, act, cp)

    layers.cp_instance_norm = traced
    try:
        run()
        torch.cuda.synchronize()
        for _ in range(5):  # a trace may come back without kernels
            cropped.clear()
            shapes.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            device = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
            ranges = [e.time_range for e in device
                      if e.name == "cp_instance_norm"]
            kernels = [e for e in device if e.name != "cp_instance_norm"]
            calls = [[k for k in kernels if r.start <= k.time_range.start
                      and k.time_range.end <= r.end] for r in ranges]
            if calls and all(calls):
                break
    finally:
        layers.cp_instance_norm = inner
    check(len(calls) == len(cropped), f"{len(calls)} traced cp_instance_norm "
          f"ranges on the device for {len(cropped)} calls")
    names = [[k.name for k in c] for c in calls]
    copies = [[k for k in c if "copy" in k.name.lower()] for c in calls]
    dur = lambda k: (k.time_range.end - k.time_range.start) / 1e3  # noqa: E731
    by_name, norm_ms = {}, {}
    for k in kernels:
        by_name[k.name] = by_name.get(k.name, 0) + 1
    for k in (k for c in calls for k in c):
        norm_ms[k.name] = norm_ms.get(k.name, 0.0) + dur(k)
    by_shape = {}
    for shape, c in zip(shapes, calls):
        row = by_shape.setdefault(shape, dict(calls=0, moments=0.0,
                                              apply=0.0, copy=0.0))
        row["calls"] += 1
        for k in c:
            name = k.name.lower()
            role = ("copy" if "copy" in name else "apply" if "apply" in name
                    or "finalize" in name else "moments")
            row[role] += dur(k)
    return dict(calls=len(calls), cropped_calls=sum(cropped),
                kernels_per_call=sorted({len(n) for n in names}),
                kernel_names=sorted({k for n in names for k in n}),
                copy_kernels=sum(len(c) for c in copies),
                copy_kernels_at_cropped=sum(
                    len(c) for c, crop in zip(copies, cropped) if crop),
                norm_device_ms=sum(v for k, v in norm_ms.items()
                                   if "copy" not in k.lower()),
                copy_device_ms=sum(dur(k) for c in copies for k in c),
                device_ms_by_kernel=norm_ms, device_ms_by_shape=by_shape,
                run_kernels=len(kernels),
                run_device_ms=sum(dur(k) for k in kernels),
                run_kernels_by_name=by_name)


def cp_long_forward(dev, seconds: float = CP_LONG_SECONDS):
    """(run, frames): run() is the bf16 flagship G's one-rank CP forward
    (the seamless full-length path of generate --cp_shards 4 in one
    process) of a `seconds` synthetic file, padded for CP_SHARDS ranks."""
    from pix2pixhdaudiosr_torch.generate import cp_forward
    from pix2pixhdaudiosr_torch.parallel.halo import make_cp_generator
    if not os.path.exists(os.path.join(WORK, "smoke", "latest_net_G.pth")):
        os.makedirs(os.path.join(WORK, "smoke"), exist_ok=True)
        flagship_generator_pth(os.path.join(WORK, "smoke"))
    wav = os.path.join(WORK, "long_48k.wav")
    write_synthetic_wav(wav, seconds)
    full, spec = full_length_spec(flagship_system(dev), wav, CP_SHARDS)
    os.remove(wav)
    group = one_rank_group(dev)
    forward = make_cp_generator(full, group)
    return (lambda: cp_forward(forward, spec)), spec.shape[2]


def cp_long_leg(dev) -> dict:
    """`cp_long_forward` of a CP_LONG_SECONDS file: the G's wall ms (CUDA
    events, 5 forwards after 2) and `cp_norm_profile` of one forward; each
    cp_instance_norm must launch one B3m and one B3a kernel and no copy."""
    run, frames = cp_long_forward(dev)
    r = dict(seconds=CP_LONG_SECONDS, frames=frames,
             g_wall_ms=cuda_ms(run, iters=5, warmup=2), **cp_norm_profile(run))
    check(r["kernels_per_call"] == [2] and r["copy_kernels"] == 0,
          f"the CP forward's InstanceNorms launched {r['kernels_per_call']} "
          f"kernels a call, {r['copy_kernels']} copies: expected 2 and 0")
    return r


def phase_cp_one_rank(dev, wav: str, n_in: int) -> dict:
    """generate --cp_shards 4 in this process (one rank, so one shard: the
    seamless full-length forward), every count set to 0 just before it: B1,
    B2 and B3's cross-shard entries launched, no one-pass B3 (the CP path
    never reaches it); then the CP generator against the plain generator on
    the same whole-file spectrogram, f32 and bf16, read in ulps, each within 2x the rounding floor (check_against_floor);
    then the bf16 timing leg on a long file (`cp_long_leg`)."""
    import torch
    from pix2pixhdaudiosr_torch.generate import cp_forward
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import imdct2, mdct2
    from pix2pixhdaudiosr_torch.ops.norm import (instance_apply,
                                                 instance_moments,
                                                 instance_norm_act)
    from pix2pixhdaudiosr_torch.parallel.halo import make_cp_generator
    reset_counts(instance_norm_act)
    counters = {"mdct2": mdct2, "imdct2": imdct2,
                "instance_moments": instance_moments,
                "instance_apply": instance_apply}
    res = phase_generate(dev, counters, wav, n_in,
                         ["--cp_shards", str(CP_SHARDS)],
                         [f"context-parallel inference: 960 frames over 1 "
                          f"shards"])
    res["instance_norm_act_launches"] = instance_norm_act.launches
    res["in_launches_by_shape"] = {
        k: {str(s): n for s, n in counters[k].launches_by_shape.items()}
        for k in ("instance_moments", "instance_apply")}
    check(instance_norm_act.launches == 0, f"the CP run launched "
          f"{instance_norm_act.launches} one-/two-pass InstanceNorms")
    group = one_rank_group(dev)
    for dtype in ("float32", "bfloat16"):
        full, spec = full_length_spec(flagship_system(
            dev, ["--compute_dtype", dtype]), wav, 1)
        got = cp_forward(make_cp_generator(full, group), spec)
        want = unsharded_forward(full, spec)
        r = ulp_reading(got, want)
        r["bit_identical"] = bool(torch.equal(got, want))
        check_against_floor(f"one-rank CP G {dtype}", r,
                            rounding_floor(full, spec, want),
                            want.abs().max().item())
        res[dtype] = r
        print(f"[cp 1 rank] {dtype} T={spec.shape[2]}: " + json.dumps(r))
        del full, spec, got, want
    torch.cuda.empty_cache()
    res["long"] = cp_long_leg(dev)
    print(f"[cp 1 rank] bf16 {CP_LONG_SECONDS:.0f} s: "
          + json.dumps(res["long"]))
    torch.cuda.empty_cache()
    print("[cp 1 rank] " + json.dumps({k: v for k, v in res.items()
                                       if k != "metric"}))
    return res


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(mode: str, n: int) -> list:
    """n processes of this script (`--rank-worker mode`), ranks of one
    gloo group on cuda:0 (the launcher's variables set as torchrun sets
    them), under a wall limit of their own: a rank that fails, hangs or
    exits non-zero fails the phase, and every rank is stopped. Returns
    each rank's record."""
    port, procs = free_port(), []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="2")
        log = open(os.path.join(WORK, f"{mode}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", mode],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
    deadline, failed = time.monotonic() + RANK_LIMIT, None
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [r for r, (p, _) in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]][0].poll()}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks ran past {RANK_LIMIT} s"
                break
            time.sleep(0.5)
        else:
            bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]][0].returncode}"
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r in range(n):
        with open(os.path.join(WORK, f"{mode}_rank{r}.log")) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines() if ln.startswith(
            ("distributed:", "[rank", "context-parallel", "tensor-parallel",
             "data-parallel"))]
        print(f"[{mode} rank {r}] " + " | ".join(lines[-8:]))
        if failed:
            print(f"[{mode} rank {r}] log tail:\n{text[-3000:]}")
    check(failed is None, f"{mode} at {n} ranks: {failed}")
    recs = []
    for r in range(n):
        with open(os.path.join(WORK, f"{mode}_rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def flagship_layers():
    """(name, module, input shape [B, C, H, W]) of each layer kind with a
    CP path at flagship width on a 1024-frame file: the enhancer's head,
    down, resblock, deconv and final conv, its input's pool, and the
    trunk's resblock and first deconv; N(0, 0.02) weights, N(0, 0.1)
    biases."""
    import torch
    from pix2pixhdaudiosr_torch.models import layers as L
    torch.manual_seed(21)
    out = [
        ("enh1_down0", L.ConvIN(2, 48, 7, reflect=3), (1, 2, 512, 1024)),
        ("enh1_down1", L.ConvIN(48, 96, 3, stride=2, pad=1),
         (1, 48, 512, 1024)),
        ("enh1_block", L.ResnetBlock(96), (1, 96, 256, 512)),
        ("enh1_up", L.ConvTransposeIN(96, 48), (1, 96, 256, 512)),
        ("enh1_final", L.ConvIN(48, 2, 7, reflect=3, norm=False, act="tanh"),
         (1, 48, 512, 1024)),
        ("pool", None, (1, 2, 512, 1024)),
        ("trunk_block", L.ResnetBlock(1536), (1, 1536, 16, 32)),
        ("trunk_up", L.ConvTransposeIN(1536, 768), (1, 1536, 16, 32)),
    ]
    with torch.no_grad():
        for _, m, _ in out:
            for name, p in (m.named_parameters() if m else ()):
                p.normal_(0.0, 0.02 if name.endswith("weight") else 0.1)
    return out


def cp_layer_checks(group, dev) -> dict:
    """Each flagship_layers layer, f32, on this rank's block of its input
    (the frames split over the group) against its unsharded output on rank
    0: {name: (max|err|, max|y|)} on rank 0, {} elsewhere."""
    import torch
    from pix2pixhdaudiosr_torch.models.layers import avg_pool_3s2
    from pix2pixhdaudiosr_torch.parallel.halo import set_cp
    res = {}
    gen = torch.Generator().manual_seed(22)
    for name, module, shape in flagship_layers():
        x = torch.randn(shape, generator=gen).to(dev).contiguous(
            memory_format=torch.channels_last)
        per = shape[3] // group.size
        block = x[..., group.rank * per:(group.rank + 1) * per].contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            if module is None:
                got = avg_pool_3s2(block, group)
            else:
                module = module.to(dev, memory_format=torch.channels_last)
                got = set_cp(module, group)(block)
            parts = group.gather_to_first(got)
            if parts is not None:
                if module is None:
                    want = avg_pool_3s2(x)
                else:
                    want = set_cp(module, None)(x)
                err = (torch.cat(parts, dim=3) - want).abs().max().item()
                res[name] = (err, want.abs().max().item())
    return res


def tp_block_checks(group, dev) -> dict:
    """A trunk resblock (1536 channels, 16 x 4) and an enhancer resblock
    (96 channels, 256 x 64) at batch 16, f32, split over the group against
    the whole block on every rank: {name: (max|err|, max|y|)}."""
    import torch
    from pix2pixhdaudiosr_torch.models.layers import ResnetBlock
    from pix2pixhdaudiosr_torch.parallel.tp import shard_generator
    res = {}
    gen = torch.Generator().manual_seed(23)
    torch.manual_seed(24)
    for name, dim, (h, w) in (("ResnetBlock_0", 1536, (16, 4)),
                              ("enh1_block0", 96, (256, 64))):
        holder = torch.nn.Module()
        holder.add_module(name, ResnetBlock(dim))
        with torch.no_grad():
            for pname, p in holder.named_parameters():
                p.normal_(0.0, 0.02 if pname.endswith("weight") else 0.1)
        holder.to(dev, memory_format=torch.channels_last)
        x = torch.randn(16, dim, h, w, generator=gen).to(dev).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            want = getattr(holder, name)(x)
            shard_generator(holder, group)
            got = getattr(holder, name)(x)
        res[name] = ((got - want).abs().max().item(),
                     want.abs().max().item())
    return res


def rank_worker(mode: str) -> int:
    """One rank of run_ranks: phase 16's modes (dp, zero, fsdp) in
    dp_rank_worker, its CLI (cli) in dp_cli_rank_worker; CP and TP here.
    Joins the group through the port's
    parallel.mesh (gloo, the ranks sharing cuda:0), runs the generator in
    f32 and bf16 on the spectrogram the parent saved (CP: this rank's
    frames, the blocks gathered on rank 0; TP: the resblocks split), once
    to warm up and once timed with every count set to 0 just before it;
    then dp x cp serving on the 2 x 2 mesh (CP, dp_cp_rank) or the int8
    trunk under TP (int8_tp_rank); then the generate CLI in the mode at
    bf16 (TP: with --int8_trunk too); rank 0 saves the outputs. Writes its
    record to WORK/<mode>_rank<r>.json."""
    if mode in DP_MODES:
        return dp_rank_worker(mode)
    if mode == "cli":
        return dp_cli_rank_worker()
    import torch
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import imdct2, mdct2
    from pix2pixhdaudiosr_torch.ops.norm import (instance_apply,
                                                 instance_moments,
                                                 instance_norm_act)
    from pix2pixhdaudiosr_torch.parallel import mesh
    from pix2pixhdaudiosr_torch.parallel.halo import make_cp_generator
    from pix2pixhdaudiosr_torch.parallel.tp import shard_generator
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"instance_norm_act": instance_norm_act,
                "instance_moments": instance_moments,
                "instance_apply": instance_apply, "mdct2": mdct2,
                "imdct2": imdct2}
    world = mesh.initialize(torch.device("cuda:0"))
    group = mesh.make_group(world, world.size)
    rec = dict(rank=world.rank, size=world.size, backend=world.backend,
               device=str(world.device))
    spec = torch.load(os.path.join(WORK, f"{mode}_spec.pt")).to(world.device)

    def counts():
        return {k: dict(launches=fn.launches, by_shape={
            str(s): v for s, v in fn.launches_by_shape.items()})
            for k, fn in counters.items() if hasattr(fn, "launches_by_shape")}

    for dtype in ("float32", "bfloat16"):
        system = flagship_system(world.device, ["--compute_dtype", dtype])
        if mode == "cp":
            run = functools.partial(generate.cp_forward,
                                    make_cp_generator(system, group), spec)
        else:
            rec["sharded"] = shard_generator(system.netG, group)
            run = functools.partial(unsharded_forward, system, spec)
        run()
        for fn in counters.values():
            reset_counts(fn)
        group.reset_traffic()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        rec[dtype] = dict(wall_s=time.perf_counter() - t0, counts=counts(),
                          traffic=group.traffic())
        if world.rank == 0:
            torch.save(out.cpu(), os.path.join(WORK, f"{mode}_out_{dtype}.pt"))
        del system, run, out
        torch.cuda.empty_cache()
    if mode == "cp":
        rec["dp_cp"] = dp_cp_rank(world, counters, counts)
    else:
        rec["int8_tp"] = int8_tp_rank(world, group, spec, counters, counts)
    rec["layers"] = (cp_layer_checks if mode == "cp" else tp_block_checks)(
        group, world.device)
    for name, extra in [(f"{mode}{world.size}", [])] + (
            [(f"{mode}{world.size}_int8", ["--int8_trunk"])]
            if mode == "tp" else []):
        for fn in counters.values():
            reset_counts(fn)
        argv = ["--name", name, "--checkpoints_dir", WORK,
                "--dataroot", os.path.join(WORK, "input_48k.wav"),
                "--load_pretrain", os.path.join(WORK, "smoke"), "--batchSize",
                "16", "--no_html", "--device", "cuda:0", *FLAGSHIP,
                f"--{mode}_shards", str(world.size), *extra]
        t0 = time.perf_counter()
        audio = generate.main(argv)
        rec["cli" + ("_int8" if extra else "")] = dict(
            seconds=time.perf_counter() - t0, counts=counts(),
            returned_audio=audio is not None)
    with open(os.path.join(WORK, f"{mode}_rank{world.rank}.json"), "w") as f:
        json.dump(rec, f)
    mesh.shutdown()
    return 0


def timed_forward(run, world, groups, counters, counts) -> tuple:
    """run() once with every count, each group's traffic and the peak
    memory reset just before it, synchronized around it: (its output,
    {wall_ms, counts, traffic by group, peak_gib})."""
    import torch
    for fn in counters.values():
        reset_counts(fn)
    for g in groups.values():
        g.reset_traffic()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, dict(wall_ms=1e3 * (time.perf_counter() - t0),
                     counts=counts(),
                     traffic={k: g.traffic() for k, g in groups.items()},
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def dp_cp_rank(world, counters, counts) -> dict:
    """dp x cp serving on one rank of the DP_CP data x cp mesh
    (parallel.mesh.make_serving_layout over phase 15's 4 ranks): the
    flagship G in f32 and bf16 through make_cp_generator(..., batch_group=
    data) on this rank's block [1, 512, 64, 2] of the parent's 2-segment
    spectrogram (WORK/dpcp_spec.pt), the blocks gathered on rank 0
    (generate.cp_forward), once to warm up and once timed (timed_forward);
    rank 0 saves the output. Returns the rank's groups and each dtype's
    record."""
    import torch
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.parallel import mesh
    from pix2pixhdaudiosr_torch.parallel.halo import make_cp_generator
    lay = mesh.make_serving_layout(world, *DP_CP)
    spec = torch.load(os.path.join(WORK, "dpcp_spec.pt")).to(world.device)
    rec = dict(cp=lay.cp.ranks, data=lay.data.ranks)
    for dtype in ("float32", "bfloat16"):
        system = flagship_system(world.device, ["--compute_dtype", dtype])
        run = functools.partial(generate.cp_forward, make_cp_generator(
            system, lay.cp, batch_group=lay.data), spec)
        run()
        out, rec[dtype] = timed_forward(run, world, {"cp": lay.cp,
                                                     "data": lay.data},
                                        counters, counts)
        if world.rank == 0:
            torch.save(out.cpu(), os.path.join(WORK, f"dpcp_out_{dtype}.pt"))
        del system, run, out
        torch.cuda.empty_cache()
    return rec


def int8_tp_rank(world, group, spec, counters, counts) -> dict:
    """The int8 trunk under TP on one rank of phase 15's 2, in f32 and
    bf16, on the parent's batch of 16 segments: the one-rank int8 G first
    (the flagship loaded with --int8_trunk, whole weights), each trunk
    conv's input and int32 accumulator recorded; then the resblocks
    sharded (parallel/tp.shard_generator), a warm-up (which quantizes the
    shards and records the TP G's own accumulators) and a timed forward
    (timed_forward, the int8 convs and B3's one-pass launches counted);
    then each split conv run on the one-rank conv's recorded input (its
    slice of the channels for ConvIN_1) with this rank's quantized shard:
    its accumulator and scale against the one-rank conv's (ConvIN_0: the
    accumulator's slice of this rank's output channels). Rank 0 saves the
    TP G's output."""
    import torch
    from pix2pixhdaudiosr_torch.ops import quant
    from pix2pixhdaudiosr_torch.ops.norm import instance_norm_act
    from pix2pixhdaudiosr_torch.parallel.tp import shard_generator
    acc_fn, rec = quant.conv3x3_int8_acc, {}
    r, n = group.rank, group.size

    def recording(into):
        def spy(x, kq, g=None):
            acc, sx = acc_fn(x, kq, g)
            into.append((x, acc, sx))
            return acc, sx
        return spy

    for dtype in ("float32", "bfloat16"):
        system = flagship_system(world.device, ["--int8_trunk",
                                                "--compute_dtype", dtype])
        whole, split = [], []
        quant.conv3x3_int8_acc = recording(whole)
        try:
            unsharded_forward(system, spec)
            shard_generator(system.netG, group)
            quant.conv3x3_int8_acc = recording(split)
            unsharded_forward(system, spec)
        finally:
            quant.conv3x3_int8_acc = acc_fn
        run = functools.partial(unsharded_forward, system, spec)
        reset_counts(quant.conv3x3_int8)
        out, rec[dtype] = timed_forward(run, world, {"tp": group},
                                        dict(counters, conv3x3_int8=
                                             quant.conv3x3_int8), counts)
        rec[dtype].update(
            int8_launches=quant.conv3x3_int8.launches,
            in_onepass=instance_norm_act.launches_onepass,
            in_launches=instance_norm_act.launches)
        quantized = getattr(system.netG, "global")._int8_cache[2]
        convs, g_acc = [], []
        for i, ((x, acc, sx), (kq, _), (_, tp_acc, _)) in enumerate(
                zip(whole, quantized, split)):
            if i % 2 == 0:       # ConvIN_0: this rank's output channels
                got, got_sx = acc_fn(x, kq)
                want = acc.chunk(n, 1)[r]
            else:                # ConvIN_1: this rank's input channels
                got, got_sx = acc_fn(x.chunk(n, 1)[r], kq, group)
                want = acc
            convs.append(bool(torch.equal(got, want))
                         and bool(torch.equal(got_sx, sx)))
            g_acc.append(bool(torch.equal(tp_acc, want)))
        rec[dtype].update(split_conv_acc_equal=convs, g_acc_equal=g_acc,
                          convs=len(whole))
        if world.rank == 0:
            torch.save(out.cpu(), os.path.join(WORK,
                                               f"int8tp_out_{dtype}.pt"))
        del system, run, out, whole, split, quantized
        torch.cuda.empty_cache()
    return rec


def phase_cp_ranks(dev, wav: str) -> dict:
    """CP at CP_SHARDS ranks sharing cuda:0 over gloo (ranks 1 and 2
    interior shards), flagship width, on the whole file's spectrogram: the
    gathered output against the plain generator's in one process, f32 and
    bf16 within 2x the rounding floor; every layer kind at flagship width
    (f32) against its unsharded output within 1e-5 max|y|; on every rank B3's cross-shard entries
    launched and no one- or two-pass B3 in the CP G; the CLI at these
    ranks wrote the file (rank 0 alone returned it)."""
    import torch
    full, spec = full_length_spec(flagship_system(dev, ["--compute_dtype",
                                                        "float32"]),
                                  wav, CP_SHARDS)
    torch.save(spec.cpu(), os.path.join(WORK, "cp_spec.pt"))
    # dp x cp: DP_CP_BATCH seeded segments, their rows over `data`
    seg = flagship_system(dev, ["--compute_dtype", "float32"])
    lr, noise = seeded_batch(seg, dev, DP_CP_BATCH)
    with torch.no_grad():
        dspec = seg.encode_input(lr, noise)[0].contiguous()
    del seg
    torch.save(dspec.cpu(), os.path.join(WORK, "dpcp_spec.pt"))
    want, floor, dwant, dfloor = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            full = flagship_system(dev)
        ref = unsharded_forward(full, spec)
        floor[dtype] = rounding_floor(full, spec, ref)
        want[dtype] = ref.cpu()
        ref = unsharded_forward(full, dspec)
        dfloor[dtype] = rounding_floor(full, dspec, ref)
        dwant[dtype] = ref.cpu()
    del full, ref
    torch.cuda.empty_cache()
    recs = run_ranks("cp", CP_SHARDS)
    res = dict(frames=spec.shape[2], ranks=recs)
    for dtype, ref in want.items():
        got = torch.load(os.path.join(WORK, f"cp_out_{dtype}.pt"))
        res[dtype] = ulp_reading(got, ref)
        check_against_floor(f"CP at {CP_SHARDS} ranks, {dtype}", res[dtype],
                            floor[dtype], ref.abs().max().item())
        print(f"[cp {CP_SHARDS} ranks] {dtype}: " + json.dumps(res[dtype]))
    for r in recs:
        for name, (err, scale) in r["layers"].items():
            check(err <= 1e-5 * scale, f"rank 0, CP layer {name} at "
                  f"flagship width, f32: {err} > 1e-5 x {scale}")
        for dtype in want:
            c = r[dtype]["counts"]
            check(c["instance_moments"]["launches"] > 0
                  and c["instance_apply"]["launches"] > 0,
                  f"rank {r['rank']} {dtype}: B3's cross-shard entries not "
                  f"launched: {c}")
            check(c["instance_norm_act"]["launches"] == 0,
                  f"rank {r['rank']} {dtype}: one-/two-pass B3 in the CP G")
        check(r["cli"]["returned_audio"] == (r["rank"] == 0),
              f"rank {r['rank']}: the CLI's return")
    check(os.path.exists(os.path.join(WORK, f"cp{CP_SHARDS}", "sr_audio.wav")),
          "the CP CLI at 4 ranks wrote no sr_audio.wav")
    res["dp_cp"] = phase_dp_cp_checks(recs, dwant, dfloor, dspec.shape)
    print(f"[cp {CP_SHARDS} ranks] " + json.dumps(res))
    return res


def phase_dp_cp_checks(recs, want, floor, shape) -> dict:
    """dp x cp serving at DP_CP (the CP world's ranks as a 2 x 2 data x cp
    mesh): the gathered G output in f32 and bf16 against the plain G's in
    one process within 2x its rounding floor; each rank's groups row-major
    (cp: its data row, data: its column), B3's cross-shard entries
    launched on every rank and no one-launch B3; each rank's gloo bytes by
    group, wall ms and peak GiB printed."""
    import torch
    dp, cp = DP_CP
    res = dict(shape=list(shape), mesh=DP_CP)
    for dtype, ref in want.items():
        got = torch.load(os.path.join(WORK, f"dpcp_out_{dtype}.pt"))
        check(got.shape == ref.shape, f"dp x cp {dtype}: output "
              f"{tuple(got.shape)}, expected {tuple(ref.shape)}")
        res[dtype] = ulp_reading(got, ref)
        check_against_floor(f"dp x cp at {dp} x {cp} ranks, {dtype}",
                            res[dtype], floor[dtype], ref.abs().max().item())
    res["ranks"] = []
    for r in recs:
        rank, d = r["rank"], r["dp_cp"]
        check(d["cp"] == [rank // cp * cp + c for c in range(cp)]
              and d["data"] == [rank % cp + k * cp for k in range(dp)],
              f"rank {rank}: dp x cp groups {d['cp']}, {d['data']}")
        row = dict(rank=rank)
        for dtype in want:
            c = d[dtype]["counts"]
            check(c["instance_moments"]["launches"] > 0
                  and c["instance_apply"]["launches"] > 0
                  and c["instance_norm_act"]["launches"] == 0,
                  f"dp x cp rank {rank} {dtype}: B3m/B3a not launched or a "
                  f"one-launch B3 ran: {c}")
            row[dtype] = dict(
                wall_ms=d[dtype]["wall_ms"], peak_gib=d[dtype]["peak_gib"],
                b3m=c["instance_moments"]["launches"],
                b3a=c["instance_apply"]["launches"],
                gloo_bytes={g: sum(v["bytes"] for v in t.values())
                            for g, t in d[dtype]["traffic"].items()})
        res["ranks"].append(row)
    print(f"[dp x cp {dp} x {cp}] " + json.dumps(res))
    return res


def phase_tp_ranks(dev) -> dict:
    """TP at TP_SHARDS ranks sharing cuda:0 over gloo, flagship width, on a
    seeded batch of 16 segments: rank 0's output against the plain
    generator's in one process, f32 and bf16 within 2x the rounding floor;
    a trunk and an enhancer resblock at flagship width split over the
    ranks against the whole block, f32 within 1e-5 max|y|; B3's
    launches by shape at C/N channels (the trunk's 1536 / 2 = 768 and the
    enhancer's 96 / 2 = 48); the CLI at these ranks wrote the file."""
    import torch
    system = flagship_system(dev, ["--compute_dtype", "float32"])
    lr, noise = seeded_batch(system, dev, 16)
    with torch.no_grad():
        spec = system.encode_input(lr, noise)[0].contiguous()
    torch.save(spec.cpu(), os.path.join(WORK, "tp_spec.pt"))
    want, floor, want8 = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            system = flagship_system(dev)
        ref = unsharded_forward(system, spec)
        floor[dtype] = rounding_floor(system, spec, ref)
        want[dtype] = ref.cpu()
        want8[dtype] = unsharded_forward(flagship_system(dev, [
            "--int8_trunk", "--compute_dtype", dtype]), spec).cpu()
    del system, ref
    torch.cuda.empty_cache()
    recs = run_ranks("tp", TP_SHARDS)
    res = dict(ranks=recs)
    for dtype, ref in want.items():
        got = torch.load(os.path.join(WORK, f"tp_out_{dtype}.pt"))
        res[dtype] = ulp_reading(got, ref)
        check_against_floor(f"TP at {TP_SHARDS} ranks, {dtype}", res[dtype],
                            floor[dtype], ref.abs().max().item())
        print(f"[tp {TP_SHARDS} ranks] {dtype}: " + json.dumps(res[dtype]))
    for r in recs:
        for name, (err, scale) in r["layers"].items():
            check(err <= 1e-5 * scale, f"rank {r['rank']}, TP block {name} "
                  f"at flagship width, f32: {err} > 1e-5 x {scale}")
        shapes = r["bfloat16"]["counts"]["instance_norm_act"]["by_shape"]
        for s in ("(16, 4, 768)", "(256, 64, 48)"):
            check(shapes.get(s, 0) > 0, f"rank {r['rank']}: no B3 launch at "
                  f"{s} (C/N channels): {shapes}")
    check(os.path.exists(os.path.join(WORK, f"tp{TP_SHARDS}", "sr_audio.wav")),
          "the TP CLI at 2 ranks wrote no sr_audio.wav")
    res["int8_tp"] = phase_int8_tp_checks(recs, want8, floor)
    print(f"[tp {TP_SHARDS} ranks] " + json.dumps(res))
    return res


def phase_int8_tp_checks(recs, want, floor) -> dict:
    """The int8 trunk under TP at TP_SHARDS ranks (int8_tp_rank): on every
    rank each split trunk conv's int32 accumulator and activation scale
    equal to the one-rank conv's on the same input, INT8_TP_CONVS int8
    convs a forward and every InstanceNorm on B3's one-pass route, with the
    trunk's at C/N channels (16 x 4 x 768); rank 0's G output against the
    one-rank int8 G's: correlation >= 0.99 in bf16 (as the int8 path
    against the plain one, phase 7) and, in f32, within 2x the plain G's
    f32 rounding floor (the TP G's bound); generate --int8_trunk
    --tp_shards 2 wrote its file (rank 0 alone returned it). Whether the
    TP G's own accumulators equal the one-rank G's (they do where B3 at
    C/N channels rounds each plane as at C) is read."""
    import torch
    res = dict(ranks=[])
    for dtype, ref in want.items():
        got = torch.load(os.path.join(WORK, f"int8tp_out_{dtype}.pt"))
        r = ulp_reading(got, ref)
        r["corr"] = torch.corrcoef(torch.stack([
            got.flatten().double(), ref.flatten().double()]))[0, 1].item()
        if dtype == "bfloat16":
            check(r["corr"] >= 0.99, f"int8 TP G bf16: correlation "
                  f"{r['corr']} < 0.99 with the one-rank int8 G")
        else:
            check_against_floor(f"int8 TP at {TP_SHARDS} ranks, f32", r,
                                floor["float32"], ref.abs().max().item())
        res[dtype] = r
    for rec in recs:
        rank, t = rec["rank"], rec["int8_tp"]
        row = dict(rank=rank)
        for dtype in want:
            d = t[dtype]
            shapes = d["counts"]["instance_norm_act"]["by_shape"]
            check(d["convs"] == INT8_TP_CONVS and all(
                d["split_conv_acc_equal"]), f"int8 TP rank {rank} {dtype}: "
                f"split accumulators {d['split_conv_acc_equal']}")
            check(d["int8_launches"] == INT8_TP_CONVS, f"int8 TP rank {rank} "
                  f"{dtype}: {d['int8_launches']} int8 convs a forward")
            check(d["in_onepass"] == d["in_launches"] > 0
                  and shapes.get("(16, 4, 768)", 0) > 0,
                  f"int8 TP rank {rank} {dtype}: B3 off the one-pass route "
                  f"or not at C/N: {d['in_onepass']}/{d['in_launches']}, "
                  f"{shapes}")
            row[dtype] = dict(
                wall_ms=d["wall_ms"], peak_gib=d["peak_gib"],
                int8_launches=d["int8_launches"],
                g_acc_equal=d["g_acc_equal"],
                gloo_bytes=sum(v["bytes"]
                               for v in d["traffic"]["tp"].values()),
                traffic=d["traffic"]["tp"])
        row["cli_seconds"] = rec["cli_int8"]["seconds"]
        check(rec["cli_int8"]["returned_audio"] == (rank == 0),
              f"rank {rank}: the int8 TP CLI's return")
        res["ranks"].append(row)
    check(os.path.exists(os.path.join(WORK, f"tp{TP_SHARDS}_int8",
                                      "sr_audio.wav")),
          "generate --int8_trunk --tp_shards 2 wrote no sr_audio.wav")
    print(f"[int8 tp {TP_SHARDS} ranks] " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# The training half of the parallel modes (parallel/dp.py, zero.py, fsdp.py):
# 2 ranks sharing cuda:0 over gloo, at flagship width.
DP_MODES, DP_RANKS = ("dp", "zero", "fsdp"), 2
# the parity leg (f32, TF32 off): its global batch and steps; the timing
# leg (bf16): its global batch (32 a rank) and timed steps after 1 warm-up
DP_PARITY_BATCH, DP_PARITY_STEPS = 8, 2
# the parity legs' depth: flagship widths, one resblock in the trunk and
# one in the enhancer (the full flagship's 3 and 2; the timing leg keeps
# them): G 70,998,530 parameters, whose host copies the readings take
DP_PARITY_DEPTH = ["--n_blocks_global", "1", "--n_blocks_local", "1"]
# the recipes held under DP in the dp world, f32 at the parity leg's batch
# and depth: the time-D + match step and the HiFi-GAN D (RECIPES' flags)
DP_RECIPES = {"time_d_match": RECIPES[0][0], "hifigan": RECIPES[1][0]}
DP_TIMING_BATCH, DP_TIMING_STEPS = TRAIN_BATCH, 1
# a flagship train step's launches a rank at its share of the batch (all on
# the fast routes): B1 2, B3 and its backward 40
# the rounding floor's orders of the parity batch's rows: as given, reversed,
# its halves swapped (every batch sum of the step in another order)
DP_ORDERS = {"one": [0, 1, 2, 3, 4, 5, 6, 7], "reversed": [7, 6, 5, 4, 3, 2, 1, 0],
             "swapped": [4, 5, 6, 7, 0, 1, 2, 3]}
# the parity bounds of one step, kind by kind. Each parity step starts from
# the state the reference's starts from: from a second step on, Adam turns
# the rounding of the first into whole steps of ~lr, and two f32 runs on
# the rows in other orders drift apart by up to ~4 lr at flagship width.
# Moments: the largest gap over a leaf's max (its net's max for the conv
# biases that feed an InstanceNorm, whose exact grad is 0: norm_fed_biases);
# after a step exp_avg is (1 - beta1) g, so this reads the reduced grads.
# Parameters: the largest gap, in units of lr, over the entries whose grad
# in the reference's step is above 1e-3 of its leaf's max|g| and
# DP_NOISE_FACTOR x the leaf's grad noise (the largest change of any of its
# grads over the rows in DP_ORDERS), those biases left out: Adam steps by
# the sign of a grad, and in a conv that feeds an InstanceNorm the input's
# per-channel mean cancels in the weight grads, so entries near 0 flip sign
# with rounding. Every parity leg runs on parity_cudnn's algorithms, each
# one-process net on the ranks' row blocks (rank_blocks): every row's
# forward is then bit for bit the one it has on its rank and in every
# order, and a floor or a mode reads only the rounding of the sums (an
# H100, eleven phase-16 runs: every floor's moments <= 4.4e-5 and
# parameters <= 0.0026 lr, every mode's <= 2e-5 and <= 0.001 lr; the bounds
# sit ~20x above them: a grad reduced at bf16's precision moves a moment
# ~5e-3 of its leaf's max. On cuDNN's default algorithms the G forward
# moved run to run, and the floor's moments read up to 0.0223).
# DP_FLOOR_FACTOR x the rounding floor's largest relative gap bounds the
# losses. Every run reads the floor against the same bounds, and 3 planted
# faults of the dp step (the grads left unreduced; summed, not averaged;
# rounded to bf16 before and after the all-reduce) must exceed them.
DP_PARAM_LR = 0.05
DP_MOMENT_REL = 1e-3
DP_NOISE_FACTOR = 10
DP_FLOOR_FACTOR = 4
DP_FAULTS = ("unreduced", "summed", "bf16")
DP_STEP_LAUNCHES = {"mdct2": TRAIN_MDCT_LAUNCHES,
                    "instance_norm_act": TRAIN_IN_LAUNCHES,
                    "instance_norm_act_grad": TRAIN_IN_LAUNCHES}


# The reference's default generator, --netG local at its defaults: G9L3 at
# ngf 64 (scripts/train_recipes.sh:73-78, Family C's pretrain at batch 32,
# which Family D fine-tunes), 9 trunk resblocks at 2048 channels and 3
# enhancer ones at 128; the flagship's other flags. Its serve at batch 128
# and its one-process step at the recipe's batch 32 in bf16, then DP and
# FSDP at 2 ranks of 16 rows each (phase 16)
G730 = [*FLAGSHIP, "--ngf", "64", "--n_blocks_global", "9",
        "--n_blocks_local", "3"]
G730_PARAMS = 730_713_346
G730_SERVE_BATCH, G730_STEP_BATCH = 128, 32
# a forward's InstanceNorms: 27 in the trunk (the head, 4 downs, 18 in the
# resblocks, 4 deconvs) and 9 in the enhancer (2 downs, 6 in the
# resblocks, the deconv); a step's: G's and 6 in each of 3 D forwards,
# each with its backward
G730_SERVE_LAUNCHES = {"mdct2": 1, "instance_norm_act": 36, "imdct2": 1}
G730_STEP_LAUNCHES = {"mdct2": 2, "instance_norm_act": 54,
                      "instance_norm_act_grad": 54}
# its InstanceNorm planes (C, H, W): the trunk's resblocks, the enhancer's
# resblocks (and the trunk's head), the enhancer's first conv
G730_IN_SHAPES = [(2048, 16, 4), (128, 256, 64), (64, 512, 128)]
# an FSDP rank's peak below a DP rank's at G730_STEP_BATCH over DP_RANKS
# ranks (the moments, slices and slice grads halved), and the share of
# DP's parameter and moment bytes it may hold between steps
G730_FSDP_SAVING_GIB, G730_HELD_SHARE = 4.0, 0.6


def g730_train_state(dev, batch: int = G730_STEP_BATCH):
    """A bf16 G730 training system and its fresh train state (seeded
    init: every rank draws the same), its parameter counts checked."""
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state
    cfg = parse_config([*G730, "--batchSize", str(batch)], is_train=True,
                       save=False)
    state = init_state(Pix2PixHDSystem(cfg, device=dev), 0)
    n = [sum(p.numel() for p in net.parameters())
         for net in (state.system.netG_train, state.system.netD)]
    check(n == [G730_PARAMS, 5_531_522], f"the 730M G and its D: {n}")
    return state


def g730_serve(dev, counters) -> dict:
    """The 730M G served (system.inference + codec.imdct_eval, bf16,
    batch 128): its weights seeded N(0, 0.02) on the card in f32 (730,713,346
    parameters checked), cast once to bf16 as generate's load_system does;
    one forward's launches (B1 1, B3 36, B2 1) and routes, ms a batch by
    CUDA events (5 after 2) and peak GiB. In f32 at batch 1 the card's G
    output against the port's CPU twin on the same weights and
    spectrogram, within 2x the G's f32 rounding floor on the card
    (rounding_floor, check_against_floor: the two devices round every
    layer apart)."""
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.models.generator import init_normal_
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem

    def system(dtype: str, device):
        cfg = parse_config([*G730, "--compute_dtype", dtype],
                           is_train=False, save=False)
        return Pix2PixHDSystem(cfg, device=device)

    f32 = system("float32", dev)
    init_normal_(f32.netG, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in f32.netG.parameters())
    check(n_params == G730_PARAMS, f"the 730M G has {n_params} parameters")
    f32.netG.to(memory_format=torch.channels_last).eval()
    cpu = system("float32", "cpu")
    cpu.netG.load_state_dict({k: v.cpu() for k, v in
                              f32.netG.state_dict().items()})
    cpu.netG.to(memory_format=torch.channels_last).eval()
    lr1, noise1 = seeded_batch(f32, dev, 1)
    with torch.no_grad():
        spec = f32.encode_input(lr1, noise1)[0]
    want = unsharded_forward(f32, spec)
    floor = rounding_floor(f32, spec, want)
    t0 = time.perf_counter()
    got = unsharded_forward(cpu, spec.cpu())
    reading = ulp_reading(got, want.cpu())
    reading["cpu_forward_s"] = time.perf_counter() - t0
    check_against_floor("the 730M G in f32 at batch 1, the CPU twin against "
                        "the card", reading, floor, want.abs().max().item())
    del cpu, got
    serve_sys = system("bfloat16", dev)
    serve_sys.netG.load_state_dict(f32.netG.state_dict())
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    serve_sys.netG.to(dtype=serve_sys.dtype,
                      memory_format=torch.channels_last).eval()
    lr, noise = seeded_batch(serve_sys, dev, G730_SERVE_BATCH)

    def serve():
        with torch.no_grad():
            sr, pha, norm, _ = serve_sys.inference(lr, noise=noise)
            return serve_sys.codec.imdct_eval(torch.abs(sr), pha, norm)

    for fn in counters.values():
        reset_counts(fn)
    out = serve()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    inorm = counters["instance_norm_act"]
    routes = dict(mdct2_tc=counters["mdct2"].launches_tc,
                  imdct2_tc=counters["imdct2"].launches_tc,
                  in_onepass=inorm.launches_onepass,
                  in_twopass=inorm.launches - inorm.launches_onepass,
                  in_by_shape={f"{h}x{w}x{c}": n for (h, w, c), n
                               in inorm.launches_by_shape.items()})
    check(bool(torch.isfinite(out).all()) and out.abs().max().item() > 0,
          "the 730M serve's waveform is not finite, or silent")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(serve, iters=5, warmup=2)
    res = dict(params=n_params, batch=G730_SERVE_BATCH, ms_per_batch=ms,
               frames_per_s=G730_SERVE_BATCH * serve_sys.n_frames / (ms / 1e3),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, routes=routes, f32_vs_cpu=reading)
    print("[g730 serve] " + json.dumps(res))
    check({k: n for k, n in launches.items() if n}
          == G730_SERVE_LAUNCHES, f"the 730M serve launched {launches}, "
          f"expected {G730_SERVE_LAUNCHES}")
    del serve_sys, lr, noise, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def g730_step(dev, counters) -> dict:
    """The 730M G's GAN step in one process through
    trainer.make_train_step at the recipe's batch 32, bf16 (G and D
    parameter counts checked): 1 warm-up and 3 timed steps (CUDA events),
    every count set to 0 just before the warm-up: ms/step, peak GiB,
    launches a step (B1 2, B3 54, B3' 54) with B3's and B3''s routes,
    every loss finite and every parameter moved."""
    import torch
    from pix2pixhdaudiosr_torch.trainer import make_train_step
    torch.backends.cudnn.benchmark = True
    state = g730_train_state(dev)
    step = make_train_step(state.system)
    data = flagship_train_batch(dev, G730_STEP_BATCH)
    probe = [p for net in (state.system.netG_train, state.system.netD)
             for p in net.parameters()][::7]
    before = [p.detach().clone() for p in probe]
    seeds = iter(range(2000, 3000))

    def run():
        gen = torch.Generator(device=dev).manual_seed(next(seeds))
        return {k: float(v) for k, v in step(state, data, gen)[0].items()}

    for fn in counters.values():
        reset_counts(fn)
    losses = [run()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        losses.append(run())
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    n = len(losses)
    inorm, grad = counters["instance_norm_act"], counters["instance_norm_act_grad"]
    res = dict(batch=G730_STEP_BATCH, steps=n, ms_per_step=sum(ms) / len(ms),
               ms_runs=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches_per_step={k: fn.launches / n
                                  for k, fn in counters.items()},
               mdct2_tc_per_step=counters["mdct2"].launches_tc / n,
               in_onepass_per_step=inorm.launches_onepass / n,
               in_grad_by_route_per_step={
                   k: v / n for k, v in grad.launches_by_route.items()},
               losses=losses,
               probed_moved=sum(int(not torch.equal(a, p.detach()))
                                for a, p in zip(before, probe)),
               probed=len(probe))
    print("[g730 step] " + json.dumps(res))
    check(all(v == v and abs(v) != float("inf") for lo in losses
              for v in lo.values()), "a 730M step's loss is not finite")
    check(res["probed_moved"] == res["probed"],
          f"{res['probed'] - res['probed_moved']} probed parameter tensors "
          f"of the 730M step did not move")
    got = {k: res["launches_per_step"].get(k, 0) for k in G730_STEP_LAUNCHES}
    check(got == G730_STEP_LAUNCHES, f"the 730M step launched {got} a step, "
          f"expected {G730_STEP_LAUNCHES}")
    del state, step, data, before, probe
    gc.collect()
    torch.cuda.empty_cache()
    return res


def g730_in_timing(dev) -> dict:
    """B3 (forward, relu, one launch) and B3' (its backward) at the 730M
    G's InstanceNorm planes, bf16 channels_last: B3 at the serve's batch
    and the step's, B3' at the step's; CUDA events (10 after 3), the route
    each shape takes and its bound (B3: x read and y written; B3': x and
    dy read, dx written: in_grad_bound)."""
    import torch
    from pix2pixhdaudiosr_torch.ops import norm
    out = {}
    for c, h, w in G730_IN_SHAPES:
        for b, grad in ((G730_SERVE_BATCH, False), (G730_STEP_BATCH, False),
                        (G730_STEP_BATCH, True)):
            gen = torch.Generator(device=dev).manual_seed(c + b)
            x = torch.randn(b, c, h, w, generator=gen, device=dev,
                            dtype=torch.bfloat16).contiguous(
                                memory_format=torch.channels_last)
            if grad:
                _, saved = norm.instance_norm_act(x, "relu", with_stats=True)
                dy = torch.randn_like(x)
                ms = cuda_ms(lambda: norm.instance_norm_act_grad(
                    x, dy, saved, "relu"), iters=10)
                r = dict(in_grad_bound(x), route=norm.plan_instance_norm_grad(
                    b, h, w, c, x.dtype).route)
            else:
                ms = cuda_ms(lambda: norm.instance_norm_act(x, "relu"),
                             iters=10)
                r = dict(bound(2 * 2 * x.numel(), 8 * x.numel(), F32_FLOPS),
                         route=norm.plan_instance_norm(b, h, w, c,
                                                       x.dtype).route)
            r.update(ms=ms, share_of_bound=r["bound_ms"] / ms)
            out[f"{'B3p' if grad else 'B3'} [{b},{c},{h},{w}]"] = r
            del x
    torch.cuda.empty_cache()
    print("[g730 in] " + json.dumps(out))
    return out


def g730_rank(world, mode: str, own) -> dict:
    """The 730M leg of a phase-16 rank (dp or fsdp): G730 in bf16 on this
    rank's 16 rows of a global batch of 32, one step after one warm-up,
    every count set to 0 just before it: the step's wall time (host clock,
    synchronized), peak GiB, the bytes held between steps (held_bytes)
    beside the replicated ones, gloo bytes (Group.traffic), launches, the
    losses; under FSDP the gathered-bytes peak and the two largest units'
    bytes."""
    import torch
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import mdct2
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    from pix2pixhdaudiosr_torch.parallel import mesh
    from pix2pixhdaudiosr_torch.parallel.dp import apply_dp
    from pix2pixhdaudiosr_torch.parallel.fsdp import apply_fsdp
    from pix2pixhdaudiosr_torch.trainer import make_train_step
    parity_cudnn(False)
    dev = world.device
    counters = {"mdct2": mdct2, "instance_norm_act": instance_norm_act,
                "instance_norm_act_grad": instance_norm_act_grad}
    layout = mesh.make_data_layout(world, G730_STEP_BATCH)
    state = g730_train_state(dev)
    n_params = sum(p.numel() for net in (state.system.netG_train,
                                         state.system.netD)
                   for p in net.parameters())
    par = {"dp": apply_dp, "fsdp": apply_fsdp}[mode](state, layout)
    step = make_train_step(state.system)
    rows = own(flagship_train_batch(dev, G730_STEP_BATCH), layout)
    seeds = iter(range(3000, 3100))

    def run():
        gen = torch.Generator(device=dev).manual_seed(next(seeds))
        return {k: float(v) for k, v in step(state, rows, gen)[0].items()}

    t0 = time.perf_counter()
    losses = [run()]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    groups = {"members": layout.members, "data": layout.data}
    for fn in counters.values():
        reset_counts(fn)
    for g in groups.values():
        g.reset_traffic()
    if mode == "fsdp":
        par.reset_gathered_peak()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses.append(run())
    torch.cuda.synchronize()
    traffic = {k: g.traffic() for k, g in groups.items()}
    rec = dict(rows=G730_STEP_BATCH // layout.data.size, warmup_s=warm,
               step_s=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               held=par.held_bytes(state),
               replicated=dict(params=4 * n_params, moments=8 * n_params),
               gloo_bytes=sum(v["bytes"] for t in traffic.values()
                              for v in t.values()),
               traffic=traffic, losses=losses,
               launches={k: fn.launches for k, fn in counters.items()})
    if mode == "fsdp":
        sizes = sorted(par.unit_bytes().values())
        rec.update(gathered_peak=par.gathered_peak,
                   two_largest_units=sizes[-1] + sizes[-2],
                   units=len(sizes))
    del state, par, step, rows
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def g730_checks(recs: dict, fails: list) -> dict:
    """Phase 16's 730M rank legs (g730_rank, dp and fsdp): every rank's
    losses finite and equal; the launches a rank-step (B1 2, B3 54, B3'
    54); FSDP's gathered-bytes peak within its two largest units; an FSDP
    rank's peak at least G730_FSDP_SAVING_GIB below every DP rank's, and
    the parameter and moment bytes it holds between steps at most
    G730_HELD_SHARE of DP's. A reading beyond its bound is added to
    `fails`. Returns the readings by mode and rank."""
    out = {}
    for mode, rs in recs.items():
        rows = [r["g730"] for r in rs]
        check(all(r["losses"] == rows[0]["losses"] for r in rows)
              and all(v == v and abs(v) != float("inf")
                      for lo in rows[0]["losses"] for v in lo.values()),
              f"the 730M step under {mode}: losses not finite or not equal "
              f"on every rank")
        for r in rows:
            got = {k: r["launches"][k] for k in G730_STEP_LAUNCHES}
            check(got == G730_STEP_LAUNCHES, f"the 730M step under {mode} "
                  f"launched {got}")
            if mode == "fsdp" and r["gathered_peak"] > r["two_largest_units"]:
                fails.append(f"730M FSDP gathered {r['gathered_peak']} bytes "
                             f"at once, beyond its two largest units' "
                             f"{r['two_largest_units']}")
        out[mode] = [{k: v for k, v in r.items() if k != "traffic"}
                     for r in rows]
    dp, fsdp = out["dp"], out["fsdp"]
    saving = min(d["peak_gib"] for d in dp) - max(f["peak_gib"] for f in fsdp)
    held = sum(fsdp[0]["held"].values()) / sum(dp[0]["held"].values())
    out["fsdp_saving_gib"], out["fsdp_held_share"] = saving, held
    if saving < G730_FSDP_SAVING_GIB:
        fails.append(f"730M: an FSDP rank peaks {saving:.3f} GiB below a DP "
                     f"rank, not {G730_FSDP_SAVING_GIB}")
    if held > G730_HELD_SHARE:
        fails.append(f"730M: FSDP holds {held:.3f} of DP's parameter and "
                     f"moment bytes between steps")
    print("[dp g730] " + json.dumps(out))
    return out


def parity_cudnn(on: bool) -> None:
    """cuDNN as phase 16's f32 parity legs run it (on: the one-process
    reference, its floor, every rank's parity and recipe steps) or as the
    rest of the script does (off: cuDNN times its algorithms). On, it
    takes its heuristic algorithms, the same in every process (a timed
    choice follows each process's own timings), and deterministic ones
    only. On the defaults ConvTranspose's forward (a cuDNN backward-data)
    summed with atomics: the same G forward moved ~3e-6 of max|y| run to
    run on an H100 and flipped 3-16 feature-matching L1 signs a step, so
    the step-2 floor's grad noise jumped (a ConvTranspose leaf at 0.0014
    or 0.0095 of its max over 10 floors from one state; 0.0218 in one
    run, past DP_MOMENT_REL) and the time-D step's G moments moved
    0.2-0.65 of a leaf's max; on these algorithms both floors read
    <= 5e-5."""
    import torch
    torch.backends.cudnn.benchmark = not on
    torch.backends.cudnn.deterministic = on


def _cat_rows(outs):
    """Row blocks' outputs of one net (tensors, or lists and tuples of
    them, as the discriminators return) joined along the batch."""
    import torch
    if isinstance(outs[0], (list, tuple)):
        return type(outs[0])(_cat_rows(parts) for parts in zip(*outs))
    return torch.cat(outs)


def rank_blocks(system, n: int = DP_RANKS) -> None:
    """Make the trained nets of a one-process parity system (G and every
    discriminator) run each forward on the batch's n row blocks, one
    after another, and join the outputs: a rank of phase 16 runs its own
    block. cuDNN picks its algorithm by the batch size, so on parity_cudnn's
    deterministic algorithms each row then meets in the reference the
    arithmetic it meets on its rank (a G forward at 8 rows sat 4e-6 of
    max|y| from the same rows at 4, H100), and no rounding of the forward
    can flip a branch (a ReLU, a feature-matching L1 sign, the dB floor)
    between the two: the step is the same sum of per-row terms."""
    for net in (system.netG_train, *system.d_nets().values()):
        forward = net.forward

        def blocked(x, *args, _forward=forward, **kw):
            return _cat_rows([_forward(rows, *args, **kw)
                              for rows in x.chunk(n)])
        net.forward = blocked


def dp_train_state(dev, dtype: str, batch: int, seed: int = 0, extra=()):
    """A flagship training system in `dtype` (with the flags `extra`) and
    its fresh train state (seeded init: every rank draws the same)."""
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state
    cfg = parse_config([*FLAGSHIP, "--compute_dtype", dtype, "--batchSize",
                        str(batch), *extra], is_train=True, save=False)
    return init_state(Pix2PixHDSystem(cfg, device=dev), seed)


def dp_noise(system, dev, batch: int, i: int):
    """The global batch's mask noise of parity step i (each rank draws the
    whole of it and keeps its rows)."""
    import torch
    b, f, t, c = system.spectro_shape(batch)
    gen = torch.Generator(device=dev).manual_seed(7000 + i)
    return torch.randn(b, system.codec.mask_size(f), t, c, generator=gen,
                       device=dev)


def dp_state_dict(state, nets_only: bool = False) -> dict:
    """A train state's parameters of every trained net and, unless
    nets_only, Adam moments, whole, on the host, by name ("G.<p>", netE's
    "G.E.<p>", "D.<p>", "D.time_D.<p>", "D.hifigan_D.<p>",
    "opt_g.exp_avg.<p>", ...): collective under a parallel strategy (every
    rank calls it)."""
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    par, system, out = state.parallel, state.system, {}
    with par.full_state(state) if par else contextlib.nullcontext():
        for key, named in (("G", ckpt.g_params(system)),
                           ("D", ckpt.d_params(system))):
            out.update({f"{key}.{k}": v.detach().cpu()
                        for k, v in named.items()})
        if nets_only:
            return out
        for tag, opt, named in (("opt_g", state.opt_g, ckpt.g_params(system)),
                                ("opt_d", state.opt_d, ckpt.d_params(system))):
            names = ckpt._param_names(opt, named)
            for i, st in opt.state_dict()["state"].items():
                for m in ("exp_avg", "exp_avg_sq"):
                    out[f"{tag}.{m}.{names[i]}"] = st[m].detach().float().cpu()
    return out


def dp_grads(system) -> dict:
    """The grads a step left on every trained net's parameters, on the
    host, by dp_state_dict's names (one process: ZeRO and FSDP drop a
    sharded leaf's), the names of those parameters that are conv biases
    feeding an InstanceNorm (norm_fed_biases), and each leaf's grad noise
    (0 until add_noise reads it)."""
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    grads = {f"{key}.{n}": q.grad.detach().float().cpu()
             for key, named in (("G", ckpt.g_params(system)),
                                ("D", ckpt.d_params(system)))
             for n, q in named.items()}
    prefix = {"G": "G.", "E": "G.E.", "D": "D.", "time_D": "D.time_D.",
              "hifigan_D": "D.hifigan_D."}
    void = set().union(*(norm_fed_biases(net, prefix[k]) for k, net in {
        **system.g_nets(), **system.d_nets()}.items()))
    return dict(grads=grads, void=sorted(void),
                noise={k: 0.0 for k in grads})


def add_noise(ref: dict, other: dict) -> None:
    """Raise each leaf's grad noise in ref (dp_grads) to the largest change
    of its grads in `other`, the same step on the rows in another order."""
    for k, g in ref["grads"].items():
        ref["noise"][k] = max(ref["noise"][k],
                              (other["grads"][k] - g).abs().max().item())


def parity_gaps(got: dict, want: dict, ref: dict, lr: float, dev) -> dict:
    """Two states' (dp_state_dict) largest gaps kind by kind, as
    DP_PARAM_LR and DP_MOMENT_REL read them: "G" and "D" in units
    of lr over the entries whose grad in ref (dp_grads) is above 1e-3 of
    its leaf's max|g| and DP_NOISE_FACTOR x its noise, the conv biases
    feeding an InstanceNorm left out;
    each Adam moment ("opt_g.exp_avg", ...) over its leaf's max (its net's
    max for those biases). {kind: [gap, the leaf that gives it]}."""
    import torch
    grads, void = ref["grads"], set(ref["void"])
    net_max, out = {}, {}
    for k, w in want.items():
        if k.startswith("opt_"):
            kind = ".".join(k.split(".", 2)[:2])
            net_max[kind] = max(net_max.get(kind, 0.0),
                                w.float().abs().max().item())
    for k, w in want.items():
        w = w.to(dev).float()
        diff = (got[k].to(dev).float() - w).abs()
        if k.startswith("opt_"):
            tag, m, name = k.split(".", 2)
            kind, leaf = f"{tag}.{m}", ("G." if tag == "opt_g" else "D.") + name
            scale = net_max[kind] if leaf in void else w.abs().max().item()
            gap = diff.max().item() / max(scale, 1e-30)
        elif k in grads and k not in void:
            g = grads[k].to(dev).abs()
            big = g > max(1e-3 * g.max().item(),
                          DP_NOISE_FACTOR * ref["noise"][k])
            kind = k.split(".")[0]
            gap = diff[big].max().item() / lr if bool(big.any()) else 0.0
        else:
            continue
        out[kind] = max(out.get(kind, [0.0, ""]), [gap, k])
        del w, diff
    torch.cuda.empty_cache()
    return out


def loss_gaps(got: list, want: list) -> float:
    """The largest relative difference of two runs' losses, step by step."""
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
               for g, w in zip(got, want) for k in w)


def parity_bounds(gaps: dict) -> dict:
    """Each kind's (gap, bound, leaf) of parity_gaps: parameters
    DP_PARAM_LR (in lr), moments DP_MOMENT_REL (of a leaf's max)."""
    return {kind: (gap, DP_MOMENT_REL if "." in kind else DP_PARAM_LR, leaf)
            for kind, (gap, leaf) in gaps.items()}


def dp_parity_state(dev, i: int):
    """The f32 flagship train state that parity step i starts from: the
    seeded init (i = 0), else another init restored from the one-process
    reference's `latest` after step i (WORK/dp_ref_step<i>)."""
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    if i == 0:
        return dp_train_state(dev, "float32", DP_PARITY_BATCH,
                              extra=DP_PARITY_DEPTH)
    state = dp_train_state(dev, "float32", DP_PARITY_BATCH, seed=99,
                           extra=DP_PARITY_DEPTH)
    ckpt.load_train_state(state, "latest",
                          os.path.join(WORK, f"dp_ref_step{i}"))
    return state


def ordered_steps(dev, make_state, batch: dict, i: int, save=None) -> dict:
    """Parity step i in this process on the rows of `batch` in each order
    of DP_ORDERS, each from a state make_state() builds: the first order's
    losses, state (dp_state_dict) and grads (dp_grads, each leaf's grad
    noise raised over the other orders: add_noise), and the rounding
    floor: the widest parity_gaps between two orders, kind by kind, and
    the widest relative loss gap. With the time-domain D, the first order
    records its branch of the dB floor (record_floors: `floors`, by the
    batch's rows) and the other orders take it (card_floor), as the ranks'
    steps do (dp_recipe_rank): an element within rounding of the floor
    takes either branch in two f32 steps, and its grad jumps by
    8.7 / min_value. Each order's nets run on the ranks' row blocks
    (rank_blocks). With `save`, the first order's state is saved there as
    `latest`."""
    import torch
    from pix2pixhdaudiosr_torch.trainer import make_train_step
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    runs, floors = {}, None
    for name, order in DP_ORDERS.items():
        state = make_state()
        system = state.system
        rank_blocks(system)
        if system.cfg.use_time_d and floors is None:
            floors = []
            record_floors(system, floors)
        elif system.cfg.use_time_d:
            system.time_d_input = card_floor(floor_rows(floors, order),
                                             system.cfg.min_value)
        data = {k: v[order].contiguous() for k, v in batch.items()}
        lo = make_train_step(state.system)(state, data, dp_noise(
            state.system, dev, DP_PARITY_BATCH, i)[order].contiguous())[0]
        runs[name] = ({k: float(v) for k, v in lo.items()},
                      dp_state_dict(state))
        if name != "one":
            add_noise(grads, dp_grads(state.system))
        else:
            grads = dp_grads(state.system)
            if save:
                ckpt.save_train_state(state, save, "latest")
        lr = state.system.cfg.lr
        del state
        gc.collect()
        torch.cuda.empty_cache()
    pairs = [(a, b) for j, a in enumerate(runs) for b in list(runs)[j + 1:]]
    gaps = [parity_gaps(runs[a][1], runs[b][1], grads, lr, dev)
            for a, b in pairs]
    return dict(losses=runs["one"][0], state=runs["one"][1], grads=grads,
                lr=lr, floor={kind: max(g[kind] for g in gaps)
                              for kind in gaps[0]},
                floor_loss=max(loss_gaps([runs[a][0]], [runs[b][0]])
                               for a, b in pairs),
                floors=floors and [tuple(k.cpu() for k in call)
                                   for call in floors])


def beyond(bounds: dict) -> list:
    """The kinds of parity_bounds whose gap exceeds the bound."""
    return [kind for kind, (gap, bound, _) in bounds.items() if gap > bound]


def dp_rank_worker(mode: str) -> int:
    """One rank of phase 16's `mode` (dp, zero, fsdp) at DP_RANKS ranks
    sharing cuda:0 over gloo (parallel.mesh). Parity leg, f32: 2 steps on
    this rank's rows of the parent's 8 (the same mask noise), each from
    the state the parent's step starts from (dp_parity_state), the mode
    applied; their losses and whole states against the parent's (rank 0,
    parity_gaps), the bytes of parameters and moments held after them and
    each leaf's slice against shard_dim; with dp, the same steps under
    each planted fault (DP_FAULTS) read alike; with zero, `latest` saved
    after them (rank 0 writes) and a third step's losses and state kept
    for the parent. Timing leg, bf16: 32 rows a rank of a
    batch of 64, 1 warm-up and DP_TIMING_STEPS timed steps (host clock
    around each, synchronized), every count set to 0 just before them:
    launches a step, gloo bytes a step (Group.traffic), peak CUDA memory,
    and with fsdp the gathered-bytes peak beside the two largest units'
    bytes. Then with dp the recipes (dp_recipe_rank), and with dp and fsdp
    the 730M G's step (g730_rank).
    Writes its record to WORK/<mode>_rank<r>.json."""
    import torch
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import mdct2
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    from pix2pixhdaudiosr_torch.parallel import mesh
    from pix2pixhdaudiosr_torch.parallel.dp import all_reduce_mean_, apply_dp
    from pix2pixhdaudiosr_torch.parallel.fsdp import apply_fsdp
    from pix2pixhdaudiosr_torch.parallel.zero import apply_zero, shard_dim
    from pix2pixhdaudiosr_torch.trainer import make_train_step
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parity_cudnn(True)      # as the parent's runs
    apply = {"dp": apply_dp, "zero": apply_zero, "fsdp": apply_fsdp}[mode]
    world = mesh.initialize(torch.device("cuda:0"))
    dev = world.device
    rec = dict(rank=world.rank, size=world.size, backend=world.backend,
               device=str(dev), mode=mode,
               seconds=dict(joined=time.perf_counter() - t0))

    def own(batch, layout):
        return {k: v.chunk(layout.data.size)[layout.data.rank].contiguous()
                for k, v in batch.items()}

    # -- parity leg (f32)
    layout = mesh.make_data_layout(world, DP_PARITY_BATCH)
    rows = own(flagship_train_batch(dev, DP_PARITY_BATCH), layout)
    ref = torch.load(os.path.join(WORK, "dp_ref.pt"), mmap=True,
                     weights_only=True) if world.rank == 0 else None

    def parity_steps(fault=None, steps=DP_PARITY_STEPS) -> tuple:
        """The first `steps` parity steps under the mode (and `fault`, its
        reduce_grads), each from the state the reference's starts from
        (dp_parity_state): (losses, the gaps to the reference on rank 0,
        the last state, its G and D parameters' count)."""
        losses, gaps, state = [], [], None
        for i in range(steps):
            del state
            gc.collect()
            torch.cuda.empty_cache()
            state = dp_parity_state(dev, i)
            n_params = sum(p.numel() for net in (
                state.system.netG_train, state.system.netD)
                for p in net.parameters())
            par = apply(state, layout)
            if fault is not None:
                par.reduce_grads = fault
            lo = make_train_step(state.system)(state, rows, dp_noise(
                state.system, dev, DP_PARITY_BATCH, i))[0]
            losses.append({k: float(v) for k, v in lo.items()})
            got = dp_state_dict(state)
            if ref is not None:
                gaps.append(parity_gaps(got, ref["states"][i],
                                        ref["grads"][i], state.system.cfg.lr,
                                        dev))
            del got
        return losses, gaps, state, n_params

    losses, gaps, state, n_params = parity_steps()
    par = state.parallel
    parity = dict(losses=losses, held=par.held_bytes(state),
                  replicated=dict(params=4 * n_params, moments=8 * n_params))
    if ref is not None:
        parity.update(gaps=gaps, loss_gap=loss_gaps(losses, ref["losses"]))
    if mode != "dp":
        named = {**ckpt.g_params(state.system), **{
            f"D.{k}": v for k, v in ckpt.d_params(state.system).items()}}
        names = {id(p): n for n, p in named.items()}
        follow, n_split = True, 0
        for opt in (state.opt_g, state.opt_d):
            for p, shard, (shape, _) in zip(opt.model_params, opt.shards,
                                            opt.meta):
                name = names[id(p)].removeprefix("D.")
                d = shard_dim(name, shape, layout.data.size)
                want = list(shape)
                if d is not None:
                    want[d] //= layout.data.size
                    n_split += 1
                follow &= list(shard.shape) == want
                if mode == "fsdp" and d is not None:
                    follow &= p.numel() == 0      # freed between steps
        parity.update(shards_follow_leaf_spec=follow, sharded_leaves=n_split)
    rec["parity"] = parity
    if mode == "zero":
        with par.full_state(state):
            if world.rank == 0:
                ckpt.save_train_state(state, os.path.join(WORK, "dp_zero_ck"),
                                      "latest")
        layout.members.barrier()
        lo = make_train_step(state.system)(state, rows, dp_noise(
            state.system, dev, DP_PARITY_BATCH, DP_PARITY_STEPS))[0]
        rec["third_step_losses"] = {k: float(v) for k, v in lo.items()}
        third = dp_state_dict(state)
        if world.rank == 0:
            torch.save(third, os.path.join(WORK, "dp_zero_step3.pt"))
        del third
    del state, par
    if mode == "dp":
        # the planted faults the parity bounds must reject
        def unreduced(state):
            pass

        def summed(state):
            par = state.parallel
            all_reduce_mean_([p.grad for p in par._params(state)
                              if p.grad is not None], par.members, 1)

        def bf16(state):
            par = state.parallel
            grads = [p.grad for p in par._params(state) if p.grad is not None]
            for g in grads:
                g.copy_(g.to(torch.bfloat16))
            type(par).reduce_grads(par, state)    # the mode's own reduce
            for g in grads:
                g.copy_(g.to(torch.bfloat16))

        parity["faults"] = {}
        # bf16's rounding shows at step 1 (its moments 5e-3 of a leaf's max)
        for name, fault, steps in zip(DP_FAULTS, (unreduced, summed, bf16),
                                      (DP_PARITY_STEPS, DP_PARITY_STEPS, 1)):
            t1 = time.perf_counter()
            lo, fault_gaps, _, _ = parity_steps(fault, steps)
            if ref is not None:
                parity["faults"][name] = dict(
                    gaps=fault_gaps, loss_gap=loss_gaps(lo, ref["losses"]),
                    seconds=time.perf_counter() - t1)
    del rows, ref
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"]["parity"] = time.perf_counter() - t0

    # -- timing and launch leg (bf16), cuDNN timing its algorithms
    parity_cudnn(False)
    counters = {"mdct2": mdct2, "instance_norm_act": instance_norm_act,
                "instance_norm_act_grad": instance_norm_act_grad}
    layout = mesh.make_data_layout(world, DP_TIMING_BATCH)
    state = dp_train_state(dev, "bfloat16", DP_TIMING_BATCH)
    par = apply(state, layout)
    step = make_train_step(state.system)
    rows = own(flagship_train_batch(dev, DP_TIMING_BATCH), layout)
    seeds = iter(range(100, 200))

    def run():
        gen = torch.Generator(device=dev).manual_seed(next(seeds))
        return step(state, rows, gen)[0]

    run()
    torch.cuda.synchronize()
    groups = {"members": layout.members, "data": layout.data}
    for fn in counters.values():
        reset_counts(fn)
    for g in groups.values():
        g.reset_traffic()
    torch.cuda.reset_peak_memory_stats()
    if mode == "fsdp":
        par.reset_gathered_peak()
    wall, losses = [], []
    for _ in range(DP_TIMING_STEPS):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        losses.append({k: float(v) for k, v in run().items()})
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t_step)
    n = DP_TIMING_STEPS
    traffic = {k: g.traffic() for k, g in groups.items()}
    rec["timing"] = dict(
        rows=DP_TIMING_BATCH // layout.data.size, step_s=wall,
        step_s_mean=sum(wall) / n, losses=losses,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        gloo_bytes_per_step=sum(v["bytes"] for t in traffic.values()
                                for v in t.values()) / n,
        traffic=traffic, held=par.held_bytes(state),
        launches_per_step={k: fn.launches / n for k, fn in counters.items()},
        mdct2_tc_per_step=mdct2.launches_tc / n,
        in_onepass_per_step=instance_norm_act.launches_onepass / n,
        in_grad_by_route_per_step={
            k: v / n for k, v in instance_norm_act_grad.launches_by_route.items()})
    if mode == "fsdp":
        sizes = sorted(par.unit_bytes().values())
        rec["timing"].update(gathered_peak=par.gathered_peak,
                             two_largest_units=sizes[-1] + sizes[-2],
                             units=len(sizes))
    rec["seconds"]["timing"] = time.perf_counter() - t0
    del state, par, step, rows
    gc.collect()
    torch.cuda.empty_cache()
    if mode == "dp":
        rec["recipes"] = dp_recipe_rank(world, own)
        rec["seconds"]["recipes"] = time.perf_counter() - t0
    if mode in ("dp", "fsdp"):
        rec["g730"] = g730_rank(world, mode, own)
        rec["seconds"]["g730"] = time.perf_counter() - t0
    with open(os.path.join(WORK, f"{mode}_rank{world.rank}.json"), "w") as f:
        json.dump(rec, f)
    mesh.shutdown()
    return 0


def dp_recipe_rank(world, own) -> dict:
    """The recipes of DP_RECIPES on one rank of phase 16's dp world, f32
    (TF32 off, parity_cudnn), at the parity leg's batch and depth: one
    step on this rank's rows of the parent's batch with the global mask
    noise, from the seeded init, under DP, the time-domain D on the
    one-process step's branches of the dB floor (its rows of them:
    card_floor); its wall time (the host clock, synchronized), gloo bytes
    (Group.traffic), peak memory and launches; on rank 0 its whole state
    against the parent's one-process step (parity_gaps) and its losses'
    gap. With the time-domain D, two more steps from the same start read
    alike: on the rank's own branches of the floor ("own_branches"), and
    on the recorded ones with the grads left unreduced (the planted fault
    "unreduced", which the held kinds must reject)."""
    import torch
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import (imdct2, imdct2_grad,
                                                         mdct2)
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    from pix2pixhdaudiosr_torch.parallel import mesh
    from pix2pixhdaudiosr_torch.parallel.dp import apply_dp
    from pix2pixhdaudiosr_torch.trainer import make_train_step
    parity_cudnn(True)
    dev = world.device
    counters = {"mdct2": mdct2, "imdct2": imdct2, "imdct2_grad": imdct2_grad,
                "instance_norm_act": instance_norm_act,
                "instance_norm_act_grad": instance_norm_act_grad}
    layout = mesh.make_data_layout(world, DP_PARITY_BATCH)
    rows = own(flagship_train_batch(dev, DP_PARITY_BATCH), layout)
    n = DP_PARITY_BATCH // layout.data.size
    mine = slice(layout.data.rank * n, (layout.data.rank + 1) * n)
    floors = torch.load(os.path.join(WORK, "dp_recipe_floors.pt"),
                        weights_only=True)
    ref = torch.load(os.path.join(WORK, "dp_recipe_ref.pt"), mmap=True,
                     weights_only=True) if world.rank == 0 else None

    def step(name, flags, replay=True, fault=None) -> dict:
        """One DP step of the recipe from the seeded init: its readings
        (seconds: the leg's, set-up included) and, on rank 0, its gaps to
        the one-process step."""
        t_leg = time.perf_counter()
        state = dp_train_state(dev, "float32", DP_PARITY_BATCH,
                               extra=[*flags, *DP_PARITY_DEPTH])
        par = apply_dp(state, layout)
        if fault is not None:
            par.reduce_grads = fault
        if replay and floors[name] is not None:
            state.system.time_d_input = card_floor(
                floor_rows(floors[name], mine), state.system.cfg.min_value)
        noise = dp_noise(state.system, dev, DP_PARITY_BATCH, 0)
        for fn in counters.values():
            reset_counts(fn)
        layout.members.reset_traffic()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lo = make_train_step(state.system)(state, rows, noise)[0]
        torch.cuda.synchronize()
        r = dict(wall_ms=1e3 * (time.perf_counter() - t0),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 losses=[{k: float(v) for k, v in lo.items()}],
                 gloo_bytes=sum(v["bytes"] for v in
                                layout.members.traffic().values()),
                 launches={k: fn.launches for k, fn in counters.items()})
        got = dp_state_dict(state)
        if ref is not None:
            r.update(gaps=parity_gaps(got, ref[name]["state"],
                                      ref[name]["grads"],
                                      state.system.cfg.lr, dev),
                     loss_gap=loss_gaps(r["losses"], ref[name]["losses"]))
        del state, par, got
        gc.collect()
        torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t_leg
        return r

    out = {}
    for name, flags in DP_RECIPES.items():
        out[name] = step(name, flags)
        if floors[name] is not None:
            out[name]["own_branches"] = step(name, flags, replay=False)
            out[name]["unreduced"] = step(name, flags,
                                          fault=lambda state: None)
    return out


def dp_recipe_checks(recs, recipes: dict, fails: list) -> None:
    """The recipes under DP (dp_recipe_rank) against their one-process
    steps: every rank's losses equal, rank 0's within DP_FLOOR_FACTOR x
    the floor's (relative), its parameters and moments, G's and every
    discriminator's, within parity_bounds, and the one-process floor
    within them too; with the time-domain D, the rank's step on its own
    branches of the dB floor read ("own_branches") and the planted fault
    (its grads left unreduced) beyond the bounds of G's kinds; B1, B3 and
    B3' launched on every rank, and with the HiFi-GAN D, B2 and its
    backward (B2'). A reading beyond its bound is added to `fails`; each
    recipe's readings go into `recipes`."""
    for name, row in recipes.items():
        first = recs[0]["recipes"][name]
        check(all(r["recipes"][name]["losses"] == first["losses"]
                  for r in recs), f"{name} under DP: the ranks report "
              f"different losses")
        row["within"] = parity_bounds(first["gaps"])
        row["loss_gap"] = first["loss_gap"]
        if beyond(row["floor"]):
            fails.append(f"{name}: the rounding floor beyond the bounds: "
                         f"{row['floor']}")
        if beyond(row["within"]):
            fails.append(f"{name} under DP at {DP_RANKS} ranks, f32: beyond "
                         f"the bounds: {row['within']}")
        if "unreduced" in first:
            row["own_branches"] = parity_bounds(first["own_branches"]["gaps"])
            fault = row["unreduced"] = parity_bounds(
                first["unreduced"]["gaps"])
            if not {"G", "opt_g.exp_avg", "opt_g.exp_avg_sq"} & set(
                    beyond(fault)):
                fails.append(f"{name}: the planted fault `unreduced` within "
                             f"the bounds of G's kinds: {fault}")
        if first["loss_gap"] > DP_FLOOR_FACTOR * row["floor_loss_gap"] + 1e-6:
            fails.append(f"{name} under DP: loss gap {first['loss_gap']} "
                         f"beyond {DP_FLOOR_FACTOR}x the floor's "
                         f"{row['floor_loss_gap']}")
        want = ["mdct2", "instance_norm_act", "instance_norm_act_grad"] + (
            ["imdct2", "imdct2_grad"] if name == "hifigan" else [])
        row["ranks"] = []
        for r in recs:
            d = r["recipes"][name]
            check(all(d["launches"][k] > 0 for k in want), f"{name} under "
                  f"DP rank {r['rank']}: launches {d['launches']}")
            row["ranks"].append({k: d[k] for k in (
                "wall_ms", "peak_gib", "gloo_bytes", "launches")})
        print(f"[dp recipe {name}] " + json.dumps(row))


def dp_cli_rank_worker() -> int:
    """One rank of the training CLI under 2 ranks (`--rank-worker cli`,
    the launcher's variables set as torchrun sets them), flagship width,
    --zero_opt_state, on phase 12's corpus (4 wavs) at batch 2: 2 steps
    saving at the epoch's end, then --continue_train for 2 more, whose
    first step must start from the saved G and D. Writes
    WORK/cli_rank<r>.json."""
    import torch
    import torch.distributed as dist
    from pix2pixhdaudiosr_torch import train_loop
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import mdct2
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    counters = {"mdct2": mdct2, "instance_norm_act": instance_norm_act,
                "instance_norm_act_grad": instance_norm_act_grad}
    expr = os.path.join(WORK, "dp_cli")
    argv = ["--name", "dp_cli", "--checkpoints_dir", WORK, "--dataroot",
            os.path.join(WORK, "corpus"), "--device", "cuda:0", *FLAGSHIP,
            "--batchSize", "2", "--niter_decay", "0", "--no_html",
            "--validation_split", "0", "--print_freq", "2",
            "--save_latest_freq", "0", "--save_epoch_freq", "1",
            "--zero_opt_state"]
    state, out, secs = run_cli(train_loop.main, [*argv, "--niter", "1"],
                               counters)
    rec = dict(rank=int(os.environ["RANK"]), mode=state.parallel.mode,
               seconds=secs, step=state.step,
               launches={k: fn.launches for k, fn in counters.items()},
               log=[ln for ln in out.splitlines() if ln.startswith(
                   ("data-parallel", "(epoch", "saving"))])
    del state
    dist.barrier()     # rank 0's files are whole before any rank reads them
    saved = {k: torch.load(os.path.join(expr, f"latest_net_{k}.pth"),
                           weights_only=True) for k in ("G", "D")}
    first = {}
    make_step = train_loop.make_train_step

    def hooked(system):
        step = make_step(system)

        def first_step(state, *args, **kw):
            if not first:
                nets = {"G": system.netG_train, "D": system.netD}
                first["equal"] = {k: all(
                    torch.equal(v.cpu(), saved[k][n])
                    for n, v in nets[k].state_dict().items()) for k in saved}
                first["step"] = state.step
            return step(state, *args, **kw)
        return first_step

    train_loop.make_train_step = hooked
    try:
        state, out2, secs2 = run_cli(train_loop.main, [
            *argv, "--niter", "2", "--continue_train"])
    finally:
        train_loop.make_train_step = make_step
    rec.update(resume_seconds=secs2, final_step=state.step,
               resumed=first, resume_line="Resuming from epoch 2 at "
               "iteration 0" in out2.splitlines())
    with open(os.path.join(WORK, f"cli_rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)
    from pix2pixhdaudiosr_torch.parallel import mesh
    mesh.shutdown()
    return 0


def phase_dp_ranks(dev) -> dict:
    """Phase 16: the one-process f32 reference (2 flagship steps on 8
    seeded rows, the second from its `latest` after the first, restored
    into another init: dp_parity_state; each step's grads kept) and its
    rounding floor (the same steps on the rows in DP_ORDERS, every batch
    sum in another order: the widest parity_gaps between two orders, step
    by step); then dp, zero and fsdp at DP_RANKS ranks (dp_rank_worker,
    each step from the same start): each rank's parameters and moments
    within parity_bounds of the reference step by step, its losses within
    DP_FLOOR_FACTOR x the floor's (relative, step by step), every rank's
    losses equal, ZeRO's and FSDP's slices per shard_dim and the bytes held
    between steps (ZeRO: moments 1/N of the shardable leaves'; FSDP:
    parameters too); the floor within the same bounds and dp's planted
    faults (DP_FAULTS) beyond them; the per-rank launches of a bf16 step
    at 32 rows (B1 2 on the tensor cores, B3 40 one-pass, B3' 40) with its
    wall time, gloo bytes and peak memory; ZeRO's `latest` resumed in this
    process to the same third step (parameters and moments within
    parity_bounds of one step, losses rtol 1e-4); and the training CLI
    under 2 ranks with --zero_opt_state and its --continue_train. The
    parity readings are all taken before any is checked."""
    import torch
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import imdct2, mdct2
    from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                 instance_norm_act_grad)
    from pix2pixhdaudiosr_torch.trainer import make_train_step
    from pix2pixhdaudiosr_torch.utils import checkpoint as ckpt
    gc.collect()
    torch.cuda.empty_cache()
    # the 730M G served and stepped in this process
    t0 = time.perf_counter()
    counters = {"mdct2": mdct2, "imdct2": imdct2,
                "instance_norm_act": instance_norm_act,
                "instance_norm_act_grad": instance_norm_act_grad}
    g730 = dict(serve=g730_serve(dev, counters),
                step=g730_step(dev, counters), kernels=g730_in_timing(dev))
    g730_s = time.perf_counter() - t0
    parity_cudnn(True)      # as the ranks' parity legs
    t0 = time.perf_counter()
    batch = flagship_train_batch(dev, DP_PARITY_BATCH)
    ref, floor, floor_loss, fails = dict(losses=[], states=[], grads=[]), [], \
        0.0, []
    for i in range(DP_PARITY_STEPS):
        one = ordered_steps(dev, functools.partial(dp_parity_state, dev, i),
                            batch, i, save=os.path.join(
                                WORK, f"dp_ref_step{i + 1}")
                            if i + 1 < DP_PARITY_STEPS else None)
        floor.append(one["floor"])
        floor_loss = max(floor_loss, one["floor_loss"])
        grads, lr = one["grads"], one["lr"]
        for key, value in zip(("losses", "states", "grads"),
                              (one["losses"], one["state"], grads)):
            ref[key].append(value)
        del one
    res = dict(floor=[parity_bounds(f) for f in floor],
               floor_loss_gap=floor_loss, modes={}, grad_noise=[max(
                   (n / max(g["grads"][k].abs().max().item(), 1e-30), k)
                   for k, n in g["noise"].items() if k not in g["void"])
                   for g in ref["grads"]])
    print("[dp] rounding floor (the rows in 3 orders): " + json.dumps(res))
    for i, f in enumerate(res["floor"]):
        if beyond(f):
            fails.append(f"the rounding floor of step {i + 1} beyond the "
                         f"bounds: {f}")
    torch.save(ref, os.path.join(WORK, "dp_ref.pt"))
    ref_losses = ref["losses"]
    del ref
    gc.collect()
    res["seconds"] = dict(g730=g730_s, reference=time.perf_counter() - t0)
    # the recipes' one-process steps (from the seeded init) and floors
    t1 = time.perf_counter()
    recipe_ref, res["recipes"], floors = {}, {}, {}
    for name, flags in DP_RECIPES.items():
        one = ordered_steps(dev, functools.partial(
            dp_train_state, dev, "float32", DP_PARITY_BATCH,
            extra=[*flags, *DP_PARITY_DEPTH]), batch, 0)
        recipe_ref[name] = dict(losses=[one["losses"]], state=one["state"],
                                grads=one["grads"])
        floors[name] = one["floors"]
        res["recipes"][name] = dict(floor=parity_bounds(one["floor"]),
                                    floor_loss_gap=one["floor_loss"])
        del one
        gc.collect()
    torch.save(recipe_ref, os.path.join(WORK, "dp_recipe_ref.pt"))
    torch.save(floors, os.path.join(WORK, "dp_recipe_floors.pt"))
    del recipe_ref
    gc.collect()
    res["seconds"]["recipe_reference"] = time.perf_counter() - t1
    for mode in DP_MODES:
        t1 = time.perf_counter()
        recs = run_ranks(mode, DP_RANKS)
        res["seconds"][mode] = time.perf_counter() - t1
        first = recs[0]
        par = first["parity"]
        check(all(r["parity"]["losses"] == par["losses"] for r in recs),
              f"{mode}: the ranks report different losses")
        if par["loss_gap"] > DP_FLOOR_FACTOR * res["floor_loss_gap"] + 1e-6:
            fails.append(f"{mode}: losses {par['losses']} against one "
                         f"process {ref_losses}, beyond {DP_FLOOR_FACTOR}x "
                         f"the floor's {res['floor_loss_gap']}")
        par["within"] = [parity_bounds(g) for g in par["gaps"]]
        if any(map(beyond, par["within"])):
            fails.append(f"{mode} at {DP_RANKS} ranks, f32: beyond the "
                         f"bounds: {par['within']}")
        for name, fault in par.get("faults", {}).items():
            fault["within"] = [parity_bounds(g) for g in fault["gaps"]]
            if not any(map(beyond, fault["within"])):
                fails.append(f"the planted fault `{name}` within the "
                             f"bounds: {fault['within']}")
        held, rep = par["held"], par["replicated"]
        if mode != "dp":
            check(par["shards_follow_leaf_spec"] and par["sharded_leaves"] > 0,
                  f"{mode}: slices off shard_dim")
            check(held["moments"] < 0.6 * rep["moments"],
                  f"{mode}: moments held {held} of {rep}")
        check(held["params"] < 0.6 * rep["params"] if mode == "fsdp"
              else held["params"] == rep["params"],
              f"{mode}: parameters held {held} of {rep}")
        for r in recs:
            t = r["timing"]
            for k, want in DP_STEP_LAUNCHES.items():
                check(t["launches_per_step"][k] == want, f"{mode} rank "
                      f"{r['rank']}: {k} {t['launches_per_step'][k]} a step, "
                      f"expected {want}")
            check(t["mdct2_tc_per_step"] == TRAIN_MDCT_LAUNCHES
                  and t["in_onepass_per_step"] == TRAIN_IN_LAUNCHES,
                  f"{mode} rank {r['rank']}: off the fast routes {t}")
            check(all(v == v and abs(v) != float("inf") for lo in t["losses"]
                      for v in lo.values()), f"{mode}: a bf16 loss is not "
                  f"finite")
        if mode == "dp":
            dp_recipe_checks(recs, res["recipes"], fails)
        res["modes"][mode] = recs
        print(f"[dp {mode}] " + json.dumps({
            "parity": par, "timing": [
                {k: r["timing"][k] for k in (
                    "step_s", "gloo_bytes_per_step", "peak_gib",
                    "launches_per_step", "held")} for r in recs]}))
    # the flagship's bf16 timing leg: a rank's peak under FSDP and DP, and
    # FSDP's gathered-bytes peak within its two largest units
    for r in res["modes"]["fsdp"]:
        t = r["timing"]
        if t["gathered_peak"] > t["two_largest_units"]:
            fails.append(f"flagship FSDP rank {r['rank']} gathered "
                         f"{t['gathered_peak']} bytes at once, beyond its two "
                         f"largest units' {t['two_largest_units']}")
    print("[dp flagship peaks] bf16, 32 rows a rank, GiB: " + json.dumps({
        **{m: [r["timing"]["peak_gib"] for r in res["modes"][m]]
           for m in ("dp", "fsdp")},
        "fsdp_gathered_peak": [r["timing"]["gathered_peak"]
                               for r in res["modes"]["fsdp"]],
        "two_largest_units": res["modes"]["fsdp"][0]["timing"][
            "two_largest_units"]}))
    g730["ranks"] = g730_checks({m: res["modes"][m] for m in ("dp", "fsdp")},
                                fails)
    res["g730"] = g730
    # ZeRO's checkpoint, resumed in one process to the same third step
    state = dp_train_state(dev, "float32", DP_PARITY_BATCH, seed=99,
                           extra=DP_PARITY_DEPTH)
    ckpt.load_train_state(state, "latest", os.path.join(WORK, "dp_zero_ck"))
    check(state.step == DP_PARITY_STEPS, f"the ZeRO save resumed at step "
          f"{state.step}")
    rank_blocks(state.system)
    lo = make_train_step(state.system)(state, batch, dp_noise(
        state.system, dev, DP_PARITY_BATCH, DP_PARITY_STEPS))[0]
    zero3 = torch.load(os.path.join(WORK, "dp_zero_step3.pt"),
                       weights_only=True)
    want = res["modes"]["zero"][0]["third_step_losses"]
    # each leaf's grad noise as the reference's last step read it
    third = dict(dp_grads(state.system), noise=grads["noise"])
    resume = dict(loss_gap=loss_gaps([want], [{k: float(v) for k, v in
                                               lo.items()}]),
                  within=parity_bounds(parity_gaps(
                      zero3, dp_state_dict(state), third, lr, dev)))
    print("[dp] ZeRO resumed in one process: " + json.dumps(resume))
    if resume["loss_gap"] > 1e-4:
        fails.append(f"the resumed third step's losses {lo} against ZeRO's "
                     f"{want}")
    if beyond(resume["within"]):
        fails.append(f"ZeRO resumed in one process: beyond the bounds: "
                     f"{resume['within']}")
    res["zero_resume"] = resume
    del state, zero3
    gc.collect()
    torch.cuda.empty_cache()
    parity_cudnn(False)
    # the training CLI under 2 ranks
    t1 = time.perf_counter()
    cli = run_ranks("cli", DP_RANKS)
    res["seconds"]["cli"] = time.perf_counter() - t1
    for r in cli:
        check(r["mode"] == "zero" and r["step"] == 2 and r["final_step"] == 4
              and r["resume_line"] and r["resumed"]["step"] == 2
              and r["resumed"]["equal"] == {"G": True, "D": True},
              f"the CLI under 2 ranks, rank {r['rank']}: {r}")
        check(r["launches"]["instance_norm_act"] == 2 * TRAIN_IN_LAUNCHES
              and r["launches"]["mdct2"] == 2 * TRAIN_MDCT_LAUNCHES,
              f"the CLI rank {r['rank']} launches {r['launches']}")
    check(os.path.exists(os.path.join(WORK, "dp_cli", "latest_optim.pth")),
          "the CLI under 2 ranks saved no latest_optim.pth")
    res["cli"] = cli
    print("[dp] " + json.dumps({k: v for k, v in res.items()
                                if k not in ("modes", "g730")}))
    check(not fails, "phase 16's parity: " + "; ".join(fails))
    return res


# ---------------------------------------------------------------------------
# phase 16b: the long tail (the DCT family, MDCT4, the legacy MCLT codec,
# the device resampler, VGG19, the UI model), which no serve or train path
# calls. MDCT4 / IMDCT4 legs (n_fft, hop, batch, samples): the README
# recipe (1024/512 kbd, 130,816-sample segments) and the half-size codec at
# the flagship segment; the legacy lapped spectrogram (frame length, batch,
# samples) with a sine window
LONG_TAIL_MDCT4 = [(1024, 512, 64, 130816), (512, 256, 128, SEG)]
LONG_TAIL_LEGACY = (2048, 16, 130816)
# the DCT family's input [rows, N] and the VGG19 input [B, 3, H, W]
LONG_TAIL_DCT = (64, 512)
LONG_TAIL_VGG = (4, 3, 224, 224)
# the transforms of ops/dct.py and ops/dctlib.py held on the card
LONG_TAIL_DCT_FNS = {
    "dct": ("dct_2n", "idct_2n", "dct_n", "dct2d", "idct2d", "dct_2n_rfft",
            "idct_2n_rfft"),
    "dctlib": ("dst", "idst", "idxct", "idxst", "idct_n", "dst2", "idcct2",
               "idsct2", "idcst2", "idxst_idct", "idct_idxst", "dct_lee",
               "idct_lee")}


def rel_err(got, want) -> float:
    """max|got - want| over max|want|, on the CPU in float64."""
    want = want.detach().double().cpu()
    return ((got.detach().double().cpu() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def long_tail_codec(name: str, card, cpu, x) -> dict:
    """A lapped codec's round trip on the card (card = (fwd, inv)) against
    the CPU's (cpu = (fwd, inv)) on the same input, the inverse fed the
    card's spectrum: each output within 1e-5 of max|y|, the MSE < 1e-10,
    one B1 and one B2 launch, on the tensor-core route; timed (CUDA
    events)."""
    from pix2pixhdaudiosr_torch.ops.mdct_kernels import imdct2, mdct2
    n0 = (mdct2.launches, mdct2.launches_tc, imdct2.launches,
          imdct2.launches_tc)
    spec = card[0](x)
    rec = card[1](spec)
    launches = [a - b for a, b in zip(
        (mdct2.launches, mdct2.launches_tc, imdct2.launches,
         imdct2.launches_tc), n0)]
    r = dict(spec=list(spec.shape), spec_rel_err=rel_err(spec, cpu[0](x.cpu())),
             rec_rel_err=rel_err(rec, cpu[1](spec.cpu())),
             mse=((rec - x) ** 2).mean().item(),
             b1_b2_launches=launches,
             fwd_ms=cuda_ms(lambda: card[0](x), 5, 1),
             inv_ms=cuda_ms(lambda: card[1](spec), 5, 1))
    print(f"[long tail] {name}: " + json.dumps(r))
    check(r["spec_rel_err"] <= 1e-5 and r["rec_rel_err"] <= 1e-5,
          f"{name}: the card disagrees with the CPU: {r}")
    check(r["mse"] < 1e-10, f"{name}: round trip MSE {r['mse']}")
    check(launches == [1, 1, 1, 1], f"{name}: B1 / B2 launches (all, "
          f"tensor-core) {launches}, expected one each on the tensor cores")
    return r


def phase_long_tail(dev, wav: str) -> dict:
    """The long tail on the card against its CPU twins (f32, TF32 off):
      MDCT4 -> IMDCT4 at each LONG_TAIL_MDCT4 leg and the legacy
      spectrogram round trip (LONG_TAIL_LEGACY, sine window) on B1 / B2
      (long_tail_codec); MDCT4's first row within 1e-5 of max|y| of the
      float64 oracle mdct4_np;
      every transform of LONG_TAIL_DCT_FNS at LONG_TAIL_DCT within 1e-5 of
      max|y| of the CPU's, but the Lee pair, each within twice the CPU's
      distance (+ 1e-6) of the same recursion in float64, and the Lee DCT
      within 1e-5 of the basis product (dct_n * N) on the card;
      resample of the 5 s wav 48k -> 8k -> 48k within 1e-5 of max|y| of
      resample_np;
      VGG19 at LONG_TAIL_VGG (an init seeded on the CPU) within 1e-4 of
      each slice's max of the CPU's, one forward timed (CUDA events);
      UIModel.single_forward at the flagship config (the seeded G of phase
      5, bf16) on [1, 512, 128, 2]: bit-equal to system.netG on the same
      input (else within one bf16 ulp, and said), 22 B3 launches, all on
      the one-pass route."""
    import numpy as np
    import torch
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.data.wavio import read_wav
    from pix2pixhdaudiosr_torch.models.vgg import Vgg19Features
    from pix2pixhdaudiosr_torch.ops import audio, dct, dctlib, legacy
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT4, MDCT4, mdct4_np
    from pix2pixhdaudiosr_torch.ops.norm import instance_norm_act
    from pix2pixhdaudiosr_torch.ops.window import kbdwin
    from pix2pixhdaudiosr_torch.ui_model import UIModel

    gen = torch.Generator(device=dev).manual_seed(19)
    res = {}
    for n_fft, hop, b, s in LONG_TAIL_MDCT4:
        kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft,
                  window=kbdwin(n_fft))
        fwd = [MDCT4(device=d, **kw) for d in (dev, "cpu")]
        inv = [IMDCT4(out_length=s, device=d, **kw) for d in (dev, "cpu")]
        x = torch.randn(b, s, generator=gen, device=dev) * 0.3
        name = f"MDCT4 {n_fft}/{hop} [{b}, {s}]"
        r = long_tail_codec(name, (fwd[0], inv[0]), (fwd[1], inv[1]), x)
        r["oracle_rel_err"] = rel_err(fwd[0](x[:1]), torch.from_numpy(
            mdct4_np(x[:1].cpu().numpy(), n_fft, hop, kw["window"])))
        print(f"[long tail] {name}: first row against mdct4_np "
              f"{r['oracle_rel_err']:.3e} of max|y|")
        check(r["oracle_rel_err"] <= 1e-5, f"{name} disagrees with mdct4_np")
        res[name] = r
    frame, b, s = LONG_TAIL_LEGACY
    w = legacy.sine_window(frame)
    x = torch.randn(b, s, generator=gen, device=dev) * 0.3
    codec = (lambda v: legacy.mdct_spectrogram(v, w, frame),
             lambda v: legacy.imdct_spectrogram(v, w, out_length=s))
    name = f"legacy spectrogram {frame} sine [{b}, {s}]"
    res[name] = long_tail_codec(name, codec, codec, x)

    x = torch.randn(*LONG_TAIL_DCT, generator=gen, device=dev)
    errs, lee = {}, {}
    for mod in (dct, dctlib):
        for f in LONG_TAIL_DCT_FNS[mod.__name__.rsplit(".", 1)[1]]:
            fn = getattr(mod, f)
            got, want = fn(x), fn(x.cpu())
            errs[f] = rel_err(got, want)
            if f in ("dct_lee", "idct_lee"):
                exact = fn(x.cpu().double())
                lee[f] = dict(card=rel_err(got, exact), cpu=rel_err(want, exact))
    errs["dct_lee vs dct_n * N"] = rel_err(
        dctlib.dct_lee(x), dctlib.dct_n(x) * x.shape[-1])
    res["dct_family_rel_err"] = errs
    res["lee_rel_err_from_f64"] = lee
    print("[long tail] the DCT family at "
          f"{list(LONG_TAIL_DCT)}, card vs CPU: " + json.dumps(errs)
          + "; Lee from the float64 recursion: " + json.dumps(lee))
    # the Lee recursion's f32 rounding (~1e-5 of max|y| in idct_lee's
    # alternating suffix sums) is its own: the card is held to the float64
    # recursion, no farther than twice the CPU's f32
    bad = {k: e for k, e in errs.items() if not e <= 1e-5 and k not in lee}
    bad.update({k: e for k, e in lee.items()
                if not e["card"] <= 2 * e["cpu"] + 1e-6})
    check(not bad, f"the DCT family disagrees on the card: {bad}")

    audio_in = read_wav(wav)[0].reshape(-1)
    errs = {}
    for orig, new in ((48000, 8000), (8000, 48000)):
        got = audio.resample(torch.from_numpy(audio_in).to(dev), orig, new)
        want = audio.resample_np(audio_in, orig, new)
        check(got.shape == want.shape, f"resample {orig}->{new}: "
              f"{tuple(got.shape)} against {want.shape}")
        errs[f"{orig}->{new}"] = rel_err(got, torch.from_numpy(want))
        audio_in = want
    res["resample_rel_err"] = errs
    print("[long tail] resample of the 5 s wav against resample_np: "
          + json.dumps(errs))
    check(max(errs.values()) <= 1e-5, f"resample disagrees: {errs}")

    vgg = Vgg19Features(device="cpu",
                        generator=torch.Generator().manual_seed(0))
    vgg_card = Vgg19Features(device=dev)
    vgg_card.load_state_dict(vgg.state_dict())
    x = torch.randn(*LONG_TAIL_VGG, generator=gen, device=dev)
    with torch.no_grad():
        got, want = vgg_card(x), vgg(x.cpu())
        errs = [rel_err(g, w_) for g, w_ in zip(got, want)]
        vgg_ms = cuda_ms(lambda: vgg_card(x), 5, 2)
    res["vgg"] = dict(shape=list(LONG_TAIL_VGG), slice_rel_err=errs,
                      forward_ms=vgg_ms)
    print(f"[long tail] VGG19 {list(LONG_TAIL_VGG)} f32: " + json.dumps(
        res["vgg"]))
    check(max(errs) <= 1e-4, f"VGG19 disagrees with the CPU: {errs}")
    del vgg, vgg_card, got, want

    cfg, _ = run_quiet(lambda: parse_config(FLAGSHIP, is_train=False,
                                            save=False))
    sd = torch.load(os.path.join(WORK, "smoke", "latest_net_G.pth"),
                    map_location="cpu", weights_only=True)
    ui = UIModel()
    ui.initialize(cfg, state_dict=sd, device=dev)
    net_in = torch.randn(1, 512, 128, 2, generator=gen, device=dev)
    reset_counts(instance_norm_act)
    got = ui.single_forward(net_in.cpu().numpy())
    launches = (instance_norm_act.launches, instance_norm_act.launches_onepass)
    with torch.no_grad():
        want = ui.system.netG(net_in.to(ui.system.dtype).permute(0, 3, 1, 2))
        want = want.permute(0, 2, 3, 1).float()
    got = torch.from_numpy(got).to(dev)
    res["ui"] = dict(bit_equal=bool(torch.equal(got, want)),
                     ulp_excess=ulp_excess(got, want),
                     in_launches=launches[0], in_onepass=launches[1],
                     finite=bool(torch.isfinite(got).all()))
    print("[long tail] UIModel.single_forward, flagship bf16 [1, 512, 128, "
          "2], against system.netG: " + json.dumps(res["ui"]))
    check(res["ui"]["finite"], "UIModel.single_forward output not finite")
    check(res["ui"]["bit_equal"] or res["ui"]["ulp_excess"] <= 0,
          "UIModel.single_forward beyond one bf16 ulp of system.netG")
    check(launches == (22, 22), f"UIModel.single_forward: B3 launches "
          f"(all, one-pass) {launches}, expected 22 one-pass")
    return res


# ---------------------------------------------------------------------------
# phase 17: the tools and entry points
# the p2p operators (ops/_cuda.define_op) opcheck'd at one flagship shape
# each (op_case; tests/test_torch_cuda.py runs the same cases)
OP_CASES = ("mdct2", "imdct2", "instance_norm_act", "instance_norm_act_stats",
            "instance_stats", "instance_moments", "instance_apply",
            "conv3x3_in", "conv3x3_valid", "stochastic_quantize_2d")
# the file-to-file legs: the 5 s wav of phase 4 and a 60 s one, 2 runs of
# generate_audio_torch.py in a process of its own each, then in this
# process 1 warm-up and 3 timed runs of the generate CLI and one traced run
F2F_SECONDS, F2F_RUNS, F2F_PROCESS_RUNS = 60.0, 4, 1
# the flagship G's InstanceNorms in one forward (the exported engine's),
# and the batches the AOT tool runs at (the first with --out)
ENGINE_IN_LAUNCHES = IN_LAUNCHES["plain"]
ENGINE_BATCHES = (4, 128)


def op_case(name: str, dev):
    """(operator, its arguments, a call of the eager wrapper that returns
    what the operator returns) of OP_CASES's `name` at a flagship shape:
    B1/B2 at batch 4 (512/256, the codec's planes), B3 and its statistics
    at the G's [4, 48, 512, 128] and the enhancer's [4, 96, 256, 64] bf16,
    B3m/B3a at a CP block [1, 48, 512, 256] bf16, B4/B5 at the enhancer's
    rows [8, 96, 256, 64] (B5 pre-padded), B6 at the trunk conv weight's
    [13824, 1536] f32."""
    import torch
    from pix2pixhdaudiosr_torch.ops import conv, enhancer, norm, quant
    from pix2pixhdaudiosr_torch.ops import mdct_kernels as mk
    from pix2pixhdaudiosr_torch.ops.mdct import IMDCT2, MDCT2
    from pix2pixhdaudiosr_torch.ops.window import kbdwin
    gen = torch.Generator(device=dev).manual_seed(17)
    p = torch.ops.p2p

    def randn(*shape, scale=1.0, dtype=torch.float32, cl=False):
        t = (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    bf16 = torch.bfloat16
    kw = dict(n_fft=512, hop_length=256, win_length=512, window=kbdwin(512),
              device=dev)
    if name == "mdct2":
        fwd, x = MDCT2(**kw), randn(4, SEG + 512, scale=0.1)
        return (p.mdct2, (x, fwd.basis, 256, *fwd.planes),
                lambda: mk.mdct2(x, fwd.basis, 256, fwd.planes))
    if name == "imdct2":
        inv, spec = IMDCT2(**kw), randn(4, 128, 512)
        return (p.imdct2, (spec, inv.basis, 256, *inv.planes),
                lambda: mk.imdct2(spec, inv.basis, 256, inv.planes))
    if name.startswith("instance_norm_act"):
        x, stats = randn(4, 48, 512, 128, dtype=bf16, cl=True), "stats" in name
        return (p.instance_norm_act, (x, "relu", 1e-5, stats),
                lambda: norm.instance_norm_act(x, "relu", 1e-5, True)
                if stats else (norm.instance_norm_act(x, "relu"),
                               x.new_empty(0, dtype=torch.float32)))
    if name == "instance_stats":
        x = randn(4, 96, 256, 64, dtype=bf16, cl=True)
        return (p.instance_stats, (x, 1e-5),
                lambda: torch.stack(norm.instance_stats(x)))
    if name in ("instance_moments", "instance_apply"):
        x = randn(1, 48, 512, 256, dtype=bf16, cl=True)
        if name == "instance_moments":
            return p.instance_moments, (x,), lambda: norm.instance_moments(x)
        m = 3 * norm.instance_moments_ref(x)
        return (p.instance_apply, (x, m, "relu", 1e-5, 3),
                lambda: norm.instance_apply(x, m, "relu", 1e-5, 3))
    if name == "conv3x3_in":
        x = randn(8, 96, 256, 64, dtype=bf16, cl=True)
        w = enhancer.pack_weights(randn(96, 96, 3, 3, scale=0.05))
        b, mean, scale = randn(96), randn(8, 96), randn(8, 96).abs() + 0.5

        def eager():
            y, (m_, s_) = enhancer.conv3x3_in(x, w, b, mean, scale, x,
                                              "in_relu_add")
            return y, torch.stack((m_, s_))
        return (p.conv3x3_in, (x, w, b, mean, scale, x, "in_relu_add", 1e-5),
                eager)
    if name == "conv3x3_valid":
        x = randn(8, 96, 258, 66, dtype=bf16, cl=True)
        w = randn(96, 96, 3, 3, scale=0.05)
        return (p.conv3x3_valid, (x, w, True),
                lambda: conv.conv3x3_valid(x, w, True))
    if name == "stochastic_quantize_2d":
        x = randn(*TRUNK_W2D, scale=0.02)
        return (p.stochastic_quantize_2d, (x, 5),
                lambda: quant.stochastic_quantize_2d(x, 5))
    raise ValueError(f"no operator case {name!r}")


def reference_keys(n_down: int, n_blocks: int, n_blocks_local: int) -> dict:
    """{port layer: reference layer} of a LocalEnhancer with one enhancer:
    the reference's Sequential layouts (pix2pixHD models/networks.py), walked
    a layer at a time: the trunk `model` (pad, conv, norm, relu; the downs;
    the resblocks, each conv_block's convs at 1 and 5; the deconvs), then
    `model1_1` (pad, conv, norm, relu, the stride-2 conv, norm, relu) and
    `model1_2` (the resblocks, the deconv, norm, relu, pad, conv, tanh)."""
    trunk = [None, "global.ConvIN_0", None, None]
    for i in range(n_down):
        trunk += [f"global.ConvIN_{i + 1}", None, None]
    trunk += [f"global.ResnetBlock_{i}" for i in range(n_blocks)]
    for i in range(n_down):
        trunk += [f"global.ConvTransposeIN_{i}", None, None]
    down = [None, "enh1_down0", None, None, "enh1_down1", None, None]
    up = [f"enh1_block{i}" for i in range(n_blocks_local)] + [
        "enh1_up", None, None, None, "enh1_final", None]
    table = {}
    for seq, layers in (("model", trunk), ("model1_1", down),
                        ("model1_2", up)):
        for idx, layer in enumerate(layers):
            if layer is None:
                continue
            if "ResnetBlock" in layer or "_block" in layer:
                table[f"{layer}.ConvIN_0"] = f"{seq}.{idx}.conv_block.1"
                table[f"{layer}.ConvIN_1"] = f"{seq}.{idx}.conv_block.5"
            else:
                table[layer] = f"{seq}.{idx}"
    return table


def to_reference(sd: dict) -> dict:
    """The flagship G's state_dict under the reference's keys."""
    table = reference_keys(4, 3, 2)
    out = {}
    for key, t in sd.items():
        layer, _, leaf = key.rsplit(".", 2)   # <layer>.Conv_0.weight
        out[f"{table[layer]}.{leaf}"] = t
    check(len(out) == len(sd) == 2 * len(table),
          f"{len(sd)} tensors of the flagship G, {len(out)} renamed, "
          f"{len(table)} reference layers")
    return out


def route_counts(counters) -> dict:
    """{kernel: (launches, on the fast route)}: the tensor-core route of
    B1/B2, the one-pass route of B3; 0 for a kernel with neither."""
    return {k: (fn.launches, getattr(fn, "launches_tc",
                                     getattr(fn, "launches_onepass", 0)))
            for k, fn in counters.items()}


def check_fast_routes(what: str, counts: dict) -> None:
    for k, (n, fast) in counts.items():
        check(n > 0 and fast == n, f"{what}: {k} launched {n} times, {fast} "
              f"on the tensor-core or one-pass route")


def run_quiet(fn, *args):
    """fn(*args) with its printing kept: (its result, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def phase_import_round_trip(dev, wav: str, counters) -> dict:
    """The seeded flagship G (phase 5) under the reference's keys as a
    .pth, through tools/import_torch_checkpoint_torch.py, then served by
    generate_audio_torch.py --torch_deconv on the 5 s wav: the sr wav and
    the float output bit-equal to the same G loaded directly in torch
    deconv mode, and B1, B3, B2 launched on their fast routes."""
    import runpy
    import numpy as np
    import torch
    import import_torch_checkpoint_torch as importer
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.data.wavio import read_wav

    sd = torch.load(os.path.join(WORK, "smoke", "latest_net_G.pth"),
                    map_location="cpu", weights_only=True)
    ref_dir = os.path.join(WORK, "reference")
    os.makedirs(ref_dir, exist_ok=True)
    ref_pth = os.path.join(ref_dir, "latest_net_G.pth")
    torch.save(to_reference(sd), ref_pth)
    t0 = time.perf_counter()
    _, printed = run_quiet(importer.main, ["--pth", ref_pth, "--name",
                                           "imported", "--checkpoints_dir",
                                           WORK, *FLAGSHIP])
    import_s = time.perf_counter() - t0
    check("note: enabling --torch_deconv" in printed,
          "the import tool did not force --torch_deconv")
    imported = os.path.join(WORK, "imported")
    loaded = torch.load(os.path.join(imported, "latest_net_G.pth"),
                        map_location="cpu", weights_only=True)
    check(sorted(loaded) == sorted(sd) and all(
        torch.equal(loaded[k], sd[k]) for k in sd),
        "the imported G differs from the G the reference keys came from")
    serve = ["--checkpoints_dir", WORK, "--dataroot", wav, "--batchSize",
             "16", "--no_html", "--device", dev, *FLAGSHIP, "--torch_deconv"]
    for fn in counters.values():
        reset_counts(fn)
    argv = sys.argv
    sys.argv = ["generate_audio_torch.py", "--name", "via_import",
                "--load_pretrain", imported, *serve]
    try:
        run_quiet(runpy.run_path,
                  os.path.join(ROOT, "generate_audio_torch.py"), None,
                  "__main__")
    finally:
        sys.argv = argv
    routes = route_counts(counters)
    check_fast_routes("generate_audio_torch.py on the imported G", routes)
    direct, _ = run_quiet(generate.main, ["--name", "direct",
                                          "--load_pretrain",
                                          os.path.join(WORK, "smoke"), *serve])
    again, _ = run_quiet(generate.main, ["--name", "direct_import",
                                         "--load_pretrain", imported, *serve])
    wavs = [read_wav(os.path.join(WORK, n, "sr_audio.wav"))[0]
            for n in ("via_import", "direct")]
    check(np.array_equal(*wavs), "the imported G's sr_audio.wav differs from "
          "the directly loaded G's")
    check(np.array_equal(direct, again), "the imported G's output differs "
          "from the directly loaded G's")
    res = dict(import_s=import_s, tensors=len(sd), launches={
        k: dict(launches=n, fast_route=f) for k, (n, f) in routes.items()},
        bit_equal=True)
    print("[tools import] " + json.dumps(res))
    return res


# the module of each wrapper in KERNELS, which the engine's process imports
# to reset and read its counts (reset_counts, route_counts)
KERNEL_MODULES = {"mdct2": "mdct_kernels", "imdct2": "mdct_kernels",
                  "imdct2_grad": "mdct_kernels", "instance_norm_act": "norm",
                  "instance_norm_act_grad": "norm",
                  "instance_moments": "norm", "instance_apply": "norm",
                  "conv3x3_in": "enhancer", "conv3x3_valid": "conv",
                  "stochastic_quantize_2d": "quant"}
# the launches of one exported forward (all, on the fast route) that the
# engine must make; every other kernel of KERNELS must make none
ENGINE_LAUNCHES = {"mdct2": (1, 1), "instance_norm_act": (ENGINE_IN_LAUNCHES,
                                                          ENGINE_IN_LAUNCHES)}
ENGINE_RUN = """
import importlib, json, sys
for m in ("jax", "flax", "optax", "orbax"):
    sys.modules[m] = None
import torch
import pix2pixhdaudiosr_torch
from chip_smoke import reset_counts, route_counts
engine = torch.export.load(sys.argv[1]).module()
dev = sys.argv[4]
fns = {k: getattr(importlib.import_module("pix2pixhdaudiosr_torch.ops." + m), k)
       for k, m in json.loads(sys.argv[5]).items()}
x = {k: v.to(dev) for k, v in torch.load(sys.argv[2]).items()}
# cuDNN's heuristic algorithms, as the eager reference runs: a benchmark
# run's choice follows its own timings, so two processes may round apart
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.deterministic = True
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
with torch.no_grad():
    y = engine(x["audio"], x["noise"])
    sync()
    for fn in fns.values():
        reset_counts(fn)
    y = engine(x["audio"], x["noise"])
    sync()
torch.save(y.cpu(), sys.argv[3])
bad = [m for m in sys.modules if m.split(".")[0] in
       ("pix2pixhdaudiosr_tpu", "jax", "tools") and sys.modules[m]]
weights = [t for t in engine.state_dict().values() if t.dim() == 4]
print(json.dumps(dict(bad=bad, weights=len(weights), channels_last=sum(
    t.is_contiguous(memory_format=torch.channels_last) for t in weights),
    launches=route_counts(fns))))
"""


def phase_engine(dev) -> dict:
    """tools/aot_engine_torch.py on the card at batch 4 with --out, the
    engine loaded in a process of its own that imports only torch, the
    package and this script's count helpers (jax blocked) and run twice: its second forward's launches,
    every wrapper of KERNELS reset and read there (B1 1 and B3 22, on the
    tensor-core and one-pass routes, every other kernel 0), and its
    output against eager's within one bf16 ulp (+1e-6: it is the bf16 G's
    output in f32), both on cuDNN's heuristic algorithms (the tool serves
    with cudnn.benchmark, whose choice follows each process's timings, and
    a bf16 G rounds apart through its 22 InstanceNorms on another
    algorithm: 0.054 of max|y| ~1 on an H100); then the tool at batch
    128."""
    import torch
    import aot_engine_torch as aot
    check(set(KERNEL_MODULES) == set(KERNELS),
          "KERNEL_MODULES does not name every kernel of KERNELS")
    eng = os.path.join(WORK, "engine.pt2")
    res = {}
    for batch, extra in zip(ENGINE_BATCHES, (["--out", eng], [])):
        r, printed = run_quiet(aot.main, ["--batch", str(batch), "--device",
                                          dev, *extra])
        print("\n".join(f"[aot b{batch}] {line}"
                        for line in printed.splitlines()))
        res[batch] = dict(compile_s=r["compile_s"], flops=r["flops"],
                          peak_gib=(r["peak_bytes"] or 0) / 2**30, ms=r["ms"],
                          eager_ms=r["eager_ms"])
        if extra:
            inputs = os.path.join(WORK, "engine_in.pt")
            torch.save({"audio": r["audio"].cpu(),
                        "noise": r["noise"].cpu()}, inputs)
            size = r["out_bytes"]
            check(ulp_excess(r["engine_out"], r["eager_out"]) <= 0,
                  "the engine reloaded in this process is beyond one bf16 "
                  "ulp of eager")
            cudnn = torch.backends.cudnn
            flags = cudnn.benchmark, cudnn.deterministic
            cudnn.benchmark, cudnn.deterministic = False, True
            with torch.no_grad():
                want = r["system"].inference(r["audio"], r["noise"])[0].cpu()
            cudnn.benchmark, cudnn.deterministic = flags
        del r
        gc.collect()
        torch.cuda.empty_cache()
    out = os.path.join(WORK, "engine_out.pt")
    run = subprocess.run([sys.executable, "-c", ENGINE_RUN, eng, inputs, out,
                          dev, json.dumps(KERNEL_MODULES)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    check(run.returncode == 0, f"the engine's own process failed: "
          f"{run.stderr[-3000:]}")
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    got = torch.load(out)
    err = (got - want).abs().max().item()
    excess = ulp_excess(got, want)
    launches = {k: tuple(v) for k, v in rec["launches"].items()}
    print(f"[aot] the engine ({size} bytes) in a process of its own: "
          f"modules of jax or the JAX package {rec['bad']}, "
          f"{rec['channels_last']} of its {rec['weights']} conv weights "
          f"channels_last, one forward's "
          f"launches (all, fast route) {launches}, max|engine - eager| {err} "
          f"(bit-equal: {torch.equal(got, want)}, beyond one bf16 ulp "
          f"{excess})")
    check(not rec["bad"], f"the engine's process loaded {rec['bad']}")
    want_launches = {k: ENGINE_LAUNCHES.get(k, (0, 0)) for k in KERNELS}
    check(launches == want_launches, f"an exported forward launched "
          f"{launches}; expected B1 1 and B3 {ENGINE_IN_LAUNCHES}, on the "
          f"tensor-core and one-pass routes, and no other kernel")
    check(excess <= 0, f"the engine's output is {excess} beyond one bf16 ulp "
          f"of eager's")
    for b, r in res.items():
        print(f"[aot b{b}] export {r['compile_s']:.1f} s, "
              f"{r['flops'] / 1e12:.4f} TFLOP a forward, peak "
              f"{r['peak_gib']:.3f} GiB, engine {r['ms']:.3f} ms/call, "
              f"eager {r['eager_ms']:.3f} ms/call")
    res.update(engine_bytes=size, max_abs_err=err,
               bit_equal=bool(torch.equal(got, want)),
               launches={k: v[0] for k, v in launches.items()})
    return res


def span_times(prof) -> dict:
    """From a trace of one generate CLI run, for each `generate.*` span:
    its host ms (the span on the CPU), the device window ms (the span's
    mirror on the device: from its first kernel or copy's start to its
    last one's end) and the device ms of the kernels and copies inside
    that window; and the device ms of all of them."""
    from torch.autograd import DeviceType
    spans = {}
    device = []
    for e in prof.events():
        span = e.name.startswith("generate.")
        if e.device_type == DeviceType.CUDA:
            if span:
                spans.setdefault(e.name, {})["device"] = e.time_range
            else:
                device.append(e.time_range)
        elif span:
            spans.setdefault(e.name, {})["host"] = e.time_range
    out = dict(host_ms={}, device_window_ms={}, device_busy_ms={})
    for name, r in spans.items():
        key = name.split(".", 1)[1]
        if "host" in r:
            out["host_ms"][key] = r["host"].elapsed_us() / 1e3
        w = r.get("device")
        out["device_window_ms"][key] = w.elapsed_us() / 1e3 if w else 0.0
        out["device_busy_ms"][key] = sum(
            d.elapsed_us() for d in device
            if w and w.start <= d.start and d.end <= w.end) / 1e3
    out["device_ms"] = sum(d.elapsed_us() for d in device) / 1e3
    return out


# what a process of the generate CLI does before its first file: start,
# import torch and the package, make the CUDA context, load the kernels
STARTUP_RUN = """
import sys
import torch
import pix2pixhdaudiosr_torch.generate
from pix2pixhdaudiosr_torch.ops import _cuda
if sys.argv[1] == "cuda":
    torch.zeros(1, device="cuda")
    _cuda.library()
    torch.cuda.synchronize()
"""


def phase_file_to_file(dev, wav: str) -> dict:
    """The generate CLI (plain flagship, bf16, batch 16) file to file on
    the 5 s wav and a 60 s one: the wall time of generate_audio_torch.py
    in a process of its own (what a user of the script waits for, the
    checkpoint read from a warm page cache; F2F_PROCESS_RUNS runs), and
    of a process that only starts up as that one does (STARTUP_RUN); then
    in this process, warm, by utils/profiling.StepTimer (1 warm-up, 3
    timed runs), and one run under utils/profiling.trace: the host ms of
    its spans (read + resample, load, serve = encode + G + decode,
    metrics, write; the trace's own cost included), each span's window on
    the device and the device ms of the kernels and copies in it
    (span_times)."""
    import torch
    from pix2pixhdaudiosr_torch import generate
    from pix2pixhdaudiosr_torch.utils.profiling import StepTimer, trace
    long_wav = os.path.join(WORK, "input_60s.wav")
    n_long = write_synthetic_wav(long_wav, F2F_SECONDS)
    startup_s = []
    for _ in range(F2F_PROCESS_RUNS):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", STARTUP_RUN, dev],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        startup_s.append(time.perf_counter() - t0)
        check(run.returncode == 0, f"the start-up process failed: "
              f"{run.stderr[-3000:]}")
    res = dict(startup_s=startup_s)
    print(f"[file to file] a process's start-up (interpreter, imports, the "
          f"CUDA context, the kernel library): {startup_s} s")
    for label, path, n in (("5s", wav, None), ("60s", long_wav, n_long)):
        argv = ["--name", f"f2f_{label}", "--checkpoints_dir", WORK,
                "--dataroot", path, "--load_pretrain",
                os.path.join(WORK, "smoke"), "--batchSize", "16",
                "--no_html", "--device", dev, *FLAGSHIP]
        process_s = []
        for _ in range(F2F_PROCESS_RUNS):
            out = os.path.join(WORK, f"f2f_{label}", "sr_audio.wav")
            if os.path.exists(out):
                os.remove(out)
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, os.path.join(
                ROOT, "generate_audio_torch.py"), *argv], cwd=ROOT,
                capture_output=True, text=True, timeout=300)
            process_s.append(time.perf_counter() - t0)
            check(run.returncode == 0 and os.path.exists(out),
                  f"{label}: generate_audio_torch.py in its own process "
                  f"failed: {run.stderr[-3000:]}")
        timer = StepTimer(warmup=1)
        for _ in range(F2F_RUNS):
            timer.start()
            run_quiet(generate.main, argv)
            timer.stop()
        with trace(os.path.join(WORK, f"trace_{label}")) as prof:
            run_quiet(generate.main, argv)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        check(prof is not None, "the profiler did not start")
        rec = dict(process_s=process_s, wall=timer.summary(),
                   **span_times(prof))
        check(set(rec["host_ms"]) == {"read", "load", "serve", "metrics",
                                      "write"},
              f"{label}: the trace holds the spans {sorted(rec['host_ms'])}")
        check(rec["device_busy_ms"]["serve"] > 0, f"{label}: no kernel in "
              f"the serve span")
        res[label] = rec
        print(f"[file to file {label}] " + json.dumps(rec))
    return res


def phase_opcheck(dev) -> dict:
    """torch.library.opcheck of every p2p operator's CUDA impl at a
    flagship shape (op_case): schema, fake impl against the launch's
    output (shape, dtype, strides), AOT dispatch; and each operator's
    output the eager wrapper's bits."""
    import torch
    for name in OP_CASES:
        op, args, eager = op_case(name, dev)
        r = torch.library.opcheck(op, args)
        check(all(v == "SUCCESS" for v in r.values()), f"opcheck {name}: {r}")
        got, want = op(*args), eager()
        check(all(torch.equal(g, w) for g, w in zip(
            torch.utils._pytree.tree_leaves(got),
            torch.utils._pytree.tree_leaves(want))),
            f"{name}: the operator's output differs from its wrapper's")
        del op, args, eager, got, want
    print(f"[opcheck] torch.library.opcheck of {len(OP_CASES)} cases, every "
          f"p2p operator on its CUDA impl: SUCCESS")
    return {name: "SUCCESS" for name in OP_CASES}


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    try:
        t0 = time.perf_counter()
        from pix2pixhdaudiosr_torch.ops import _cuda
        from pix2pixhdaudiosr_torch.ops.conv import conv3x3_valid
        from pix2pixhdaudiosr_torch.ops.enhancer import conv3x3_in
        from pix2pixhdaudiosr_torch.ops.mdct_kernels import (imdct2,
                                                             imdct2_grad, mdct2)
        from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,
                                                     instance_norm_act_grad,
                                                     instance_stats)
        from pix2pixhdaudiosr_torch.ops.quant import (conv3x3_int8,
                                                      stochastic_quantize_2d)
        lib = _cuda.build()
        _cuda.library()
        print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s")
        print(open(lib.parent / "build.log").read()[-3000:])

        phase_s = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            phase_s[name] = time.perf_counter() - t0
            print(f"[phase] {name}: {phase_s[name]:.1f} s")
            return out

        rec, detail = timed("kernels", phase_kernels, dev)
        for phase in (phase_conv_kernels, phase_quant_kernels,
                      phase_cp_kernels):
            rec_p, detail_p = timed(phase.__name__[6:], phase, dev)
            rec.update(rec_p)
            detail.update(detail_p)
        # no path calls B5 or B6: their launches are phase 3's
        valid_launches = conv3x3_valid.launches
        quant_launches = stochastic_quantize_2d.launches
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(os.path.join(WORK, "smoke"))
        wav = os.path.join(WORK, "input_48k.wav")
        n_in = write_synthetic_wav(wav)
        pth = flagship_generator_pth(os.path.join(WORK, "smoke"))
        counters = {"mdct2": mdct2, "imdct2": imdct2,
                    "instance_norm_act": instance_norm_act}
        gen_res = timed("generate", phase_generate, dev, counters, wav, n_in)
        gen_fused = timed("generate fused", phase_generate, dev, dict(
            counters, conv3x3_in=conv3x3_in, instance_stats=instance_stats),
            wav, n_in, FUSED)
        gen_quant = timed("generate int8", phase_generate, dev, dict(
            counters, conv3x3_int8=conv3x3_int8), wav, n_in, QUANT,
            ["int8 weight quantization enabled"])
        ref_err = timed("reference", phase_reference, dev)
        system = flagship_system(dev, ["--fused_enhancer"])
        lr, noise = seeded_batch(system, dev, 128)
        fused_err = timed("fused vs plain", phase_fused_vs_plain, system, lr,
                          noise)
        quant_err = timed("quant vs plain", phase_quant_vs_plain, system,
                          flagship_system(dev, ["--data_type", "8"]), lr, noise)
        all_counters = dict(counters, conv3x3_in=conv3x3_in,
                            conv3x3_valid=conv3x3_valid,
                            stochastic_quantize_2d=stochastic_quantize_2d,
                            instance_norm_act_grad=instance_norm_act_grad,
                            imdct2_grad=imdct2_grad)
        train_counters = dict(counters, imdct2_grad=imdct2_grad,
                              instance_norm_act_grad=instance_norm_act_grad)
        serve = timed("serve timing", phase_serve_timing, system, lr, noise,
                      all_counters)
        sizes = phase_sizes(pth)
        del system, lr, noise
        torch.cuda.empty_cache()
        cp1 = timed("cp one rank", phase_cp_one_rank, dev, wav, n_in)
        cpn = timed("cp ranks", phase_cp_ranks, dev, wav)
        tpn = timed("tp ranks", phase_tp_ranks, dev)
        in_grad = timed("in grad", phase_in_grad, dev)
        in_grad_a = timed("in grad family A", phase_in_grad, dev,
                          FAMILY_A_BATCH, [(FAMILY_A_IN_SHAPES,
                                            ("relu", "none"))], False)
        train_ref = timed("train reference", phase_train_reference, dev, (),
                          True)
        recipe_ref = [timed(f"train reference {' '.join(flags)}",
                            phase_train_reference, dev, flags)
                      for flags in TOY_RECIPES]
        feat_ref = timed("train reference instance_feat",
                         phase_train_reference, dev, TOY_FEAT)
        train = timed("train step", phase_train_step, dev, all_counters)
        recipes = [timed(f"recipe step {' '.join(flags)}", phase_train_step,
                         dev, all_counters, flags, batch)
                   for flags, batch in RECIPES]
        knobs = [timed(f"knob step {' '.join(flags)}", phase_train_step, dev,
                       all_counters, flags) for flags in KNOBS]
        for knob in knobs:
            check(knob["flags"][0] != "--remat_g" or knob["peak_gib"]
                  <= train["peak_gib"] - REMAT_SAVING_GIB,
                  f"{' '.join(knob['flags'])} peaks at {knob['peak_gib']:.3f}"
                  f" GiB, the plain step at {train['peak_gib']:.3f}: less "
                  f"than {REMAT_SAVING_GIB} GiB saved")
        remat = timed("remat grads", phase_remat_grads, dev)
        train_cli = timed("train cli", phase_train_cli, dev, train_counters,
                          wav, n_in)
        recipe_cli = timed("recipe cli", phase_recipe_cli, dev, train_counters)
        gate = timed("quality gate", phase_quality_gate, dev, train_counters)
        soak = timed("flagship soak", phase_flagship_soak, dev,
                     soak_counters(), os.path.join(WORK, "soak"),
                     os.path.join(WORK, "smoke"))
        family_a = timed("family A cli", phase_family_a, dev, train_counters)
        in_bwd = in_backward_per_step(in_grad, train)
        print("[in grad] a train step's calls: " + json.dumps(in_bwd))
        cli = timed("cli", phase_cli, dev, train_counters)
        flac = timed("flac", phase_flac)
        dp = timed("dp ranks", phase_dp_ranks, dev)
        long_tail = timed("long tail", phase_long_tail, dev, wav)
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        tools = dict(opcheck=timed("opcheck", phase_opcheck, dev))
        tools["import"] = timed("import round trip", phase_import_round_trip,
                                dev, wav, counters)
        tools["engine"] = timed("aot engine", phase_engine, dev)
        tools["file_to_file"] = timed("file to file", phase_file_to_file, dev,
                                      wav)
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    b3 = b3_per_shape(detail, serve["plain"]["in_launches_by_shape"])
    # the backward kernel at 512 x 128 x 48, batch 64, bf16 (phase 9); its
    # `launches` are one flagship train step's (phase 11), its path
    big = in_grad[f"{IN_SHAPES[0][0]}x{IN_SHAPES[0][1]}x{IN_SHAPES[0][2]}"]
    rec["instance_norm_act_grad"] = dict(
        big, ms=big["backward_ms"], plain_ms=big["twin_ms"],
        library_ms=big["library_backward_ms"])
    # B2's backward runs on the HiFi-GAN recipe's step alone (RECIPES[1])
    launches = dict(gen_res["launches"],
                    conv3x3_in=gen_fused["launches"]["conv3x3_in"],
                    conv3x3_valid=valid_launches,
                    stochastic_quantize_2d=quant_launches,
                    instance_norm_act_grad=train["launches"][
                        "instance_norm_act_grad"] // train["steps"],
                    imdct2_grad=recipes[1]["launches"]["imdct2_grad"]
                    // recipes[1]["steps"],
                    # the CP path's: one generate --cp_shards 4 run
                    instance_moments=cp1["launches"]["instance_moments"],
                    instance_apply=cp1["launches"]["instance_apply"])
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1], launches=launches[k],
                    serve_launches=serve["plain"]["launches"].get(k, 0),
                    train_launches_per_step=train["launches"].get(k, 0)
                    / train["steps"],
                    recipe_launches_per_step={
                        " ".join(r["flags"]): r["launches_per_step"].get(k, 0)
                        for r in recipes},
                    knob_launches_per_step={
                        " ".join(r["flags"]): r["launches_per_step"].get(k, 0)
                        for r in knobs},
                    family_a_launches_per_step=family_a[
                        "launches_per_step"].get(k, 0),
                    dp_launches_per_step={
                        mode: recs[0]["timing"]["launches_per_step"].get(k, 0)
                        for mode, recs in dp["modes"].items()},
                    g730_serve_launches=dp["g730"]["serve"]["launches"].get(
                        k, 0),
                    g730_launches_per_step=dp["g730"]["step"][
                        "launches_per_step"].get(k, 0),
                    export_launches=tools["engine"]["launches"][k],
                    soak_launches={
                        part: soak["launches"][part].get(k, 0)
                        for part in ("step", "eval_batch")} | {
                        "serve_file": soak["launches"]["serve_file"][
                            "plain"].get(k, 0)},
                    **{f: rec[k][f] for f in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}) for k in KERNELS]
    phase_s["total"] = time.perf_counter() - t_start
    print(f"[total] {phase_s['total']:.1f} s of the script (its "
          f"{len(phase_s) - 1} phases, the build and the readings)")
    print("[detail] " + json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kernel_detail=detail, generate=gen_res, generate_fused=gen_fused,
        generate_quant=gen_quant, reference_max_abs_err=ref_err,
        fused_vs_plain=fused_err, quant_vs_plain=quant_err, serve=serve,
        sizes=sizes, b3_per_shape=b3, in_grad=in_grad,
        train_reference=train_ref, recipe_reference=recipe_ref,
        feature_reference=feat_ref, in_grad_family_a=in_grad_a,
        train_step=train, recipe_steps=recipes, knob_steps=knobs,
        remat_grads=remat, train_cli=train_cli, recipe_cli=recipe_cli,
        quality_gate=gate, flagship_soak=soak, family_a_cli=family_a,
        in_backward_per_step=in_bwd, cli=cli, flac=flac, cp_one_rank=cp1,
        cp_ranks=cpn, tp_ranks=tpn, dp_ranks=dp, long_tail=long_tail,
        tools=tools,
        phase_seconds=phase_s)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2]))
    sys.exit(main())
