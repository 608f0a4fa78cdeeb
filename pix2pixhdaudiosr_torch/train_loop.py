"""Training CLI.

Port of pix2pixhdaudiosr_tpu/train_loop.py:41-280: the resumable epoch
loop over a wav/flac corpus with the sample-counted print, display, save
and eval cadences (on a resume, counted from the resume point, as the JAX
loop's deltas do), the print cadence aligned to
lcm(print_freq, batch) (loss_log.txt, scalars.jsonl, and event files under
--tf_log), the HTML gallery of the step's visuals every display_freq
samples, the `latest` save every save_latest_freq samples and the `latest`
+ epoch save every save_epoch_freq epochs (a frequency of 0 disables its
cadence), eval.csv rows every eval_freq samples on the persisted
validation split, Ctrl+C saving `latest` and the epoch tag at the next
batch, the divergence guard's post-mortem `diverged` save, the
niter_fix_global switch with a fresh G optimizer, the linear learning rate
decay after `niter` epochs, and the fake pool (--pool_size).

    python -m pix2pixhdaudiosr_torch.train_loop <the JAX CLI's flags> \
        [--device cuda|cpu]
    python -m torch.distributed.run --nproc_per_node N \
        -m pix2pixhdaudiosr_torch.train_loop <flags> \
        [--zero_opt_state | --fsdp] [--mesh_shape S --mesh_axes A]

Under a launcher (torchrun), the ranks train one global-batch step
together, as the JAX loop does over its data mesh (train_loop.py:102-109):
the mesh of make_data_layout (--mesh_shape / --mesh_axes; by default the
largest divisor of --batchSize that fits the ranks, the rest sitting out),
the batch split over its `data` axis (each rank's Loader decodes its rows
of the same shuffled global batches), then FSDP (--fsdp), else ZeRO-1
(--zero_opt_state), else plain data parallelism (parallel/). Rank 0
alone writes checkpoints, iter.txt, the logs, eval.csv and the gallery;
every rank takes part in a save's gathers and stops at the same step on
Ctrl+C or a non-finite loss. In one process the loop is the one-process
loop, and --zero_opt_state / --fsdp shard over one rank: nothing.

The device defaults to cuda; the CPU runs only when asked for (--device
cpu), and then every kernel runs its plain PyTorch twin. On the card the
kernels are built before the first step, and a run whose kernels cannot be
built stops: it never trains on the twins. Checkpoints go to
checkpoints_dir/name/ (utils/checkpoint.py); `<tag>_net_G.pth` is what
pix2pixhdaudiosr_torch.generate serves. --continue_train resumes from
iter.txt and the `which_epoch` tag; --load_pretrain DIR warm-starts from
DIR's tag by the tolerant merge. As in the JAX package, the loader's
shuffle and the dataset's segment draws restart on a resume, so a resume
in mid-epoch replays that epoch's first batches.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import math
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import parse_config
from .data.dataset import AudioDataset, Loader
from .data.filelist import discover_files, train_val_split
from .generate import resolve_device, seeded_noise
from .metrics import append_csv_row, compute_metrics
from .ops import _cuda
from .parallel import mesh
from .parallel.dp import apply_dp, pool_rows
from .parallel.fsdp import apply_fsdp
from .parallel.zero import apply_zero
from .system import Pix2PixHDSystem, check_trainable
from .trainer import (TrainState, init_state, make_eval_step, make_pool_steps,
                      make_train_step, reset_opt_g, set_learning_rate)
from .utils import checkpoint as ckpt
from .utils.image_pool import ImagePool
from .utils.visualizer import Visualizer, require_gallery_packages


def check_supported(cfg) -> None:
    try:
        check_trainable(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def apply_parallel(state: TrainState, layout: mesh.DataLayout, cfg) -> None:
    """Make `state` a train state of the layout's ranks, as the JAX loop
    shards its state: FSDP, else ZeRO-1, else plain data parallelism; in a
    one-rank mesh, nothing."""
    if layout.members.size == 1:
        return
    apply = (apply_fsdp if cfg.fsdp else apply_zero if cfg.zero_opt_state
             else apply_dp)
    par = apply(state, layout)
    print(f"data-parallel ({par.mode}) over mesh "
          f"{dict(zip(layout.axes, layout.shape))}: rank "
          f"{layout.members.rank}, data index {layout.data.rank}, "
          f"{cfg.batch_size // layout.data.size} rows a step")


def require_kernels(device: torch.device) -> None:
    """Build the CUDA kernels before the first step; stop if they do not
    build (no run trains on the CPU twins of a card's kernels)."""
    if device.type == "cuda":
        try:
            _cuda.library()
        except (RuntimeError, OSError) as e:
            raise SystemExit(f"the CUDA kernels (InstanceNorm B3, MDCT2 B1, "
                             f"IMDCT2 B2) cannot be built or loaded: {e}"
                             ) from None


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def lcm(a: int, b: int) -> int:
    return abs(a * b) // math.gcd(a, b) if a and b else 0


def eval_model(system: Pix2PixHDSystem, eval_step, loader,
               noise: Callable) -> Dict[str, float]:
    """One in-training eval (pix2pixhdaudiosr_tpu/train_loop.py:141-167):
    eval_step on each validation batch j, its mask noise `noise(j, shape)`,
    scored against the batch's hr on the host. As in the JAX package, the
    snr column averages s_lr and s_sr together, and the loop stops after
    the batch j >= eval_size, so it scores eval_size + 1 batches."""
    cfg = system.cfg
    errs, snrs, snr_segs, pesqs, lsds = [], [], [], [], []
    for j, data in enumerate(loader):
        lr = torch.from_numpy(data["label"]).to(system.device)
        b, f, t, c = system.spectro_shape(lr.shape[0])
        sr_audio, _ = eval_step(lr, noise(j, (b, system.codec.mask_size(f),
                                              t, c)))
        m, s_sr, s_lr, ss_sr, _, pesq, lsd = compute_metrics(
            torch.from_numpy(data["image"]), torch.from_numpy(data["label"]),
            sr_audio.cpu(), cfg.n_fft, cfg.hop_length, cfg.win_length,
            cfg.center)
        errs.append(m)
        snrs.append((s_lr, s_sr))
        snr_segs.append(ss_sr)
        pesqs.append(pesq)
        lsds.append(lsd)
        if j >= cfg.eval_size:
            break
    return {"err": float(np.mean(errs)), "snr": float(np.mean(snrs)),
            "snr_seg": float(np.mean(snr_segs)),
            "pesq": float(np.mean(pesqs)), "lsd": float(np.mean(lsds))}


def main(argv=None) -> Optional[TrainState]:
    """Run the CLI; returns the final train state (None on a rank outside
    the training mesh)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    cfg = parse_config(rest, is_train=True, save=mesh.env_rank() == 0)
    check_supported(cfg)
    world = mesh.initialize(resolve_device(args.device))
    device = world.device
    require_kernels(device)
    layout = mesh.make_data_layout(world, cfg.batch_size, cfg.mesh_shape,
                                   cfg.mesh_axes)
    if not layout.member:
        print(f"rank {world.rank}: outside the {layout.members.size}-rank "
              f"training mesh, idle")
        return None
    first = world.rank == 0      # writes every file
    data = layout.data
    if device.type == "cuda":
        # f32 at full precision (the JAX package asks for Precision.HIGHEST);
        # cuDNN picks its fastest algorithm per shape
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    np.random.seed(cfg.seed)
    # before any work: stops here, on every rank, if the gallery's packages
    # are missing
    visualizer = None
    if first:
        visualizer = Visualizer(cfg)
    elif not cfg.no_html:
        require_gallery_packages()

    if cfg.continue_train:
        start_epoch, epoch_iter = ckpt.load_iter(cfg.expr_dir)
        print("Resuming from epoch %d at iteration %d" % (start_epoch, epoch_iter))
    else:
        start_epoch, epoch_iter = 1, 0

    # ---------------- data
    if not cfg.dataroot:
        raise SystemExit("--dataroot is required: a corpus directory or a "
                         "csv file list")
    files = discover_files(cfg.dataroot, cfg.max_dataset_size)
    split = functools.partial(
        train_val_split, len(files), cfg.validation_split, cfg.seed,
        os.path.join(cfg.expr_dir, "validation_indices.json")
        if cfg.validation_split > 0 else None)
    # rank 0 persists the split first; the others read it
    if first:
        train_idx, val_idx = split()
    layout.members.barrier()
    if not first:
        train_idx, val_idx = split()
    # each data index draws its own segment offsets (rank 0: as one process)
    dataset = AudioDataset(cfg.dataroot, cfg.lr_sampling_rate,
                           cfg.hr_sampling_rate, cfg.segment_length,
                           seed=cfg.seed if data.rank == 0 else
                           [cfg.seed, data.rank], files=files)
    loader = Loader(dataset, train_idx, cfg.batch_size,
                    shuffle=not cfg.serial_batches, seed=cfg.seed,
                    n_threads=cfg.n_threads, shard=(data.rank, data.size))
    # the eval (rank 0, the whole batch) keeps its partial batch, so that a
    # validation split smaller than one batch still evaluates
    eval_loader = Loader(dataset, val_idx, cfg.batch_size, shuffle=False,
                         seed=cfg.seed, n_threads=cfg.n_threads,
                         drop_last=False) if val_idx and first else None
    if cfg.use_features and val_idx and cfg.eval_freq > 0:
        raise SystemExit(
            "the in-training eval of a feature config (--instance_feat / "
            "--label_feat): its inference takes no feature map, so G's input "
            "lacks the feature channels, and the JAX package's eval fails on "
            "it too; pass --eval_freq 0 or --validation_split 0")
    dataset_size = len(loader) * cfg.batch_size
    print("#training data = %d" % dataset_size)
    print("#evaluating data = %d" % len(val_idx))
    if dataset_size == 0:
        raise SystemExit(
            f"no training batches: {len(train_idx)} training files after the "
            f"{cfg.validation_split} validation split are less than one "
            f"batch of {cfg.batch_size} (partial batches are dropped); add "
            f"files, lower --batchSize or lower --validation_split")

    # ---------------- model/state
    system = Pix2PixHDSystem(cfg, device=device)
    state = init_state(system, cfg.seed)
    if cfg.continue_train and ckpt.has(cfg.which_epoch, cfg.expr_dir):
        ckpt.load_train_state(state, cfg.which_epoch, cfg.expr_dir)
        print("restored checkpoint '%s'" % cfg.which_epoch)
    elif cfg.load_pretrain:
        ckpt.load_train_state(state, cfg.which_epoch, cfg.load_pretrain)
        print("warm-started from %s" % cfg.load_pretrain)
    apply_parallel(state, layout, cfg)
    par = state.parallel
    use_pool = cfg.pool_size > 0
    pool = ImagePool(cfg.pool_size, cfg.seed)
    if use_pool:
        g_step, d_step = make_pool_steps(system)
    else:
        step = make_train_step(system)
    eval_step = make_eval_step(system)
    eval_noise = seeded_noise(system, cfg.seed)
    eval_path = os.path.join(cfg.expr_dir, "eval.csv")
    print(f"training on {device} ({cfg.compute_dtype} compute, f32 params)")

    # ---------------- cadence: every count is of samples
    print_freq = lcm(cfg.print_freq, cfg.batch_size) if cfg.print_freq > 0 else 0
    total_steps = (start_epoch - 1) * dataset_size + epoch_iter
    display_delta = total_steps % cfg.display_freq if cfg.display_freq > 0 else -1
    print_delta = total_steps % print_freq if print_freq > 0 else -1
    save_delta = (total_steps % cfg.save_latest_freq
                  if cfg.save_latest_freq > 0 else -1)
    do_eval = bool(val_idx) and cfg.eval_freq > 0
    eval_delta = total_steps % cfg.eval_freq if do_eval else -1

    def whole():
        """The nets and Adam states whole on every rank (a collective)."""
        return par.full_state(state) if par else contextlib.nullcontext()

    def save(*tags: str) -> None:
        with whole():
            if first:
                for tag in tags:
                    ckpt.save_train_state(state, cfg.expr_dir, tag)

    def guard_finite(losses, epoch: int, epoch_iter: int) -> Dict[str, float]:
        """The losses as floats. A non-finite one saves the state under the
        `diverged` tag and stops, leaving the last good `latest`. Called at
        the print cadence and before every save."""
        errors = {k: float(v) for k, v in losses.items()}
        if not all(math.isfinite(v) for v in errors.values()):
            # every rank holds the same (all-reduced) losses: all stop here
            save("diverged")
            raise SystemExit(
                f"non-finite losses at epoch {epoch} iter {epoch_iter}: "
                f"{errors}; state saved under the 'diverged' tag; resume "
                f"from 'latest' (the last good save) with --continue_train, "
                f"typically with a lower --lr")
        return errors

    interrupted = {"flag": False}

    def _sigint(_sig, _frame):
        print("You pressed Ctrl+C!")
        interrupted["flag"] = True

    lr_value = cfg.lr
    losses = {}  # guard_finite passes until the first step lands
    fix_global = (cfg.niter_fix_global > 0
                  and start_epoch <= cfg.niter_fix_global)
    previous = signal.signal(signal.SIGINT, _sigint)
    iter_start_time = time.time()
    try:
        for epoch in range(start_epoch, cfg.niter + cfg.niter_decay + 1):
            epoch_start_time = time.time()
            if epoch != start_epoch:
                epoch_iter = epoch_iter % dataset_size
            for rows in loader:
                # a Ctrl+C on any rank stops every rank at this step
                if layout.members.agree(interrupted["flag"]):
                    guard_finite(losses, epoch, epoch_iter)
                    print("exiting and saving the model at epoch %d, iters %d"
                          % (epoch, total_steps))
                    save("latest", str(epoch))
                    if first:
                        ckpt.save_iter(cfg.expr_dir, epoch + 1, 0)
                    return state
                if print_freq > 0 and total_steps % print_freq == print_delta:
                    iter_start_time = time.time()
                total_steps += cfg.batch_size
                epoch_iter += cfg.batch_size
                save_fake = (cfg.display_freq > 0
                             and total_steps % cfg.display_freq == display_delta)
                batch = {k: torch.from_numpy(rows[k]).to(device)
                         for k in ("label", "image")}
                noise_seed = cfg.seed * 1000003 + total_steps

                if use_pool:
                    losses, aux = g_step(state, batch,
                                         _generator(device, noise_seed),
                                         fix_global=fix_global,
                                         with_visuals=save_fake)
                    # the pool lives on the host, as in the JAX package
                    pooled = pool_rows(pool, aux["fake_pair"], data)
                    d_losses = d_step(state, batch,
                                      _generator(device, noise_seed),
                                      pooled.to(device))
                    losses = {**losses, **d_losses}
                else:
                    losses, aux = step(state, batch,
                                       _generator(device, noise_seed),
                                       fix_global=fix_global,
                                       with_visuals=save_fake)

                if print_freq > 0 and total_steps % print_freq == print_delta:
                    errors = guard_finite(losses, epoch, epoch_iter)
                    t = (time.time() - iter_start_time) / print_freq
                    if first:
                        visualizer.print_current_errors(epoch, epoch_iter,
                                                        errors, t)
                        visualizer.plot_current_errors(errors, total_steps)

                if save_fake and first and visualizer.use_html:
                    raw = {k: v.cpu().numpy() for k, v in aux["visuals"].items()}
                    visualizer.display_current_results(
                        visualizer.render_visuals(raw, cfg.abs_spectro),
                        epoch, total_steps)

                if (cfg.save_latest_freq > 0
                        and total_steps % cfg.save_latest_freq == save_delta):
                    guard_finite(losses, epoch, epoch_iter)
                    print("saving the latest model (epoch %d, total_steps %d)"
                          % (epoch, total_steps))
                    save("latest")
                    if first:
                        ckpt.save_iter(cfg.expr_dir, epoch, epoch_iter)

                if do_eval and total_steps % cfg.eval_freq == eval_delta:
                    # rank 0 over the whole eval batch; the others wait
                    with whole():
                        if first:
                            result = eval_model(system, eval_step,
                                                eval_loader, eval_noise)
                            append_csv_row(eval_path, result)
                            print("Evaluation:", result)
                        layout.members.barrier()

                if epoch_iter >= dataset_size:
                    break

            print("End of epoch %d / %d \t Time Taken: %d sec"
                  % (epoch, cfg.niter + cfg.niter_decay,
                     time.time() - epoch_start_time))

            if cfg.save_epoch_freq > 0 and epoch % cfg.save_epoch_freq == 0:
                guard_finite(losses, epoch, epoch_iter)
                print("saving the model at the end of epoch %d, iters %d"
                      % (epoch, total_steps))
                save("latest", str(epoch))
                if first:
                    ckpt.save_iter(cfg.expr_dir, epoch + 1, 0)

            if cfg.niter_fix_global != 0 and epoch == cfg.niter_fix_global:
                reset_opt_g(state, lr_value)
                fix_global = False
                print("------------ Now also finetuning global generator "
                      "-----------")

            if epoch > cfg.niter:
                lr_value -= cfg.lr / cfg.niter_decay
                set_learning_rate(state, lr_value)
                if cfg.verbose:
                    print("update learning rate: %f" % lr_value)
    finally:
        signal.signal(signal.SIGINT, previous)
    return state


if __name__ == "__main__":
    main()
    mesh.shutdown()
