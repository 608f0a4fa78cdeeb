"""Training CLI.

Port of the core of pix2pixhdaudiosr_tpu/train_loop.py:41-280: the epoch
loop over a wav corpus with the sample-counted print cadence aligned to
lcm(print_freq, batch) (loss_log.txt, scalars.jsonl), the `latest` save
every save_latest_freq samples and the `latest` + epoch save every
save_epoch_freq epochs (a frequency of 0 disables its cadence), the
niter_fix_global switch with a fresh G optimizer, and the linear learning
rate decay after `niter` epochs.

    python -m pix2pixhdaudiosr_torch.train_loop <the JAX CLI's flags> \
        --no_html --validation_split 0 [--device cuda|cpu]

The device defaults to cuda; the CPU runs only when asked for (--device
cpu), and then every kernel runs its plain PyTorch twin. On the card the
kernels are built before the first step, and a run whose kernels cannot be
built stops: it never trains on the twins. Checkpoints go to
checkpoints_dir/name/ (utils/checkpoint.py); `<tag>_net_G.pth` is what
pix2pixhdaudiosr_torch.generate serves. Resuming, the eval cadence, the
HTML gallery, --tf_log, the save on Ctrl+C and the divergence guard's
post-mortem save come with ROADMAP A8: the first four are refused, Ctrl+C
stops the run, and a non-finite loss stops it before it can overwrite a
checkpoint.
"""

from __future__ import annotations

import argparse
import math
import signal
import time

import numpy as np
import torch

from .config import parse_config
from .data.dataset import AudioDataset, Loader
from .data.filelist import discover_files, train_val_split
from .generate import resolve_device
from .ops import _cuda
from .system import Pix2PixHDSystem, check_trainable
from .trainer import (TrainState, init_state, make_train_step, reset_opt_g,
                      set_learning_rate)
from .utils.checkpoint import save_iter, save_train_state
from .utils.visualizer import Visualizer

_A8 = "the rest of the train loop, ROADMAP A8"
# (condition on the config, what it asks for, the ROADMAP item that brings it)
_NOT_YET = (
    (lambda c: c.continue_train, "--continue_train", _A8),
    (lambda c: bool(c.load_pretrain), "--load_pretrain (a warm start)", _A8),
    (lambda c: c.validation_split > 0 and c.eval_freq > 0,
     "the eval cadence (pass --validation_split 0 or --eval_freq 0)", _A8),
    (lambda c: not c.no_html, "the HTML gallery (pass --no_html)", _A8),
    (lambda c: c.tf_log, "--tf_log", _A8),
    (lambda c: c.zero_opt_state or c.fsdp, "--zero_opt_state / --fsdp",
     "parallel modes, ROADMAP A11"),
)


def check_supported(cfg) -> None:
    for cond, what, where in _NOT_YET:
        if cond(cfg):
            raise SystemExit(f"{what} is not ported to pix2pixhdaudiosr_torch "
                             f"yet; it comes with {where}")
    try:
        check_trainable(cfg)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None


def require_kernels(device: torch.device) -> None:
    """Build the CUDA kernels before the first step; stop if they do not
    build (no run trains on the CPU twins of a card's kernels)."""
    if device.type == "cuda":
        try:
            _cuda.library()
        except (RuntimeError, OSError) as e:
            raise SystemExit(f"the CUDA kernels (InstanceNorm B3, MDCT2 B1) "
                             f"cannot be built or loaded: {e}") from None


def lcm(a: int, b: int) -> int:
    return abs(a * b) // math.gcd(a, b) if a and b else 0


def finite_losses(losses, epoch: int, epoch_iter: int) -> dict:
    """The losses as floats; stop on a non-finite one, so that no save can
    overwrite the last good checkpoint with a diverged state."""
    errors = {k: float(v) for k, v in losses.items()}
    if not all(math.isfinite(v) for v in errors.values()):
        raise SystemExit(
            f"non-finite losses at epoch {epoch} iter {epoch_iter}: {errors}; "
            f"the last save is the last good state (the divergence guard's "
            f"post-mortem save comes with {_A8})")
    return errors


def _interrupted(_sig, _frame):
    raise SystemExit(f"interrupted: nothing saved since the last checkpoint "
                     f"(the save on Ctrl+C comes with {_A8})")


def main(argv=None) -> TrainState:
    """Run the CLI; returns the final train state."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    cfg = parse_config(rest, is_train=True)
    check_supported(cfg)
    device = resolve_device(args.device)
    require_kernels(device)
    if device.type == "cuda":
        # f32 at full precision (the JAX package asks for Precision.HIGHEST);
        # cuDNN picks its fastest algorithm per shape
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    np.random.seed(cfg.seed)

    # ---------------- data
    if not cfg.dataroot:
        raise SystemExit("--dataroot is required: a corpus directory or a "
                         "csv file list")
    files = discover_files(cfg.dataroot, cfg.max_dataset_size)
    train_idx, _ = train_val_split(len(files), cfg.validation_split, cfg.seed)
    dataset = AudioDataset(cfg.dataroot, cfg.lr_sampling_rate,
                           cfg.hr_sampling_rate, cfg.segment_length,
                           seed=cfg.seed, files=files)
    loader = Loader(dataset, train_idx, cfg.batch_size,
                    shuffle=not cfg.serial_batches, seed=cfg.seed,
                    n_threads=cfg.n_threads)
    dataset_size = len(loader) * cfg.batch_size
    print("#training data = %d" % dataset_size)
    if dataset_size == 0:
        raise SystemExit(
            f"no training batches: {len(train_idx)} training files are less "
            f"than one batch of {cfg.batch_size} (partial batches are "
            f"dropped); add files or lower --batchSize")

    # ---------------- model/state
    system = Pix2PixHDSystem(cfg, device=device)
    state = init_state(system, cfg.seed)
    step = make_train_step(system)
    visualizer = Visualizer(cfg.expr_dir)
    print(f"training on {device} ({cfg.compute_dtype} compute, f32 params)")

    # ---------------- cadence: every count is of samples, from 0
    print_freq = lcm(cfg.print_freq, cfg.batch_size) if cfg.print_freq > 0 else 0
    total_steps = epoch_iter = 0
    lr_value = cfg.lr
    fix_global = cfg.niter_fix_global > 0
    previous = signal.signal(signal.SIGINT, _interrupted)
    iter_start_time = time.time()
    try:
        for epoch in range(1, cfg.niter + cfg.niter_decay + 1):
            epoch_start_time = time.time()
            epoch_iter = epoch_iter % dataset_size
            for data in loader:
                if print_freq > 0 and total_steps % print_freq == 0:
                    iter_start_time = time.time()
                total_steps += cfg.batch_size
                epoch_iter += cfg.batch_size
                batch = {k: torch.from_numpy(data[k]).to(device)
                         for k in ("label", "image")}
                gen = torch.Generator(device=device).manual_seed(
                    cfg.seed * 1000003 + total_steps)
                losses, _ = step(state, batch, gen, fix_global=fix_global)

                if print_freq > 0 and total_steps % print_freq == 0:
                    errors = finite_losses(losses, epoch, epoch_iter)
                    t = (time.time() - iter_start_time) / print_freq
                    visualizer.print_current_errors(epoch, epoch_iter, errors, t)
                    visualizer.plot_current_errors(errors, total_steps)

                if (cfg.save_latest_freq > 0
                        and total_steps % cfg.save_latest_freq == 0):
                    finite_losses(losses, epoch, epoch_iter)
                    print("saving the latest model (epoch %d, total_steps %d)"
                          % (epoch, total_steps))
                    save_train_state(state, cfg.expr_dir, "latest")
                    save_iter(cfg.expr_dir, epoch, epoch_iter)

                if epoch_iter >= dataset_size:
                    break

            print("End of epoch %d / %d \t Time Taken: %d sec"
                  % (epoch, cfg.niter + cfg.niter_decay,
                     time.time() - epoch_start_time))

            if cfg.save_epoch_freq > 0 and epoch % cfg.save_epoch_freq == 0:
                finite_losses(losses, epoch, epoch_iter)
                print("saving the model at the end of epoch %d, iters %d"
                      % (epoch, total_steps))
                save_train_state(state, cfg.expr_dir, "latest")
                save_train_state(state, cfg.expr_dir, str(epoch))
                save_iter(cfg.expr_dir, epoch + 1, 0)

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
