"""Standalone test-set evaluation CLI.

Port of pix2pixhdaudiosr_tpu/evaluate.py:1-79: the generator of
`<which_epoch>_net_G.pth` (from --load_pretrain, else checkpoints_dir/name)
runs the in-training eval's inference and inverse (trainer.make_eval_step)
over every file of --dataroot, one random segment each, for --niter
epochs, and appends one {err, snr, snr_seg, pesq, lsd} row an epoch to
checkpoints_dir/name/eval.csv. Kept from the JAX CLI: it scores
2 * sr_audio (the reference's scale quirk; the metrics renormalize sr, so
only the lsd column sees it), its `snr` column is s_sr alone, and its
lists are made once, before the epoch loop, so row n is the mean over
epochs 1..n. --data_type 8 is ignored, as there.

    python -m pix2pixhdaudiosr_torch.evaluate <the JAX CLI's flags> \
        [--device cuda|cpu]

The device defaults to cuda; the CPU runs only when asked for (--device
cpu), and then every kernel runs its plain PyTorch twin.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List

import numpy as np
import torch

from .config import parse_config
from .data.dataset import AudioDataset, Loader
from .data.filelist import discover_files
from .generate import check_supported, load_system, resolve_device, seeded_noise
from .metrics import append_csv_row, compute_metrics
from .system import Pix2PixHDSystem
from .trainer import make_eval_step


def evaluate_epochs(system: Pix2PixHDSystem, eval_step, loader,
                    noise: Callable, n_epochs: int,
                    eval_path: str) -> List[Dict[str, float]]:
    """`n_epochs` passes over `loader`; batch j's mask noise is
    `noise(j, shape)`. Appends each epoch's row (the running mean over all
    batches so far) to eval_path and returns the rows."""
    cfg = system.cfg
    errs, snrs, snr_segs, pesqs, lsds = [], [], [], [], []
    rows = []
    for _ in range(n_epochs):
        for j, data in enumerate(loader):
            lr = torch.from_numpy(data["label"]).to(system.device)
            b, f, t, c = system.spectro_shape(lr.shape[0])
            sr_audio, _ = eval_step(lr, noise(j, (b, system.codec.mask_size(f),
                                                  t, c)))
            m, s_sr, _, ss_sr, _, pesq, lsd = compute_metrics(
                torch.from_numpy(data["image"]),
                torch.from_numpy(data["label"]), 2 * sr_audio.cpu(),
                cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.center)
            errs.append(m)
            snrs.append(s_sr)
            snr_segs.append(ss_sr)
            pesqs.append(pesq)
            lsds.append(lsd)
        result = {"err": float(np.mean(errs)), "snr": float(np.mean(snrs)),
                  "snr_seg": float(np.mean(snr_segs)),
                  "pesq": float(np.mean(pesqs)), "lsd": float(np.mean(lsds))}
        append_csv_row(eval_path, result)
        print("Evaluation:", result)
        rows.append(result)
    return rows


def main(argv=None) -> List[Dict[str, float]]:
    """Run the CLI; returns the rows it appended."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    cfg = parse_config(rest, is_train=False)
    check_supported(cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True

    files = discover_files(cfg.dataroot, cfg.max_dataset_size)
    dataset = AudioDataset(cfg.dataroot, cfg.lr_sampling_rate,
                           cfg.hr_sampling_rate, cfg.segment_length,
                           seed=cfg.seed, files=files)
    loader = Loader(dataset, range(len(dataset)), cfg.batch_size,
                    shuffle=False, n_threads=cfg.n_threads, drop_last=False)
    print("#eval data = %d" % (len(loader) * cfg.batch_size))

    system = load_system(cfg.replace(data_type=32), device)
    os.makedirs(cfg.expr_dir, exist_ok=True)
    return evaluate_epochs(system, make_eval_step(system), loader,
                           seeded_noise(system, cfg.seed), cfg.niter,
                           os.path.join(cfg.expr_dir, "eval.csv"))


if __name__ == "__main__":
    main()
