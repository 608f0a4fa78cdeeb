"""Audio file discovery and the persisted train/val split.

Copied from pix2pixhdaudiosr_tpu/data/filelist.py (that package's `data`
imports jax): a directory walk or a csv file list, matching .wav, .mp3 and
.flac, and a seeded split whose validation indices are persisted so that a
resumed run keeps the same split.
"""

from __future__ import annotations

import csv
import json
import os
import random
from typing import List, Optional, Tuple

AUDIO_EXTS = (".wav", ".mp3", ".flac")


def discover_files(dataroot: str, max_size: Optional[int] = None) -> List[str]:
    if os.path.isdir(dataroot):
        files = []
        for root, _dirs, names in os.walk(dataroot, topdown=False):
            for name in sorted(names):
                if os.path.splitext(name)[1].lower() in AUDIO_EXTS:
                    files.append(os.path.join(root, name))
    else:
        root = os.path.dirname(dataroot)
        with open(dataroot, "r") as f:
            files = [os.path.join(root, item)
                     for row in csv.reader(f) for item in row]
    if max_size is not None:
        files = files[: int(max_size)]
    return files


def train_val_split(n: int, validation_split: float, seed: int,
                    indices_path: Optional[str] = None
                    ) -> Tuple[List[int], List[int]]:
    """Seeded split; validation indices persisted/restored like the
    reference's validation_indices.pt (data/custom_dataset_data_loader.py:31-40)."""
    if indices_path and os.path.exists(indices_path):
        with open(indices_path) as f:
            val = json.load(f)
        val_set = set(val)
        train = [i for i in range(n) if i not in val_set]
        return train, list(val)
    idx = list(range(n))
    random.Random(seed).shuffle(idx)
    n_val = int(n * validation_split)
    val = idx[:n_val]
    val_set = set(val)
    train = [i for i in range(n) if i not in val_set]  # stable order; the
    # training sampler shuffles anyway (reference SubsetRandomSampler)
    if indices_path:
        os.makedirs(os.path.dirname(indices_path) or ".", exist_ok=True)
        with open(indices_path, "w") as f:
            json.dump(val, f)
    return train, val
