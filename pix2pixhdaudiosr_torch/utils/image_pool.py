"""Replay buffer for discriminator fakes.

Copied from pix2pixhdaudiosr_tpu/utils/image_pool.py (numpy only): per
sample, while the pool is not full, store and return the current fake;
afterwards, with p = 0.5, swap it with a random stored fake (returning the
old one), else return the current fake. Host-side state, seeded; a
pool_size of 0 returns its input.
"""

from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 1234):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.default_rng(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return images
        out = []
        for image in np.asarray(images):
            if len(self.images) < self.pool_size:
                self.images.append(image.copy())
                out.append(image)
            elif self.rng.uniform() > 0.5:
                idx = int(self.rng.integers(0, self.pool_size))
                out.append(self.images[idx].copy())
                self.images[idx] = image.copy()
            else:
                out.append(image)
        return np.stack(out)
