#!/usr/bin/env python
"""Precompute feature-encoder maps for a dataset with the PyTorch port.

The port's twin of tools/precompute_feature_maps.py: run the port's netE
(Pix2PixHDSystem.netE of a feature config's training system) over every
item ({"image": [H, W, C], "inst": [H, W, 1], "path": ...}) and save each
instance-pooled feature map ([H, W, feat_num] float32) as
`<out_dir>/<file stem>_feat.npy`. Imports no jax.

    from tools.precompute_feature_maps_torch import precompute
    precompute(system, dataset, out_dir)
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from encode_features_torch import feature_map  # noqa: E402


def precompute(system, dataset, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(dataset)):
        item = dataset[i]
        name = os.path.splitext(os.path.basename(item["path"]))[0]
        np.save(os.path.join(out_dir, f"{name}_feat.npy"),
                feature_map(system, item))
        if (i + 1) % 100 == 0:
            print(f"{i + 1} / {len(dataset)}")


if __name__ == "__main__":
    print(__doc__)
