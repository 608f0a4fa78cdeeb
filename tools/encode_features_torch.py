#!/usr/bin/env python
"""Instance-feature encoding and k-means clustering with the PyTorch port.

The port's twin of tools/encode_features.py: run the port's feature
encoder (Pix2PixHDSystem.netE, a training system of a --instance_feat or
--label_feat config) over a dataset, take each instance's pooled feature
at the middle pixel of its region, and cluster the features of each label
into `features_clustered_<n>.npy`, which Pix2PixHDSystem.sample_features
reads at inference. Dataset items are {"image": [H, W, C] spectrogram,
"inst": [H, W, 1] integer ids}. `kmeans` is the numpy Lloyd's loop of
tools/encode_features.py, copied. Imports no jax.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def kmeans(feat: np.ndarray, n_clusters: int, n_iter: int = 100,
           seed: int = 0) -> np.ndarray:
    """Lloyd's algorithm; returns [n_clusters, D] centers."""
    rng = np.random.default_rng(seed)
    n = feat.shape[0]
    n_clusters = min(n, n_clusters)
    centers = feat[rng.choice(n, n_clusters, replace=False)]
    for _ in range(n_iter):
        d = ((feat[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = np.stack([feat[assign == k].mean(0) if np.any(assign == k)
                        else centers[k] for k in range(n_clusters)])
        if np.allclose(new, centers):
            break
        centers = new
    return centers


def feature_map(system, item) -> np.ndarray:
    """netE's instance-pooled feature map of one item, [H, W, feat_num]
    float32, in the system's compute dtype on its device."""
    import torch
    image = torch.as_tensor(np.asarray(item["image"], np.float32),
                            device=system.device)[None]
    inst = torch.as_tensor(np.asarray(item["inst"]).astype(np.int64),
                           device=system.device)[None, ..., 0]
    with torch.no_grad():
        fmap = system.encode_features(image, inst)
    return fmap[0].float().cpu().numpy()


def encode_and_cluster(system, dataset, label_nc: int, feat_num: int,
                       n_clusters: int, save_path: str,
                       max_items: int = 10_000_000) -> str:
    """Gather per-instance pooled encoder features, then cluster per label;
    writes features.npy and features_clustered_<n_clusters>.npy into
    save_path and returns the latter's path."""
    features = {label: np.zeros((0, feat_num + 1)) for label in range(label_nc)}
    for i in range(min(len(dataset), max_items)):
        item = dataset[i]
        fmap = feature_map(system, item)
        inst_np = np.asarray(item["inst"]).astype(int)
        h, w = inst_np.shape[:2]
        for iid in np.unique(inst_np):
            label = iid if iid < 1000 else iid // 1000
            if label >= label_nc:
                continue
            ys, xs = np.nonzero(inst_np[..., 0] == iid)
            if len(ys) == 0:
                continue
            mid = len(ys) // 2
            val = np.zeros((1, feat_num + 1))
            val[0, :feat_num] = fmap[ys[mid], xs[mid], :feat_num]
            val[0, feat_num] = len(ys) / (h * w // 32)
            features[label] = np.append(features[label], val, axis=0)
    np.save(os.path.join(save_path, "features.npy"), features,
            allow_pickle=True)

    centers = {}
    for label in range(label_nc):
        feat = features[label]
        feat = feat[feat[:, -1] > 0.5, :-1]
        if feat.shape[0]:
            centers[label] = kmeans(feat, n_clusters)
    out = os.path.join(save_path, "features_clustered_%03d.npy" % n_clusters)
    np.save(out, centers, allow_pickle=True)
    print("saving to %s" % out)
    return out


if __name__ == "__main__":
    print(__doc__)
    print("Use encode_and_cluster(system, dataset, ...) from python.")
