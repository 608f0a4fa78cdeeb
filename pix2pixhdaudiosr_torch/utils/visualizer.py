"""Training observability: console + loss_log.txt, scalars.jsonl, the
TensorBoard event file and the HTML image gallery.

Port of pix2pixhdaudiosr_tpu/utils/visualizer.py:29-131: the line
`(epoch: %d, iters: %d, time: %.3f) name: %.3f ...` (zero-valued losses
skipped), one JSON line of scalars a print (and, under --tf_log, one event
record each into expr_dir/logs), and the gallery: web/images/
epochNNN_<label>.jpg and web/index.html (refresh 30, newest epoch first,
two rows from 10 images up). The gallery is on for a training config
without --no_html; it needs matplotlib and PIL, checked when the
Visualizer is made, before any work.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from .html import HTML
from .spectro_img import compute_visuals, require_gallery_packages


def _save_image(arr: np.ndarray, path: str) -> None:
    from PIL import Image
    Image.fromarray(np.asarray(arr, np.uint8)).save(path)


class Visualizer:
    def __init__(self, cfg):
        self.name = cfg.name
        self.use_html = cfg.is_train and not cfg.no_html
        self.win_size = 512
        expr = cfg.expr_dir
        os.makedirs(expr, exist_ok=True)
        self.web_dir = os.path.join(expr, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        if self.use_html:
            require_gallery_packages()
            os.makedirs(self.img_dir, exist_ok=True)
        self.log_name = os.path.join(expr, "loss_log.txt")
        self.scalar_log = os.path.join(expr, "scalars.jsonl")
        self.tb = None
        if cfg.tf_log:
            from .tb_events import EventWriter
            self.tb = EventWriter(os.path.join(expr, "logs"))
        self._epochs_with_images = []
        with open(self.log_name, "a") as f:
            f.write("================ Training Loss (%s) ================\n"
                    % time.strftime("%c"))

    # ------------------------------------------------------------------
    def print_current_errors(self, epoch: int, i: int,
                             errors: Dict[str, float], t: float) -> None:
        message = "(epoch: %d, iters: %d, time: %.3f) " % (epoch, i, t)
        for k, v in errors.items():
            if v != 0:
                message += "%s: %.3f " % (k, v)
        print(message)
        with open(self.log_name, "a") as f:
            f.write("%s\n" % message)

    def plot_current_errors(self, errors: Dict[str, float], step: int) -> None:
        with open(self.scalar_log, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in
                                                 errors.items()}}) + "\n")
        if self.tb is not None:
            self.tb.add_scalars(errors, step)

    # ------------------------------------------------------------------
    def render_visuals(self, raw: Dict[str, np.ndarray],
                       abs_spectro: bool = False) -> Dict[str, np.ndarray]:
        """Raw [F, T] arrays (system.visual_slices) -> rendered images."""
        out = {}
        for key in ("label", "generated", "real"):
            if key in raw:
                sp, hist, _ = compute_visuals(sp=np.asarray(raw[key]),
                                              abs=abs_spectro)
                out[f"{key}_spectro"] = sp
                out[f"{key}_hist"] = hist
        for key in ("label_pha", "generated_pha", "real_pha"):
            if key in raw:
                _, _, pha = compute_visuals(pha=np.asarray(raw[key]))
                out[key] = pha
        return out

    def display_current_results(self, visuals: Dict[str, np.ndarray],
                                epoch: int, step: int) -> None:
        if not self.use_html:
            return
        for label, img in visuals.items():
            if img is None:
                continue
            _save_image(img, os.path.join(self.img_dir,
                                          "epoch%.3d_%s.jpg" % (epoch, label)))
        if epoch not in self._epochs_with_images:
            self._epochs_with_images.append(epoch)
        page = HTML(self.web_dir, "Experiment name = %s" % self.name, refresh=30)
        for n in sorted(self._epochs_with_images, reverse=True):
            page.add_header("epoch [%d]" % n)
            ims, txts, links = [], [], []
            for label in visuals:
                p = "epoch%.3d_%s.jpg" % (n, label)
                if os.path.exists(os.path.join(self.img_dir, p)):
                    ims.append(p)
                    txts.append(label)
                    links.append(p)
            if len(ims) < 10:
                page.add_images(ims, txts, links, width=self.win_size)
            else:
                num = int(round(len(ims) / 2.0))
                page.add_images(ims[:num], txts[:num], links[:num],
                                width=self.win_size)
                page.add_images(ims[num:], txts[num:], links[num:],
                                width=self.win_size)
        page.save()

    def save_images(self, webpage: HTML, visuals: Dict[str, np.ndarray],
                    image_path: str) -> None:
        name = os.path.splitext(os.path.basename(image_path))[0]
        webpage.add_header(name)
        ims, txts, links = [], [], []
        for label, img in visuals.items():
            if img is None:
                continue
            image_name = "%s_%s.jpg" % (name, label)
            _save_image(img, os.path.join(webpage.get_image_dir(), image_name))
            ims.append(image_name)
            txts.append(label)
            links.append(image_name)
        webpage.add_images(ims, txts, links, width=self.win_size)
