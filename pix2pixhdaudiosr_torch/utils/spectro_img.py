"""Spectrogram / histogram / phase renders for the HTML gallery.

Port of pix2pixhdaudiosr_tpu/utils/spectro_img.py:1-45: matplotlib's
imshow with 'PuBu_r', a 100-bin histogram, the 'cool' phase map, on the
Agg backend. matplotlib and PIL are imported at the first render, not
when this module is imported: only a run that writes the gallery needs
them (`require_gallery_packages`).
"""

from __future__ import annotations

import importlib
from typing import Optional, Tuple

import numpy as np


def require_gallery_packages() -> None:
    """Stop (SystemExit) unless matplotlib and PIL import."""
    for name in ("matplotlib", "PIL"):
        try:
            importlib.import_module(name)
        except ImportError:
            raise SystemExit(
                f"the HTML gallery needs the {name} package, which is not "
                f"installed; pass --no_html to run without the gallery"
            ) from None


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _fig2img(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def compute_visuals(sp: Optional[np.ndarray] = None,
                    pha: Optional[np.ndarray] = None,
                    abs: bool = False) -> Tuple[Optional[np.ndarray],
                                                Optional[np.ndarray],
                                                Optional[np.ndarray]]:
    plt = _pyplot()
    sp_spectro = sp_hist = pha_img = None
    if sp is not None:
        fig, ax = plt.subplots()
        ax.imshow(np.abs(sp) if abs else sp, cmap="PuBu_r", origin="lower",
                  aspect="auto")
        sp_spectro = _fig2img(fig)
        fig2, ax2 = plt.subplots()
        ax2.hist(np.asarray(sp).reshape(-1), bins=100)
        sp_hist = _fig2img(fig2)
    if pha is not None:
        fig3, ax3 = plt.subplots()
        ax3.imshow(pha, cmap="cool", origin="lower", aspect="auto")
        pha_img = _fig2img(fig3)
    plt.close("all")
    return sp_spectro, sp_hist, pha_img
