"""Interactive label-map editing (the legacy pix2pixHD editor), the
inference model and the model factory.

Port of pix2pixhdaudiosr_tpu/ui_model.py. The editing is host numpy,
copied as it is (load_maps, reset, backup_current_state, undo,
change_labels, add_strokes, add_objects, get_current_visuals, get_edges);
only the generator forward runs on the card (`single_forward`: the
system's netG, its input cast to the compute dtype and its output to f32,
numpy [B, H, W, C] in and out as in the JAX package).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from .system import Pix2PixHDSystem


class UIModel:
    def name(self) -> str:
        return "UIModel"

    def initialize(self, cfg, state_dict: Optional[Mapping] = None,
                   device="cuda"):
        """An inference system for `cfg`; its generator takes `state_dict`
        (the JAX package's params_g) and is cast once to the compute dtype,
        as the generate CLI loads it. Without one, single_forward raises,
        as the JAX package's asserts without params."""
        self.cfg = cfg
        self.system = Pix2PixHDSystem(cfg.replace(is_train=False),
                                      device=device)
        self.loaded = state_dict is not None
        if self.loaded:
            self.system.netG.load_state_dict(state_dict)
        self.system.netG.to(dtype=self.system.dtype,
                            memory_format=torch.channels_last)
        self.system.netG.eval()
        self._undo_stack: List[Tuple[np.ndarray, np.ndarray]] = []
        self.label_map: Optional[np.ndarray] = None
        self.inst_map: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def load_maps(self, label_map: np.ndarray, inst_map: Optional[np.ndarray] = None):
        """File IO is left to the caller."""
        self.label_map = np.asarray(label_map).copy()
        self.inst_map = (np.asarray(inst_map).copy() if inst_map is not None
                         else np.zeros_like(self.label_map))
        self._original = (self.label_map.copy(), self.inst_map.copy())
        self._undo_stack = []

    def reset(self):
        self.label_map, self.inst_map = (a.copy() for a in self._original)
        self._undo_stack = []

    def backup_current_state(self):
        self._undo_stack.append((self.label_map.copy(), self.inst_map.copy()))

    def undo(self):
        if self._undo_stack:
            self.label_map, self.inst_map = self._undo_stack.pop()

    # ------------------------------------------------------------------
    def change_labels(self, click_src: Tuple[int, int], click_tgt: Tuple[int, int]):
        """Relabel the clicked instance region to the target pixel's label."""
        self.backup_current_state()
        src_inst = self.inst_map[click_src]
        tgt_label = self.label_map[click_tgt]
        tgt_inst = self.inst_map[click_tgt]
        mask = self.inst_map == src_inst
        self.label_map[mask] = tgt_label
        self.inst_map[mask] = tgt_inst

    def add_strokes(self, click_src: Tuple[int, int], label_tgt: int, bw: int,
                    save: bool = True):
        """Paint a (2bw+1)^2 square stroke."""
        if save:
            self.backup_current_state()
        y, x = click_src
        h, w = self.label_map.shape[-2:]
        ys, ye = max(0, y - bw), min(h, y + bw + 1)
        xs, xe = max(0, x - bw), min(w, x + bw + 1)
        self.label_map[..., ys:ye, xs:xe] = label_tgt
        self.inst_map[..., ys:ye, xs:xe] = label_tgt

    def add_objects(self, click_src: Tuple[int, int], label_tgt: int,
                    mask: np.ndarray, style_id: int = 0):
        """Stamp an object mask at the click point."""
        self.backup_current_state()
        y, x = click_src
        mh, mw = mask.shape
        h, w = self.label_map.shape[-2:]
        ye, xe = min(h, y + mh), min(w, x + mw)
        region = mask[: ye - y, : xe - x] > 0
        self.label_map[..., y:ye, x:xe][region] = label_tgt
        self.inst_map[..., y:ye, x:xe][region] = label_tgt

    # ------------------------------------------------------------------
    @torch.no_grad()
    def single_forward(self, net_input: np.ndarray) -> np.ndarray:
        """Generator forward on an edited input: [B, H, W, C] numpy ->
        [B, H, W, C_out] f32 numpy."""
        if not self.loaded:
            raise RuntimeError("load generator params first")
        x = torch.as_tensor(np.asarray(net_input), device=self.system.device)
        x = x.to(self.system.dtype).permute(0, 3, 1, 2)  # channels_last view
        y = self.system.netG(x).permute(0, 2, 3, 1).float()
        return y.cpu().numpy()

    def get_current_visuals(self):
        return {"label": None if self.label_map is None else self.label_map.copy(),
                "inst": None if self.inst_map is None else self.inst_map.copy()}


def get_edges(t: np.ndarray) -> np.ndarray:
    """Instance-boundary map: 1 where an instance id differs from a
    4-neighbour. t: [..., H, W] ints."""
    edge = np.zeros_like(t, dtype=bool)
    edge[..., :, 1:] |= t[..., :, 1:] != t[..., :, :-1]
    edge[..., :, :-1] |= t[..., :, 1:] != t[..., :, :-1]
    edge[..., 1:, :] |= t[..., 1:, :] != t[..., :-1, :]
    edge[..., :-1, :] |= t[..., 1:, :] != t[..., :-1, :]
    return edge.astype(np.float32)


class InferenceModel(Pix2PixHDSystem):
    """The reference's InferenceModel: a system whose call is inference."""

    def __call__(self, lr_audio: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        return self.inference(lr_audio, noise=noise, generator=generator)


def create_model(cfg, device="cuda"):
    """The reference's factory: a training system, an InferenceModel, or
    for another --model a UIModel. Data parallelism is a process group
    (parallel/), not a module wrapper."""
    if cfg.model == "pix2pixHD":
        return (Pix2PixHDSystem(cfg, device=device) if cfg.is_train
                else InferenceModel(cfg, device=device))
    model = UIModel()
    model.initialize(cfg, device=device)
    return model
