"""The serving parallel modes: the process-group layer (mesh.py), frame-axis
context parallelism (halo.py) and Megatron tensor parallelism of the
resblocks (tp.py). Counterpart of pix2pixhdaudiosr_tpu/parallel/."""

from .mesh import Group, World, initialize, make_group

__all__ = ["Group", "World", "initialize", "make_group"]
