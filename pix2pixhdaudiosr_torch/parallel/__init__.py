"""The parallel modes: the process-group layer and the training mesh
(mesh.py), data parallelism of the train step (dp.py), ZeRO-1 (zero.py)
and FSDP (fsdp.py), frame-axis context parallelism (halo.py) and Megatron
tensor parallelism of the resblocks (tp.py). Counterpart of
pix2pixhdaudiosr_tpu/parallel/."""

from .mesh import (DataLayout, Group, World, initialize, make_data_layout,
                   make_group)

__all__ = ["DataLayout", "Group", "World", "initialize", "make_data_layout",
           "make_group"]
