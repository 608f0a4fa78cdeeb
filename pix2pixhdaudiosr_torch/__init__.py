"""PyTorch + CUDA port of pix2pixhdaudiosr_tpu for one NVIDIA H100.

The JAX package `pix2pixhdaudiosr_tpu` is the reference; this package keeps
its module names so each counterpart is easy to find. It imports torch and
never jax. Its hot kernels (ops/mdct_kernels.py, ops/norm.py) are CUDA C++
for sm_90a under csrc/, built with nvcc at first use.
"""

from .config import Config, parse_config

__all__ = ["Config", "parse_config"]
