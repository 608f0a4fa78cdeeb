"""PyTorch + CUDA port of pix2pixhdaudiosr_tpu for one NVIDIA H100.

The JAX package `pix2pixhdaudiosr_tpu` is the reference; this package keeps
its module names so each counterpart is easy to find. It imports torch and
never jax. Its hot kernels (ops/mdct_kernels.py, ops/norm.py) are CUDA C++
for sm_90a under csrc/, built with nvcc at first use. Importing the
package registers them as the operators of the `p2p` namespace
(ops/_cuda.define_op), which an exported program (tools/aot_engine_torch.py)
calls.
"""

from .config import Config, parse_config
from .ops import conv, enhancer, mdct_kernels, norm, quant  # noqa: F401

__all__ = ["Config", "parse_config"]
