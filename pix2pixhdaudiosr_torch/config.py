"""Configuration: `Config` and `parse_config` of the JAX package, shared.

pix2pixhdaudiosr_tpu/config.py is standard library only, so the port uses
that very file rather than a copy. It is loaded by path, under this
package's name, so that neither the port nor chip_smoke.py imports any
module of the JAX package (whose `ops` and `data` pull in jax).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_NAME = "pix2pixhdaudiosr_torch._shared_config"
_SOURCE = Path(__file__).resolve().parent.parent / "pix2pixhdaudiosr_tpu" / "config.py"


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _SOURCE)
    module = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = module  # dataclasses resolves its module by name
    spec.loader.exec_module(module)
    return module


_shared = _load()
Config = _shared.Config
parse_config = _shared.parse_config

__all__ = ["Config", "parse_config"]
