"""Build and load the package's CUDA kernels (csrc/*.cu).

The sources are compiled by `nvcc` for sm_90a, one process a source, all
started together, and linked into ONE shared library with a plain C
interface, loaded with ctypes. The build happens at first use,
from the package's own sources, into `pix2pixhdaudiosr_torch/_build/<hash>/`
(keyed on a hash of the sources and flags, so an edit rebuilds). Nothing
here runs at import time: a CPU-only machine imports every module and never
reaches nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_LIB_NAME = "libp2p_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
# C signature of every kernel entry point: (argtypes); all return int
_SIGNATURES = {
    "p2p_mdct2_tc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "p2p_imdct2_tc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "p2p_mdct2_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "p2p_imdct2_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "p2p_instance_norm_onepass": (_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I,
                                  _F, _I, _I, _I, _P),
    "p2p_instance_norm_act": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                              _P),
    "p2p_instance_norm_grad_onepass": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                                       _I, _L, _L, _I, _I, _F, _I, _I, _I,
                                       _P),
    "p2p_instance_norm_grad_twopass": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _L, _L, _I, _L, _L, _I, _I, _F, _I, _I,
                                       _P),
    "p2p_instance_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "p2p_conv3x3_in": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _F, _I, _I, _I, _I, _P),
    "p2p_conv3x3_valid": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    "p2p_conv3x3_in_wg": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _F, _I, _I, _I, _P),
    "p2p_conv3x3_valid_wg": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "p2p_stochastic_quantize_2d": (_P, _P, _P, _P, _I, _I, _U, _P),
    "p2p_stochastic_quantize_strip": (_P, _P, _P, _I, _I, _U, _I, _I, _I, _P),
}

_lib = None


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of pix2pixhdaudiosr_torch are built at first use")
    return found


def build() -> Path:
    """Compile csrc/*.cu into _build/<hash>/libp2p_kernels.so unless that
    file exists: one nvcc a source, all at once, then one link. The
    compilers' output (with -Xptxas -v: registers, shared memory and spills
    per kernel) is kept beside it in build.log."""
    out_dir = _BUILD / source_hash()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for cu in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{cu.stem}{tag}.o"
        cmd = [_nvcc(), *compile_flags, "-c", "-I", str(_CSRC), "-o",
               str(obj), str(cu)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = out_dir / f".{_LIB_NAME}{tag}"
    if not failed:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.p2p_error_string.argtypes = [ctypes.c_int]
        lib.p2p_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry point `name` on `device`'s current stream (appended
    as the last argument); raise if the launch was refused."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.p2p_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
