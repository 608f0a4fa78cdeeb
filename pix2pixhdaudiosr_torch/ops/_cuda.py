"""Build and load the package's CUDA kernels (csrc/*.cu).

The sources are compiled by `nvcc` for sm_90a, one process a source, all
started together, and linked into ONE shared library with a plain C
interface, loaded with ctypes. The build happens at first use,
from the package's own sources, into `pix2pixhdaudiosr_torch/_build/<hash>/`
(keyed on a hash of the sources and flags, so an edit rebuilds). Nothing
here builds at import time: a CPU-only machine imports every module and
never reaches nvcc.

Each kernel entry a forward calls is also an operator of the `p2p`
namespace (`define_op`), so that torch.export, FlopCounterMode and the
profiler see it: a CUDA impl (the launch, counted as an eager one), a CPU
impl (the plain twin) and a fake impl (the output's shape, dtype and
strides on each device). Importing the package registers them, so an
exported program that calls them loads in a process that imports only
pix2pixhdaudiosr_torch. A wrapper calls its operator while it is traced
(`tracing`); run eagerly it launches directly, since the dispatcher costs
host time on every launch (PERF.md §6).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

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
    "p2p_instance_moments": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I,
                             _I, _I, _I, _I, _P),
    "p2p_instance_apply": (_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _I,
                           _I, _I, _I, _I, _F, _P),
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

# the operators' library: one namespace for every kernel entry (define_op)
LIBRARY = torch.library.Library("p2p", "DEF")


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


def _index(device: torch.device) -> int:
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def current_stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream, as `launch` passes it
    (without building a torch.cuda.Stream)."""
    return torch._C._cuda_getCurrentRawStream(_index(device))


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry point `name` on `device`'s current stream (appended
    as the last argument), with `device` made the current device where it
    is not already; raise if the launch was refused."""
    fn, index = getattr(library(), name), _index(device)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch._C._cuda_getDevice() == index:
        code = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*args, stream)
    if code != 0:
        msg = _lib.p2p_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")


def tracing() -> bool:
    """Whether the caller runs under torch.export or torch.compile, where a
    wrapper calls its `p2p` operator (which the graph records) instead of
    launching directly."""
    return torch.compiler.is_compiling()


def _device_of(args) -> torch.device:
    """The device of the first tensor among an operator's arguments."""
    return next(a.device for a in args if isinstance(a, torch.Tensor))


def define_op(schema: str, cuda: Callable, cpu: Callable,
              cuda_fake: Callable):
    """Define the operator p2p::<name> of `schema` ("name(args) -> out"),
    implemented by `cuda` on CUDA tensors (the kernel's launch, which
    counts it) and by `cpu` on CPU tensors (the plain twin); its fake impl
    runs `cpu` itself on fake CPU tensors (the twin's own output strides)
    and `cuda_fake` on fake CUDA ones, which allocates what the launch
    returns. Returns the operator (torch.ops.p2p.<name>)."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cuda, "CUDA")
    LIBRARY.impl(name, cpu, "CPU")

    def fake(*args):
        return (cpu if _device_of(args).type == "cpu" else cuda_fake)(*args)

    torch.library.register_fake(f"p2p::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.p2p, name)
