"""ctypes bindings for the native (C++/OpenMP) host audio pipeline.

Copied from pix2pixhdaudiosr_tpu/runtime/native_audio.py, with its own
build: runtime/native/audio_pipeline.cpp (the port's copy of that
package's source) is compiled with g++ at first use into
`pix2pixhdaudiosr_torch/_build/native-<hash>/libaudio_pipeline.so`, keyed
on a hash of the source, the flags and the host's CPU (model name and
flags: the build uses -march=native, so a library built on another machine
is never loaded). Unlike the JAX module, nothing falls back: a build or
load failure raises with the compiler's stderr. `available()` says whether
the library builds; it is for tests, and no data path consults it.

The resampler takes its kernel bank from the port's ops/audio.py
(`sinc_resample_kernel`, the same function as the JAX package's).
`set_threads(n)` sets the OpenMP team size of every later call (0: the
runtime's default, one thread per core).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.audio import sinc_resample_kernel

_PKG = Path(__file__).resolve().parent.parent
_SRC = Path(__file__).resolve().parent / "native" / "audio_pipeline.cpp"
_BUILD = _PKG / "_build"
_LIB_NAME = "libaudio_pipeline.so"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def _cpu_signature() -> bytes:
    """The host CPU's model name and feature flags (/proc/cpuinfo)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return b"unknown"
    keep = [ln for ln in lines if ln.split(":")[0].strip() in
            ("model name", "flags", "Features", "CPU part")]
    return "\n".join(sorted(set(keep))).encode()


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_cpu_signature())
    return _BUILD / f"native-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile the library unless this source, these flags and this CPU
    already have one; raise RuntimeError with g++'s stderr on failure."""
    out_dir = build_dir()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}"
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build the native audio pipeline "
                           f"({' '.join(cmd)}): {e}") from None
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native audio pipeline "
                           f"({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c64 = ctypes.c_int64
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.resample_poly_f32.restype = c64
        lib.resample_poly_f32.argtypes = [f32p, c64, f64p, c64, c64, c64, c64,
                                          f32p, c64]
        lib.decode_pcm_first_channel.restype = c64
        lib.decode_pcm_first_channel.argtypes = [u8p, c64, ctypes.c_int32,
                                                 ctypes.c_int32, ctypes.c_int32,
                                                 f32p, c64]
        lib.flac_decode.restype = c64
        lib.flac_decode.argtypes = [u8p, c64, f32p, c64, ctypes.c_int32]
        lib.make_pair_batch.restype = None
        lib.make_pair_batch.argtypes = [f32p, ctypes.POINTER(c64), c64, c64, c64,
                                        f64p, c64, c64, c64, c64,
                                        f64p, c64, c64, c64, c64,
                                        f64p, c64, c64, c64, c64,
                                        f32p, f32p]
        lib.native_audio_set_threads.restype = None
        lib.native_audio_set_threads.argtypes = [ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (for tests)."""
    try:
        library()
        return True
    except (RuntimeError, OSError):
        return False


def set_threads(n: int) -> None:
    """The OpenMP team size of every later call; 0 for the default."""
    library().native_audio_set_threads(int(n))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def resample(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """1-D native polyphase resample (torchaudio kernel convention), the
    counterpart of ops/audio.resample_np on a 1-D signal."""
    if orig_freq == new_freq:
        return np.asarray(x, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 1:
        raise ValueError(f"native resample takes a 1-D signal, got {x.shape}")
    lib = library()
    kernels, width, p, q = sinc_resample_kernel(orig_freq, new_freq)
    kernels = np.ascontiguousarray(kernels, np.float64)
    target = int(math.ceil(len(x) * q / p))
    out = np.zeros(target, np.float32)
    n = lib.resample_poly_f32(_f32p(x), len(x), _f64p(kernels),
                              kernels.shape[1], p, q, width, _f32p(out), target)
    return out[:n]


def make_pair_batch(wavs: np.ndarray, lens: np.ndarray, orig_freq: int,
                    lr_freq: int, hr_freq: int,
                    segment_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batch (hr, lr) pair construction in native code. wavs: [B, max_len]
    padded float32, lens: true lengths."""
    lib = library()
    b = wavs.shape[0]

    def bank(a, c):
        if a == c:
            return np.zeros((1, 0), np.float64), 0, 1, 1
        k, w, p, q = sinc_resample_kernel(a, c)
        return np.ascontiguousarray(k, np.float64), w, p, q

    k_hr, w_hr, p_hr, q_hr = bank(orig_freq, hr_freq)
    k_dn, w_dn, p_dn, q_dn = bank(orig_freq, lr_freq)
    k_up, w_up, p_up, q_up = bank(lr_freq, hr_freq)
    wavs = np.ascontiguousarray(wavs, np.float32)
    lens = np.ascontiguousarray(lens, np.int64)
    hr_out = np.zeros((b, segment_length), np.float32)
    lr_out = np.zeros((b, segment_length), np.float32)
    lib.make_pair_batch(
        _f32p(wavs), lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b, wavs.shape[1], segment_length,
        _f64p(k_hr), k_hr.shape[1], p_hr, q_hr, w_hr,
        _f64p(k_dn), k_dn.shape[1], p_dn, q_dn, w_dn,
        _f64p(k_up), k_up.shape[1], p_up, q_up, w_up,
        _f32p(hr_out), _f32p(lr_out))
    return hr_out, lr_out


def flac_decode(buf: bytes, num_frames: int, nch: int) -> Optional[np.ndarray]:
    """Decode a complete FLAC stream to [C, T] float32, or None where the
    decoder does not cover the stream (it returns -1: a parse error or a
    channel count other than `nch`)."""
    lib = library()
    out = np.zeros((max(num_frames, 1), nch), np.float32)
    b = np.frombuffer(buf, np.uint8)
    n = lib.flac_decode(b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        len(buf), _f32p(out), num_frames, nch)
    if n < 0:
        return None
    return np.ascontiguousarray(out[:n].T)


def decode_pcm_first_channel(raw: bytes, fmt: int, bits: int,
                             nch: int) -> Optional[np.ndarray]:
    """The first channel of interleaved PCM bytes as float32, or None for a
    format the decoder does not cover."""
    lib = library()
    bpf = nch * (bits // 8)
    frames = len(raw) // bpf if bpf else 0
    out = np.zeros(frames, np.float32)
    buf = np.frombuffer(raw, np.uint8)
    n = lib.decode_pcm_first_channel(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(raw),
        fmt, bits, nch, _f32p(out), frames)
    return out[:n] if n >= 0 else None
