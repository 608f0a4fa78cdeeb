"""Self-contained FLAC codec, numpy and stdlib only.

Copied from pix2pixhdaudiosr_tpu/data/flac.py (that package's `data`
imports jax): the corpora the system is trained on (VCTK 0.92, HiFi-TTS)
ship as .flac. `read_flac` decodes through the port's native C++ decoder
(runtime/native_audio.py) as that module does; a stream the C++ decoder
does not cover (it returns no frames, or a length other than STREAMINFO's,
or STREAMINFO gives no length) takes the Python decoder below, and
`decodes` counts both routes. A failure of the library itself raises.

  read_flac / flac_info  — full decoder: constant/verbatim/fixed/LPC
    subframes, 4- and 5-bit Rice partitions with escape codes, wasted bits,
    all stereo decorrelation modes (left-side / right-side / mid-side),
    8/12/16/20/24-bit, variable and fixed blocking.
  write_flac             — minimal encoder (16-bit) with constant, verbatim,
    fixed-predictor and quantized-LPC subframes + Rice residuals; used for
    test fixtures and as the oracle for the decoder's hard paths.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

_FIXED_COEFS = [(), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1)]

# read_flac's decodes by route ("native": the C++ decoder, "python": the
# decoder below); set an entry to 0 to count afresh
decodes = {"native": 0, "python": 0}
_decodes_lock = threading.Lock()


def _count(route: str) -> None:
    with _decodes_lock:
        decodes[route] += 1


@dataclass(frozen=True)
class FlacInfo:
    sample_rate: int
    num_frames: int          # total samples per channel
    num_channels: int
    bits_per_sample: int
    data_offset: int         # byte offset of the first audio frame


class _BitReader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, bytepos: int = 0):
        self.buf = buf
        self.pos = bytepos * 8

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        lo, hi = p >> 3, (p + n + 7) >> 3
        chunk = int.from_bytes(self.buf[lo:hi], "big")
        return (chunk >> ((hi << 3) - p - n)) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def unary(self) -> int:
        """Count 0 bits until the terminating 1."""
        buf, p = self.buf, self.pos
        q = 0
        # scan bit by bit within the current byte, then whole zero bytes
        while True:
            byte = buf[p >> 3]
            rem = 8 - (p & 7)
            window = byte & ((1 << rem) - 1)
            if window:
                lead = rem - window.bit_length()
                q += lead
                self.pos = p + lead + 1
                return q
            q += rem
            p += rem

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bytepos(self) -> int:
        return self.pos >> 3


def _read_utf8_number(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n):
        val = (val << 6) | (br.read(8) & 0x3F)
    return val


def _parse_streaminfo(buf: bytes) -> Tuple[FlacInfo, int]:
    if buf[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC magic)")
    off = 4
    info = None
    while True:
        hdr = buf[off:off + 4]
        last, btype = hdr[0] >> 7, hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = buf[off + 4:off + 4 + size]
        if btype == 0:  # STREAMINFO
            sr = int.from_bytes(body[10:13], "big") >> 4
            ch = ((body[12] >> 1) & 0x7) + 1
            bps = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
            total = ((body[13] & 0x0F) << 32) | int.from_bytes(body[14:18], "big")
            info = (sr, total, ch, bps)
        off += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("FLAC stream has no STREAMINFO")
    sr, total, ch, bps = info
    return FlacInfo(sr, total, ch, bps, off), off


_BLOCKSIZE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
              8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
              13: 8192, 14: 16384, 15: 32768}
_SAMPLESIZE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_SAMPLERATE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
               7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"reserved residual coding method {method}")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    po = br.read(4)
    nparts = 1 << po
    psize = blocksize >> po
    out = np.empty(blocksize - order, np.int64)
    idx = 0
    for part in range(nparts):
        n = psize - order if part == 0 else psize
        param = br.read(pbits)
        if param == escape:
            raw = br.read(5)
            if raw == 0:
                out[idx:idx + n] = 0
            else:
                for i in range(n):
                    out[idx + i] = br.read_signed(raw)
            idx += n
        else:
            for i in range(n):
                q = br.unary()
                v = (q << param) | br.read(param) if param else q
                out[idx + i] = (v >> 1) ^ -(v & 1)
            idx += n
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("invalid subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.unary() + 1
        bps -= wasted
    if stype == 0:  # constant
        out = np.full(blocksize, br.read_signed(bps), np.int64)
    elif stype == 1:  # verbatim
        out = np.array([br.read_signed(bps) for _ in range(blocksize)], np.int64)
    elif 8 <= stype <= 12:  # fixed predictor, order = stype & 7
        order = stype & 7
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        o = out
        for i in range(order, blocksize):
            p = 0
            for j, c in enumerate(coefs):
                p += c * o[i - 1 - j]
            o[i] = p + res[i - order]
    elif stype >= 32:  # LPC, order = (stype & 31) + 1
        order = (stype & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("invalid LPC precision escape")
        shift = br.read_signed(5)
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        o = out
        for i in range(order, blocksize):
            p = 0
            for j in range(order):
                p += coefs[j] * o[i - 1 - j]
            o[i] = (p >> shift) + res[i - order]
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def _decode_frame(buf: bytes, bytepos: int, info: FlacInfo
                  ) -> Tuple[np.ndarray, int, int]:
    """Decode one frame; returns ([C, N] int64, first-sample index, next byte
    position)."""
    br = _BitReader(buf, bytepos)
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"bad frame sync at byte {bytepos}")
    br.read(1)  # reserved
    variable = br.read(1)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    br.read(1)  # reserved
    num = _read_utf8_number(br)
    if bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCKSIZE[bs_code]
    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    br.read(8)  # header CRC-8 (validated by the stream CRC16 downstream)
    bps = info.bits_per_sample if ss_code == 0 else _SAMPLESIZE[ss_code]

    if ch_code < 8:
        nch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
    elif ch_code == 8:   # left-side: ch1 = left - right
        left = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        chans = [left, left - side]
    elif ch_code == 9:   # right-side: ch0 = side, ch1 = right
        side = _decode_subframe(br, blocksize, bps + 1)
        right = _decode_subframe(br, blocksize, bps)
        chans = [right + side, right]
    elif ch_code == 10:  # mid-side
        mid = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        lr_sum = (mid << 1) | (side & 1)
        left = (lr_sum + side) >> 1
        chans = [left, left - side]
    else:
        raise ValueError(f"reserved channel assignment {ch_code}")
    br.align()
    br.read(16)  # frame CRC-16
    start = num * blocksize if not variable else num
    return np.stack(chans), start, br.bytepos()


def flac_info(path: str) -> FlacInfo:
    with open(path, "rb") as f:
        head = f.read(65536)
    info, _ = _parse_streaminfo(head)
    return info


def read_flac(path: str, frame_offset: int = 0,
              num_frames: Optional[int] = None,
              use_native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file; returns ([C, T] float32 in [-1, 1], sample_rate).

    Frames are variable-length on the wire, so random access decodes from the
    start and slices (the corpora's per-utterance files are short; the
    dataset's resample cache amortizes repeats). use_native=True decodes
    with the C++ decoder (runtime/native/audio_pipeline.cpp) where it covers
    the stream, else with this Python implementation, the oracle."""
    with open(path, "rb") as f:
        buf = f.read()
    info, off = _parse_streaminfo(buf)
    if use_native and info.num_frames:
        from ..runtime import native_audio
        data = native_audio.flac_decode(buf, info.num_frames,
                                        info.num_channels)
        if data is not None and data.shape[1] == info.num_frames:
            _count("native")
            end = data.shape[1] if num_frames is None else min(
                frame_offset + num_frames, data.shape[1])
            return (data[:, min(frame_offset, data.shape[1]):end],
                    info.sample_rate)
    _count("python")
    want_end = None if num_frames is None else frame_offset + num_frames
    parts: List[np.ndarray] = []
    got = 0
    pos = off
    while pos < len(buf) and (want_end is None or got < want_end):
        chans, start, pos = _decode_frame(buf, pos, info)
        parts.append(chans)
        got = start + chans.shape[1]
    if not parts:
        data = np.zeros((info.num_channels, 0), np.int64)
    else:
        data = np.concatenate(parts, axis=1)
    if info.num_frames:
        data = data[:, :info.num_frames]
    end = data.shape[1] if num_frames is None \
        else min(frame_offset + num_frames, data.shape[1])
    data = data[:, min(frame_offset, data.shape[1]):end]
    scale = float(1 << (info.bits_per_sample - 1))
    return (data.astype(np.float32) / scale), info.sample_rate


# ---------------------------------------------------------------------------
# Encoder (for fixtures/tests and wav->flac conversion tooling)
# ---------------------------------------------------------------------------

def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.out)


def _utf8_number(n: int) -> bytes:
    """FLAC's extended UTF-8 coding for frame/sample numbers (up to 36 bits).
    `trail` continuation bytes carry 6 bits each; the lead byte has
    (6 - trail) payload bits (0 for trail == 6)."""
    if n < 0x80:
        return bytes([n])
    for trail in range(1, 7):
        lead_bits = 6 - trail
        if n < (1 << (6 * trail + lead_bits)):
            lead = (0xFF << (7 - trail)) & 0xFF
            parts = [lead | (n >> (6 * trail))]
            for i in range(trail - 1, -1, -1):
                parts.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(parts)
    raise ValueError(f"frame number too large for UTF-8 coding: {n}")


def _rice_param(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    mean = float(np.mean(np.abs(res.astype(np.float64)))) + 1e-9
    k = max(0, int(np.ceil(np.log2(mean + 1))))
    return min(k, 14)


def _write_residual(bw: _BitWriter, res: np.ndarray) -> None:
    bw.write(0, 2)   # 4-bit rice
    bw.write(0, 4)   # partition order 0
    param = _rice_param(res)
    bw.write(param, 4)
    for r in res:
        r = int(r)
        v = (abs(r) << 1) - (1 if r < 0 else 0)  # zigzag
        bw.write_unary(v >> param)
        if param:
            bw.write(v & ((1 << param) - 1), param)


def _write_subframe(bw: _BitWriter, x: np.ndarray, bps: int,
                    mode: str) -> None:
    x = x.astype(np.int64)
    if mode == "auto":
        if len(x) and np.all(x == x[0]):
            mode = "constant"
        elif len(x) >= 8:
            mode = "fixed2"
        else:
            mode = "verbatim"
    if mode == "constant":
        bw.write(0, 1); bw.write(0, 6); bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    if mode == "verbatim":
        bw.write(0, 1); bw.write(1, 6); bw.write(0, 1)
        for v in x:
            bw.write(int(v), bps)
        return
    if mode.startswith("fixed"):
        order = int(mode[5:])
        bw.write(0, 1); bw.write(8 | order, 6); bw.write(0, 1)
        for v in x[:order]:
            bw.write(int(v), bps)
        coefs = _FIXED_COEFS[order]
        res = x[order:].copy()
        for j, c in enumerate(coefs):
            res -= c * x[order - 1 - j:len(x) - 1 - j]
        _write_residual(bw, res)
        return
    if mode == "lpc2":
        # quantized order-2 LPC with fixed coefficients (coef precision 12,
        # shift 10): prediction = (c0*x[i-1] + c1*x[i-2]) >> 10
        order, prec, shift = 2, 12, 10
        coefs = [int(1.8 * (1 << shift)), int(-0.85 * (1 << shift))]
        bw.write(0, 1); bw.write(32 | (order - 1), 6); bw.write(0, 1)
        for v in x[:order]:
            bw.write(int(v), bps)
        bw.write(prec - 1, 4)
        bw.write(shift, 5)
        for c in coefs:
            bw.write(c, prec)
        pred = (coefs[0] * x[1:-1] + coefs[1] * x[:-2]) >> shift
        _write_residual(bw, x[2:] - pred)
        return
    raise ValueError(f"unknown subframe mode {mode}")


def write_flac(path: str, audio: np.ndarray, sample_rate: int,
               block_size: int = 4096, subframe_mode: str = "auto",
               stereo_mode: str = "independent") -> None:
    """Encode float32/int16 audio ([C, T] or [T]) as a 16-bit FLAC file.

    subframe_mode: auto | constant | verbatim | fixed0..fixed4 | lpc2
    stereo_mode:   independent | left-side | mid-side   (2-channel only)
    """
    a = np.asarray(audio)
    if a.ndim == 1:
        a = a[None]
    if a.dtype.kind == "f":
        pcm = np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int64)
    else:
        pcm = a.astype(np.int64)
    nch, total = pcm.shape
    bps = 16

    # MD5 of the interleaved little-endian PCM (spec'd signature)
    md5 = hashlib.md5(pcm.T.astype("<i2").tobytes()).digest()

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(nch - 1, 3)
    si.write(bps - 1, 5)
    si.write(total, 36)
    body = si.getvalue() + md5
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    frame_idx = 0
    for start in range(0, total, block_size):
        blk = pcm[:, start:start + block_size]
        n = blk.shape[1]
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)           # fixed blocksize strategy
        bs_code = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                   512: 9, 1024: 10, 2048: 11, 4096: 12}.get(n, 7)
        bw.write(bs_code, 4)
        bw.write(0, 4)           # sample rate: from STREAMINFO
        use_stereo = nch == 2 and stereo_mode != "independent"
        if use_stereo:
            ch_code = {"left-side": 8, "mid-side": 10}[stereo_mode]
        else:
            ch_code = nch - 1
        bw.write(ch_code, 4)
        bw.write(4, 3)           # 16-bit
        bw.write(0, 1)
        for b in _utf8_number(frame_idx):
            bw.write(b, 8)
        if bs_code == 7:
            bw.write(n - 1, 16)
        hdr = bytes(bw.out) if bw.nbits == 0 else None
        assert hdr is not None, "frame header must be byte-aligned here"
        bw.write(_crc8(hdr), 8)

        if use_stereo and stereo_mode == "left-side":
            _write_subframe(bw, blk[0], bps, subframe_mode)
            _write_subframe(bw, blk[0] - blk[1], bps + 1, subframe_mode)
        elif use_stereo and stereo_mode == "mid-side":
            side = blk[0] - blk[1]
            mid = (blk[0] + blk[1]) >> 1
            _write_subframe(bw, mid, bps, subframe_mode)
            _write_subframe(bw, side, bps + 1, subframe_mode)
        else:
            for c in range(nch):
                _write_subframe(bw, blk[c], bps, subframe_mode)
        bw.align()
        frame_bytes = bw.getvalue()
        out += frame_bytes + struct.pack(">H", _crc16(frame_bytes))
        frame_idx += 1

    with open(path, "wb") as f:
        f.write(bytes(out))
