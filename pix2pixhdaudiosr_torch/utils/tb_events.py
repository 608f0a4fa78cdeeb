"""Minimal TensorBoard event-file writer (no TensorFlow dependency).

Copied from pix2pixhdaudiosr_tpu/utils/tb_events.py (stdlib only): the two
protobufs involved (Event{wall_time, step, summary{value{tag,
simple_value}}}) encoded by hand, in TFRecord framing (length + masked
crc32c), so that standard TensorBoard reads the files.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# crc32c (software, Castagnoli polynomial), as required by TFRecord framing
# ---------------------------------------------------------------------------
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _double_field(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float_field(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int64_field(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: Optional[float] = None) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    val = _len_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _len_field(1, val)            # Summary.value = 1 (repeated)
    event = (_double_field(1, wall_time if wall_time is not None else time.time())
             + _int64_field(2, int(step))
             + _len_field(5, summary))      # Event.summary = 5
    return event


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Append-only TensorBoard scalar event file."""

    def __init__(self, log_dir: str, filename_suffix: str = ".tfevents"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, "events.out.tfevents.%d.audiosr" % int(time.time()))
        # file-version header event (required by TensorBoard)
        version = (_double_field(1, time.time())
                   + _len_field(3, b"brain.Event:2"))
        with open(self.path, "wb") as f:
            f.write(_record(version))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        with open(self.path, "ab") as f:
            f.write(_record(_scalar_event(tag, value, step)))

    def add_scalars(self, scalars: dict, step: int) -> None:
        with open(self.path, "ab") as f:
            for tag, value in scalars.items():
                f.write(_record(_scalar_event(tag, float(value), step)))


def read_events(path: str):
    """Parse back (tag, value, step) tuples — test oracle for the writer."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 12  # len + len-crc
        payload = data[pos : pos + length]
        pos += length + 4
        # naive scan: find step (field 2 varint) and summary (field 5)
        step = None
        i = 0
        tag = None
        value = None
        while i < len(payload):
            key = payload[i]
            if key == 0x09:  # field 1 wire 1 (wall_time, fixed64 double)
                # must be skipped as 8 raw bytes: byte-scanning through the
                # double misparses mantissa bytes that equal 0x10/0x2A as
                # step/summary keys (time-dependent flake, caught in CI)
                i += 9
            elif key == 0x10:  # field 2 wire 0 (step)
                i += 1
                step = 0
                shift = 0
                while payload[i] & 0x80:
                    step |= (payload[i] & 0x7F) << shift
                    shift += 7
                    i += 1
                step |= payload[i] << shift
                i += 1
            elif key == 0x1A:  # field 3 (file_version string)
                i += 1
                ln = payload[i]
                i += 1 + ln
            elif key == 0x2A:  # field 5 (summary)
                i += 1
                ln = payload[i]
                i += 1
                summary = payload[i : i + ln]
                i += ln
                # Summary.value -> Value{tag=1 str, simple_value=2 float}
                j = 0
                if summary[j] == 0x0A:
                    j += 1
                    vlen = summary[j]
                    j += 1
                    val = summary[j : j + vlen]
                    k = 0
                    while k < len(val):
                        if val[k] == 0x0A:
                            k += 1
                            tlen = val[k]
                            k += 1
                            tag = val[k : k + tlen].decode()
                            k += tlen
                        elif val[k] == 0x15:
                            (value,) = struct.unpack_from("<f", val, k + 1)
                            k += 5
                        else:
                            k += 1
            else:
                i += 1
        if tag is not None:
            out.append((tag, value, step))
    return out
