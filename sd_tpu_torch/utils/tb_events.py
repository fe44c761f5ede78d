"""TensorBoard event-file writer, dependency-free (the port's copy of
``sd_tpu/utils/tb_events.py``, byte for byte the same records).

The reference wires a TestTube (TensorBoard) logger by default
(``main.py:541-565``); this writes the same artifact, ``events.out.tfevents.*``
files that TensorBoard reads, without tensorflow or tensorboardX. The file
is TFRecord-framed ``tensorflow.Event`` protos; both the framing (masked
CRC32C) and the two protos used (Event, Summary with simple_value) are small
enough to encode by hand.

Wire reference:
- TFRecord: u64le(len) + u32le(maskedcrc(len)) + data + u32le(maskedcrc(data))
- Event: 1=wall_time double, 2=step int64, 3=file_version string,
  5=summary message
- Summary: repeated 1=Value; Value: 1=tag string, 2=simple_value float
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

__all__ = ["TensorBoardWriter"]

# --- CRC32C (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding ---------------------------------------------


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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    msg = _field_double(1, wall_time)
    if step:
        msg += _field_varint(2, step)
    if file_version:
        msg += _field_bytes(3, file_version.encode())
    if summary:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(metrics: Dict[str, float]) -> bytes:
    out = b""
    for tag, value in metrics.items():
        value_msg = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
        out += _field_bytes(1, value_msg)
    return out


class TensorBoardWriter:
    """Writes scalar metrics as TensorBoard event files."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def write(self, step: int, metrics: Dict[str, float]):
        self._record(_event(time.time(), step=int(step),
                            summary=_scalar_summary(metrics)))

    def close(self):
        self._f.close()
