"""Minimal, dependency-free TensorBoard scalar writer.

A copy of ``dmtpu/utils/tensorboard_writer.py`` (pure Python, the same bytes
out): the TensorBoard event-file format encoded by hand, TFRecord framing
(length + masked crc32c) around hand-serialised Event protobufs carrying
``simple_value`` scalar summaries, readable by any standard TensorBoard.
``torch.utils.tensorboard`` is not used: it needs the ``tensorboard``
package, which a training machine need not have.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — needed for TFRecord masking
# ---------------------------------------------------------------------------
_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# tiny protobuf encoder (only what Event/Summary scalars need)
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag=1: string, simple_value=2: float }
    sv = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    # Summary { value=1: repeated Value }
    summary = _bytes_field(1, sv)
    # Event { wall_time=1: double, step=2: int64, summary=5: Summary }
    return _double_field(1, wall_time) + _int64_field(2, step) + _bytes_field(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    # Event { wall_time=1, file_version=3: string }
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


class SummaryWriter:
    """Scalar-only TensorBoard writer (API subset of torch's)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}.0"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write_record(_file_version_event(time.time()))
        self.flush()

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, global_step: Optional[int] = None) -> None:
        self._write_record(_scalar_event(tag, float(value), int(global_step or 0), time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()
