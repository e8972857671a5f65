"""Minimal TensorBoard event writer — pure Python, zero TF dependency.

The reference wires a ``TensorBoard(log_dir, histogram_freq=1)`` callback
(reference ``scripts/train.py:299-302``) that writes per-epoch scalars and
weight histograms.  This module emits the same on-disk artifact — a
``events.out.tfevents.*`` file readable by TensorBoard — by hand-encoding
the two tiny protobufs involved (Event / Summary / HistogramProto) and the
TFRecord framing (length + masked CRC32C), so the framework's logging
stack stays TF-free.

The port's own copy of ``unet_image_segmentation_tpu/utils/tb_writer.py``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterable, Optional

import numpy as np

# ---- CRC32C (Castagnoli), table-driven ----

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf wire-format helpers ----


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _pb_int(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _pb_string(field: int, value: str) -> bytes:
    return _pb_bytes(field, value.encode("utf-8"))


def _pb_packed_doubles(field: int, values: Iterable[float]) -> bytes:
    payload = b"".join(struct.pack("<d", v) for v in values)
    return _pb_bytes(field, payload)


def _histogram_proto(values: np.ndarray, bins: int = 30) -> bytes:
    """HistogramProto from raw values (TF-style exponential-ish buckets not
    required; TensorBoard renders any bucket_limit/bucket pairs)."""
    values = np.asarray(values, np.float64).reshape(-1)
    if values.size == 0:
        values = np.zeros((1,))
    counts, edges = np.histogram(values, bins=bins)
    msg = b"".join(
        [
            _pb_double(1, float(values.min())),
            _pb_double(2, float(values.max())),
            _pb_double(3, float(values.size)),
            _pb_double(4, float(values.sum())),
            _pb_double(5, float(np.square(values).sum())),
            _pb_packed_doubles(6, edges[1:]),
            _pb_packed_doubles(7, counts.astype(np.float64)),
        ]
    )
    return msg


def _summary_value_scalar(tag: str, value: float) -> bytes:
    inner = _pb_string(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, inner)  # Summary.value


def _summary_value_histo(tag: str, values: np.ndarray) -> bytes:
    inner = _pb_string(1, tag) + _pb_bytes(5, _histogram_proto(values))  # Value.histo = field 5
    return _pb_bytes(1, inner)


def _event(step: int, summary: bytes = b"", file_version: Optional[str] = None) -> bytes:
    msg = _pb_double(1, time.time()) + _pb_int(2, step)
    if file_version is not None:
        msg += _pb_string(3, file_version)
    if summary:
        msg += _pb_bytes(5, summary)
    return msg


class SummaryWriter:
    """Append-only events-file writer.

    Usage::

        w = SummaryWriter(log_dir)
        w.scalar("epoch_loss", 0.3, step=1)
        w.histogram("enc1_block1/kernel", np_array, step=1)
        w.flush()
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, _summary_value_scalar(tag, value)))

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        for tag, value in values.items():
            self.scalar(prefix + tag, float(value), step)

    def histogram(self, tag: str, values: np.ndarray, step: int) -> None:
        self._write_record(_event(step, _summary_value_histo(tag, values)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()
