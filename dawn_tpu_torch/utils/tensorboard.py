"""Dependency-free TensorBoard scalar event writer.

Port of ``dawn_tpu/utils/tensorboard.py``. The reference trainers log
through torch.utils.tensorboard.SummaryWriter (DM_3/train_DM_xt_nodm_
mouthloss_ca_multi_6D.py:174,319-321 and the LFG/PBnet trainers); the
port's trainers log metrics.jsonl and, with ``--tensorboard``, event files
written here without a tensorboard or tensorflow dependency: the two protos
a scalar stream needs (Event, Summary) are encoded by hand and framed in the
TFRecord format (length + masked crc32c) that TensorBoard's event loader
reads.

Wire format references (stable public contracts):
- TFRecord framing: 8-byte LE length, masked crc32c(length), payload,
  masked crc32c(payload); mask(crc) = ((crc>>15 | crc<<17) + 0xa282ead8).
- Event proto: 1=wall_time (double), 2=step (int64), 3=file_version
  (string, first record "brain.Event:2"), 5=summary (message).
- Summary proto: repeated 1=Value{1=tag (string), 2=simple_value (float)}.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ------------------------------------------------------------------- crc32c

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- proto encoding

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


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:            # length-delimited
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: Optional[float] = None) -> bytes:
    val = _ld(1, tag.encode("utf-8")) + _float(2, float(value))
    summary = _ld(1, val)
    return (_double(1, time.time() if wall_time is None else wall_time)
            + _int64(2, int(step)) + _ld(5, summary))


def _version_event(wall_time: Optional[float] = None) -> bytes:
    return (_double(1, time.time() if wall_time is None else wall_time)
            + _ld(3, b"brain.Event:2"))


# ------------------------------------------------------------------- writer

class EventWriter:
    """Minimal SummaryWriter: ``add_scalar(tag, value, step)`` into a
    standard ``events.out.tfevents.*`` file under ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_version_event())
        self.flush()

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._record(_scalar_event(tag, float(value), step))

    def add_scalars(self, scalars: dict, step: int,
                    prefix: str = "") -> None:
        for k, v in scalars.items():
            try:
                self.add_scalar(f"{prefix}{k}", float(v), step)
            except (TypeError, ValueError):
                continue

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
