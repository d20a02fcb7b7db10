"""Dependency-free TensorBoard scalar event writer.

The port's own copy of ``dyglib_tpu/utils/tensorboard.py`` (the port
imports nothing of the JAX package): a metrics stream that standard
TensorBoard reads, without tensorflow or tensorboardX. Event files use
the TFRecord framing (length + masked CRC32C) around an ``Event``
protobuf; both are tiny, stable wire formats encoded by hand here.

Wire formats implemented:
  * TFRecord: [uint64 length][uint32 masked_crc(length)][payload]
              [uint32 masked_crc(payload)]
  * Event proto: wall_time(1: double), step(2: int64), file_version(3: str),
    summary(5: Summary); Summary.value(1, repeated): tag(1: str),
    simple_value(2: float).
"""
from __future__ import annotations

import os
import struct
import time


# ---------------------------------------------------------------- CRC32C
def _crc_table() -> tuple[int, ...]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _double_field(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float_field(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int_field(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _bytes_field(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    out = _double_field(1, wall_time)
    if step is not None:
        out += _int_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            v = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
            summary += _bytes_field(1, v)  # Summary.value, repeated
        out += _bytes_field(5, summary)
    return out


# --------------------------------------------------------------- writer
class SummaryWriter:
    """Append-only scalar writer: ``events.out.tfevents.<ts>.<host>`` in
    ``log_dir``, one record per add_scalar(s) call."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = os.uname().nodename if hasattr(os, "uname") else "host"
        path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(path, "ab")
        self.path = path
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(
            header
            + struct.pack("<I", _masked_crc(header))
            + payload
            + struct.pack("<I", _masked_crc(payload))
        )
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=step, scalars={tag: value}))

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        self._write(_event(time.time(), step=step, scalars=scalars))

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_scalar_events(path: str) -> list[tuple[int, dict[str, float]]]:
    """Parse an event file back (CRC-checked; a mismatch raises) — the test
    oracle and a debugging aid; returns [(step, {tag: value})] for scalar
    events."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != hcrc:
            raise ValueError(f"{path}: header CRC mismatch at byte {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"{path}: payload CRC mismatch at byte {pos}")
        pos += 16 + length
        out.append(_parse_event(payload))
    return [(s, sc) for s, sc in out if sc]


def _parse_event(buf: bytes) -> tuple[int, dict[str, float]]:
    step, scalars = 0, {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if num == 2:
                step = val
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            if num == 5:  # summary
                scalars.update(_parse_summary(sub))
    return step, scalars


def _parse_summary(buf: bytes) -> dict[str, float]:
    out = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        if key >> 3 == 1 and key & 7 == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
            tag, value, p2 = "", 0.0, 0
            while p2 < len(v):
                k2, p2 = _read_varint(v, p2)
                if k2 >> 3 == 1 and k2 & 7 == 2:
                    ln2, p2 = _read_varint(v, p2)
                    tag = v[p2 : p2 + ln2].decode()
                    p2 += ln2
                elif k2 >> 3 == 2 and k2 & 7 == 5:
                    (value,) = struct.unpack_from("<f", v, p2)
                    p2 += 4
                else:  # skip unknown
                    wire = k2 & 7
                    if wire == 0:
                        _, p2 = _read_varint(v, p2)
                    elif wire == 1:
                        p2 += 8
                    elif wire == 5:
                        p2 += 4
                    elif wire == 2:
                        ln2, p2 = _read_varint(v, p2)
                        p2 += ln2
            out[tag] = value
    return out


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
