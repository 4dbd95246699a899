"""Minimal TensorBoard event-file writer (no tensorboardX dependency).

The port's copy of ``eamm_tpu/train/tbevents.py`` (pure Python).

The reference logs per-loss scalars through tensorboardX
(ref:train.py:68,81-86); that package is not in this image, so this module
writes the TensorBoard wire format directly — an events file is a TFRecord
stream of serialized ``tensorflow.Event`` protos, and scalar events only
need three proto messages:

    Event  { double wall_time = 1; int64 step = 2;
             string file_version = 3; Summary summary = 5; }
    Summary{ repeated Value value = 1; }
    Value  { string tag = 1; float simple_value = 2; }

TFRecord framing: u64le(len) · masked_crc(len bytes) · data ·
masked_crc(data), with the CRC32C polynomial and TensorFlow's rotate-mask.
Files written here load in stock TensorBoard.
"""
from __future__ import annotations

import os
import struct
import time


# ----------------------------------------------------------- crc32c

def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _scalar_event(wall_time: float, step: int, scalars: dict) -> bytes:
    values = b"".join(
        _field_bytes(1, _field_bytes(1, tag.encode()) +
                     _field_float(2, float(v)))
        for tag, v in scalars.items())
    return (_field_double(1, wall_time) + _field_varint(2, int(step))
            + _field_bytes(5, values))


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


# ----------------------------------------------------------- writer

class EventWriter:
    """Appends scalar events to a ``events.out.tfevents.*`` file."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.eamm{suffix}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalars(self, step: int, scalars: dict, prefix: str = ""):
        tagged = {(f"{prefix}/{k}" if prefix else k): v
                  for k, v in scalars.items()}
        self._write_record(_scalar_event(time.time(), step, tagged))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_events(path: str) -> list:
    """Parse an events file back into [(step, {tag: value})] — used by the
    round-trip test and as a loader where TensorBoard isn't installed."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (n,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("corrupt record header")
            data = f.read(n)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise ValueError("corrupt record payload")
            ev = _parse_event(data)
            if ev is not None:
                out.append(ev)
    return out


def _parse_fields(data: bytes):
    i = 0
    while i < len(data):
        key = 0
        shift = 0
        while True:
            b = data[i]; i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        num, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = data[i]; i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            val = data[i:i + 8]; i += 8
        elif wire == 5:
            val = data[i:i + 4]; i += 4
        elif wire == 2:
            n = 0
            shift = 0
            while True:
                b = data[i]; i += 1
                n |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = data[i:i + n]; i += n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, val


def _parse_event(data: bytes):
    step = 0
    scalars = {}
    for num, wire, val in _parse_fields(data):
        if num == 2 and wire == 0:
            step = val
        elif num == 5 and wire == 2:
            for vn, vw, vv in _parse_fields(val):
                if vn == 1 and vw == 2:
                    tag, simple = None, None
                    for fn, fw, fv in _parse_fields(vv):
                        if fn == 1 and fw == 2:
                            tag = fv.decode()
                        elif fn == 2 and fw == 5:
                            (simple,) = struct.unpack("<f", fv)
                    if tag is not None and simple is not None:
                        scalars[tag] = simple
    return (step, scalars) if scalars else None
