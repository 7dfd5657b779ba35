"""Minimal TensorBoard event-file writer and reader (counterpart of
`pwn_tpu/utils/tensorboard.py`, a copy: the port imports nothing of the
JAX package).

Dependency-free: the `tensorflow.Event` protobuf wire format and the
TFRecord framing (length + masked-CRC32C records) are hand-encoded here.
TensorBoard's record reader validates the CRCs, so a real TB install can
load these files directly.  Scalars and audio (the two summary kinds the
workload produces) are supported.

Proto field numbers (tensorflow/core/util/event.proto,
tensorflow/core/framework/summary.proto):
    Event:   wall_time=1 (double), step=2 (int64),
             file_version=3 (string), summary=5 (message)
    Summary: value=1 (repeated message)
    Value:   tag=1 (string), simple_value=2 (float), audio=6 (message)
    Audio:   sample_rate=1 (float), num_channels=2, length_frames=3,
             encoded_audio_string=4 (bytes), content_type=5 (string)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

# --- CRC32C (Castagnoli), table-driven; TFRecord framing requires it ---

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire-format encoding helpers ---


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


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _string(field: int, v: str) -> bytes:
    return _bytes(field, v.encode("utf-8"))


def _scalar_value(tag: str, value: float) -> bytes:
    return _string(1, tag) + _float(2, float(value))


def _audio_value(tag: str, wav_bytes: bytes, sample_rate: int) -> bytes:
    n_frames = max((len(wav_bytes) - 44) // 2, 0)  # PCM16 mono payload
    audio = (
        _float(1, float(sample_rate))
        + _int64(2, 1)
        + _int64(3, n_frames)
        + _bytes(4, wav_bytes)
        + _string(5, "audio/wav")
    )
    return _string(1, tag) + _bytes(6, audio)


def _event(step: Optional[int] = None, summary: Optional[bytes] = None,
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    ev = _double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        ev += _int64(2, int(step))
    if file_version is not None:
        ev += _string(3, file_version)
    if summary is not None:
        ev += _bytes(5, summary)
    return ev


class SummaryWriter:
    """Append-only TB event file under `logdir` (one per process)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname(),
        )
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_record(_event(file_version="brain.Event:2"))
        self.flush()

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        summary = _bytes(1, _scalar_value(tag, value))
        self._write_record(_event(step=step, summary=summary))

    def add_scalars(self, step: int, **metrics: float) -> None:
        vals = b"".join(
            _bytes(1, _scalar_value(k, v))
            for k, v in metrics.items()
            if isinstance(v, (int, float)) and np.isfinite(v)
        )
        if vals:
            self._write_record(_event(step=step, summary=vals))

    def add_audio(self, tag: str, wav: np.ndarray, sample_rate: int,
                  step: int) -> None:
        """wav: (T,) float32 in [-1, 1] — encoded as PCM16 WAV bytes."""
        from pwn_tpu_torch.utils.audio_io import wav_bytes

        summary = _bytes(
            1, _audio_value(tag, wav_bytes(wav, sample_rate), sample_rate)
        )
        self._write_record(_event(step=step, summary=summary))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# --- reader (tests + offline inspection; TB itself is not installed) ---


def read_events(path: str):
    """Parse an event file back into dicts; validates both CRCs of every
    record (what TB's reader enforces)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return out
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != masked_crc32c(header):
                raise ValueError("header CRC mismatch")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != masked_crc32c(data):
                raise ValueError("data CRC mismatch")
            out.append(_parse_event(data))


def _parse_fields(data: bytes):
    i = 0
    while i < len(data):
        key = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, v
        elif wire == 1:
            yield field, struct.unpack("<d", data[i:i + 8])[0]
            i += 8
        elif wire == 5:
            yield field, struct.unpack("<f", data[i:i + 4])[0]
            i += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, data[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_event(data: bytes) -> dict:
    ev = {}
    for field, v in _parse_fields(data):
        if field == 1:
            ev["wall_time"] = v
        elif field == 2:
            ev["step"] = v
        elif field == 3:
            ev["file_version"] = v.decode()
        elif field == 5:
            vals = {}
            for f2, v2 in _parse_fields(v):
                if f2 == 1:
                    tag, val = None, None
                    for f3, v3 in _parse_fields(v2):
                        if f3 == 1:
                            tag = v3.decode()
                        elif f3 == 2:
                            val = v3
                        elif f3 == 6:
                            val = {
                                f4: v4 for f4, v4 in _parse_fields(v3)
                            }
                    vals[tag] = val
            ev["summary"] = vals
    return ev
