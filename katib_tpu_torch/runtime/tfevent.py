"""TfEvent collector — the port's own copy of ``katib_tpu/runtime/tfevent.py``:
the scalars of TensorBoard event files, read without TensorFlow.

Katib's tfevent-metricscollector walks a trial's event directory with
TensorBoard's EventAccumulator. Here the TFRecord framing and the Event and
Summary protobuf wire format are decoded directly:

- a TFRecord frame: u64 length, u32 masked CRC of the length, the payload,
  u32 masked CRC of the payload (the reader does not check the CRCs);
- Event: wall_time = 1 (double), step = 2 (int64), summary = 5;
- Summary.Value: tag = 1, simple_value = 2 (float, TF1) or tensor = 8 with
  a float scalar (TF2).

A metric named "accuracy" matches the tags "accuracy" and "<any>/accuracy",
as Katib's loader matches them. The writer at the end frames records with
masked CRC32C, so TensorBoard reads its files too.
"""

from __future__ import annotations

import itertools
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..db.store import MetricLog

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, raw_value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == _WIRE_64BIT:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == _WIRE_32BIT:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            return  # unknown wire type: stop parsing this message


def _parse_tensor_scalar(buf: bytes) -> Optional[float]:
    """TensorProto: float_val=5 (packed/repeated float), double_val=6,
    tensor_content=4 (raw bytes), dtype=1."""
    dtype = None
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_VARINT:
            dtype = val
        elif field == 5:
            if wire == _WIRE_32BIT:
                return struct.unpack("<f", val)[0]
            if wire == _WIRE_LEN and len(val) >= 4:
                return struct.unpack("<f", val[:4])[0]
        elif field == 6:
            if wire == _WIRE_64BIT:
                return struct.unpack("<d", val)[0]
            if wire == _WIRE_LEN and len(val) >= 8:
                return struct.unpack("<d", val[:8])[0]
        elif field == 4 and wire == _WIRE_LEN and val:
            if dtype in (None, 1) and len(val) >= 4:  # DT_FLOAT
                return struct.unpack("<f", val[:4])[0]
            if dtype == 2 and len(val) >= 8:  # DT_DOUBLE
                return struct.unpack("<d", val[:8])[0]
    return None


def _parse_summary_value(buf: bytes) -> Tuple[Optional[str], Optional[float]]:
    tag = None
    value = None
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            tag = val.decode("utf-8", errors="replace")
        elif field == 2 and wire == _WIRE_32BIT:
            value = struct.unpack("<f", val)[0]
        elif field == 8 and wire == _WIRE_LEN:
            v = _parse_tensor_scalar(val)
            if v is not None:
                value = v
    return tag, value


def _parse_event(buf: bytes) -> Tuple[float, int, List[Tuple[str, float]]]:
    wall_time = 0.0
    step = 0
    scalars: List[Tuple[str, float]] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_64BIT:
            wall_time = struct.unpack("<d", val)[0]
        elif field == 2 and wire == _WIRE_VARINT:
            step = val
        elif field == 5 and wire == _WIRE_LEN:
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == _WIRE_LEN:
                    tag, value = _parse_summary_value(v2)
                    if tag is not None and value is not None:
                        scalars.append((tag, value))
    return wall_time, step, scalars


def read_tfevents(path: str) -> Iterator[Tuple[float, int, List[Tuple[str, float]]]]:
    """Yield (wall_time, step, [(tag, value)]) per event record."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        (length,) = struct.unpack("<Q", data[pos : pos + 8])
        pos += 12  # length + length-crc
        if pos + length > n:
            break
        payload = data[pos : pos + length]
        pos += length + 4  # payload + payload-crc
        try:
            yield _parse_event(payload)
        except (IndexError, struct.error):
            continue  # truncated/corrupt record


def collect_tfevent_metrics(
    directory: str,
    metric_names: Sequence[str],
) -> List[MetricLog]:
    """Walk a tfevent directory and extract the named scalars
    (tfevent_loader.py MetricsCollector.parse_file). Tag matching: exact or
    trailing path component."""
    wanted = set(metric_names)
    out: List[MetricLog] = []
    for root, _dirs, files in os.walk(directory):
        for fname in sorted(files):
            if "tfevents" not in fname:
                continue
            for wall_time, step, scalars in read_tfevents(os.path.join(root, fname)):
                for tag, value in scalars:
                    name = tag if tag in wanted else tag.rsplit("/", 1)[-1]
                    if name in wanted:
                        out.append(
                            MetricLog(
                                timestamp=wall_time or float(step),
                                metric_name=name,
                                value=repr(float(value)),
                            )
                        )
    return sorted(out, key=lambda l: l.timestamp)


# -- writer ------------------------------------------------------------------
# A trial that wants TensorBoard's output (Katib's tf-mnist-with-summaries
# writes its summaries with tf.summary) writes event files without
# TensorFlow; masked CRC32C framing, as the TFRecord format asks.

_CRC32C_TABLE = None
# unique writer file names within a process: two trial threads writing in
# the same second must not truncate each other's file
_WRITER_SEQ = itertools.count(1)


def _crc32c(data: bytes) -> int:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _write_varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # two's-complement int64, protobuf varint rule
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _encode_field(num: int, wire: int) -> bytes:
    return _write_varint((num << 3) | wire)


def _encode_len_field(num: int, payload: bytes) -> bytes:
    return _encode_field(num, _WIRE_LEN) + _write_varint(len(payload)) + payload


def encode_scalar_event(wall_time: float, step: int, scalars: Dict[str, float]) -> bytes:
    """Event proto bytes with TF1 simple_value scalars."""
    summary = b""
    for tag, value in scalars.items():
        val_msg = _encode_len_field(1, tag.encode())
        val_msg += _encode_field(2, _WIRE_32BIT) + struct.pack("<f", float(value))
        summary += _encode_len_field(1, val_msg)
    event = _encode_field(1, _WIRE_64BIT) + struct.pack("<d", wall_time)
    event += _encode_field(2, _WIRE_VARINT) + _write_varint(step)
    event += _encode_len_field(5, summary)
    return event


def write_scalar_events(
    directory: str,
    events: Sequence[Tuple[int, Dict[str, float]]],
    filename: Optional[str] = None,
) -> str:
    """Write (step, {tag: value}) sequences as one tfevents file; returns
    its path. The TfEvent collector and TensorBoard both read it."""
    import time as _time

    os.makedirs(directory, exist_ok=True)
    if filename is None:
        # time alone collides for calls in the same second (TF disambiguates
        # with hostname+pid; we also need uniqueness within a process)
        filename = (
            f"events.out.tfevents.{int(_time.time())}.{os.getpid()}."
            f"{next(_WRITER_SEQ)}.katib-tpu"
        )
    path = os.path.join(directory, filename)
    base = _time.time()
    with open(path, "wb") as f:
        for i, (step, scalars) in enumerate(events):
            payload = encode_scalar_event(base + i * 1e-3, step, scalars)
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
    return path
