"""Experiment logging: TensorBoard and CSV writers.

The port's copy of ``vibravox_tpu/core/logging.py`` (numpy and the stdlib).
Config-selected like the reference (``configs/logging/{tensorboard,csv}.yaml``)
with the same surface the tasks rely on: scalars (namespaced
``stage/metric/dataloader``), audio samples, and free text.
``TensorBoardLogger`` writes TensorBoard's event files itself: TFRecord
framing with masked CRC-32C checksums around ``Event`` protocol buffers
encoded by hand, byte for byte what tensorboardX 2.6.4 writes for the same
calls.  ``read_events`` reads such a file back, checking every checksum.
In a multi-process run the writers write on rank 0 only: on the other
ranks they are made inert and create no file.
"""

from __future__ import annotations

import csv
import io
import re
import socket
import struct
import time
import wave
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vibravox_tpu_torch.parallel.distributed import process_index

__all__ = ["Logger", "TensorBoardLogger", "CSVLogger", "MultiLogger", "NoOpLogger", "read_events",
           "crc32c"]


class Logger:
    """Abstract logger interface."""

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int) -> None:
        pass

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class NoOpLogger(Logger):
    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        pass


# ---------------------------------------------------------------------------
# TensorBoard event files
# ---------------------------------------------------------------------------

# CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), one table entry per byte
_CRC_TABLE = []
for _byte in range(256):
    _crc = _byte
    for _ in range(8):
        _crc = (_crc >> 1) ^ (0x82F63B78 if _crc & 1 else 0)
    _CRC_TABLE.append(_crc)
del _byte, _crc


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked checksum: rotate right by 15, add a constant."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _record(data: bytes) -> bytes:
    """One TFRecord: uint64 length, masked crc of the length, the data,
    masked crc of the data (all little-endian)."""
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", _masked_crc(length)) + data + struct.pack("<I", _masked_crc(data))


# Field numbers of tensorboardX 2.6.4's proto files (tensorboardX/proto/):
# event.proto ``Event``; summary.proto ``Summary``, ``Summary.Value``,
# ``Summary.Audio``, ``SummaryMetadata`` and its ``PluginData``;
# tensor.proto ``TensorProto``; tensor_shape.proto ``TensorShapeProto`` and
# its ``Dim``; plugin_text.proto ``TextPluginData``; types.proto ``DT_STRING``.
EVENT_WALL_TIME, EVENT_STEP, EVENT_FILE_VERSION, EVENT_SUMMARY = 1, 2, 3, 5
SUMMARY_VALUE = 1
VALUE_TAG, VALUE_SIMPLE_VALUE, VALUE_AUDIO, VALUE_TENSOR, VALUE_METADATA = 1, 2, 6, 8, 9
AUDIO_SAMPLE_RATE, AUDIO_NUM_CHANNELS, AUDIO_LENGTH_FRAMES, AUDIO_ENCODED, AUDIO_CONTENT_TYPE = 1, 2, 3, 4, 5
METADATA_PLUGIN_DATA, PLUGIN_NAME, PLUGIN_CONTENT = 1, 1, 2
TENSOR_DTYPE, TENSOR_SHAPE, TENSOR_STRING_VAL = 1, 2, 8
SHAPE_DIM, DIM_SIZE = 2, 1
DT_STRING = 7

_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64s take ten bytes, as protobuf writes them
    out = bytearray()
    while True:
        low = n & 0x7F
        n >>= 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int_field(field: int, n: int) -> bytes:
    """A proto3 integer field: left out when 0, as protobuf does."""
    return _key(field, _VARINT) + _varint(n) if n else b""


def _bytes_field(field: int, data: bytes, always: bool = False) -> bytes:
    """A length-delimited field; a proto3 empty string is left out unless it
    is a set member of a oneof or a message (``always``)."""
    if not data and not always:
        return b""
    return _key(field, _BYTES) + _varint(len(data)) + data


def _event(wall_time: float, step: int = 0, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    out = _key(EVENT_WALL_TIME, _FIXED64) + struct.pack("<d", wall_time) if wall_time else b""
    out += _int_field(EVENT_STEP, step)
    if file_version is not None:
        out += _bytes_field(EVENT_FILE_VERSION, file_version.encode(), always=True)
    if summary is not None:
        out += _bytes_field(EVENT_SUMMARY, summary, always=True)
    return out


def _summary(*values: bytes) -> bytes:
    return b"".join(_bytes_field(SUMMARY_VALUE, v, always=True) for v in values)


# tensorboardX's summary._clean_tag: characters outside [-/\w.] become "_",
# leading slashes go
_INVALID_TAG = re.compile(r"[^-/\w\.]")


def _scalar_value(tag: str, value: float) -> bytes:
    tag = _INVALID_TAG.sub("_", tag).lstrip("/")
    return (_bytes_field(VALUE_TAG, tag.encode())
            + _key(VALUE_SIMPLE_VALUE, _FIXED32) + struct.pack("<f", value))


def _audio_value(tag: str, wav: bytes, sample_rate: int, frames: int) -> bytes:
    audio = (_key(AUDIO_SAMPLE_RATE, _FIXED32) + struct.pack("<f", sample_rate) if sample_rate else b"")
    audio += _int_field(AUDIO_NUM_CHANNELS, 1) + _int_field(AUDIO_LENGTH_FRAMES, frames)
    audio += _bytes_field(AUDIO_ENCODED, wav) + _bytes_field(AUDIO_CONTENT_TYPE, b"audio/wav")
    return _bytes_field(VALUE_TAG, tag.encode()) + _bytes_field(VALUE_AUDIO, audio, always=True)


def _text_value(tag: str, text: str) -> bytes:
    """tensorboardX's ``summary.text``: the text plugin's metadata (an empty
    ``TextPluginData(version=0)``) and a DT_STRING tensor of shape [1]."""
    shape = _bytes_field(SHAPE_DIM, _int_field(DIM_SIZE, 1), always=True)
    tensor = (_int_field(TENSOR_DTYPE, DT_STRING) + _bytes_field(TENSOR_SHAPE, shape, always=True)
              + _bytes_field(TENSOR_STRING_VAL, text.encode("utf-8"), always=True))
    plugin = _bytes_field(PLUGIN_NAME, b"text")  # content: TextPluginData(version=0) is empty
    metadata = _bytes_field(METADATA_PLUGIN_DATA, plugin, always=True)
    return (_bytes_field(VALUE_TAG, f"{tag}/text_summary".encode())
            + _bytes_field(VALUE_TENSOR, tensor, always=True)
            + _bytes_field(VALUE_METADATA, metadata, always=True))


def _wav_pcm16(audio: np.ndarray, sample_rate: int) -> tuple:
    """Mono PCM16 WAV bytes of ``audio`` clipped to [-1, 1], and its frames."""
    samples = np.asarray(audio, dtype=np.float32).reshape(-1)
    pcm = (np.clip(samples, -1.0, 1.0) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue(), len(samples)


class TensorBoardLogger(Logger):
    """TensorBoard event writer (``configs/logging/tensorboard.yaml``).

    One file ``events.out.tfevents.<10-digit time>.<hostname>`` in
    ``save_dir`` (tensorboardX's name), opened when the logger is made and
    led by the ``file_version`` event; then one event per scalar, per audio
    clip and per text.  ``flush`` writes out what is buffered."""

    def __init__(self, save_dir: str = "tensorboard/", log_every_n_steps: int = 100):
        self.log_every_n_steps = log_every_n_steps
        self._file = None
        self.path: Optional[Path] = None
        if process_index() == 0:
            directory = Path(save_dir)
            directory.mkdir(parents=True, exist_ok=True)
            self.path = directory / f"events.out.tfevents.{str(time.time())[:10]}.{socket.gethostname()}"
            self._file = open(self.path, "wb")
            self._file.write(_record(_event(time.time(), file_version="brain.Event:2")))

    def _write(self, value: bytes, step: int) -> None:
        self._file.write(_record(_event(time.time(), int(step), _summary(value))))

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self._file is None:
            return
        for key, value in scalars.items():
            self._write(_scalar_value(key, float(value)), step)

    def log_audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int) -> None:
        if self._file is None:
            return
        wav, frames = _wav_pcm16(audio, sample_rate)
        self._write(_audio_value(tag, wav, sample_rate, frames), step)

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        if self._file is not None:
            self._write(_text_value(tag, text), step)

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def _fields(data: bytes) -> List[tuple]:
    """(field, wire type, value) of one protocol buffer message: an int for
    a varint, the raw bytes of a fixed or length-delimited field."""
    out, pos = [], 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(data, pos)
        elif wire == _FIXED64:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire == _FIXED32:
            value, pos = data[pos:pos + 4], pos + 4
        elif wire == _BYTES:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported wire type {wire} of field {field}")
        if pos > len(data):
            raise ValueError("truncated protocol buffer")
        out.append((field, wire, value))
    return out


def _read_varint(data: bytes, pos: int) -> tuple:
    shift = n = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def _decode_value(data: bytes) -> Dict[str, object]:
    value: Dict[str, object] = {}
    for field, _, raw in _fields(data):
        if field == VALUE_TAG:
            value["tag"] = raw.decode("utf-8")
        elif field == VALUE_SIMPLE_VALUE:
            value["simple_value"] = struct.unpack("<f", raw)[0]
        elif field == VALUE_AUDIO:
            audio = {"sample_rate": 0.0, "num_channels": 0, "length_frames": 0,
                     "encoded_audio_string": b"", "content_type": ""}
            for f, _, v in _fields(raw):
                if f == AUDIO_SAMPLE_RATE:
                    audio["sample_rate"] = struct.unpack("<f", v)[0]
                elif f == AUDIO_NUM_CHANNELS:
                    audio["num_channels"] = v
                elif f == AUDIO_LENGTH_FRAMES:
                    audio["length_frames"] = v
                elif f == AUDIO_ENCODED:
                    audio["encoded_audio_string"] = v
                elif f == AUDIO_CONTENT_TYPE:
                    audio["content_type"] = v.decode("utf-8")
            value["audio"] = audio
        elif field == VALUE_TENSOR:
            tensor: Dict[str, object] = {"dtype": 0, "shape": [], "string_val": []}
            for f, _, v in _fields(raw):
                if f == TENSOR_DTYPE:
                    tensor["dtype"] = v
                elif f == TENSOR_SHAPE:
                    tensor["shape"] = [dict((g, s) for g, _, s in _fields(dim)).get(DIM_SIZE, 0)
                                       for g, _, dim in _fields(v) if g == SHAPE_DIM]
                elif f == TENSOR_STRING_VAL:
                    tensor["string_val"].append(v)
            value["tensor"] = tensor
        elif field == VALUE_METADATA:
            plugin = dict((f, v) for f, _, v in _fields(raw)).get(METADATA_PLUGIN_DATA, b"")
            parts = dict((f, v) for f, _, v in _fields(plugin))
            value["plugin_name"] = parts.get(PLUGIN_NAME, b"").decode("utf-8")
            value["plugin_content"] = parts.get(PLUGIN_CONTENT, b"")
    if "tensor" in value and value.get("plugin_name") == "text":
        value["text"] = b"".join(value["tensor"]["string_val"]).decode("utf-8")
    return value


def read_events(path) -> List[Dict[str, object]]:
    """The events of one event file, in order: ``{"wall_time", "step"}``
    with ``"file_version"`` or ``"values"`` (each value a dict with
    ``tag`` and ``simple_value``, ``audio`` or ``tensor``; text values also
    carry ``text``).  Raises ``ValueError`` on a record whose length or
    data checksum is wrong, or a truncated file."""
    data = Path(path).read_bytes()
    events, pos = [], 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"truncated record header at byte {pos}")
        length = data[pos:pos + 8]
        if struct.unpack("<I", data[pos + 8:pos + 12])[0] != _masked_crc(length):
            raise ValueError(f"bad length checksum at byte {pos}")
        n = struct.unpack("<Q", length)[0]
        body = data[pos + 12:pos + 12 + n]
        crc = data[pos + 12 + n:pos + 16 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated record at byte {pos}")
        if struct.unpack("<I", crc)[0] != _masked_crc(body):
            raise ValueError(f"bad data checksum at byte {pos}")
        pos += 16 + n
        event: Dict[str, object] = {"wall_time": 0.0, "step": 0}
        for field, _, raw in _fields(body):
            if field == EVENT_WALL_TIME:
                event["wall_time"] = struct.unpack("<d", raw)[0]
            elif field == EVENT_STEP:
                event["step"] = raw - (1 << 64) if raw >= 1 << 63 else raw
            elif field == EVENT_FILE_VERSION:
                event["file_version"] = raw.decode("utf-8")
            elif field == EVENT_SUMMARY:
                event["values"] = [_decode_value(v) for f, _, v in _fields(raw) if f == SUMMARY_VALUE]
        events.append(event)
    return events


class CSVLogger(Logger):
    """Append-only metrics.csv (``configs/logging/csv.yaml``); the SPKV eval
    path reads results from here like the reference README instructs."""

    def __init__(self, save_dir: str = "csv/", log_every_n_steps: int = 100):
        self.dir = Path(save_dir)
        self._writer = process_index() == 0
        if self._writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.csv"
        self.log_every_n_steps = log_every_n_steps
        self._fieldnames = ["step"]
        self._rows = []

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        row = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        for k in row:
            if k not in self._fieldnames:
                self._fieldnames.append(k)
        self._rows.append(row)
        self.flush()

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        if self._writer:
            (self.dir / f"{tag.replace('/', '_')}.txt").write_text(text)

    def flush(self) -> None:
        if not self._writer:
            return
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            writer.writerows(self._rows)


class MultiLogger(Logger):
    def __init__(self, *loggers: Logger):
        self.loggers = [l for l in loggers if l is not None]

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for l in self.loggers:
            l.log_scalars(scalars, step)

    def log_audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int) -> None:
        for l in self.loggers:
            l.log_audio(tag, audio, step, sample_rate)

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        for l in self.loggers:
            l.log_text(tag, text, step)

    def flush(self) -> None:
        for l in self.loggers:
            l.flush()

    def close(self) -> None:
        for l in self.loggers:
            l.close()
