"""Experiment logging: TensorBoard and CSV writers.

The port's copy of ``vibravox_tpu/core/logging.py`` (numpy only).
Config-selected like the reference (``configs/logging/{tensorboard,csv}.yaml``)
with the same surface the tasks rely on: scalars (namespaced
``stage/metric/dataloader``), audio samples, and free text.
``TensorBoardLogger`` imports ``tensorboardX`` when it is made, and raises
``ImportError`` where that package is missing; use ``logging=csv`` there.
In a multi-process run the writers write on rank 0 only: on the other
ranks they are made inert and create no file.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from vibravox_tpu_torch.parallel.distributed import process_index

__all__ = ["Logger", "TensorBoardLogger", "CSVLogger", "MultiLogger", "NoOpLogger"]


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


class TensorBoardLogger(Logger):
    """tensorboardX event writer (``configs/logging/tensorboard.yaml``)."""

    def __init__(self, save_dir: str = "tensorboard/", log_every_n_steps: int = 100):
        from tensorboardX import SummaryWriter

        self.log_every_n_steps = log_every_n_steps
        self.writer = None
        if process_index() == 0:
            Path(save_dir).mkdir(parents=True, exist_ok=True)
            self.writer = SummaryWriter(logdir=str(save_dir))

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self.writer is None:
            return
        for key, value in scalars.items():
            self.writer.add_scalar(key, float(value), step)

    def log_audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int) -> None:
        if self.writer is None:
            return
        # encode PCM16 WAV with the stdlib (tensorboardX's own encoder needs
        # the optional soundfile dependency) and emit the summary proto directly
        import io
        import wave

        from tensorboardX.proto.summary_pb2 import Summary

        samples = np.asarray(audio, dtype=np.float32).reshape(-1)
        pcm = (np.clip(samples, -1.0, 1.0) * 32767).astype("<i2")
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())
        proto = Summary.Audio(
            sample_rate=sample_rate,
            num_channels=1,
            length_frames=len(samples),
            encoded_audio_string=buf.getvalue(),
            content_type="audio/wav",
        )
        self.writer._get_file_writer().add_summary(
            Summary(value=[Summary.Value(tag=tag, audio=proto)]), step
        )

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        if self.writer is not None:
            self.writer.add_text(tag, text, step)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


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
