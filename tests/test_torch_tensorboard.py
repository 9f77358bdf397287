"""PyTorch port: the TensorBoard event writer and reader (no JAX).

``TensorBoardLogger`` writes event files itself (TFRecord framing, masked
CRC-32C, protocol buffers by hand).  With the clock and the host name
pinned, the same scalar, audio and text calls give the bytes that
tensorboardX 2.6.4 writes (skipped where tensorboardX is absent; the port
never imports it).  ``read_events`` reads them back and refuses a record
whose checksum is wrong; a rank other than 0 writes no file; and the CLI's
default ``logging: tensorboard`` writes on the CPU an event file whose
scalars are the trainer's, step by step, with its validation audio as WAV
at the run's rate.
"""

import io
import socket
import time
import wave

import numpy as np
import pytest
import torch

from vibravox_tpu_torch.core import logging as tb
from vibravox_tpu_torch.core.logging import TensorBoardLogger, crc32c, read_events
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

NOW, HOST = 1700000000.25, "host-a"


@pytest.fixture()
def pinned(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(socket, "gethostname", lambda: HOST)


def _calls(scalar, audio, text):
    """The logger's calls: scalars (one a zero, one a tag tensorboardX
    cleans, a negative step), clipped and empty audio, unicode and empty
    text."""
    scalar("train/loss", 0.5, 3)
    scalar("train/zero", 0.0, 0)
    scalar("a b/c!", -1e30, 7)
    scalar("validation/stoi/real", 0.875, -5)
    audio("validation_0/enhanced", np.sin(np.arange(1600) / 7.0) * 1.2, 4, 16000)
    audio("validation_0/empty", np.zeros(0, np.float32), 4, 24000)
    text("description", "EBEN(M=4) || héllo\nworld", 2)
    text("model_summary", "", 0)


def _ours(directory):
    logger = TensorBoardLogger(save_dir=str(directory))
    _calls(lambda k, v, s: logger.log_scalars({k: v}, s), logger.log_audio, logger.log_text)
    logger.close()
    return logger.path


def test_bytes_equal_tensorboardx(tmp_path, pinned):
    tensorboardX = pytest.importorskip("tensorboardX")
    from tensorboardX.proto.summary_pb2 import Summary

    writer = tensorboardX.SummaryWriter(logdir=str(tmp_path / "tbx"))

    def audio(tag, samples, step, rate):
        # the WAV the port encodes, in tensorboardX's own Summary.Audio
        wav, frames = tb._wav_pcm16(samples, rate)
        value = Summary.Audio(sample_rate=rate, num_channels=1, length_frames=frames,
                              encoded_audio_string=wav, content_type="audio/wav")
        writer._get_file_writer().add_summary(Summary(value=[Summary.Value(tag=tag, audio=value)]), step)

    _calls(lambda k, v, s: writer.add_scalar(k, v, s), audio, writer.add_text)
    writer.close()
    (want,) = (tmp_path / "tbx").iterdir()
    got = _ours(tmp_path / "ours")
    assert got.name == want.name == f"events.out.tfevents.{str(NOW)[:10]}.{HOST}"
    assert got.read_bytes() == want.read_bytes()


def test_read_events_round_trips(tmp_path, pinned):
    events = read_events(_ours(tmp_path))
    assert events[0] == {"wall_time": NOW, "step": 0, "file_version": "brain.Event:2"}
    values = [(e["step"], v) for e in events[1:] for v in e["values"]]
    assert [(s, v["tag"], v["simple_value"]) for s, v in values[:4]] == [
        (3, "train/loss", 0.5), (0, "train/zero", 0.0), (7, "a_b/c_", np.float32(-1e30)),
        (-5, "validation/stoi/real", 0.875)]
    for (step, v), rate, frames in zip(values[4:6], (16000, 24000), (1600, 0)):
        a = v["audio"]
        assert (step, a["sample_rate"], a["num_channels"], a["length_frames"], a["content_type"]) == (
            4, rate, 1, frames, "audio/wav")
        with wave.open(io.BytesIO(a["encoded_audio_string"])) as w:
            assert (w.getframerate(), w.getnchannels(), w.getsampwidth(), w.getnframes()) == (rate, 1, 2, frames)
            pcm = np.frombuffer(w.readframes(frames), "<i2")
    # float32 samples, clipped to [-1, 1], scaled by 32767 and truncated
    want = (np.clip((np.sin(np.arange(1600) / 7.0) * 1.2).astype(np.float32), -1, 1) * 32767).astype("<i2")
    assert pcm.size == 0 and np.array_equal(
        np.frombuffer(values[4][1]["audio"]["encoded_audio_string"][44:], "<i2"), want)
    texts = [(s, v["tag"], v["text"], v["plugin_name"], v["tensor"]["shape"]) for s, v in values[6:]]
    assert texts == [(2, "description/text_summary", "EBEN(M=4) || héllo\nworld", "text", [1]),
                     (0, "model_summary/text_summary", "", "text", [1])]


def test_crc32c_check_value():
    assert crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    assert crc32c(b"") == 0


@pytest.mark.parametrize("where", ["length_crc", "data", "data_crc", "truncated"])
def test_read_events_refuses_a_damaged_record(tmp_path, pinned, where):
    path = _ours(tmp_path)
    data = bytearray(path.read_bytes())
    n = int.from_bytes(data[:8], "little")  # the first record: 12 + n + 4 bytes
    if where == "truncated":
        data = data[:-3]
    else:
        data[{"length_crc": 9, "data": 12 + n // 2, "data_crc": 12 + n + 1}[where]] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum|truncated"):
        read_events(path)


def test_other_ranks_write_no_file(tmp_path, monkeypatch):
    monkeypatch.setattr(tb, "process_index", lambda: 1)
    logger = TensorBoardLogger(save_dir=str(tmp_path / "tb"))
    logger.log_scalars({"train/loss": 1.0}, 0)
    logger.log_audio("a", np.zeros(8), 0, 16000)
    logger.log_text("t", "x")
    logger.flush()
    logger.close()
    assert logger.path is None and not (tmp_path / "tb").exists()


def test_flush_writes_what_is_buffered(tmp_path):
    logger = TensorBoardLogger(save_dir=str(tmp_path))
    logger.log_scalars({"train/a": 1.0, "train/b": 2.0}, 5)
    logger.flush()
    assert [v["tag"] for e in read_events(logger.path)[1:] for v in e["values"]] == ["train/a", "train/b"]
    logger.close()


def test_cli_default_logging_writes_the_trainers_scalars(tmp_path, monkeypatch):
    """``run.main`` without a ``logging=`` override: the event file under
    ``run_dir/tensorboard`` holds every scalar the trainer logged, at its
    step, and the validation audio at 16 kHz."""
    from vibravox_tpu_torch.core.loop import Trainer
    from vibravox_tpu_torch.run import main

    logged = []
    log = Trainer._log

    def recording(self, scalars):
        logged.append((self.global_step, dict(scalars)))
        return log(self, scalars)

    monkeypatch.setattr(Trainer, "_log", recording)
    main(["lightning_datamodule=bwe", "lightning_module=eben", "lightning_datamodule.dataset_name_principal=synthetic",
          "~lightning_datamodule.data_augmentation", "++lightning_datamodule.synthetic_size=4",
          "++lightning_datamodule.batch_size=2", "++lightning_datamodule.num_workers=0",
          "++lightning_datamodule.collate_strategy=constant_length-500-ms", "++trainer.limit_val_batches=1",
          "++trainer.limit_test_batches=1", "++trainer.max_epochs=1", "++lightning_module.compute_dtype=null",
          "++lightning_module.discriminator.min_channels=8", f"++run_dir={tmp_path}", "++device=cpu"])
    (path,) = (tmp_path / "tensorboard").iterdir()
    events = read_events(path)
    scalars = [(e["step"], v["tag"], v["simple_value"]) for e in events[1:] for v in e["values"]
               if "simple_value" in v]
    want = [(step, k, float(np.float32(v))) for step, d in logged for k, v in d.items()]
    assert scalars == want
    tags = {t for _, t, _ in scalars}
    assert any(t.startswith("train/") for t in tags) and any(t.startswith("validation/") for t in tags)
    audio = [v for e in events[1:] for v in e["values"] if "audio" in v]
    assert audio and all(v["audio"]["sample_rate"] == 16000 for v in audio)
    for v in audio:
        with wave.open(io.BytesIO(v["audio"]["encoded_audio_string"])) as w:
            assert w.getframerate() == 16000 and w.getnframes() == v["audio"]["length_frames"] > 0
    assert any(v["tag"] == "description/text_summary" for e in events[1:] for v in e["values"])
