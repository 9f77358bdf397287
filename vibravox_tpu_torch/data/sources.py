"""Audio data sources: synthetic data, npz directories and the HF hub.

The port's own copy of ``vibravox_tpu/data/sources.py``.  Each source gives
utterances, dicts of 1-D float32 numpy arrays (and metadata):

* ``SyntheticVibravoxSource``, the stand-in for the reference CI's
  miniature ``vibravox-test`` dataset: the same numbers for the same seed,
  split and index as the JAX package's;
* ``NpzDirectorySource``, one ``*.npz`` file per utterance, for clusters
  without the hub;
* ``load_hf_vibravox``, the reference's HF ``datasets`` path
  (``lightning_datamodules/bwe.py:104-144``): a map-style ``_HFSource``, or
  with ``streaming=True`` an ``_HFIterableSource`` with no length, which the
  data module batches through a shuffle buffer.  A stream's rows stay
  encoded (``rows``) until ``decode`` turns one into an utterance, so a
  loader worker decodes only the rows of the batches it collates.  ``datasets`` is imported
  when it is called, and its absence raises an error that names it.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = [
    "SENSORS",
    "AudioPairSource",
    "SyntheticVibravoxSource",
    "NpzDirectorySource",
    "load_hf_vibravox",
]

# the six body-conduction sensors + the airborne reference mic
SENSORS = (
    "headset_microphone",
    "throat_microphone",
    "soft_in_ear_microphone",
    "rigid_in_ear_microphone",
    "forehead_accelerometer",
    "temple_vibration_pickup",
)


class AudioPairSource:
    """Map-style source of utterances: dicts of 1-D float32 numpy arrays."""

    sample_rate: int

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]


class SyntheticVibravoxSource(AudioPairSource):
    """Deterministic speech-like synthetic data with coupled sensor pairs.

    The 'airborne' signal is a harmonic-rich amplitude-modulated tone stack
    plus noise; the 'body_conducted' signal is a low-passed, attenuated
    version of the same — reproducing the BWE problem structure (and the
    cross-sensor time alignment that the reference's datamodule tests check
    by cross-correlation).
    """

    def __init__(
        self,
        n_utterances: int = 16,
        sample_rate: int = 16000,
        min_seconds: float = 2.0,
        max_seconds: float = 6.0,
        seed: int = 0,
        split: str = "train",
        with_metadata: bool = False,
    ):
        self.sample_rate = sample_rate
        self.n = n_utterances
        self.min_seconds = min_seconds
        self.max_seconds = max_seconds
        self.with_metadata = with_metadata
        # distinct streams per split so train/val/test differ deterministically
        self.base_seed = seed * 1000 + int(
            hashlib.sha1(split.encode()).hexdigest(), 16
        ) % 997

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.base_seed + idx)
        sr = self.sample_rate
        seconds = rng.uniform(self.min_seconds, self.max_seconds)
        t = np.arange(int(seconds * sr)) / sr
        f0 = rng.uniform(90, 220)
        # voiced harmonic stack with slow AM envelope (speech-ish)
        envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t + rng.uniform(0, 6)))
        airborne = np.zeros_like(t)
        for h in range(1, 24):
            if f0 * h > sr / 2 * 0.95:
                break
            airborne += np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / (h**0.8)
        airborne = airborne * envelope + 0.02 * rng.standard_normal(len(t))
        airborne = (airborne / (np.abs(airborne).max() + 1e-9) * 0.5).astype(np.float32)

        # body-conducted: low-pass via FFT mask + slight gain loss + noise
        spec = np.fft.rfft(airborne)
        freqs = np.fft.rfftfreq(len(airborne), 1 / sr)
        cutoff = 700.0
        mask = 1.0 / (1.0 + (freqs / cutoff) ** 4)
        body = np.fft.irfft(spec * mask, n=len(airborne)).astype(np.float32)
        body = body + 0.005 * rng.standard_normal(len(t)).astype(np.float32)

        item = {"audio_airborne": airborne, "audio_body_conducted": body}
        if self.with_metadata:
            item["speaker_id"] = str(idx % 4)
            item["sentence_id"] = int(idx)
            item["gender"] = "male" if (idx % 2) else "female"
        return item


class NpzDirectorySource(AudioPairSource):
    """Reads ``*.npz`` files, in name order, each holding one utterance's
    field arrays."""

    def __init__(self, directory: str, sample_rate: int = 16000):
        self.files: List[Path] = sorted(Path(directory).glob("*.npz"))
        if not self.files:
            raise FileNotFoundError(f"no .npz utterances under {directory}")
        self.sample_rate = sample_rate

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        with np.load(self.files[idx], allow_pickle=True) as f:
            return {k: f[k] for k in f.files}


def _convert_row(row: Dict, rename: Dict[str, str]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for src, dst in rename.items():
        cell = row[src]
        if isinstance(cell, dict) and "array" in cell:
            out[dst] = np.asarray(cell["array"], dtype=np.float32)
        else:
            out[dst] = cell
    for key in ("speaker_id", "sentence_id", "gender", "phonemized_text"):
        if key in row:
            out[key] = row[key]
    return out


class _HFSource(AudioPairSource):
    def __init__(self, hf_dataset, rename: Dict[str, str], sample_rate: int):
        self.ds = hf_dataset
        self.rename = rename
        self.sample_rate = sample_rate

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return _convert_row(self.ds[idx], self.rename)


class _HFIterableSource(AudioPairSource):
    """Source over an HF ``IterableDataset`` (the ``streaming=True`` path,
    ref ``bwe.py:108``): no length and no random access.  Its audio columns
    are cast with ``decode=False``; ``decode`` decodes a row's cells with
    ``audio`` (the ``datasets.Audio`` feature at ``sample_rate``), and
    passes a cell that already holds an ``array`` through."""

    def __init__(self, hf_dataset, rename: Dict[str, str], sample_rate: int, audio=None):
        self.ds = hf_dataset
        self.rename = rename
        self.sample_rate = sample_rate
        self.audio = audio

    def __len__(self) -> int:  # type: ignore[override]
        raise TypeError("streaming source has no length")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raise TypeError("streaming source has no random access")

    def rows(self) -> Iterator[Dict]:
        """The stream's rows, their audio still encoded."""
        return iter(self.ds)

    def decode(self, row: Dict) -> Dict[str, np.ndarray]:
        row = dict(row)
        for col in self.rename:
            cell = row[col]
            if not (isinstance(cell, dict) and "array" in cell):
                row[col] = {"array": self.audio.decode_example(cell)["array"]}
        return _convert_row(row, self.rename)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for row in self.rows():
            yield self.decode(row)


def load_hf_vibravox(
    dataset_name: str,
    subset: str,
    split: str,
    sensor: str,
    sample_rate: int,
    streaming: bool = False,
    reference_sensor: Optional[str] = "headset_microphone",
) -> AudioPairSource:
    """The hub's ``dataset_name`` / ``subset`` / ``split``: the ``sensor``
    column as ``audio_body_conducted`` and ``reference_sensor``'s as
    ``audio_airborne``, resampled to ``sample_rate`` when decoded."""
    try:
        import datasets as hfd
    except ImportError as e:
        raise ImportError(
            f"reading {dataset_name!r} from the hub needs the 'datasets' package; use "
            "dataset_name_principal=synthetic or a directory of .npz utterances without it") from e

    ds = hfd.load_dataset(dataset_name, subset, split=split, streaming=streaming)
    rename = {f"audio.{sensor}": "audio_body_conducted"}
    if reference_sensor:
        rename[f"audio.{reference_sensor}"] = "audio_airborne"
    keep = set(rename) | {"speaker_id", "sentence_id", "gender", "phonemized_text"}
    # an IterableDataset may not know its columns up front; row conversion
    # only reads the kept keys, so skipping the removal is harmless there
    cols = ds.column_names
    if cols:
        ds = ds.remove_columns([c for c in cols if c not in keep])
    for col in rename:
        # a stream's rows are decoded by the loader worker that collates them
        ds = ds.cast_column(col, hfd.Audio(sampling_rate=sample_rate, decode=not streaming))
    if streaming:
        return _HFIterableSource(ds, rename, sample_rate, hfd.Audio(sampling_rate=sample_rate))
    return _HFSource(ds, rename, sample_rate)
