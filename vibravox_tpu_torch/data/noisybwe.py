"""Noisy BWE data module: clean speech mixed with speechless noise, and real
noisy speech without a reference (PyTorch loaders).

Counterpart of ``vibravox_tpu/data/noisybwe.py`` (the reference's
``NoisyBWELightningDataModule``, ``lightning_datamodules/noisybwe.py:14-290``,
and ``SpeechNoiseDataset``, ``datasets/speech_noise.py:6-59``).  Three
subsets: clean coupled speech, speechless noise, and real noisy speech.

* Synthetic pairs (train, and the ``synthetic`` val/test loaders): each
  speech item gets a random noise item, and a random slice of it (tiled
  when shorter) is added to the body-conducted channel without rescaling;
  the batch is then cropped or padded (``BWECollate``), and augmented in
  training.  The noise item and the slice's start are drawn from
  generators keyed to ``(seed, epoch, index)``, so they hold under loader
  workers and across a resume; the JAX package draws them from stateful
  generators, a difference of random stream only.
* Real noisy speech (the ``real`` val/test loaders) has no airborne
  reference: its batches are right-padded to the longest item, and the
  task's eval step and metrics take their reference-free path.

Validation and test return ``{"synthetic": ..., "real": ...}`` loader dicts.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.data.bwe import _EpochBatches, Keyed, KeyedCollate, eval_keys
from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource, load_hf_vibravox
from vibravox_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["NoisyBWEDataModule", "SpeechNoiseSource", "NoisyBWECollate", "mix_noise"]

NOISE_KEY = "audio_body_conducted_speechless_noisy"


class SpeechNoiseSource:
    """Pairs each speech item with a noise item drawn anew each epoch
    (``speech_noise.py:51-59``), from ``default_rng((seed, epoch, index))``."""

    def __init__(self, speech_source, noise_source, seed: int = 0):
        self.speech = speech_source
        self.noise = noise_source
        self.seed = seed

    def __len__(self) -> int:
        return len(self.speech)

    def noise_index(self, idx: int, epoch: int) -> int:
        return int(np.random.default_rng((self.seed, epoch, idx)).integers(len(self.noise)))

    def keyed_item(self, idx: int, epoch: int) -> Dict[str, np.ndarray]:
        speech = self.speech[idx]
        noise = self.noise[self.noise_index(idx, epoch)]
        return {"audio_airborne": speech["audio_airborne"],
                "audio_body_conducted": speech["audio_body_conducted"], NOISE_KEY: noise[NOISE_KEY]}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.keyed_item(idx, 0)


class _SyntheticNoiseSource:
    """Speechless noise: band-limited noise bursts, longer than the speech.
    Its seed comes from the split's sha1 (the JAX package's from Python's
    ``hash``, which each process salts anew)."""

    def __init__(self, n: int, sample_rate: int, split: str, seconds: float = 8.0):
        self.n = n
        self.sample_rate = sample_rate
        self.seconds = seconds
        self.base_seed = int(hashlib.sha1(split.encode()).hexdigest(), 16) % (2**31)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.base_seed + i)
        t = int(self.seconds * self.sample_rate)
        noise = rng.standard_normal(t).astype(np.float32)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(t, 1 / self.sample_rate)
        spec *= 1.0 / (1.0 + (freqs / 1500.0) ** 2)
        return {NOISE_KEY: np.fft.irfft(spec, n=t).astype(np.float32) * 0.1}


class _Field:
    """Items of ``source`` with one field kept under another name."""

    def __init__(self, source, field: str, name: str):
        self.source, self.field, self.name = source, field, name

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {self.name: self.source[i][self.field]}


def mix_noise(speech: np.ndarray, noise: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """``speech`` plus a slice of ``noise`` (tiled when shorter) of its
    length, from a start drawn from ``rng``; no rescaling."""
    speech = np.asarray(speech, np.float32).reshape(-1)
    noise = np.asarray(noise, np.float32).reshape(-1)
    if len(noise) < len(speech):
        noise = np.tile(noise, int(np.ceil(len(speech) / len(noise))))
    start = int(rng.integers(0, len(noise) - len(speech) + 1))
    return speech + noise[start:start + len(speech)]


class NoisyBWECollate:
    """Mixes the noise into the body-conducted channel, then collates with
    ``BWECollate`` (``noisybwe.py:230-290``); items without a reference
    (real noisy speech) are only right-padded to the longest."""

    def __init__(
        self,
        sample_rate: int,
        strategy: str = "constant_length-2500-ms",
        deterministic: bool = False,
        augmentation=None,
        seed: int = 0,
    ):
        self.sample_rate = sample_rate
        self.strategy = strategy
        self.deterministic = deterministic
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._bwe_collate = BWECollate(sample_rate, strategy=strategy, deterministic=deterministic,
                                       augmentation=augmentation, seed=seed)

    @staticmethod
    def _pad_only(samples) -> Dict[str, torch.Tensor]:
        bodies = [np.asarray(s["audio_body_conducted"], np.float32).reshape(-1) for s in samples]
        longest = max(len(b) for b in bodies)
        padded = np.stack([np.pad(b, (0, longest - len(b))) for b in bodies])
        return {"audio_body_conducted": torch.from_numpy(padded[:, :, None])}

    def _mixed(self, samples, rngs):
        return [{"audio_body_conducted": mix_noise(s["audio_body_conducted"], s[NOISE_KEY], rng),
                 "audio_airborne": np.asarray(s["audio_airborne"], np.float32).reshape(-1)}
                for s, rng in zip(samples, rngs)]

    def __call__(self, samples: Sequence[Dict]) -> Dict[str, torch.Tensor]:
        """Slice starts from one generator seeded with ``seed``, in sample
        order (the JAX collate's draws)."""
        if "audio_airborne" not in samples[0]:
            return self._pad_only(samples)
        return self._bwe_collate(self._mixed(samples, [self.rng] * len(samples)))

    def keyed(self, samples: Sequence[Dict], key: Tuple[int, int],
              indices: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
        """Item i's slice start from ``default_rng((seed, epoch, index, 1))``,
        the batch's other draws keyed to ``(seed, epoch, batch)``."""
        if "audio_airborne" not in samples[0]:
            return self._pad_only(samples)
        rngs = [np.random.default_rng((self.seed, key[0], i, 1)) for i in indices]
        return self._bwe_collate.keyed(self._mixed(samples, rngs), key)


class NoisyBWEDataModule:
    """``dataset_name``: ``synthetic`` or a hub name (map-style only: the
    noise pairing draws items by index).  ``device`` as for
    ``BWEDataModule``; ``id`` names the run."""

    def __init__(
        self,
        sample_rate: int = 16000,
        dataset_name: str = "synthetic",
        sensor: str = "rigid_in_ear_microphone",
        collate_strategy: str = "constant_length-2500-ms",
        streaming: bool = False,
        batch_size: int = 32,
        num_workers: int = 4,
        data_augmentation=None,
        synthetic_size: int = 16,
        seed: int = 42,
        id: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if streaming:
            raise NotImplementedError(
                "noisy BWE pairs speech with noise items by index, which a streaming source has not; "
                "use streaming=False")
        self.sample_rate = sample_rate
        self.dataset_name = dataset_name
        self.sensor = sensor
        self.id = id
        self.collate_strategy = collate_strategy
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.data_augmentation = data_augmentation
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.device = resolve_device(device)
        self._sources: Dict[str, object] = {}

    def _hub(self, subset: str, split: str, reference: bool):
        return load_hf_vibravox(self.dataset_name, subset, split, self.sensor, self.sample_rate,
                                reference_sensor="headset_microphone" if reference else None)

    def _speech_source(self, split: str):
        if self.dataset_name == "synthetic":
            return SyntheticVibravoxSource(n_utterances=self.synthetic_size, sample_rate=self.sample_rate,
                                           split=f"speech_clean-{split}")
        return self._hub("speech_clean", split, reference=True)

    def _noise_source(self, split: str):
        if self.dataset_name == "synthetic":
            return _SyntheticNoiseSource(max(4, self.synthetic_size // 2), self.sample_rate, f"noise-{split}")
        return _Field(self._hub("speechless_noisy", split, reference=False), "audio_body_conducted", NOISE_KEY)

    def _real_noisy_source(self, split: str):
        if self.dataset_name == "synthetic":
            source = SyntheticVibravoxSource(n_utterances=max(2, self.synthetic_size // 2),
                                             sample_rate=self.sample_rate, split=f"speech_noisy-{split}")
        else:
            source = self._hub("speech_noisy", split, reference=False)
        return _Field(source, "audio_body_conducted", "audio_body_conducted")

    def setup(self, stage: str = "fit") -> None:
        if stage in ("fit", "validate"):
            if stage == "fit" and "train" not in self._sources:
                self._sources["train"] = SpeechNoiseSource(
                    self._speech_source("train"), self._noise_source("train"), self.seed)
            if "val_synth" not in self._sources:
                self._sources["val_synth"] = SpeechNoiseSource(
                    self._speech_source("validation"), self._noise_source("validation"), self.seed + 1)
                self._sources["val_real"] = self._real_noisy_source("validation")
        if stage == "test":
            self._sources["test_synth"] = SpeechNoiseSource(
                self._speech_source("test"), self._noise_source("test"), self.seed + 2)
            self._sources["test_real"] = self._real_noisy_source("test")

    def _collate(self, deterministic: bool) -> NoisyBWECollate:
        return NoisyBWECollate(self.sample_rate, self.collate_strategy, deterministic,
                               augmentation=None if deterministic else self.data_augmentation, seed=self.seed)

    def _loader(self, source, keys, train: bool) -> torch.utils.data.DataLoader:
        return torch.utils.data.DataLoader(
            Keyed(source), batch_sampler=keys, num_workers=self.num_workers,
            persistent_workers=train and self.num_workers > 0,
            collate_fn=KeyedCollate(self._collate(deterministic=not train)),
            pin_memory=self.device.type == "cuda")

    def train_dataloader(self) -> torch.utils.data.DataLoader:
        """Its ``batch_sampler.set_epoch(epoch)`` keys the next pass's
        shuffle, noise pairing, slices and crops to the trainer's epoch."""
        source = self._sources["train"]
        return self._loader(source, _EpochBatches(len(source), self.batch_size, self.seed), train=True)

    def _eval_loaders(self, prefix: str) -> Dict[str, torch.utils.data.DataLoader]:
        return {name: self._loader(source, eval_keys(len(source)), train=False)
                for name, source in (("synthetic", self._sources[f"{prefix}_synth"]),
                                     ("real", self._sources[f"{prefix}_real"]))}

    def val_dataloader(self) -> Dict[str, torch.utils.data.DataLoader]:
        return self._eval_loaders("val")

    def test_dataloader(self) -> Dict[str, torch.utils.data.DataLoader]:
        return self._eval_loaders("test")
