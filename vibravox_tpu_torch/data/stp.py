"""STP (speech-to-phoneme) data module (PyTorch loaders).

Counterpart of ``vibravox_tpu/data/stp.py`` (the reference's
``STPLightningDataModule``, ``lightning_datamodules/stp.py:11-261``): one
sensor's audio and its phonemised text, normalised by the feature
extractor, padded to the longest with ``pad_to_multiple_of``, labels
tokenised and set to -100 where padded, optional augmentation in training.

* ``SyntheticSTPSource``: the synthetic source's body-conducted audio and
  pseudo phoneme strings, the JAX source's numbers;
* ``STPCollate``: the JAX collate's arrays, byte for byte, plus the audio
  padded to a multiple of ``audio_bucket_samples`` (32000); its
  augmentation draws are keyed as the BWE collate's (``keyed``);
  ``phonemes_str`` stays a list of strings, which the trainer keeps on the
  host;
* ``STPDataModule``: ``synthetic`` or a hub name (``load_hf_vibravox`` with
  no reference sensor; ``streaming=True`` gives a stream), loaded by the
  BWE module's loaders (``data/bwe.py::make_loader``): the epoch-keyed
  shuffle in training, validation at ``batch_size`` and test at batch 1,
  in order.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.data.bwe import make_loader
from vibravox_tpu_torch.data.features import Wav2Vec2FeatureExtractor
from vibravox_tpu_torch.data.phonemes import PhonemeCTCTokenizer, build_phoneme_vocab
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource, load_hf_vibravox
from vibravox_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["STPDataModule", "STPCollate", "SyntheticSTPSource"]

_SPLITS = {"fit": ("train", "validation"), "validate": ("validation",), "test": ("test",)}


class SyntheticSTPSource(SyntheticVibravoxSource):
    """Synthetic audio and pseudo phoneme strings for offline runs."""

    def __init__(self, tokenizer, **kwargs):
        super().__init__(**kwargs)
        self._alphabet = [t for t in tokenizer.get_vocab()
                          if t not in {"<unk>", "<pad>", "<s>", "</s>", "|"}]

    def __getitem__(self, idx: int) -> Dict[str, object]:
        item = super().__getitem__(idx)
        rng = np.random.default_rng(self.base_seed + idx + 10_000)
        n_words = rng.integers(2, 6)
        words = ["".join(rng.choice(self._alphabet, size=rng.integers(2, 7))) for _ in range(n_words)]
        return {"audio": item["audio_body_conducted"], "phonemized_text": " ".join(words)}


class _HubItems:
    """A hub source's rows as STP items (``audio``, ``phonemized_text``); a
    stream keeps its ``rows`` / ``decode`` and has no length."""

    def __init__(self, source, sample_rate: int):
        self.source, self.sample_rate = source, sample_rate

    @staticmethod
    def _item(row: Dict) -> Dict[str, object]:
        return {"audio": row["audio_body_conducted"], "phonemized_text": row["phonemized_text"]}

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, i: int) -> Dict[str, object]:
        return self._item(self.source[i])

    def rows(self) -> Iterator[Dict]:
        return self.source.rows()

    def decode(self, row: Dict) -> Dict[str, object]:
        return self._item(self.source.decode(row))


class STPCollate:
    """``{"audio": (B, T) float32, "phonemes_ids": (B, N) int32,
    "phonemes_str": [str]}``: the extractor's normalised audio padded to a
    multiple of ``audio_bucket_samples``, the labels padded to a multiple
    of ``pad_to_multiple_of`` with -100.  In training an ``augmentation``
    (``ops/augment.py::WaveformDataAugmentation``) runs on the padded
    batch, which is then cut or zero-padded back to its length.  Draws:
    ``__call__`` from generators seeded with ``seed``; ``keyed`` from
    ``default_rng((seed, epoch, batch))`` and, for the masked block's
    start, ``default_rng((seed, epoch, batch, 1))``, as the BWE collate."""

    def __init__(self, feature_extractor, tokenizer, sample_rate: int = 16000, deterministic: bool = False,
                 augmentation=None, pad_to_multiple_of: int = 128, audio_bucket_samples: int = 32000,
                 seed: int = 0):
        self.feature_extractor = feature_extractor
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.deterministic = deterministic
        self.augmentation = augmentation
        self.pad_to_multiple_of = pad_to_multiple_of
        self.audio_bucket_samples = audio_bucket_samples
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.mask_rng = np.random.default_rng((seed, 1))

    def keyed(self, samples: Sequence[Dict], key: Tuple[int, ...], indices=None) -> Dict[str, object]:
        return self._collate(samples, np.random.default_rng((self.seed, *key)),
                             np.random.default_rng((self.seed, *key, 1)))

    def __call__(self, samples: Sequence[Dict]) -> Dict[str, object]:
        return self._collate(samples, self.rng, self.mask_rng)

    def arrays(self, samples: Sequence[Dict]) -> Tuple[np.ndarray, np.ndarray, list]:
        """The unaugmented (audio, labels, texts), as the JAX collate's."""
        audios = [np.asarray(s["audio"], dtype=np.float32).reshape(-1) for s in samples]
        phonemes = [s["phonemized_text"] for s in samples]
        audio = self.feature_extractor(raw_speech=audios, padding="longest", return_tensors="np",
                                       sampling_rate=self.sample_rate,
                                       pad_to_multiple_of=self.pad_to_multiple_of)["input_values"]
        labels = self.tokenizer(text=phonemes, padding="longest", return_tensors="np",
                                pad_to_multiple_of=self.pad_to_multiple_of, return_attention_mask=True)
        ids = np.where(labels["attention_mask"] == 1, labels["input_ids"], -100).astype(np.int32)
        audio = audio.astype(np.float32)
        if self.audio_bucket_samples:
            bucket = -(-audio.shape[1] // self.audio_bucket_samples) * self.audio_bucket_samples
            audio = np.pad(audio, [(0, 0), (0, bucket - audio.shape[1])])
        return audio, ids, phonemes

    def _collate(self, samples, rng: np.random.Generator, mask_rng: np.random.Generator) -> Dict[str, object]:
        audio, ids, phonemes = self.arrays(samples)
        if self.augmentation is not None and not self.deterministic:
            aug, _ = self.augmentation(torch.from_numpy(audio), None, rng=rng, mask_rng=mask_rng)
            aug = aug.numpy()
            t = audio.shape[-1]
            if aug.shape[-1] < t:
                aug = np.pad(aug, [(0, 0), (0, t - aug.shape[-1])])
            audio = np.ascontiguousarray(aug[:, :t], dtype=np.float32)
        return {"audio": torch.from_numpy(audio), "phonemes_ids": torch.from_numpy(ids),
                "phonemes_str": phonemes}


class STPDataModule:
    """``device``: where the batches go, ``None`` for the GPU (raises
    without one) or ``"cpu"``; it decides whether host batches are pinned.
    Without a ``feature_extractor`` or ``tokenizer`` the ``stp.yaml``
    extractor and the built-in phoneme vocabulary are used."""

    LIST_OF_VIBRAVOX = [
        "Cnam-LMSSC/vibravox",
        "Cnam-LMSSC/vibravox2",
        "Cnam-LMSSC/vibravox-test",
        "Cnam-LMSSC/non_curated_vibravox",
        "Cnam-LMSSC/vibravox_enhanced_by_EBEN",
        "synthetic",
    ]

    def __init__(
        self,
        sample_rate: int = 16000,
        dataset_name_principal: str = "Cnam-LMSSC/vibravox",
        dataset_name_secondary: Optional[str] = None,
        subset: str = "speech_clean",
        sensor: str = "headset_microphone",
        streaming: bool = False,
        batch_size: int = 8,
        num_workers: int = 4,
        feature_extractor=None,
        tokenizer=None,
        data_augmentation=None,
        synthetic_size: int = 16,
        seed: int = 42,
        id: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if dataset_name_principal not in self.LIST_OF_VIBRAVOX:
            raise ValueError(f"dataset_name_principal must be one of {self.LIST_OF_VIBRAVOX}, "
                             f"got {dataset_name_principal!r}")
        self.sample_rate = sample_rate
        self.dataset_name_principal = dataset_name_principal
        self.dataset_name_secondary = dataset_name_secondary
        self.subset = subset
        self.sensor = sensor
        self.streaming = streaming
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.feature_extractor = feature_extractor or Wav2Vec2FeatureExtractor(
            feature_size=1, sampling_rate=sample_rate, padding_value=0.0, do_normalize=True,
            return_attention_mask=False)
        self.tokenizer = tokenizer or PhonemeCTCTokenizer(build_phoneme_vocab())
        self.data_augmentation = data_augmentation
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.id = id
        self.device = resolve_device(device)
        self._sources: Dict[str, object] = {}

    def _make_source(self, split: str):
        if self.dataset_name_principal == "synthetic":
            return SyntheticSTPSource(self.tokenizer, n_utterances=self.synthetic_size,
                                      sample_rate=self.sample_rate, split=f"stp-{split}")
        return _HubItems(load_hf_vibravox(self.dataset_name_principal, self.subset, split, self.sensor,
                                          self.sample_rate, self.streaming, reference_sensor=None),
                         self.sample_rate)

    def setup(self, stage: str = "fit") -> None:
        for split in _SPLITS[stage]:
            if split not in self._sources:
                self._sources[split] = self._make_source(split)

    def _collate(self, deterministic: bool) -> STPCollate:
        return STPCollate(self.feature_extractor, self.tokenizer, self.sample_rate,
                          deterministic=deterministic,
                          augmentation=None if deterministic else self.data_augmentation, seed=self.seed)

    def _loader(self, split: str, batch_size: int, train: bool) -> torch.utils.data.DataLoader:
        return make_loader(self._sources[split], self._collate(deterministic=not train), batch_size, train,
                           self.num_workers, self.seed, pin=self.device.type == "cuda")

    def train_dataloader(self) -> torch.utils.data.DataLoader:
        """Its ``batch_sampler.set_epoch(epoch)`` (a stream's
        ``dataset.set_epoch``) keys the next pass's shuffle and draws."""
        return self._loader("train", self.batch_size, train=True)

    def val_dataloader(self) -> torch.utils.data.DataLoader:
        return self._loader("validation", self.batch_size, train=False)

    def test_dataloader(self) -> torch.utils.data.DataLoader:
        return self._loader("test", 1, train=False)
