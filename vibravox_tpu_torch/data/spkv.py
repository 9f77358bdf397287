"""SPKV (speaker verification) data module (PyTorch loaders).

Counterpart of ``vibravox_tpu/data/spkv.py`` (the reference's
``SPKVLightningDataModule``, ``lightning_datamodules/spkv.py:16-348``):

* fit: the train split of ``sensor_a``, interleaved 50/50 with
  ``sensor_b``'s when the two differ (the shipped task is inference only,
  so this feeds custom training tasks);
* test: the test split sorted by ``speaker_id`` in its native type, the
  trial pairs (a pickle of ``(index_a, index_b)`` from ``pairs_file``, or
  ``generate_trial_pairs``), and paired batches ``{"sensor_a": ...,
  "sensor_b": ...}``: the two sides' loaders zipped (the reference's
  CombinedLoader in ``min_size`` mode).

``generate_trial_pairs`` draws from a Mersenne Twister (``random.Random``)
in the JAX function's order, so the pairs are equal to the JAX package's
and to the reference script's for the same speakers.  The loaders are the
BWE module's (``data/bwe.py::make_loader``): the epoch-keyed shuffle in
training, the items in order in test.  Batches hold ``audio`` as a
float32 tensor, zero-padded to the batch's longest, and the metadata as
lists, which the trainer keeps on the host.
"""

from __future__ import annotations

import itertools
import math
import pickle
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.data.bwe import make_loader
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource, load_hf_vibravox
from vibravox_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["SPKVDataModule", "SPKVCollate", "generate_trial_pairs", "speaker_ranges", "speaker_sort_order"]


class SPKVCollate:
    """Pad audio to the batch's longest and pass the metadata through
    (ref ``spkv.py:309-348``); deterministic, so ``keyed`` ignores its key."""

    def __init__(self, sensor: str):
        self.sensor = sensor

    def __call__(self, samples: Sequence[Dict]) -> Dict:
        audios = [np.asarray(s["audio"], dtype=np.float32).reshape(-1) for s in samples]
        longest = max(a.shape[-1] for a in audios)
        padded = np.stack([np.pad(a, (0, longest - len(a))) for a in audios])
        return {
            "audio": torch.from_numpy(padded),
            "speaker_id": [s.get("speaker_id", "?") for s in samples],
            "sentence_id": [s.get("sentence_id", -1) for s in samples],
            "gender": [s.get("gender", "?") for s in samples],
            "sensor": [self.sensor] * len(samples),
        }

    def keyed(self, samples: Sequence[Dict], key: Tuple[int, ...], indices=None) -> Dict:
        return self(samples)


def speaker_sort_order(src) -> List[int]:
    """Row order sorted by the ``speaker_id`` column's native type, as the
    reference's ``dataset.sort("speaker_id")`` (a ``str`` key would put
    ``'10'`` before ``'2'`` on numeric ids); stable."""
    return sorted(range(len(src)), key=lambda i: src[i]["speaker_id"])


def speaker_ranges(speaker_ids: Sequence[str]) -> Tuple[List[List[int]], int]:
    """Per-speaker index ranges truncated to the minimum utterance count,
    over ids sorted by speaker (each speaker one contiguous block):
    ``ranges[i]`` is the first ``min_utterances`` indices of speaker i's
    block; offsets step by the whole block.  Returns ``(ranges,
    min_utterances)``; raises if a speaker's rows are not contiguous."""
    counts: List[int] = []
    seen: Dict[str, int] = {}
    last: Optional[str] = None
    for sid in map(str, speaker_ids):
        if sid != last:
            if sid in seen:
                raise ValueError(f"speaker {sid!r} is not contiguous — sort by speaker_id first")
            seen[sid] = len(counts)
            counts.append(0)
            last = sid
        counts[seen[sid]] += 1
    if not counts:
        return [], 0
    min_utterances = min(counts)
    offset = 0
    ranges = []
    for c in counts:
        ranges.append(list(range(offset, offset + min_utterances)))
        offset += c
    return ranges, min_utterances


def generate_trial_pairs(
    speaker_ids: Sequence[str],
    genders: Sequence[str],
    gender_policy: str = "mixed_gender",
    seed: int = 42,
    rng: Optional[random.Random] = None,
) -> List[Tuple[int, int]]:
    """The reference's trial list (``scripts/gen_pairs_for_spkv.py:91-186``).

    For every speaker, all ``combinations(range_i, 2)`` of its utterances
    (ranges from :func:`speaker_ranges`), and as many different-speaker
    pairs: targets from its own range, partners as (other speaker,
    utterance slot), drawn in that order with ``choices``.  All same-speaker
    pairs come first.  ``same_gender`` runs the construction within each
    gender (males, then the rest, by each speaker's first utterance).
    ``rng`` continues a stream; otherwise a fresh ``Random(seed)``."""
    if rng is None:
        rng = random.Random(seed)
    ranges, min_utterances = speaker_ranges(speaker_ids)
    nb_speakers = len(ranges)
    k = math.comb(min_utterances, 2)

    if gender_policy == "same_gender":
        males = [i for i in range(nb_speakers) if str(genders[ranges[i][0]]) == "male"]
        females = [i for i in range(nb_speakers) if str(genders[ranges[i][0]]) != "male"]
        groups = [males, females]
    else:
        groups = [list(range(nb_speakers))]

    same: List[Tuple[int, int]] = []
    different: List[Tuple[int, int]] = []
    for group in groups:
        for speaker in group:
            same += list(itertools.combinations(ranges[speaker], r=2))
            other_speakers = [i for i in group if i != speaker]
            # the reference's draw order: targets, partner speakers, slots
            targets = rng.choices(ranges[speaker], k=k)
            partner_speaker = rng.choices(other_speakers, k=k)
            partner_slot = rng.choices(range(min_utterances), k=k)
            different += list(zip(targets, (ranges[s][u] for s, u in zip(partner_speaker, partner_slot))))
    return [(int(a), int(b)) for a, b in same + different]


class _Selected:
    """``base`` re-indexed by ``indices``."""

    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> Dict:
        return self.base[self.indices[i]]


class _SPKVItems:
    """A source's rows as SPKV items: the sensor's audio and the metadata."""

    def __init__(self, source):
        self.source = source

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, i: int) -> Dict:
        row = self.source[i]
        return {"audio": row["audio_body_conducted"], "speaker_id": row.get("speaker_id", "?"),
                "sentence_id": row.get("sentence_id", -1), "gender": row.get("gender", "?")}


class _Interleaved:
    """Items of ``a`` and ``b`` in turn, for as long as both last."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __len__(self) -> int:
        return 2 * min(len(self.a), len(self.b))

    def __getitem__(self, i: int) -> Dict:
        return (self.a if i % 2 == 0 else self.b)[i // 2]


class _Paired:
    """The two sides' loaders zipped into ``{"sensor_a", "sensor_b"}``."""

    def __init__(self, loader_a, loader_b):
        self.loader_a, self.loader_b = loader_a, loader_b

    def __len__(self) -> int:
        return min(len(self.loader_a), len(self.loader_b))

    def __iter__(self):
        for a, b in zip(self.loader_a, self.loader_b):
            yield {"sensor_a": a, "sensor_b": b}


class SPKVDataModule:
    """``dataset_name``: ``synthetic`` (the synthetic source with metadata,
    ``synthetic_size`` utterances of 4 speakers per split) or a hub name
    (``load_hf_vibravox``, which needs ``datasets``).  ``device``: where the
    batches go, ``None`` for the GPU (raises without one) or ``"cpu"``; it
    decides whether host batches are pinned."""

    def __init__(
        self,
        sample_rate: int = 16000,
        dataset_name: str = "Cnam-LMSSC/vibravox",
        subset: str = "speech_clean",
        sensor_a: str = "headset_microphone",
        sensor_b: str = "headset_microphone",
        pairs_file: Optional[str] = None,
        gender_policy: str = "mixed_gender",
        streaming: bool = False,
        batch_size: int = 1,
        num_workers: int = 1,
        synthetic_size: int = 24,
        seed: int = 42,
        id: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if streaming:
            raise ValueError("streaming is not supported for the SPKV test stage")
        self.sample_rate = sample_rate
        self.dataset_name = dataset_name
        self.subset = subset
        self.sensor_a = sensor_a
        self.sensor_b = sensor_b
        self.pairs_file = pairs_file
        self.gender_policy = gender_policy
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.id = id
        self.device = resolve_device(device)
        self._fit_source = None
        self._test_sources = None

    def load_split(self, split: str, sensor: str) -> _SPKVItems:
        if self.dataset_name == "synthetic":
            return _SPKVItems(SyntheticVibravoxSource(n_utterances=self.synthetic_size,
                                                      sample_rate=self.sample_rate,
                                                      split=f"spkv-{split}", with_metadata=True))
        return _SPKVItems(load_hf_vibravox(self.dataset_name, self.subset, split, sensor, self.sample_rate,
                                           streaming=False, reference_sensor=None))

    def setup(self, stage: str = "test") -> None:
        if stage != "test":
            if stage == "fit" and self._fit_source is None:
                src_a = self.load_split("train", self.sensor_a)
                self._fit_source = (src_a if self.sensor_b == self.sensor_a
                                    else _Interleaved(src_a, self.load_split("train", self.sensor_b)))
            return
        src_a = self.load_split("test", self.sensor_a)
        src_b = self.load_split("test", self.sensor_b) if self.sensor_b != self.sensor_a else src_a
        order = speaker_sort_order(src_a)
        if self.pairs_file:
            with open(self.pairs_file, "rb") as f:
                pairs = pickle.load(f)
        else:
            rows = [src_a[i] for i in order]
            pairs = generate_trial_pairs([str(r["speaker_id"]) for r in rows], [str(r["gender"]) for r in rows],
                                         self.gender_policy, seed=self.seed)
        self._test_sources = (_Selected(src_a, [order[a] for a, _ in pairs]),
                              _Selected(src_b, [order[b] for _, b in pairs]))

    def _loader(self, source, sensor: str, train: bool) -> torch.utils.data.DataLoader:
        return make_loader(source, SPKVCollate(sensor), self.batch_size, train, self.num_workers, self.seed,
                           pin=self.device.type == "cuda")

    def train_dataloader(self):
        """Empty unless ``setup("fit")`` ran; its ``batch_sampler.set_epoch``
        keys the shuffle."""
        if self._fit_source is None:
            return iter(())
        return self._loader(self._fit_source, self.sensor_a, train=True)

    def val_dataloader(self):
        return iter(())

    def test_dataloader(self) -> _Paired:
        src_a, src_b = self._test_sources
        return _Paired(self._loader(src_a, self.sensor_a, train=False),
                       self._loader(src_b, self.sensor_b, train=False))
