"""PyTorch port: the SPKV host pipeline against the JAX package.

The verification metrics (ROC, EER, minDCF, distance statistics, the
accumulator) on seeded scores, with equal floats; the trial pairs and
speaker ranges for both gender policies and for numeric and string ids;
the data module's paired test batches (audio byte-equal, metadata equal)
for equal and for different sensors, and its fit source; the
``gen_pairs_for_spkv`` pickles byte-equal to the JAX script's.  No loader
workers: the file imports JAX.
"""

import random

import numpy as np
import pytest

from vibravox_tpu.data.spkv import SPKVDataModule as JaxSPKVDataModule
from vibravox_tpu.data.spkv import generate_trial_pairs as jax_generate_trial_pairs
from vibravox_tpu.data.spkv import speaker_ranges as jax_speaker_ranges
from vibravox_tpu.data.spkv import speaker_sort_order as jax_speaker_sort_order
from vibravox_tpu.metrics import verification as jax_verification
from vibravox_tpu_torch.data.spkv import SPKVDataModule, generate_trial_pairs, speaker_ranges, speaker_sort_order
from vibravox_tpu_torch.metrics import verification
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


def _scores(seed, n=300, ties=False):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    scores = rng.standard_normal(n) * 0.3 + labels * 0.5
    if ties:
        scores = np.round(scores, 1)
    return scores.astype(np.float32), labels.astype(np.int32)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, False)])
def test_verification_metrics_equal_jax(seed, ties):
    scores, labels = _scores(seed, ties=ties)
    for ours, ref in zip(verification.roc_curve(scores, labels), jax_verification.roc_curve(scores, labels)):
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert verification.equal_error_rate(scores, labels) == jax_verification.equal_error_rate(scores, labels)
    for args in ((), (0.01, 1.0, 10.0)):
        assert (verification.minimum_detection_cost(scores, labels, *args)
                == jax_verification.minimum_detection_cost(scores, labels, *args))
    assert verification.embedding_distance_stats(scores, labels) == jax_verification.embedding_distance_stats(
        scores, labels)


def test_score_accumulator_equals_jax():
    ours, ref = verification.BinaryScoreAccumulator(), jax_verification.BinaryScoreAccumulator()
    for seed in range(3):
        scores, labels = _scores(seed, n=5)
        ours.update(scores, labels)
        ref.update(scores, labels)
    ours.update(np.float32(0.5), 1)
    ref.update(np.float32(0.5), 1)
    for a, b in zip(ours.compute(), ref.compute()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    ours.reset()
    assert ours.scores == [] and ours.labels == []


def _speakers(kind):
    """Contiguous speaker blocks of unequal sizes, sorted in the ids'
    native type, and the gender of each row."""
    sizes = [5, 7, 5, 6, 8, 5]
    ids = [2, 10, 11, 30, 100, 205] if kind == "numeric" else ["a", "b10", "b2", "c", "d", "e"]
    genders = ["female", "male", "male", "female", "male", "female"]
    rows = [(i, g) for i, g, n in zip(ids, genders, sizes) for _ in range(n)]
    return [r[0] for r in rows], [r[1] for r in rows]


@pytest.mark.parametrize("kind", ["numeric", "string"])
@pytest.mark.parametrize("policy", ["mixed_gender", "same_gender"])
def test_trial_pairs_equal_jax(kind, policy):
    ids, genders = _speakers(kind)
    rows = [{"speaker_id": s} for s in ids]
    order = speaker_sort_order(rows)
    assert order == jax_speaker_sort_order(rows)
    sorted_ids = [str(ids[i]) for i in order]
    sorted_genders = [genders[i] for i in order]
    assert speaker_ranges(sorted_ids) == jax_speaker_ranges(sorted_ids)
    ours = generate_trial_pairs(sorted_ids, sorted_genders, policy, seed=7)
    ref = jax_generate_trial_pairs(sorted_ids, sorted_genders, policy, seed=7)
    assert ours == ref and len(ours) == 2 * 6 * 10
    # one stream continued: mixed then same, as the script draws them
    rng_a, rng_b = random.Random(42), random.Random(42)
    for p in ("mixed_gender", policy):
        assert (generate_trial_pairs(sorted_ids, sorted_genders, p, rng=rng_a)
                == jax_generate_trial_pairs(sorted_ids, sorted_genders, p, rng=rng_b))


def test_speaker_ranges_refuse_unsorted_speakers():
    with pytest.raises(ValueError, match="not contiguous"):
        speaker_ranges(["a", "b", "a"])
    assert speaker_ranges([]) == ([], 0)


def _flatten_batches(loader):
    out = []
    for batch in loader:
        for side in ("sensor_a", "sensor_b"):
            b = batch[side]
            audio = np.asarray(b["audio"])
            out.append((side, audio.dtype, audio.shape, audio.tobytes(),
                        [str(s) for s in b["speaker_id"]], list(b["sentence_id"]), list(b["gender"]),
                        list(b["sensor"])))
    return out


@pytest.mark.parametrize("sensor_b,policy,batch_size", [("headset_microphone", "mixed_gender", 1),
                                                         ("throat_microphone", "same_gender", 3)])
def test_paired_test_batches_equal_jax(sensor_b, policy, batch_size):
    kwargs = dict(dataset_name="synthetic", sensor_b=sensor_b, gender_policy=policy, batch_size=batch_size,
                  synthetic_size=8, seed=3)
    ours = SPKVDataModule(num_workers=0, device="cpu", **kwargs)
    ref = JaxSPKVDataModule(**kwargs)
    ours.setup("test")
    ref.setup("test")
    got, want = _flatten_batches(ours.test_dataloader()), _flatten_batches(ref.test_dataloader())
    assert len(ours.test_dataloader()) == len(ref.test_dataloader()) and got == want
    assert len(got) == 2 * -(-len(ours._test_sources[0]) // batch_size)


def test_fit_source_interleaves_two_sensors_as_jax():
    kwargs = dict(dataset_name="synthetic", sensor_b="throat_microphone", synthetic_size=4)
    ours = SPKVDataModule(num_workers=0, device="cpu", **kwargs)
    ref = JaxSPKVDataModule(**kwargs)
    ours.setup("fit")
    ref.setup("fit")
    assert len(ours._fit_source) == len(ref._fit_source) == 8
    for i in range(len(ref._fit_source)):
        a, b = ours._fit_source[i], ref._fit_source[i]
        assert set(a) == set(b) and np.asarray(a["audio"]).tobytes() == np.asarray(b["audio"]).tobytes()
        assert all(a[k] == b[k] for k in ("speaker_id", "sentence_id", "gender"))
    batches = list(ours.train_dataloader())
    assert len(batches) == 8 and all(tuple(b["audio"].shape)[0] == 1 for b in batches)


def test_gen_pairs_pickles_are_byte_equal_to_the_jax_script(tmp_path):
    from vibravox_tpu.scripts.gen_pairs_for_spkv import main as jax_main
    from vibravox_tpu_torch.scripts.gen_pairs_for_spkv import main

    args = ["--dataset", "synthetic", "--seed", "5"]
    main(args + ["--output-dir", str(tmp_path / "port")])
    jax_main(args + ["--output-dir", str(tmp_path / "jax")])
    for name in ("mixed_gender.pkl", "same_gender.pkl"):
        ours, ref = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        assert ours == ref and len(ours) > 100


def test_pairs_file_is_read_as_given(tmp_path):
    """A ``pairs_file`` from the port's script gives the data module's
    generated pairs for the same policy and seed."""
    import pickle

    from vibravox_tpu_torch.scripts.gen_pairs_for_spkv import main

    main(["--dataset", "synthetic", "--seed", "42", "--output-dir", str(tmp_path)])
    with open(tmp_path / "mixed_gender.pkl", "rb") as f:
        pairs = pickle.load(f)
    assert len(pairs) == 120 and sum(a // 6 == b // 6 for a, b in pairs) == 60  # 4 speakers of 6
    from_file = SPKVDataModule(dataset_name="synthetic", num_workers=0, device="cpu",
                               pairs_file=str(tmp_path / "mixed_gender.pkl"))
    generated = SPKVDataModule(dataset_name="synthetic", num_workers=0, device="cpu")
    from_file.setup("test")
    generated.setup("test")
    assert from_file._test_sources[0].indices == generated._test_sources[0].indices
    assert from_file._test_sources[1].indices == generated._test_sources[1].indices
