"""PyTorch port: the STP host pipeline against the JAX package.

The phoneme tokenizer against the HF ``Wav2Vec2CTCTokenizer`` that JAX's
``build_phoneme_tokenizer`` builds; the feature extractor against
``transformers.Wav2Vec2FeatureExtractor`` (what JAX's collate calls); the
synthetic source and the unaugmented collate against JAX's; CER, edit
operations and their split against ``vibravox_tpu/metrics/text.py``, for
the native kernel and the Python twin.  Everything is compared exactly
(byte for byte for arrays).  No loader workers here: the file imports JAX.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from vibravox_tpu.data.phonemes import build_phoneme_tokenizer
from vibravox_tpu.data.stp import STPCollate as JaxSTPCollate
from vibravox_tpu.data.stp import SyntheticSTPSource as JaxSyntheticSTPSource
from vibravox_tpu.metrics import text as jax_text
from vibravox_tpu_torch.data.features import Wav2Vec2FeatureExtractor
from vibravox_tpu_torch.data.phonemes import FRENCH_PHONEMES, load_phoneme_tokenizer
from vibravox_tpu_torch.data.stp import STPCollate, STPDataModule, SyntheticSTPSource
from vibravox_tpu_torch.metrics import text
from vibravox_tpu_torch.ops.augment import WaveformDataAugmentation
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

TEXTS = [
    "bɔ̃ʒuʁ lə mɔ̃d", " a  b ", "aX b", "a<unk>b", "a <pad> b", "", "ab\tc", "a\nb", "\t<pad>\n",
    "a<s>b", "<pad><pad>", "<unk", "a </s>  b", "<PAD>", "a|b", "|", "œ̃ ɑ̃ ɛ̃", "ʃɥi ʒə",
]


@pytest.fixture(scope="module")
def hf_tok():
    return build_phoneme_tokenizer()


@pytest.fixture(scope="module")
def tok():
    return load_phoneme_tokenizer()


def test_vocabulary_is_the_jax_tokenizers(hf_tok, tok):
    assert tok.get_vocab() == hf_tok.get_vocab()
    assert len(tok) == len(hf_tok) == 38 and tok.pad_token_id == hf_tok.pad_token_id == 35
    assert list(tok.get_vocab())[:33] == FRENCH_PHONEMES


@pytest.mark.parametrize("text_", TEXTS)
def test_encoding_matches_hf(hf_tok, tok, text_):
    assert tok(text_)["input_ids"] == hf_tok(text_).input_ids


def test_padded_batch_encoding_matches_hf(hf_tok, tok):
    kw = dict(padding="longest", pad_to_multiple_of=128, return_attention_mask=True, return_tensors="np")
    want, got = hf_tok(text=TEXTS, **kw), tok(text=TEXTS, **kw)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape == (len(TEXTS), 128)
        assert np.array_equal(got[key], want[key])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_decode_matches_hf(hf_tok, tok, seed):
    """Random id sequences with every special token, repeats and blanks:
    grouped, blanks dropped, "|" to " ", stripped, as HF decodes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 38, (64, 40))
    ids[:, 5:9] = ids[:, 4:5]  # runs of one token
    ids[::3, :3] = 33  # leading word delimiters
    ids[1::3, -4:] = 35  # trailing blanks
    assert tok.batch_decode(ids) == hf_tok.batch_decode(ids)
    assert [tok.decode(r, group_tokens=False) for r in ids[:8]] == [
        hf_tok.decode(r, group_tokens=False) for r in ids[:8]]


def test_local_tokenizer_directory(tmp_path, hf_tok):
    """A local directory's vocab.json and tokenizer_config.json; any other
    name is a hub name and gets the built-in vocabulary."""
    vocab = {"x": 0, "|": 1, "<unk>": 2, "<pad>": 3}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"pad_token": "<pad>", "unk_token": "<unk>"}))
    tok = load_phoneme_tokenizer(str(tmp_path))
    assert tok.get_vocab() == vocab and tok.pad_token_id == 3
    assert tok("x y")["input_ids"] == [0, 1, 2]
    assert load_phoneme_tokenizer("Cnam-LMSSC/vibravox-phonemes-tokenizer").get_vocab() == hf_tok.get_vocab()


@pytest.mark.parametrize("mask,multiple", [(False, 128), (False, None), (True, 128)])
def test_feature_extractor_is_byte_equal_to_hf(mask, multiple):
    """Ragged lengths; without a mask HF normalises each padded row over its
    whole length, padding included (stp.yaml's setting)."""
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(n).astype(np.float32) * s for n, s in ((1000, 0.1), (1777, 0.5), (250, 2.0))]
    kw = dict(feature_size=1, sampling_rate=16000, padding_value=0.0, do_normalize=True, return_attention_mask=mask)
    call = dict(padding="longest", return_tensors="np", sampling_rate=16000, pad_to_multiple_of=multiple)
    want = transformers.Wav2Vec2FeatureExtractor(**kw)(raw_speech=xs, **call)
    got = Wav2Vec2FeatureExtractor(**kw)(raw_speech=xs, **call)
    assert sorted(got) == sorted(want.keys())
    for key in got:
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes()
    if not mask:
        assert got["input_values"][2, -1] != 0.0  # the pad is normalised too
    with pytest.raises(ValueError, match="Hz"):
        Wav2Vec2FeatureExtractor(**kw)(raw_speech=xs, sampling_rate=8000)


@pytest.fixture(scope="module")
def sources(hf_tok, tok):
    kw = dict(n_utterances=6, sample_rate=16000, split="stp-train", min_seconds=0.5, max_seconds=2.5)
    return JaxSyntheticSTPSource(hf_tok, **kw), SyntheticSTPSource(tok, **kw)


def test_synthetic_source_is_the_jax_sources(sources):
    jax_src, src = sources
    for i in range(len(src)):
        a, b = jax_src[i], src[i]
        assert a["phonemized_text"] == b["phonemized_text"]
        assert a["audio"].dtype == b["audio"].dtype and a["audio"].tobytes() == b["audio"].tobytes()


@pytest.mark.parametrize("bucket", [32000, 0])
def test_collate_is_byte_equal_to_jax(sources, hf_tok, tok, bucket):
    """No augmentation: the extractor, the tokenizer, -100 labels and the
    audio bucket, as the JAX collate with the HF classes gives them."""
    jax_src, src = sources
    hf_fe = transformers.Wav2Vec2FeatureExtractor(feature_size=1, sampling_rate=16000, padding_value=0.0,
                                                  do_normalize=True, return_attention_mask=False)
    want = JaxSTPCollate(hf_fe, hf_tok, audio_bucket_samples=bucket)([jax_src[i] for i in (0, 3, 5)])
    got = STPCollate(Wav2Vec2FeatureExtractor(), tok, audio_bucket_samples=bucket)([src[i] for i in (0, 3, 5)])
    assert got["audio"].dtype == torch.float32 and got["phonemes_ids"].dtype == torch.int32
    assert got["audio"].numpy().tobytes() == want["audio"].tobytes() and got["audio"].shape == want["audio"].shape
    assert np.array_equal(got["phonemes_ids"].numpy(), want["phonemes_ids"])
    assert got["phonemes_str"] == want["phonemes_str"]
    assert (got["phonemes_ids"] == -100).any() and got["phonemes_ids"].shape[1] % 128 == 0
    if bucket:
        assert got["audio"].shape[1] % bucket == 0


def test_augmented_collate_is_keyed(sources, tok):
    """With every transform firing, a batch depends on its (epoch, batch)
    key only, keeps its length, and differs from the unaugmented batch."""
    _, src = sources
    aug = WaveformDataAugmentation(16000, p_data_augmentation=1.0, p_speed_perturbation=1.0,
                                   p_pitch_shift=0.0, p_time_masking=1.0)
    collate = STPCollate(Wav2Vec2FeatureExtractor(), tok, augmentation=aug, seed=3)
    items = [src[i] for i in (1, 2)]
    a, b, c = collate.keyed(items, (0, 1)), collate.keyed(items, (0, 1)), collate.keyed(items, (1, 1))
    plain = STPCollate(Wav2Vec2FeatureExtractor(), tok, deterministic=True, augmentation=aug)(items)
    assert torch.equal(a["audio"], b["audio"]) and not torch.equal(a["audio"], c["audio"])
    assert a["audio"].shape == plain["audio"].shape and not torch.equal(a["audio"], plain["audio"])
    assert torch.equal(a["phonemes_ids"], plain["phonemes_ids"])


def test_data_module_loaders_in_process(tok):
    dm = STPDataModule(dataset_name_principal="synthetic", batch_size=2, num_workers=0, synthetic_size=5,
                       device="cpu")
    dm.setup("fit")
    dm.setup("test")
    train, val, test = dm.train_dataloader(), dm.val_dataloader(), dm.test_dataloader()
    assert [len(b["phonemes_str"]) for b in train] == [2, 2]
    assert [len(b["phonemes_str"]) for b in val] == [2, 2, 1]
    assert [len(b["phonemes_str"]) for b in test] == [1] * 5
    with pytest.raises(ValueError, match="dataset_name_principal"):
        STPDataModule(dataset_name_principal="elsewhere", device="cpu")


PAIRS = [("kitten", "sitting"), ("ab cd", "ab ce"), ("", "abc"), ("abc", ""), ("bɔ̃ʒuʁ", "bɔʒuʁ lə"),
         ("a b c d", "abcd"), ("ʃɥi ʒə sɥi", "ʃi ʒ sɥi"), ("same", "same")]


@pytest.mark.parametrize("pred,target", PAIRS)
def test_editops_and_split_match_jax(pred, target):
    want = jax_text.levenshtein_editops(pred, target)
    assert text.levenshtein_editops(pred, target) == want
    assert text.levenshtein_editops_py(pred, target) == jax_text._levenshtein_editops_py(pred, target) == want
    assert text.split_editops(pred, target, want) == jax_text.split_editops(pred, target, want)
    assert text.decode_operations(pred, target, want) == jax_text.decode_operations(pred, target, want)


def test_char_error_rate_matches_jax():
    preds, targets = [p for p, _ in PAIRS], [t for _, t in PAIRS]
    assert text.char_error_rate(preds, targets) == jax_text.char_error_rate(preds, targets)
    assert text.char_error_rate(["abcd"], ["abxd"]) == 0.25
    edits = sum(len(text.levenshtein_editops_py(p, t)) for p, t in PAIRS)
    assert text.char_error_rate(preds, targets) == edits / sum(len(t) for t in targets)
