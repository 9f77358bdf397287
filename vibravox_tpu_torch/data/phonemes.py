"""Phoneme vocabulary and CTC tokenizer of the STP task.

Counterpart of ``vibravox_tpu/data/phonemes.py``.  The reference pulls
``Cnam-LMSSC/vibravox-phonemes-tokenizer`` from the hub
(``configs/lightning_datamodule/stp.yaml``): a ``Wav2Vec2CTCTokenizer`` of 38
tokens with pad 35.  The port needs no ``transformers``:
``PhonemeCTCTokenizer`` reproduces what the STP collate and task use of that
class, and ``load_phoneme_tokenizer`` reads a local ``vocab.json`` or, for a
hub name, builds the built-in French phoneme vocabulary, as the JAX module
does when the hub cannot be reached.
"""

from __future__ import annotations

import json
import os
import re
from itertools import groupby
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = ["FRENCH_PHONEMES", "PhonemeCTCTokenizer", "build_phoneme_vocab", "load_phoneme_tokenizer"]

# French IPA phoneme inventory of the vibravox phonemizer (espeak fr-fr).
# The tokenizer splits text per unicode codepoint, so nasal vowels
# decompose into the base vowel and the combining tilde U+0303, which is
# its own token.
FRENCH_PHONEMES = [
    "a", "b", "d", "e", "f", "i", "j", "k", "l", "m", "n", "o", "p", "s",
    "t", "u", "v", "w", "y", "z", "ø", "ŋ", "œ", "ɑ", "ɔ", "ə", "ɛ",
    "ɡ", "ʁ", "ʃ", "ʒ", "ɥ", "̃",
]


def build_phoneme_vocab() -> Dict[str, int]:
    """33 phonemes (ids 0..32), "|" (33), <unk> (34), <pad> (35), <s> (36),
    </s> (37): 38 tokens with pad 35, the shape the reference asserts."""
    vocab = {ph: i for i, ph in enumerate(FRENCH_PHONEMES)}
    for token in ("|", "<unk>", "<pad>", "<s>", "</s>"):
        vocab[token] = len(vocab)
    assert vocab["<pad>"] == 35 and len(vocab) == 38
    return vocab


def _clean_up_tokenization(text: str) -> str:
    """HF's ``clean_up_tokenization`` (spaces before punctuation and English
    contractions)."""
    for old, new in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                     (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(old, new)
    return text


class PhonemeCTCTokenizer:
    """What the STP path uses of HF's ``Wav2Vec2CTCTokenizer``, without it.

    Encoding: the vocabulary's multi-character tokens (``<unk>``, ``<pad>``,
    ``<s>``, ``</s>``) are matched first, swallowing whitespace on both
    sides; the rest is split per codepoint, ``" "`` becoming ``"|"`` and a
    character outside the vocabulary ``<unk>``.  Decoding: repeats grouped,
    ``<pad>`` (the CTC blank) dropped, ``"|"`` back to ``" "``, stripped,
    then HF's clean-up when ``clean_up_tokenization_spaces`` is set (HF's
    default for this tokenizer is off)."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "<unk>", pad_token: str = "<pad>",
                 bos_token: str = "<s>", eos_token: str = "</s>", word_delimiter_token: str = "|",
                 clean_up_tokenization_spaces: bool = False):
        self.vocab = dict(vocab)
        self.decoder = {i: t for t, i in self.vocab.items()}
        self.unk_token, self.pad_token = unk_token, pad_token
        self.bos_token, self.eos_token = bos_token, eos_token
        self.word_delimiter_token = word_delimiter_token
        self.clean_up_tokenization_spaces = clean_up_tokenization_spaces
        self.pad_token_id = self.vocab[pad_token]
        self.unk_token_id = self.vocab[unk_token]
        multi = sorted((t for t in self.vocab if len(t) > 1), key=len, reverse=True)
        self._multi = re.compile(r"\s*(" + "|".join(map(re.escape, multi)) + r")\s*") if multi else None

    def __len__(self) -> int:
        return len(self.vocab)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    # ------------------------------------------------------------------ #

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        pos = 0
        for m in (self._multi.finditer(text) if self._multi else ()):
            tokens.extend(text[pos:m.start()].replace(" ", self.word_delimiter_token))
            tokens.append(m.group(1))
            pos = m.end()
        tokens.extend(text[pos:].replace(" ", self.word_delimiter_token))
        return tokens

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]

    def __call__(self, text: Union[str, Sequence[str]], padding: Union[bool, str] = False,
                 pad_to_multiple_of: Optional[int] = None, return_attention_mask: bool = True,
                 return_tensors: Optional[str] = None) -> Dict[str, object]:
        """``input_ids`` and ``attention_mask`` of each text; with
        ``padding="longest"`` (or True) right-padded with ``<pad>`` to the
        longest, rounded up to ``pad_to_multiple_of``; ``return_tensors="np"``
        gives int64 arrays."""
        single = isinstance(text, str)
        ids = [self.encode(t) for t in ([text] if single else text)]
        if padding not in (False, None, True, "longest", "do_not_pad"):
            raise ValueError(f"unsupported padding {padding!r}")
        if padding in (True, "longest"):
            n = max((len(s) for s in ids), default=0)
            if pad_to_multiple_of and n % pad_to_multiple_of:
                n = (n // pad_to_multiple_of + 1) * pad_to_multiple_of
            masks = [[1] * len(s) + [0] * (n - len(s)) for s in ids]
            ids = [s + [self.pad_token_id] * (n - len(s)) for s in ids]
        else:
            masks = [[1] * len(s) for s in ids]
        out: Dict[str, object] = {"input_ids": ids}
        if return_attention_mask:
            out["attention_mask"] = masks
        if return_tensors == "np":
            out = {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}
        elif return_tensors is not None:
            raise ValueError(f"unsupported return_tensors {return_tensors!r}")
        if single:
            out = {k: v[0] for k, v in out.items()}
        return out

    # ------------------------------------------------------------------ #

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.decoder.get(int(i), self.unk_token) for i in ids]

    def decode(self, ids: Sequence[int], group_tokens: bool = True) -> str:
        tokens = self.convert_ids_to_tokens(ids)
        if group_tokens:
            tokens = [t for t, _ in groupby(tokens)]
        chars = [" " if t == self.word_delimiter_token else t for t in tokens if t != self.pad_token]
        text = "".join(chars).strip()
        return _clean_up_tokenization(text) if self.clean_up_tokenization_spaces else text

    def batch_decode(self, sequences, group_tokens: bool = True) -> List[str]:
        return [self.decode(np.asarray(s).reshape(-1), group_tokens=group_tokens) for s in sequences]

    def save_pretrained(self, directory: str) -> List[str]:
        """Writes ``vocab.json`` and ``special_tokens_map.json`` as HF's
        ``Wav2Vec2CTCTokenizer.save_pretrained`` does, and a
        ``tokenizer_config.json`` of the special tokens and the class, which
        ``load_phoneme_tokenizer`` and HF read.  Returns the paths."""
        out = Path(directory)
        out.mkdir(parents=True, exist_ok=True)
        special = {"bos_token": self.bos_token, "eos_token": self.eos_token, "pad_token": self.pad_token,
                   "unk_token": self.unk_token}
        config = {**special, "word_delimiter_token": self.word_delimiter_token,
                  "clean_up_tokenization_spaces": self.clean_up_tokenization_spaces, "do_lower_case": False,
                  "replace_word_delimiter_char": " ", "tokenizer_class": "Wav2Vec2CTCTokenizer"}
        files = {"vocab.json": self.vocab, "special_tokens_map.json": special, "tokenizer_config.json": config}
        for name, obj in files.items():
            (out / name).write_text(json.dumps(obj, indent=2, sort_keys=True, ensure_ascii=False) + "\n",
                                    encoding="utf-8")
        return [str(out / name) for name in files]


def load_phoneme_tokenizer(name_or_path: str = "Cnam-LMSSC/vibravox-phonemes-tokenizer") -> PhonemeCTCTokenizer:
    """A local directory's ``vocab.json`` (and the special tokens of its
    ``tokenizer_config.json``, if any); for any other name, a hub name, the
    built-in vocabulary (the port never downloads)."""
    if not os.path.isdir(name_or_path):
        return PhonemeCTCTokenizer(build_phoneme_vocab())
    directory = Path(name_or_path)
    vocab = json.loads((directory / "vocab.json").read_text(encoding="utf-8"))
    kwargs = {}
    config = directory / "tokenizer_config.json"
    if config.is_file():
        cfg = json.loads(config.read_text(encoding="utf-8"))
        for key in ("unk_token", "pad_token", "bos_token", "eos_token", "word_delimiter_token",
                    "clean_up_tokenization_spaces"):
            value = cfg.get(key)
            if isinstance(value, dict):  # a serialised AddedToken
                value = value.get("content")
            if value is not None:
                kwargs[key] = value
    return PhonemeCTCTokenizer(vocab, **kwargs)
