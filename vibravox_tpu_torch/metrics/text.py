"""Text metrics: character error rate (the phoneme error rate on phoneme
strings) and Levenshtein edit operations.

The port's copy of ``vibravox_tpu/metrics/text.py``, which replaces
torchmetrics ``CharErrorRate`` (the reference's PER,
``wav2vec2_for_stp.py:38,190-207``) and the Levenshtein helpers
(``vibravox/utils.py:256-331``).  The distances and edit operations run the
native kernel (``native/levenshtein.cpp``), built at first use with the
port's other host code (``native/build.py``); a failed build raises.
``levenshtein_editops_py`` is the same DP in Python, the tests' twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "levenshtein_editops",
    "levenshtein_editops_py",
    "char_error_rate",
    "decode_operations",
    "get_space_indices",
    "split_editops",
]

_OP_NAMES = ("replace", "insert", "delete")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    from vibravox_tpu_torch.native.build import build

    lib = ctypes.CDLL(str(build()))
    lib.levenshtein_editops.restype = ctypes.c_int
    lib.levenshtein_editops.argtypes = [
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int,
    ]
    lib.levenshtein_distance.restype = ctypes.c_int
    lib.levenshtein_distance.argtypes = [
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int,
    ]
    return lib


def _codepoints(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32).copy()


def levenshtein_editops(pred: str, target: str) -> List[Tuple[str, int, int]]:
    """Minimal edit operations turning ``pred`` into ``target``:
    ``(op, pred_idx, target_idx)`` triples, op in {replace, insert, delete},
    the python-Levenshtein convention the reference consumes."""
    a, b = _codepoints(pred), _codepoints(target)
    max_ops = len(a) + len(b) + 1
    out = np.empty(3 * max_ops, dtype=np.int32)
    n_ops = _library().levenshtein_editops(a, len(a), b, len(b), out, max_ops)
    if n_ops < 0:
        raise RuntimeError(f"levenshtein_editops overflowed {max_ops} operations")
    return [(_OP_NAMES[out[3 * k]], int(out[3 * k + 1]), int(out[3 * k + 2])) for k in range(n_ops)]


def levenshtein_editops_py(pred: str, target: str) -> List[Tuple[str, int, int]]:
    """The same DP and backtrace in Python."""
    m, n = len(pred), len(target)
    dist = np.zeros((m + 1, n + 1), dtype=np.int32)
    dist[:, 0] = np.arange(m + 1)
    dist[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if pred[i - 1] == target[j - 1] else 1
            dist[i, j] = min(dist[i - 1, j] + 1, dist[i, j - 1] + 1, dist[i - 1, j - 1] + cost)
    ops: List[Tuple[str, int, int]] = []
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] and pred[i - 1] == target[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + 1:
            ops.append(("replace", i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            ops.append(("delete", i - 1, j))
            i -= 1
        else:
            ops.append(("insert", i, j - 1))
            j -= 1
    ops.reverse()
    return ops


def char_error_rate(preds: Sequence[str], targets: Sequence[str]) -> float:
    """Corpus-level CER: total edit distance over total target characters."""
    lib = _library()
    total_edits = total_chars = 0
    for p, t in zip(preds, targets):
        a, b = _codepoints(p), _codepoints(t)
        total_edits += int(lib.levenshtein_distance(a, len(a), b, len(b)))
        total_chars += len(t)
    return total_edits / max(total_chars, 1)


# --------------------------------------------------------------------------- #
# Edit-op decoding (phoneme confusion analysis, ref ``utils.py:256-331``)
# --------------------------------------------------------------------------- #


def decode_operations(
    predicted_chr: str, label_chr: str, editops: List[Tuple[str, int, int]]
) -> List[Tuple[str, str, str]]:
    ops = []
    for op, pred_idx, label_idx in editops:
        if op == "insert":
            token = label_chr[label_idx]
            ops.append((op, token, token))
        elif op == "delete":
            token = predicted_chr[pred_idx]
            ops.append((op, token, token))
        else:
            ops.append((op, predicted_chr[pred_idx], label_chr[label_idx]))
    return ops


def get_space_indices(string: str) -> List[int]:
    return [i for i, x in enumerate(string) if x == " "]


def split_editops(pred: str, target: str, editops: List[Tuple[str, int, int]]):
    """Split edit ops into (before-space, in-word, all), ref ``utils.py:301-331``."""
    pred_space_idx = get_space_indices(pred)
    target_space_idx = get_space_indices(target)
    before_space, in_word = [], []
    for editop in editops:
        op, pred_idx, label_idx = editop
        if (
            (op == "replace" and ((pred_idx + 1) in pred_space_idx or (label_idx + 1) in target_space_idx))
            or (op == "delete" and (pred_idx + 1) in pred_space_idx)
            or (op == "insert" and (label_idx + 1) in target_space_idx)
        ):
            before_space.append(editop)
        else:
            in_word.append(editop)
    return before_space, in_word, editops
