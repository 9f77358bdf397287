"""Speaker-verification metrics: EER, minDCF, embedding-distance statistics
and a non-binned ROC (numpy, on the host).

The port's own copy of ``vibravox_tpu/metrics/verification.py``, the
functional form of the reference's torchmetrics
(``vibravox/metrics/equal_error_rate.py``, ``minimum_dcf.py``,
``embedding_distance.py``): the state is the epoch's accumulated score and
label arrays, and the compute functions are pure.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "roc_curve",
    "equal_error_rate",
    "minimum_detection_cost",
    "embedding_distance_stats",
    "BinaryScoreAccumulator",
]


def roc_curve(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-binned ROC: (false_alarm_rate, false_reject_rate, thresholds).

    Thresholds sweep the sorted unique scores descending, matching
    torchmetrics' binned=None ROC used by the reference
    (``equal_error_rate.py:89``).
    """
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    labels = labels[order].astype(bool)
    tp = np.cumsum(labels)
    fp = np.cumsum(~labels)
    n_pos = tp[-1] if len(tp) else 0
    n_neg = fp[-1] if len(fp) else 0
    # keep only the last occurrence of each distinct score
    distinct = np.r_[scores[1:] != scores[:-1], True]
    tp, fp, thr = tp[distinct], fp[distinct], scores[distinct]
    tpr = tp / max(n_pos, 1)
    far = fp / max(n_neg, 1)  # false acceptance (positive) rate
    frr = 1.0 - tpr  # false rejection rate
    # prepend the accept-nothing endpoint (FAR=0, FRR=1), like torchmetrics'
    # ROC threshold at +inf — keeps minDCF bounded for degenerate scores
    far = np.r_[0.0, far]
    frr = np.r_[1.0, frr]
    thr = np.r_[thr[0] + 1.0 if len(thr) else 1.0, thr]
    return far, frr, thr


def equal_error_rate(scores: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """EER at the threshold minimizing |FAR − FRR| (``equal_error_rate.py:77-110``)."""
    far, frr, thr = roc_curve(scores, labels)
    idx = int(np.argmin(np.abs(far - frr)))
    return {
        "eer": float((far[idx] + frr[idx]) / 2),
        "threshold": float(thr[idx]),
        "far": float(far[idx]),
        "frr": float(frr[idx]),
    }


def minimum_detection_cost(
    scores: np.ndarray,
    labels: np.ndarray,
    p_target: float = 0.05,
    c_fa: float = 1.0,
    c_fr: float = 1.0,
) -> Dict[str, float]:
    """NIST SRE-2018 normalized minimum detection cost
    (``minimum_dcf.py:99-117``)."""
    far, frr, thr = roc_curve(scores, labels)
    dcf = c_fr * p_target * frr + c_fa * (1 - p_target) * far
    idx = int(np.argmin(dcf))
    c_default = min(c_fr * p_target, c_fa * (1 - p_target))
    return {
        "min_dcf": float(dcf[idx] / c_default),
        "threshold": float(thr[idx]),
    }


def embedding_distance_stats(scores: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Mean/std of scores split by same/different-speaker label
    (``embedding_distance.py:76-95``)."""
    pos = scores[labels.astype(bool)]
    neg = scores[~labels.astype(bool)]
    return {
        "mean_same": float(pos.mean()) if len(pos) else float("nan"),
        "std_same": float(pos.std(ddof=1)) if len(pos) > 1 else float("nan"),
        "mean_different": float(neg.mean()) if len(neg) else float("nan"),
        "std_different": float(neg.std(ddof=1)) if len(neg) > 1 else float("nan"),
    }


@dataclass
class BinaryScoreAccumulator:
    """Epoch-scoped accumulation of (score, label) pairs, the host-side
    replacement for torchmetrics states with ``dist_reduce_fx='cat'``."""

    scores: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)

    def update(self, scores, labels) -> None:
        self.scores.append(np.atleast_1d(np.asarray(scores)))
        self.labels.append(np.atleast_1d(np.asarray(labels)))

    def compute(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self.scores:  # a rank with no trial of its own
            return np.zeros(0, np.float32), np.zeros(0, np.int32)
        return np.concatenate(self.scores), np.concatenate(self.labels)

    def reset(self) -> None:
        self.scores.clear()
        self.labels.clear()
