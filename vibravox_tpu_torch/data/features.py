"""Waveform feature extraction of the STP data module (numpy).

The port's own ``Wav2Vec2FeatureExtractor``: ``configs/lightning_datamodule/stp.yaml``
names ``transformers.Wav2Vec2FeatureExtractor``, which the port does not
import; ``run.port_targets`` rewrites that target to this class.  It gives
what the HF class gives for the collate's call, byte for byte, in float32:
each waveform right-padded with ``padding_value`` to the longest (rounded
up to ``pad_to_multiple_of``), then, with ``do_normalize``, normalised.

With ``return_attention_mask=False`` (as ``stp.yaml`` sets it) HF's
``zero_mean_unit_var_norm`` gets no mask and normalises each padded row
over its whole length, padding included: ``(x - x.mean()) / sqrt(x.var() +
1e-7)``, so the pad is not ``padding_value`` afterwards.  That is what is
reproduced; with a mask the statistics cover the waveform only and the pad
is set back to ``padding_value``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["Wav2Vec2FeatureExtractor"]


class Wav2Vec2FeatureExtractor:
    def __init__(self, feature_size: int = 1, sampling_rate: int = 16000, padding_value: float = 0.0,
                 do_normalize: bool = True, return_attention_mask: bool = False):
        if feature_size != 1:
            raise ValueError(f"only mono waveforms are supported (feature_size 1), got {feature_size}")
        self.feature_size = feature_size
        self.sampling_rate = sampling_rate
        self.padding_value = padding_value
        self.do_normalize = do_normalize
        self.return_attention_mask = return_attention_mask

    def __call__(self, raw_speech: Sequence[np.ndarray], padding="longest",
                 pad_to_multiple_of: Optional[int] = None, return_tensors: Optional[str] = "np",
                 sampling_rate: Optional[int] = None,
                 return_attention_mask: Optional[bool] = None) -> Dict[str, np.ndarray]:
        """``{"input_values": (B, T) float32}`` and, when asked for (or set
        at construction), ``"attention_mask"`` (B, T) int32."""
        if sampling_rate is not None and sampling_rate != self.sampling_rate:
            raise ValueError(f"the extractor was set up for {self.sampling_rate} Hz, got {sampling_rate} Hz")
        if padding not in (True, "longest"):
            raise ValueError(f"unsupported padding {padding!r}: the STP collate pads to the longest")
        if return_tensors not in (None, "np"):
            raise ValueError(f"unsupported return_tensors {return_tensors!r}")
        rows = [np.asarray(x, dtype=np.float32).reshape(-1) for x in raw_speech]
        n = max(len(x) for x in rows)
        if pad_to_multiple_of and n % pad_to_multiple_of:
            n = (n // pad_to_multiple_of + 1) * pad_to_multiple_of
        values = np.full((len(rows), n), self.padding_value, dtype=np.float32)
        mask = np.zeros((len(rows), n), dtype=np.int32)
        for i, x in enumerate(rows):
            values[i, :len(x)] = x
            mask[i, :len(x)] = 1
        want_mask = self.return_attention_mask if return_attention_mask is None else return_attention_mask
        if self.do_normalize:
            for i, x in enumerate(rows):
                row = values[i]
                if want_mask:
                    valid = row[:len(x)]
                    normed = (row - valid.mean()) / np.sqrt(valid.var() + 1e-7)
                    normed[len(x):] = self.padding_value
                else:
                    normed = (row - row.mean()) / np.sqrt(row.var() + 1e-7)
                values[i] = normed
        out = {"input_values": values}
        if want_mask:
            out["attention_mask"] = mask
        return out
