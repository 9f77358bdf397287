"""ctypes bindings of the native host kernels, with their numpy twins.

Counterpart of ``vibravox_tpu/native/pipeline.py``: ``collate_pair`` (the
BWE collate's batch assembly) and ``resample_poly`` (the serving path's
polyphase resample of requests at other rates) run ``audio_pipeline.cpp``.
The library is built at first use (``native/build.py``) and a failed build
raises: there is no switch that turns it off and no silent numpy fallback.
The numpy twins, ``collate_pair_numpy`` and ``resample_poly_numpy``, are the
tests' oracles.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from vibravox_tpu_torch.ops.resample import design_kernel

__all__ = ["collate_pair", "collate_pair_numpy", "resample_poly", "resample_poly_numpy"]

_N_THREADS = min(8, os.cpu_count() or 1)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    from vibravox_tpu_torch.native.build import build

    lib = ctypes.CDLL(str(build()))
    c_float_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    lib.vx_collate_pair.restype = None
    lib.vx_collate_pair.argtypes = [
        c_float_pp, c_float_pp,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.float32), ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    lib.vx_resample_poly.restype = None
    lib.vx_resample_poly.argtypes = [
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int64, ctypes.c_int,
    ]
    return lib


def _as_ptr_array(arrays: Sequence[np.ndarray]):
    ptr_t = ctypes.POINTER(ctypes.c_float)
    ptrs = (ptr_t * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data_as(ptr_t)
    return ptrs


def collate_pair(
    bodies: Sequence[np.ndarray],
    airs: Optional[Sequence[np.ndarray]],
    offsets: Sequence[int],
    target: int,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Fixed-length rows: crop from ``offsets[i]`` when utterance i is
    longer than ``target``, zero-pad it symmetrically when shorter; its
    airborne pair, if any, alike.  Returns ``(body (B, target) float32, air
    or None)``."""
    lib = _library()
    bodies = [np.ascontiguousarray(b, np.float32).reshape(-1) for b in bodies]
    lengths = np.asarray([b.shape[-1] for b in bodies], np.int64)
    offs = np.asarray(offsets, np.int64)
    if len(offs) != len(bodies) or target < 1:
        raise ValueError(f"{len(bodies)} utterances, {len(offs)} offsets, target {target}")
    crop = lengths >= target
    if (offs < 0).any() or (offs[crop] + target > lengths[crop]).any():
        raise ValueError(f"crop offsets {offs.tolist()} out of range for lengths {lengths.tolist()} and target {target}")
    out_body = np.empty((len(bodies), target), np.float32)
    out_air, air_ptrs, out_air_ptr = None, None, None
    if airs is not None:
        airs = [np.ascontiguousarray(a, np.float32).reshape(-1) for a in airs]
        if any(a.shape[-1] != n for a, n in zip(airs, lengths)):
            raise ValueError("each airborne signal must be as long as its body-conducted pair")
        out_air = np.empty((len(bodies), target), np.float32)
        air_ptrs = _as_ptr_array(airs)
        out_air_ptr = out_air.ctypes.data_as(ctypes.c_void_p)
    lib.vx_collate_pair(_as_ptr_array(bodies), air_ptrs, lengths, offs, out_body, out_air_ptr,
                        len(bodies), target, _N_THREADS)
    return out_body, out_air


def _fix_length_at(audio: np.ndarray, desired: int, offset: int) -> np.ndarray:
    t = audio.shape[-1]
    if t >= desired:
        return audio[offset:offset + desired]
    left = (desired - t) // 2
    return np.pad(audio, (left, desired - t - left))


def collate_pair_numpy(bodies, airs, offsets, target):
    """The numpy twin of ``collate_pair``."""
    body = np.stack([_fix_length_at(np.asarray(b, np.float32), target, o) for b, o in zip(bodies, offsets)])
    air = (np.stack([_fix_length_at(np.asarray(a, np.float32), target, o) for a, o in zip(airs, offsets)])
           if airs is not None else None)
    return body, air


@functools.lru_cache(maxsize=None)
def _bank(orig_freq: int, new_freq: int, window: str):
    """(kernels (phases, width_total) float32 or None for equal rates,
    left_pad, orig_g, new_g) for the rates reduced by their gcd."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = int(orig_freq) // gcd, int(new_freq) // gcd
    if orig_g == new_g:
        return None, 0, orig_g, new_g
    kernels, width = design_kernel(orig_g, new_g, window=window)
    return kernels, width, orig_g, new_g


def resample_poly(x: np.ndarray, orig_freq: int, new_freq: int, window: str = "kaiser") -> np.ndarray:
    """Resample a 1-D waveform on the host with the dense polyphase bank of
    ``ops/resample.py``; ``ceil(len(x) new / orig)`` samples."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    kernels, width, orig_g, new_g = _bank(int(orig_freq), int(new_freq), window)
    if kernels is None:
        return x
    out_len = int(math.ceil(new_g * len(x) / orig_g))
    out = np.empty((out_len,), np.float32)
    _library().vx_resample_poly(x, len(x), kernels, kernels.shape[0], kernels.shape[1],
                                orig_g, width, out, out_len, _N_THREADS)
    return out


def resample_poly_numpy(x: np.ndarray, orig_freq: int, new_freq: int, window: str = "kaiser") -> np.ndarray:
    """The numpy twin of ``resample_poly`` (the JAX package's
    ``_resample_poly_numpy``): each output window is one float64 matrix
    product over all phases."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    kernels, width, orig_g, new_g = _bank(int(orig_freq), int(new_freq), window)
    if kernels is None:
        return x
    out_len = int(math.ceil(new_g * len(x) / orig_g))
    n_wins = -(-out_len // new_g)
    width_total = kernels.shape[1]
    pad_right = max(0, (n_wins - 1) * orig_g - width + width_total - len(x))
    padded = np.pad(x.astype(np.float64), (width, pad_right))
    starts = np.arange(n_wins) * orig_g
    windows = padded[starts[:, None] + np.arange(width_total)[None, :]]
    y = windows @ kernels.astype(np.float64).T  # (n_wins, phases)
    return y.reshape(-1)[:out_len].astype(np.float32)
