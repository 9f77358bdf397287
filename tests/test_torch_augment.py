"""PyTorch port: waveform augmentation and the banded resampler against the
JAX package.

Sizes: two rows of T = 4000 at 4 kHz, where the pitch shift's dense banks
stay a few MB on the JAX side (16 kHz only for counting frames, which
builds no bank).  Each JAX transform is computed once per factor or step
(module fixtures).  Tolerances: speed perturbation 1e-5 of scale (the same
float32 polyphase bank and convolution); pitch shift 1e-4 of scale (float32
phases summed to 1e4 rad over the frames, and atan2 and |z| that differ in
their last bits between XLA and torch); the band against the dense bank
1e-6 of scale, and the entries it drops below 1e-15 of the largest tap.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.ops import augment as jax_augment
from vibravox_tpu.ops.resample import KaiserResampler as JaxKaiserResampler
from vibravox_tpu_torch.ops import augment, resample
from vibravox_tpu_torch.ops.resample import (
    DENSE_BANK_LIMIT,
    KaiserResampler,
    bank_nbytes,
    design_band,
    design_kernel,
)
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

SR = 4000
LIGHT_FACTORS = (0.7, 0.8, 0.85, 0.9, 0.95, 1.05, 1.1, 1.15, 1.2, 1.3)  # configs/.../light.yaml
PITCH_STEPS = (-4, -3, -2, -1, 1, 2, 3, 4, 5, 6)


@pytest.fixture(scope="module")
def signal():
    return (np.random.default_rng(0).standard_normal((2, 4000)) * 0.3).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("factor", [0.7, 0.85, 1.15, 1.3])
def test_speed_perturbation_matches_jax(factor, signal):
    want = np.asarray(jax_augment.speed_perturbation(jnp.asarray(signal), SR, factor))
    got = augment.speed_perturbation(torch.from_numpy(signal), SR, factor).numpy()
    assert got.shape == want.shape == (2, math.ceil(4000 * SR / round(SR * factor)))
    assert _rel(got, want) <= 1e-5


@pytest.fixture(scope="module")
def jax_pitch(signal):
    cache = {}

    def get(step):
        if step not in cache:
            cache[step] = np.asarray(jax_augment.pitch_shift(jnp.asarray(signal), SR, step))
        return cache[step]

    return get


@pytest.mark.parametrize("step", [-4, 1, 6])
def test_pitch_shift_matches_jax(step, signal, jax_pitch):
    want = jax_pitch(step)
    got = augment.pitch_shift(torch.from_numpy(signal), SR, step).numpy()
    assert got.shape == want.shape == signal.shape
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("step", PITCH_STEPS)
def test_stretched_frame_count_and_positions_are_jaxs(step):
    """At 16 kHz and T = 40000 (313 frames of hop 128): the stretched
    frames' read positions equal ``jnp.arange(0, n, rate)``, count and
    values, where a float32 ``torch.arange`` may be a frame off."""
    rate = 2.0 ** (-step / 12)
    n_frames = 1 + 40000 // 128
    want = np.asarray(jnp.arange(0, n_frames, rate))
    got = augment.stretched_frames(n_frames, rate)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n", [5, 40, 313, 443])
def test_blocked_cumsum_is_xlas_float32_cumsum(n):
    x = np.random.default_rng(n).standard_normal((2, n, 7)).astype(np.float32) * 400
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-2))
    got = augment.blocked_cumsum(torch.from_numpy(x), dim=-2).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("orig,new", [(101, 97), (97, 101), (331, 256), (257, 331)])
@pytest.mark.parametrize("window", ["kaiser", "hann"])
def test_band_matches_the_dense_bank(orig, new, window, signal, monkeypatch):
    """Rates whose gcd is 1: the banded resampler (its size limit set to 0)
    against the port's dense bank and JAX's (1e-6 of scale); the band holds
    the dense bank's own entries, and what it leaves out is below 1e-15 of
    the largest tap."""
    x = torch.from_numpy(signal)
    dense_resampler = KaiserResampler(orig, new, window)
    monkeypatch.setattr(resample, "DENSE_BANK_LIMIT", 0)
    banded_resampler = KaiserResampler(orig, new, window)
    assert banded_resampler.banded and not dense_resampler.banded
    dense, banded = dense_resampler(x).numpy(), banded_resampler(x).numpy()
    jax_dense = np.asarray(JaxKaiserResampler(orig, new, window=window)(jnp.asarray(signal)))
    assert banded.shape == dense.shape == jax_dense.shape
    assert _rel(banded, dense) <= 1e-6 and _rel(banded, jax_dense) <= 1e-6
    bank, _ = design_kernel(orig, new, window=window)
    taps, starts, _ = design_band(orig, new, window=window)
    inside = np.zeros(bank.shape, bool)
    for p, s in enumerate(starts):
        inside[p, s:s + taps.shape[1]] = True
    assert np.array_equal(bank[inside].reshape(taps.shape), taps)
    assert np.abs(bank[~inside]).max() <= 1e-15 * np.abs(bank).max()


@pytest.mark.parametrize("sample_rate", [16000, 48000])
def test_no_bank_of_the_config_exceeds_a_few_mb(sample_rate):
    """Every pitch step and speed factor of light/aggressive: the bank the
    resampler keeps, counted without building it, and the dense size the
    band avoids (over 200 MB for every pitch step at 16 kHz)."""
    kept = {}
    for what, orig in [(f"pitch {s}", int(sample_rate / 2.0 ** (-s / 12))) for s in PITCH_STEPS] + [
            (f"speed {f}", int(round(sample_rate * f))) for f in LIGHT_FACTORS]:
        g = math.gcd(orig, sample_rate)
        dense, band = bank_nbytes(orig // g, sample_rate // g)
        kept[what] = band if dense > DENSE_BANK_LIMIT else dense
        if what.startswith("pitch") and sample_rate == 16000:
            assert dense > 200e6
    assert max(kept.values()) <= 4e6, kept


def test_resampler_keeps_the_band_for_a_large_ratio():
    r = KaiserResampler(22627 * 5, 16000 * 5)  # pitch +6 at 16 kHz, before the gcd
    assert r.banded and r.nbytes() == bank_nbytes(22627, 16000)[1] < 2e6
    assert not KaiserResampler(48000, 16000).banded


def test_augmentation_draws_and_outputs_match_jax(signal):
    """Same generator state, time masking off: the same gates, factor and
    step, so the same transforms; outputs within the pitch tolerance."""
    kw = dict(sample_rate=SR, p_data_augmentation=1.0, p_speed_perturbation=1.0, p_pitch_shift=1.0,
              p_time_masking=0.0, speed_perturbation_factors=(0.85,), pitch_shift_steps=(-4, 1, 6))
    ours, ref = augment.WaveformDataAugmentation(**kw), jax_augment.WaveformDataAugmentation(**kw)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    w1, w2 = ours(torch.from_numpy(signal), torch.from_numpy(signal[::-1].copy()), rng=rng_a,
                  mask_rng=np.random.default_rng(0))
    j1, j2 = ref(jnp.asarray(signal), jnp.asarray(signal[::-1].copy()), rng=rng_b, jax_rng=jax.random.key(0))
    assert rng_a.bit_generator.state == rng_b.bit_generator.state
    assert _rel(w1.numpy(), j1) <= 1e-4 and _rel(w2.numpy(), j2) <= 1e-4


@pytest.mark.parametrize("pct", [1, 8])
def test_time_mask_at_a_given_start_is_jaxs_mask(pct, signal):
    key = jax.random.key(pct)
    want = np.asarray(jax_augment.time_masking_block(jnp.asarray(signal), pct, key))
    masked = int(4000 * pct / 100)
    start = int(jax.random.randint(key, (), 0, 4000 - masked))
    got = augment.time_mask_at(torch.from_numpy(signal), pct, start).numpy()
    assert np.array_equal(got, want)
    assert (got == 0).all(axis=0).sum() == masked
    drawn = augment.time_masking_block(torch.from_numpy(signal), pct, np.random.default_rng(0)).numpy()
    assert (drawn == 0).all(axis=0).sum() == masked


def test_augmentation_keeps_pairs_together_and_passes_when_gated_off(signal):
    aug = augment.WaveformDataAugmentation(SR, p_data_augmentation=1.0, p_speed_perturbation=1.0,
                                           p_pitch_shift=0.0, p_time_masking=1.0)
    x = torch.from_numpy(signal)
    w1, w2 = aug(x, x.clone(), rng=np.random.default_rng(1), mask_rng=np.random.default_rng(2))
    assert torch.equal(w1, w2) and w1.shape[-1] != x.shape[-1]
    off = augment.WaveformDataAugmentation(SR, p_data_augmentation=0.0)
    w1, w2 = off(x, None, rng=np.random.default_rng(1), mask_rng=np.random.default_rng(2))
    assert w1 is x and w2 is None
    with pytest.raises(ValueError, match="p_pitch_shift"):
        augment.WaveformDataAugmentation(SR, p_pitch_shift=1.5)
