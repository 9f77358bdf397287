"""PyTorch port: the BWE host pipeline against the JAX package.

The collate (constant-length and ``pad``, with and without augmentation),
the native batch assembly and host resampler (the serving path's), the npz and HF sources, the
streaming loader's shuffle buffer, and the audio and biquad helpers.
Tolerances: batches without augmentation byte-equal (the same draws from
the same generator state); augmented batches 1e-4 of scale (the pitch
shift's, ``tests/test_torch_augment.py``); the native resampler equal to
its numpy twin within 1e-6 of scale (float64 sums in another order); the
biquad 1e-5 of scale (float32 recurrences, scipy's against a JAX scan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.data.collate import BWECollate as JaxBWECollate
from vibravox_tpu.data.loader import DataLoader as JaxDataLoader
from vibravox_tpu.data.sources import NpzDirectorySource as JaxNpzDirectorySource
from vibravox_tpu.data.sources import load_hf_vibravox as jax_load_hf_vibravox
from vibravox_tpu.native import pipeline as jax_native
from vibravox_tpu.ops import audio as jax_audio
from vibravox_tpu.ops import biquad as jax_biquad
from vibravox_tpu.ops.augment import WaveformDataAugmentation as JaxWaveformDataAugmentation
from vibravox_tpu_torch.data.bwe import BWEDataModule
from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import NpzDirectorySource, SyntheticVibravoxSource, load_hf_vibravox
from vibravox_tpu_torch.native import pipeline as native
from vibravox_tpu_torch.ops import audio, biquad
from vibravox_tpu_torch.ops.augment import WaveformDataAugmentation
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


@pytest.fixture()
def jax_numpy_collate(monkeypatch):
    """The JAX collate on its numpy path (its native library is built by
    several test workers at once, ROADMAP Queue 3)."""
    monkeypatch.setattr(jax_native, "native_available", lambda: False)


def _pairs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [{"audio_body_conducted": rng.standard_normal(t).astype(np.float32),
             "audio_airborne": rng.standard_normal(t).astype(np.float32)} for t in lengths]


def _assert_same_bytes(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("lengths", [(900, 300, 1024, 77), (5000, 700, 2049)])
def test_pad_strategy_is_byte_equal_to_jax(lengths, deterministic, jax_numpy_collate):
    samples = _pairs(lengths)
    ours = BWECollate(16000, "pad", deterministic=deterministic, seed=3)
    ref = JaxBWECollate(16000, "pad", deterministic=deterministic, seed=3)
    got, want = ours(samples), ref(samples)
    assert got["audio_body_conducted"].shape[1] == -(-max(lengths) // 1024) * 1024
    _assert_same_bytes(got, want)


def _augmentations(**kw):
    """Both packages' augmentation with light's speed factors, a pitch step
    of an octave (a 2/1 resample, small banks on the JAX side) and the
    time mask off (its start's stream differs by design)."""
    kw = dict(dict(sample_rate=4000, p_data_augmentation=1.0, p_speed_perturbation=0.5, p_pitch_shift=0.5,
                   p_time_masking=0.0, pitch_shift_steps=(12,)), **kw)
    return WaveformDataAugmentation(**kw), JaxWaveformDataAugmentation(**kw)


def test_augmented_collate_matches_jax(jax_numpy_collate):
    """Four batches from generators in the same state: the same draws
    (crops, gates, factors, the re-crop), so byte-equal batches where no
    transform fired and within 1e-4 of scale where one did."""
    ours_aug, ref_aug = _augmentations()
    ours = BWECollate(4000, "constant_length-1000-ms", augmentation=ours_aug, seed=3)
    ref = JaxBWECollate(4000, "constant_length-1000-ms", augmentation=ref_aug, seed=3)
    fired = 0
    for b in range(4):
        samples = _pairs((5000, 4000, 3500), seed=b)
        state = ours.rng.bit_generator.state
        got, want = ours(samples), ref(samples)
        assert ours.rng.bit_generator.state == ref.rng.bit_generator.state
        plain = BWECollate(4000, "constant_length-1000-ms", seed=0)
        plain.rng.bit_generator.state = state
        crops = plain(samples)
        changed = not torch.equal(crops["audio_body_conducted"], got["audio_body_conducted"])
        fired += changed
        for k in want:
            w = np.asarray(want[k])
            assert got[k].shape == w.shape == (3, 4000, 1)
            err = np.abs(got[k].numpy() - w).max()
            assert err <= (1e-4 * np.abs(w).max() if changed else 0.0), (b, k, err)
    assert fired >= 2


def test_native_collate_is_byte_equal_to_its_twin_and_to_jax():
    samples = _pairs((3000, 2000, 1200, 2501), seed=7)
    bodies = [s["audio_body_conducted"] for s in samples]
    airs = [s["audio_airborne"] for s in samples]
    offsets = [500, 0, 0, 1]
    got = native.collate_pair(bodies, airs, offsets, 2000)
    twin = native.collate_pair_numpy(bodies, airs, offsets, 2000)
    from vibravox_tpu.data.collate import _fix_length_at as jax_fix_length_at

    want = [np.stack([jax_fix_length_at(x, 2000, o) for x, o in zip(xs, offsets)]) for xs in (bodies, airs)]
    for g, t, w in zip(got, twin, want):
        assert g.tobytes() == t.tobytes() == w.tobytes()
    body_only, none = native.collate_pair(bodies, None, offsets, 2000)
    assert none is None and body_only.tobytes() == got[0].tobytes()


@pytest.mark.parametrize("orig,new", [(48000, 16000), (16000, 24000), (11025, 16000)])
def test_native_resampler_matches_its_twin_and_jax(orig, new):
    x = np.random.default_rng(orig).standard_normal(4801).astype(np.float32)
    got = native.resample_poly(x, orig, new)
    twin = native.resample_poly_numpy(x, orig, new)
    want = jax_native._resample_poly_numpy(x, orig, new)
    assert got.shape == twin.shape == want.shape
    assert np.abs(got - twin).max() <= 1e-6 * np.abs(twin).max()
    assert twin.tobytes() == want.tobytes()


def test_npz_directory_source_matches_jax(tmp_path):
    items = [SyntheticVibravoxSource(3, split="speech_clean-train", with_metadata=True)[i] for i in range(3)]
    for i, item in enumerate(items):
        np.savez(tmp_path / f"{i:05d}.npz", **item)
    ours, ref = NpzDirectorySource(str(tmp_path)), JaxNpzDirectorySource(str(tmp_path))
    assert len(ours) == len(ref) == 3
    for i in range(3):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) == set(items[i])
        for k in a:
            assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], items[i][k])
    with pytest.raises(FileNotFoundError):
        NpzDirectorySource(str(tmp_path / "missing"))


class _FakeHub:
    """Stand-in for a ``datasets`` dataset: map-style with a length, or a
    stream (``column_names`` None) without one."""

    def __init__(self, n, streaming, length=100):
        self.n, self.streaming, self.length = n, streaming, length
        self.column_names = None if streaming else [
            "audio.rigid_in_ear_microphone", "audio.headset_microphone", "speaker_id", "extra"]
        self.cast_calls, self.removed = [], []

    def row(self, i):
        rng = np.random.default_rng(i)
        return {"audio.rigid_in_ear_microphone": {"array": rng.standard_normal(self.length), "sampling_rate": 16000},
                "audio.headset_microphone": {"array": rng.standard_normal(self.length), "sampling_rate": 16000},
                "speaker_id": str(i % 3)}

    def __len__(self):
        if self.streaming:
            raise TypeError("a stream has no length")
        return self.n

    def __getitem__(self, i):
        return self.row(i)

    def __iter__(self):
        return (self.row(i) for i in range(self.n))

    def cast_column(self, col, feature):
        self.cast_calls.append(col)
        return self

    def remove_columns(self, cols):
        self.removed = cols
        return self


@pytest.mark.parametrize("streaming", [False, True])
def test_hf_sources_match_jax(streaming, monkeypatch):
    import datasets

    hubs = []
    monkeypatch.setattr(datasets, "load_dataset", lambda *a, **k: hubs.append(_FakeHub(5, streaming)) or hubs[-1])
    args = ("Cnam-LMSSC/vibravox", "speech_clean", "train", "rigid_in_ear_microphone", 16000, streaming)
    ours, ref = load_hf_vibravox(*args), jax_load_hf_vibravox(*args)
    assert [h.removed for h in hubs] == ([[], []] if streaming else [["extra"], ["extra"]])
    assert all(sorted(h.cast_calls) == ["audio.headset_microphone", "audio.rigid_in_ear_microphone"] for h in hubs)
    rows, want = list(ours), list(ref)
    assert len(rows) == len(want) == 5
    for a, b in zip(rows, want):
        assert set(a) == set(b) == {"audio_body_conducted", "audio_airborne", "speaker_id"}
        assert a["audio_body_conducted"].dtype == np.float32
        for k in a:
            assert np.array_equal(a[k], b[k])
    if streaming:
        with pytest.raises(TypeError):
            len(ours)
    else:
        assert len(ours) == 5 and np.array_equal(ours[3]["audio_airborne"], ref[3]["audio_airborne"])


def test_streaming_loader_matches_the_jax_shuffle_buffer(monkeypatch):
    """300 streamed items (more than the 256-item buffer), batch 8: the
    port's training loader gives the JAX loader's batches of epoch 0 (the
    items are shorter than the crop, so the collate pads them and draws
    nothing).  With loader workers: ``tests/test_torch_data.py``."""
    import datasets

    monkeypatch.setattr(datasets, "load_dataset", lambda *a, **k: _FakeHub(300, True))
    ref_source = jax_load_hf_vibravox("hub", "speech_clean", "train", "rigid_in_ear_microphone", 16000, True)
    ref = JaxDataLoader(ref_source, JaxBWECollate(16000, "constant_length-10-ms", seed=42), 8, shuffle=True,
                        drop_last=True, seed=42, prefetch=0)
    ref.set_epoch(0)
    want = [b["audio_body_conducted"].tobytes() for b in ref]
    assert len(want) == 37
    dm = BWEDataModule(dataset_name_principal="hub", streaming=True, batch_size=8, num_workers=0,
                       collate_strategy="constant_length-10-ms", seed=42, device="cpu")
    dm.setup("fit")
    loader = dm.train_dataloader()
    loader.dataset.set_epoch(0)
    assert [b["audio_body_conducted"].numpy().tobytes() for b in loader] == want


def test_audio_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 900)).astype(np.float32)
    assert np.array_equal(audio.pad_audio(torch.from_numpy(x), 1001).numpy(),
                          np.asarray(jax_audio.pad_audio(jnp.asarray(x), 1001)))
    assert np.array_equal(audio.slice_audio(torch.from_numpy(x), 300, 17).numpy(),
                          np.asarray(jax_audio.slice_audio(jnp.asarray(x), 300, 17)))
    a, b = audio.set_audio_duration(torch.from_numpy(x), 400, torch.from_numpy(-x), deterministic=True)
    ja, jb = jax_audio.set_audio_duration(jnp.asarray(x), 400, jnp.asarray(-x), deterministic=True)
    assert np.array_equal(a.numpy(), np.asarray(ja)) and np.array_equal(b.numpy(), np.asarray(jb))
    with pytest.raises(ValueError):
        audio.pad_audio(torch.from_numpy(x), 10)
    speech = [torch.from_numpy(x[0, :500]), torch.from_numpy(x[1, :300])]
    noise = [torch.from_numpy(x[1]), torch.from_numpy(x[0])]
    mixed, sliced = audio.mix_speech_and_noise_without_rescaling(speech, noise, np.random.default_rng(1))
    for s, n, m, c in zip(speech, noise, mixed, sliced):
        assert torch.equal(m, s + c) and c.shape == s.shape
        start = [i for i in range(len(n) - len(s)) if torch.equal(n[i:i + len(s)], c)]
        assert start
    mixed, scaled = audio.mix_speech_and_noise_with_rescaling(speech, noise, np.random.default_rng(1), (-3.0, 5.0))
    rng = np.random.default_rng(1)  # the same draws: a start, then the SNR, per pair
    for s, n, m, c in zip(speech, noise, mixed, scaled):
        start, snr = int(rng.integers(0, len(n) - len(s))), rng.uniform(-3.0, 5.0)
        want = n[start:start + len(s)] * torch.sqrt(s.pow(2).mean() / (n.pow(2).mean() * 10.0 ** (snr / 10.0)))
        assert torch.allclose(c, want, rtol=1e-6, atol=0) and torch.equal(m, s + c)


def test_biquad_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9000)).astype(np.float32)
    for got, want in [
        (biquad.lowpass_biquad(torch.from_numpy(x), 16000, 1000.0), jax_biquad.lowpass_biquad(jnp.asarray(x), 16000, 1000.0)),
        (biquad.remove_hf(torch.from_numpy(x), 16000, 1000.0), jax_biquad.remove_hf(jnp.asarray(x), 16000, 1000.0)),
        (biquad.remove_hf(torch.from_numpy(x[0]), 16000, 2000.0), jax_biquad.remove_hf(jnp.asarray(x[0]), 16000, 2000.0)),
    ]:
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    b, a = biquad.biquad_coeffs_lowpass(16000, 1000.0)
    jb, ja = jax_biquad.biquad_coeffs_lowpass(16000, 1000.0)
    np.testing.assert_allclose(b, np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose(a, np.asarray(ja), rtol=1e-6)
