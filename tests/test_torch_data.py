"""PyTorch port: the BWE host pipeline in the workflow, without JAX.

A resumed CPU fit with augmentation bit-equal to an uninterrupted one
(0 and 2 loader workers); the sources and options the data module used to
refuse (streaming, augmentation, npz directories, hub names); the streaming
loader's batches with any number of workers; the ``pad`` collate feeding a
train step with utterances shorter than the STFT loss's fft; the native
library's build, which raises when it cannot build; the resampler banks'
host memory; and the CLI with ``lightning_datamodule=noisybwe`` and its
``aggressive`` augmentation.  Sizes as ``tests/test_torch_workflow.py``:
the full-width generator, the discriminator at q = 4 / min_channels = 8,
one STFT resolution (512/50/240), batch 2 of 254 ms crops, one torch thread.
"""

import math
import os
import tracemalloc

import numpy as np
import pytest
import torch

from vibravox_tpu_torch.core.checkpoint import CheckpointManager
from vibravox_tpu_torch.core.loop import Trainer
from vibravox_tpu_torch.core.optim import adam
from vibravox_tpu_torch.data.bwe import BWEDataModule
from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.native import build as native_build
from vibravox_tpu_torch.ops.augment import WaveformDataAugmentation
from vibravox_tpu_torch.ops.resample import KaiserResampler, design_band
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.tasks.eben import EBENTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

PITCH_STEPS = (-4, -3, -2, -1, 1, 2, 3, 4, 5, 6)


def _task(seed=0, resolutions=((512, 50, 240),)):
    torch.manual_seed(seed)
    fft, hop, win = zip(*resolutions)
    return EBENTask(
        sample_rate=16000,
        generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"),
        generator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
        discriminator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            fft, hop, win, sample_rate=16000, perceptual_weighting=True, device="cpu"),
        feature_matching_loss_fn=FeatureMatchingLoss(), adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema", update_discriminator_ratio=0.5, device="cpu",
    )


def _augmentation():
    """``light``'s factors, steps and percentages (configs/lightning_datamodule/
    data_augmentation/light.yaml) with every transform firing on every batch."""
    return WaveformDataAugmentation(16000, p_data_augmentation=1.0, p_speed_perturbation=1.0,
                                    p_pitch_shift=1.0, p_time_masking=1.0)


def _dm(num_workers=0, **kw):
    args = dict(collate_strategy="constant_length-254-ms", batch_size=2, num_workers=num_workers,
                synthetic_size=2, device="cpu", data_augmentation=_augmentation())
    args.update(kw)
    return BWEDataModule(**args)


def _fit(ckpt_dir, max_epochs, num_workers=0, seed=0):
    trainer = Trainer(max_epochs=max_epochs, log_every_n_steps=1, check_val_every_n_epoch=100,
                      checkpoint=CheckpointManager(str(ckpt_dir)))
    trainer.fit(_task(seed), _dm(num_workers))
    return trainer


def _assert_bit_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}.{i}")
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    trainer = _fit(tmp_path_factory.mktemp("uninterrupted"), max_epochs=2)
    assert trainer.global_step == 2
    return trainer.state.state_dict()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_resumed_run_with_augmentation_is_bit_equal(uninterrupted, tmp_path, num_workers):
    _fit(tmp_path, max_epochs=1, num_workers=num_workers)
    resumed = _fit(tmp_path, max_epochs=2, num_workers=num_workers, seed=1)
    assert resumed.global_step == 2 and resumed.current_epoch == 2
    _assert_bit_equal(resumed.state.state_dict(), uninterrupted)


def test_augmented_batches_are_keyed_and_augmented():
    """The augmented training batches are a function of (seed, epoch,
    batch), the same with 0 and 2 workers, and not the plain crops."""
    def epoch_batches(dm, epoch):
        dm.setup("fit")
        loader = dm.train_dataloader()
        loader.batch_sampler.set_epoch(epoch)
        return [b["audio_body_conducted"].numpy().tobytes() for b in loader]

    e1 = epoch_batches(_dm(0, synthetic_size=4), 1)
    assert len(e1) == 2 and e1 == epoch_batches(_dm(2, synthetic_size=4), 1)
    assert e1 != epoch_batches(_dm(0, synthetic_size=4), 0)
    assert e1 != epoch_batches(_dm(0, synthetic_size=4, data_augmentation=None), 1)


class _FakeHub:
    """Stand-in for a ``datasets`` dataset of synthetic utterances."""

    def __init__(self, split, n, streaming):
        self.source = SyntheticVibravoxSource(n, min_seconds=0.1, max_seconds=0.4, split=split)
        self.streaming, self.column_names = streaming, None
        self.casts = []

    def row(self, i):
        item = self.source[i]
        return {"audio.rigid_in_ear_microphone": {"array": item["audio_body_conducted"]},
                "audio.headset_microphone": {"array": item["audio_airborne"]}}

    def __len__(self):
        if self.streaming:
            raise TypeError("a stream has no length")
        return self.source.n

    def __getitem__(self, i):
        return self.row(i)

    def __iter__(self):
        return (self.row(i) for i in range(self.source.n))

    def cast_column(self, col, feature):
        self.casts.append((col, feature))
        return self


@pytest.fixture()
def fake_hub(monkeypatch):
    """The hub datasets that ``load_dataset`` made, in order."""
    import datasets

    hubs = []
    monkeypatch.setattr(datasets, "load_dataset",
                        lambda name, subset, split, streaming: hubs.append(_FakeHub(f"{name}-{split}", 6, streaming))
                        or hubs[-1])
    return hubs


def _npz_dir(root):
    for split in ("train", "validation", "test"):
        source = SyntheticVibravoxSource(3, split=f"speech_clean-{split}")
        (root / split).mkdir(parents=True)
        for i in range(3):
            np.savez(root / split / f"{i:05d}.npz", **source[i])
    return str(root)


@pytest.mark.parametrize("kw", ["streaming", "augmentation", "npz", "hub", "secondary_hub"])
def test_data_module_takes_what_it_used_to_refuse(kw, fake_hub, tmp_path):
    """Each option the data module refused until the BWE pipeline was
    ported gives batches now: a stream (streaming=True over the hub), the
    augmentation, an npz directory, a hub name, a secondary hub source."""
    args = {"streaming": dict(dataset_name_principal="hub", streaming=True),
            "augmentation": dict(data_augmentation=_augmentation()),
            "npz": dict(dataset_name_principal=_npz_dir(tmp_path / "npz")),
            "hub": dict(dataset_name_principal="hub"),
            "secondary_hub": dict(dataset_name_secondary="hub")}[kw]
    dm = BWEDataModule(collate_strategy="constant_length-254-ms", batch_size=2, num_workers=0,
                       synthetic_size=3, device="cpu", **dict({"data_augmentation": None}, **args))
    dm.setup("fit")
    batch = next(iter(dm.train_dataloader()))
    assert batch["audio_body_conducted"].shape == batch["audio_airborne"].shape == (2, 4064, 1)
    val = dm.val_dataloader()
    if kw == "secondary_hub":
        assert set(val) == {"principal", "secondary"}
        val = val["secondary"]
    assert next(iter(val))["audio_airborne"].shape == (1, 4064, 1)
    if kw == "npz":
        want = BWECollate(16000, "constant_length-254-ms", deterministic=True)(
            [SyntheticVibravoxSource(3, split="speech_clean-validation")[0]])
        assert torch.equal(next(iter(val))["audio_body_conducted"], want["audio_body_conducted"])


def test_hub_source_without_datasets_names_the_package(monkeypatch):
    """The H100 machine has no ``datasets``: a hub name raises an error
    that names the package and the sources that work without it."""
    import sys

    from vibravox_tpu_torch.data.sources import load_hf_vibravox

    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="'datasets' package"):
        load_hf_vibravox("Cnam-LMSSC/vibravox", "speech_clean", "train", "rigid_in_ear_microphone", 16000)
    with pytest.raises(ImportError, match="'datasets' package"):
        BWEDataModule(dataset_name_principal="Cnam-LMSSC/vibravox", device="cpu").setup("test")


def test_streaming_batches_are_the_same_with_any_workers(fake_hub):
    def epoch(workers, e):
        dm = BWEDataModule(dataset_name_principal="hub", streaming=True, batch_size=2, num_workers=workers,
                           collate_strategy="constant_length-254-ms", device="cpu")
        dm.setup("fit")
        loader = dm.train_dataloader()
        loader.dataset.set_epoch(e)
        return [b["audio_body_conducted"].numpy().tobytes() for b in loader]

    e0 = epoch(0, 0)
    assert len(e0) == 3 and epoch(2, 0) == e0 and epoch(0, 1) != e0


def test_stream_workers_decode_only_their_own_batches(fake_hub, monkeypatch):
    """A stream's audio is cast undecoded, and each loader worker decodes
    only the rows of the batches it collates: over three workers every row
    of the epoch is decoded once, and their batches, interleaved, are the
    one-process loader's."""
    from types import SimpleNamespace

    dm = BWEDataModule(dataset_name_principal="hub", streaming=True, batch_size=2, num_workers=0,
                       collate_strategy="constant_length-254-ms", device="cpu")
    dm.setup("fit")
    assert [f.decode for _, f in fake_hub[0].casts] == [False, False]
    stream = dm.train_dataloader().dataset
    decoded, decode = [], stream.source.decode
    monkeypatch.setattr(stream.source, "decode", lambda row: decoded.append(row) or decode(row))

    def batches():
        decoded.clear()
        return [b["audio_body_conducted"].numpy().tobytes() for b in stream], len(decoded)

    one, n_one = batches()
    assert len(one) == 3 and n_one == 6
    by_worker = []
    for w in range(3):
        monkeypatch.setattr(torch.utils.data, "get_worker_info", lambda w=w: SimpleNamespace(id=w, num_workers=3))
        by_worker.append(batches())
    assert [b for got, _ in by_worker for b in got] == one
    assert [n for _, n in by_worker] == [2, 2, 2]


def test_pad_collate_feeds_the_generator_loss_at_t_below_half_the_fft():
    """``pad`` rounds the batch up to a multiple of 1024 samples: utterances
    under 1024 give T = 1024 (960 after the generator's cut), which the
    2048-point resolution of ``multi_stft.yaml`` pads by reflecting more
    than once (T <= fft / 2; on the card K3 and K4 take it,
    ``tests/test_torch_cuda_kernels.py``).  The generator's forward and its
    STFT loss take such a batch, with gradients; the discriminator does not
    (its deepest scales need about 3000 samples; ROADMAP Queue 3)."""
    source = SyntheticVibravoxSource(2, min_seconds=0.03, max_seconds=0.06, split="speech_clean-train")
    batch = BWECollate(16000, "pad")([source[0], source[1]])
    assert batch["audio_body_conducted"].shape == (2, 1024, 1)
    task = _task(resolutions=((512, 50, 240), (2048, 240, 1200)))
    gen = task.generator
    corrupted = gen.cut_to_valid_length(batch["audio_body_conducted"])
    enhanced, _ = gen(corrupted)
    loss = task.reconstructive_loss_freq_fn(enhanced, gen.cut_to_valid_length(batch["audio_airborne"]))
    loss.backward()
    grads = [p.grad for p in gen.parameters() if p.grad is not None]
    assert corrupted.shape[1] <= 1024 and math.isfinite(float(loss.detach())) and grads
    assert all(torch.isfinite(g).all() for g in grads)


def test_native_build_raises_without_a_working_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build()
    monkeypatch.undo()
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "FLAGS", native_build.FLAGS + ("-no-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build()
    assert not list(tmp_path.iterdir())  # no partial library left behind
    monkeypatch.undo()
    lib = native_build.build()
    assert lib.is_file() and lib == native_build.build()


@pytest.mark.parametrize("offsets,target", [([0, -1], 100), ([0, 101], 100), ([0], 100), ([0, 0], 0)])
def test_native_collate_refuses_what_would_read_out_of_bounds(offsets, target):
    from vibravox_tpu_torch.native import pipeline

    rows = [np.zeros(300, np.float32), np.zeros(200, np.float32)]
    with pytest.raises(ValueError):
        pipeline.collate_pair(rows, None, offsets, target)
    body, _ = pipeline.collate_pair(rows, None, [200, 100], 100)  # the last in-range crops
    assert body.shape == (2, 100)


@pytest.mark.parametrize("step", [-4, 1, 6])
def test_pitch_resampler_design_stays_small_on_the_host(step):
    """The band of a pitch step at 16 kHz, designed from scratch: under
    1.5 MB kept and under 32 MB at its peak while designed, where the dense
    bank would hold 0.8-1.4 GB (twice that in float64)."""
    orig = int(16000 / 2.0 ** (-step / 12))
    design_band.cache_clear()
    tracemalloc.start()
    try:
        resampler = KaiserResampler(orig, 16000)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert resampler.banded and resampler.nbytes() <= 1.5e6 and peak <= 32e6


def test_cli_runs_noisy_bwe_with_its_aggressive_augmentation(tmp_path):
    from vibravox_tpu_torch.run import main

    args = ["lightning_datamodule=noisybwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
            "logging=csv", "lightning_datamodule.dataset_name=synthetic",
            "++lightning_datamodule.synthetic_size=4", "++lightning_datamodule.batch_size=2",
            "++lightning_datamodule.num_workers=0",
            "++lightning_datamodule.collate_strategy=constant_length-254-ms",
            "++trainer.limit_val_batches=1", "++trainer.limit_test_batches=1", "++trainer.max_epochs=1",
            "++lightning_module.compute_dtype=null", "++lightning_module.discriminator.min_channels=8",
            f"++run_dir={tmp_path}", "++device=cpu"]
    cwd = os.getcwd()
    metrics = main(args)
    assert os.getcwd() == cwd
    assert {"test/torchmetrics_stoi/synthetic", "test/torchmetrics_si_sdr/synthetic",
            "test/generator/reconstructive_loss_freq/synthetic"} <= set(metrics)
    assert not any(k.endswith("/real") for k in metrics)  # no reference, no SQUIM: nothing to log
    assert all(math.isfinite(v) for v in metrics.values())
    assert (tmp_path / "checkpoints" / "last" / "state.pt").exists()
    header = (tmp_path / "csv" / "metrics.csv").read_text().splitlines()[0]
    assert "validation/torchmetrics_stoi/synthetic" in header and "train/generator/backprop_loss" in header
