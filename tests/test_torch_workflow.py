"""PyTorch port: the BWE/EBEN workflow around the train step, without JAX.

The trainer's resume, checkpoints, failure guard, loggers, profiler and
mesh check; the data module's epoch-keyed loader and eval loaders; the
task's refusals and gradient-norm logs; and the CLI, on the CPU at tiny
sizes.  The train runs use the full-width generator, the discriminator at
q = 4 / min_channels = 8, one STFT resolution, float32, batch 2 of 254 ms
crops (about the shortest the discriminator takes), one step an epoch.  A
resumed run must equal an uninterrupted one bit for bit: parameters, both
Adam states, EMA norms, step and gate.

The module runs torch on one thread: the suite runs in several processes
at once, and torch's default of one thread per core in each of them
oversubscribes the cores many times over.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from vibravox_tpu_torch.core.callbacks import ModelSummary
from vibravox_tpu_torch.core.checkpoint import CheckpointManager
from vibravox_tpu_torch.core.guard import AnomalyDetected, FailureGuard
from vibravox_tpu_torch.core.logging import CSVLogger, MultiLogger, TensorBoardLogger, read_events
from vibravox_tpu_torch.core.loop import Trainer, parallel_for
from vibravox_tpu_torch.core.optim import MultiSteps
from vibravox_tpu_torch.parallel.mesh import MeshConfig
from vibravox_tpu_torch.core.optim import adam
from vibravox_tpu_torch.core.profiler import StepTimer, trace_window
from vibravox_tpu_torch.data.bwe import BWEDataModule
from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.tasks.eben import EBENTask
from vibravox_tpu_torch.tasks.se_metrics import SEMetrics
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


def _task(seed=0, **kw):
    torch.manual_seed(seed)
    args = dict(
        sample_rate=16000,
        generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"),
        generator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
        discriminator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            (512,), (50,), (240,), sample_rate=16000, perceptual_weighting=True, device="cpu"),
        feature_matching_loss_fn=FeatureMatchingLoss(), adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema", update_discriminator_ratio=0.5, device="cpu",
    )
    args.update(kw)
    return EBENTask(**args)


def _dm(num_workers=0, **kw):
    args = dict(collate_strategy="constant_length-254-ms", batch_size=2, num_workers=num_workers,
                synthetic_size=2, device="cpu")
    args.update(kw)
    return BWEDataModule(**args)


def _fit(ckpt_dir, max_epochs, num_workers=0, seed=0, task=None, **trainer_kw):
    """A fit with no validation (so `last` is the only checkpoint)."""
    task = task or _task(seed)
    trainer = Trainer(max_epochs=max_epochs, log_every_n_steps=1, check_val_every_n_epoch=100,
                      checkpoint=CheckpointManager(str(ckpt_dir)), **trainer_kw)
    trainer.fit(task, _dm(num_workers))
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
    """Two epochs in one fit: the trainer and its final state dict."""
    trainer = _fit(tmp_path_factory.mktemp("uninterrupted"), max_epochs=2)
    assert trainer.global_step == 2 and trainer.state.step == 2 and trainer.current_epoch == 2
    return trainer, trainer.state.state_dict()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(uninterrupted, tmp_path, num_workers):
    first = _fit(tmp_path, max_epochs=1, num_workers=num_workers)
    assert first.global_step == 1 and CheckpointManager(str(tmp_path)).trainer_state() == {
        "epoch": 0, "global_step": 1}
    # another seed: everything the resumed run trains on comes from `last`
    resumed = _fit(tmp_path, max_epochs=2, num_workers=num_workers, seed=1)
    assert resumed.global_step == 2 and resumed.current_epoch == 2
    assert [s for s, lg in resumed.logged if "train/generator/backprop_loss" in lg] == [1]
    _assert_bit_equal(resumed.state.state_dict(), uninterrupted[1])


def test_training_loader_is_keyed_to_the_epoch():
    """Each epoch's batches depend on (seed, epoch) only: the same with 0
    and 2 workers and for a fresh loader, other from epoch to epoch; a
    pass without set_epoch repeats the epoch last set (0 at first)."""
    def epoch_batches(loader, epoch):
        if epoch is not None:
            loader.batch_sampler.set_epoch(epoch)
        return [b["audio_body_conducted"].numpy().tobytes() for b in loader]

    dm0, dm2 = _dm(0, synthetic_size=6), _dm(2, synthetic_size=6)
    dm0.setup("fit"), dm2.setup("fit")
    l0, l2 = dm0.train_dataloader(), dm2.train_dataloader()
    e1 = epoch_batches(l0, 1)
    assert len(e1) == 3 and e1 == epoch_batches(l2, 1) == epoch_batches(dm0.train_dataloader(), 1)
    e0 = epoch_batches(l0, 0)
    assert e0 != e1
    fresh = dm0.train_dataloader()
    assert epoch_batches(fresh, None) == e0 and epoch_batches(fresh, None) == e0
    assert epoch_batches(l0, None) == e0


def test_eval_loaders_and_stages():
    dm = _dm(0, dataset_name_secondary="synthetic", synthetic_size=3)
    dm.setup("validate")
    val = dm.val_dataloader()
    assert set(val) == {"principal", "secondary"}
    dm.setup("test")
    test = dm.test_dataloader()
    batches = list(test["principal"])
    assert len(batches) == 3 and batches[0]["audio_body_conducted"].shape == (1, 4064, 1)
    item = SyntheticVibravoxSource(3, split="speech_clean-test")[0]
    want = BWECollate(16000, "constant_length-254-ms", deterministic=True)([item])
    for k in want:  # centred crops, in order
        assert torch.equal(batches[0][k], want[k])
    single = _dm(0)
    single.setup("test")
    assert isinstance(single.test_dataloader(), torch.utils.data.DataLoader)


class _Box:
    """A stand-in train state: one tensor."""

    def __init__(self, value):
        self.x = torch.tensor([float(value)])

    def state_dict(self):
        return {"x": self.x.clone()}

    def load_state_dict(self, sd):
        self.x = sd["x"]


@pytest.mark.parametrize("mode,values,kept,best", [
    ("max", [0.5, 0.7, 0.6, 0.9], {"2": 0.7, "4": 0.9}, 4),
    ("min", [0.5, 0.7, 0.6, 0.9], {"1": 0.5, "3": 0.6}, 1),
])
def test_checkpoint_top_k_and_last(tmp_path, mode, values, kept, best):
    ckpt = CheckpointManager(str(tmp_path), monitor="validation/torchmetrics_stoi", mode=mode,
                             save_top_k=2)
    assert not ckpt.has_last() and ckpt.best_step() is None and ckpt.trainer_state() == {}
    for step, v in enumerate(values, start=1):
        ckpt.save(_Box(step), step, {"validation/torchmetrics_stoi": v},
                  trainer_state={"epoch": step - 1, "global_step": step})
    ckpt.save(_Box(9), 9, {"other": 1.0})  # no monitored value: `last` only
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == [f"step_{int(s):08d}" for s in sorted(kept, key=int)]
    assert not list(tmp_path.glob(".*"))
    reopened = CheckpointManager(str(tmp_path), monitor="validation/torchmetrics_stoi", mode=mode,
                                 save_top_k=2)
    assert reopened.best_step() == best and reopened._index == kept
    assert reopened.trainer_state() == {"epoch": 3, "global_step": 4}  # the last save that had one
    assert float(reopened.restore(_Box(0), "last", device="cpu").x) == 9
    assert float(reopened.restore(_Box(0), "best", device="cpu").x) == best
    with pytest.raises(FileNotFoundError):
        reopened.restore(_Box(0), "7", device="cpu")
    no_last = CheckpointManager(str(tmp_path / "no_last"), save_last=False)
    no_last.save(_Box(1), 1, {})
    assert not no_last.has_last()


def test_a_cut_save_leaves_a_whole_last(tmp_path, monkeypatch):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(_Box(1), 1, trainer_state={"epoch": 0, "global_step": 1})
    from vibravox_tpu_torch.core import checkpoint as module

    # cut inside torch.save: `last` is untouched, the partial write is swept
    def torn_save(obj, path):
        open(path, "wb").write(b"torn")
        raise KeyboardInterrupt

    monkeypatch.setattr(module.torch, "save", torn_save)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(_Box(2), 2, trainer_state={"epoch": 1, "global_step": 2})
    monkeypatch.undo()
    reopened = CheckpointManager(str(tmp_path))
    assert float(reopened.restore(_Box(0), device="cpu").x) == 1
    assert not list(tmp_path.glob(".*tmp"))

    # cut between the two renames: the old `last` is taken back
    real_rename = os.rename

    def cut_rename(src, dst):
        if str(src).endswith(".last.tmp"):
            raise KeyboardInterrupt
        real_rename(src, dst)

    monkeypatch.setattr(module.os, "rename", cut_rename)
    with pytest.raises(KeyboardInterrupt):
        reopened.save(_Box(3), 3, trainer_state={"epoch": 2, "global_step": 3})
    monkeypatch.undo()
    assert not (tmp_path / "last").exists()
    again = CheckpointManager(str(tmp_path))
    assert again.has_last() and again.trainer_state() == {"epoch": 0, "global_step": 1}
    assert float(again.restore(_Box(0), device="cpu").x) == 1


@pytest.mark.parametrize("poison", ["state", "logs"])
def test_guard_restores_last_after_a_non_finite_step(uninterrupted, tmp_path, poison):
    """Epoch 1's step goes bad: a NaN written into the generator after it,
    which only the end-of-epoch state scan sees, or a NaN in its logs,
    which the step's log scan sees.  The guard restores `last` (epoch 0)
    and the replayed epoch 1 ends bit-equal to the uninterrupted run."""
    task = _task(0)
    step = task.train_step
    poisoned = []

    def poisoning_step(state, batch):
        state, logs = step(state, batch)
        if state.step == 2 and not poisoned:
            poisoned.append(True)
            if poison == "state":
                with torch.no_grad():
                    task.generator.last_conv.weight[0, 0, 0] = math.nan
            else:
                logs = {**logs, "train/generator/backprop_loss": torch.tensor(math.nan)}
        return state, logs

    task.train_step = poisoning_step
    guard = FailureGuard(max_restores=1)
    trainer = _fit(tmp_path, max_epochs=2, task=task, failure_guard=guard)
    assert poisoned and guard.restores_used == 1
    assert [lg for _, lg in trainer.logged if "anomaly/restores" in lg] == [{"anomaly/restores": 1.0}]
    assert guard.scan_state(trainer.state) is None
    _assert_bit_equal(trainer.state.state_dict(), uninterrupted[1])


def test_guard_without_a_restore_point_raises():
    guard = FailureGuard(max_loss=1.0)
    assert guard.scan({"train/generator/backprop_loss": 0.5}) is None
    assert "divergent" in guard.scan({"train/generator/backprop_loss": 2.0})
    assert "non-finite" in guard.scan({"train/x": math.inf})
    task = _task(0, reconstructive_loss_freq_fn=None, feature_matching_loss_fn=None,
                 dynamic_loss_balancing=None)
    with torch.no_grad():
        task.discriminator.melgan_discriminator.discriminator[6].parametrizations.weight.original1.fill_(math.nan)
    trainer = Trainer(max_epochs=1, log_every_n_steps=1, failure_guard=True)
    with pytest.raises(AnomalyDetected, match="no 'last' checkpoint"):
        trainer.fit(task, _dm(0))


def test_cli_fits_validates_checkpoints_tests_and_resumes(tmp_path):
    from vibravox_tpu_torch.run import main

    args = ["lightning_datamodule=bwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
            "logging=csv", "lightning_datamodule.dataset_name_principal=synthetic",
            "~lightning_datamodule.data_augmentation", "++lightning_datamodule.synthetic_size=4",
            "++lightning_datamodule.batch_size=2", "++lightning_datamodule.num_workers=0",
            "++lightning_datamodule.collate_strategy=constant_length-500-ms",
            "++trainer.limit_val_batches=1", "++trainer.limit_test_batches=1",
            "++lightning_module.compute_dtype=null", "++lightning_module.discriminator.min_channels=8",
            f"++run_dir={tmp_path}", "++device=cpu"]
    cwd = os.getcwd()
    metrics = main(args + ["++trainer.max_epochs=2"])
    assert os.getcwd() == cwd
    assert {"test/torchmetrics_stoi", "test/torchmetrics_si_sdr",
            "test/generator/reconstructive_loss_freq", "test/discriminator/real_loss"} <= set(metrics)
    assert all(math.isfinite(v) for v in metrics.values())
    ckpt = tmp_path / "checkpoints"
    assert (ckpt / "last" / "state.pt").exists() and (ckpt / "index.json").exists()
    assert sorted(p.name for p in ckpt.glob("step_*")) == ["step_00000002", "step_00000004"]
    manager = CheckpointManager(str(ckpt))
    assert manager.trainer_state() == {"epoch": 1, "global_step": 4}
    header = (tmp_path / "csv" / "metrics.csv").read_text().splitlines()[0]
    assert "validation/torchmetrics_stoi" in header and "test/torchmetrics_stoi" in header

    again = main(args + ["++trainer.max_epochs=3"])
    assert set(again) == set(metrics)
    assert manager.trainer_state() == {"epoch": 2, "global_step": 6}


def test_composed_optimizers_are_the_configured_adams():
    from vibravox_tpu_torch.core.config import compose, instantiate
    from vibravox_tpu_torch.run import CONFIG_DIR, port_targets

    cfg = compose(CONFIG_DIR, "run", ["lightning_datamodule=bwe", "lightning_module=eben"])
    port_targets(cfg, "cpu")
    task = instantiate(cfg.lightning_module)
    state = task.init_state(0)
    for opt, net in ((state.generator_optimizer, task.generator),
                     (state.discriminator_optimizer, task.discriminator)):
        assert isinstance(opt, torch.optim.Adam)
        (group,) = opt.param_groups
        assert (group["lr"], group["betas"], group["weight_decay"], group["amsgrad"]) == (
            3e-4, (0.5, 0.9), 0.0, False)
        assert [id(p) for p in group["params"]] == [id(p) for p in net.parameters()]
    assert task.compute_dtype == "bfloat16" and task.description.startswith("bwe: ")


@pytest.mark.parametrize("kw,error", [({"push_to_hub_after_testing": True}, NotImplementedError),
                                      ({"accumulate_grad_batches": 2}, None),
                                      ({"track_grad_norm": 1}, ValueError)])
def test_task_refuses_what_is_not_ported(kw, error):
    """``accumulate_grad_batches`` is ported (``optax.MultiSteps``): both
    optimizers accumulate over k micro-batches; the rest is refused."""
    if error is None:
        state = _task(0, **kw).init_state(0)
        for opt in (state.generator_optimizer, state.discriminator_optimizer):
            assert isinstance(opt, MultiSteps) and opt.every_k == 2
            assert isinstance(opt.inner, torch.optim.Adam)
        return
    with pytest.raises(error):
        _task(0, **kw)


@pytest.mark.parametrize("ratio", [1.0, 0.0])
def test_track_grad_norm_logs_each_networks_gradient_norm(ratio):
    """The generator's norm is that of its gradients; with the gate closed
    the discriminator's is still logged and its parameters get no gradient."""
    task = _task(0, track_grad_norm=2, update_discriminator_ratio=ratio)
    state = task.init_state(0)
    ref = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 4064, 1)).astype(np.float32))
    state, logs = task.train_step(state, {"audio_body_conducted": ref * 0.05, "audio_airborne": ref * 0.1})
    want = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in task.generator.parameters() if p.grad is not None]))
    assert float(logs["train/generator/grad_2.0_norm_total"]) == pytest.approx(float(want), rel=1e-6)
    assert float(logs["train/discriminator/grad_2.0_norm_total"]) > 0
    assert all((p.grad is None) == (ratio == 0.0) for p in task.discriminator.parameters())


@pytest.mark.parametrize("mesh,ok", [(None, True), ({"data": -1, "model": 1}, True), ({"data": 1}, True),
                                     ({"data": 2}, False), ({"model": 2}, False), ({"fsdp": True}, True)])
def test_mesh_is_accepted_for_one_device_only(mesh, ok):
    """One process takes a mesh that covers it (``data: -1`` is every
    process; FSDP over one data rank shards nothing); a mesh of more ranks
    raises, and resolves once the world has them."""
    config = MeshConfig(**(mesh or {}))
    if ok:
        assert config.resolve(1) == {"data": 1, "model": 1}
        dp = parallel_for(_task(0), mesh)
        assert (dp.world, dp.data_size, dp.model_size, dp.fsdp) == (1, 1, 1, False)
    else:
        with pytest.raises(ValueError, match="does not cover 1 processes"):
            config.resolve(1)
        assert config.resolve(2) == {"data": mesh.get("data", 1), "model": mesh.get("model", 1)}


def test_loggers(tmp_path, monkeypatch):
    csv = CSVLogger(str(tmp_path / "csv"))
    both = MultiLogger(csv, None)
    both.log_scalars({"a": 1.0}, 0)
    both.log_scalars({"b": 2}, 1)
    both.log_text("x/y", "hello")
    both.log_audio("t", np.zeros(4), 0, 16000)
    both.flush()
    assert (tmp_path / "csv" / "metrics.csv").read_text().splitlines() == ["step,a,b", "0,1.0,", "1,,2.0"]
    assert (tmp_path / "csv" / "x_y.txt").read_text() == "hello"
    # the TensorBoard writer is the port's own: it runs without tensorboardX
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    tb = TensorBoardLogger(str(tmp_path / "tb"))
    MultiLogger(tb, csv).log_scalars({"c": 3.0}, 2)
    tb.close()
    events = read_events(tb.path)
    assert [(e["step"], v["tag"], v["simple_value"]) for e in events[1:] for v in e["values"]] == [(2, "c", 3.0)]


def test_step_timer_and_trace_window(tmp_path):
    timer = StepTimer(warmup_steps=1)
    assert timer.summary() == {}
    for _ in range(3):
        timer.start()
        timer.stop()
    summary = timer.summary("train/")
    assert set(summary) == {"train/step_ms_mean", "train/step_ms_p50", "train/step_ms_p95",
                            "train/step_ms_max", "train/steps_per_sec"}
    with trace_window(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_model_summary_depth():
    task = _task(0)
    state = task.init_state(0)
    lines = ModelSummary(2).summarize(state).splitlines()
    assert lines[0] == "generator: 1,945,984 params" and "  generator.encoder_blocks: 857,856 params" in lines
    assert lines[-1] == "total: 21,294,160"
    assert len(ModelSummary(1).summarize(state).splitlines()) == 3


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_squim_metrics_are_refused(how, monkeypatch, tmp_path):
    """SQUIM weights whose keys do not fit the architecture are refused; a
    directory without the files leaves the SQUIM metrics out, as no
    directory does."""
    torch.save({"encoder.conv1d.weight": torch.zeros(256, 1, 64)}, tmp_path / "squim_objective.pt")
    empty = tmp_path / "empty"
    empty.mkdir()
    if how == "environment":
        monkeypatch.setenv("VIBRAVOX_SQUIM_DIR", str(tmp_path))
        with pytest.raises(RuntimeError, match="Missing key"):
            SEMetrics(16000, device="cpu")
        monkeypatch.setenv("VIBRAVOX_SQUIM_DIR", str(empty))
        metrics = SEMetrics(16000)
    else:
        monkeypatch.delenv("VIBRAVOX_SQUIM_DIR", raising=False)
        with pytest.raises(RuntimeError, match="Missing key"):
            SEMetrics(16000, squim_dir=str(tmp_path), device="cpu")
        metrics = SEMetrics(16000, squim_dir=str(empty))
        assert SEMetrics(16000).squim_stoi is None
    assert metrics.squim_stoi is None and metrics.noresqa_mos is None


def test_preemption_signal_saves_last_and_ends_the_fit(tmp_path):
    """SIGUSR1 during a step: the step finishes, `last` is saved with the
    previous epoch's marker (the resubmitted job replays the epoch), the fit
    returns and the caller's handler is back."""
    import signal

    task = _task(0)
    step = task.train_step

    def signalling_step(state, batch):
        out = step(state, batch)
        os.kill(os.getpid(), signal.SIGUSR1)
        return out

    task.train_step = signalling_step
    before = signal.getsignal(signal.SIGUSR1)
    trainer = Trainer(max_epochs=2, checkpoint=CheckpointManager(str(tmp_path)))
    trainer.fit(task, _dm(0, synthetic_size=4))  # two steps an epoch: the second is not taken
    assert trainer._preempt_signum == signal.SIGUSR1 and trainer.global_step == 1
    assert signal.getsignal(signal.SIGUSR1) is before
    assert CheckpointManager(str(tmp_path)).trainer_state() == {"epoch": -1, "global_step": 1}


def test_overfit_batches_and_precision():
    """overfit_batches=1 trains on the same first batch every epoch and
    validates on it; precision "32-true" runs the task in float32."""
    task = _task(0, compute_dtype="bfloat16")
    seen = []
    step = task.train_step
    task.train_step = lambda state, batch: (seen.append(batch["audio_airborne"].clone()), step(state, batch))[1]
    trainer = Trainer(max_epochs=2, log_every_n_steps=1, overfit_batches=1, precision="32-true")
    trainer.fit(task, _dm(0))
    assert task.compute_dtype is None and trainer.global_step == 2
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    val = [lg for _, lg in trainer.logged if "validation/torchmetrics_stoi" in lg]
    assert len(val) == 2
    with pytest.raises(ValueError, match="unsupported precision"):
        Trainer(precision="64").fit(task, _dm(0))


EVAL_HOOKS = ("prepare_eval_batch", "on_eval_batch_end", "on_eval_epoch_end")


def test_eval_hooks_leave_the_test_metrics_unchanged():
    """The trainer's optional eval hooks are SPKV's; EBEN defines none, and
    its test metrics stay the batch means of its eval logs and SE metrics."""
    from vibravox_tpu_torch.core.loop import _split_batch

    task = _task()
    assert not any(hasattr(task, hook) for hook in EVAL_HOOKS)
    dm = _dm(0)
    trainer = Trainer(limit_test_batches=2)
    metrics = trainer.test(task, dm)
    sums = {}
    for batch in dm.test_dataloader():
        outputs = task.eval_step(trainer.state, _split_batch(batch, torch.device("cpu"))[0])
        logs = {k: float(v) for k, v in outputs.pop("logs").items()}
        for k, v in {**logs, **task.eval_metrics(outputs)}.items():
            sums[k] = sums.get(k, 0.0) + v
    assert metrics == {f"test/{k}": v / 2 for k, v in sums.items()} and "test/torchmetrics_stoi" in metrics
