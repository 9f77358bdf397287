"""Trainer: the explicit train / validate / test loop (PyTorch).

Counterpart of ``vibravox_tpu/core/loop.py::Trainer``, which replaces the
reference's Lightning ``Trainer`` (``run.py:39-53``): batches stream from the
data module's loaders onto the task's device; ``task.train_step`` runs each
step; validation runs every ``check_val_every_n_epoch`` epochs; checkpoints
follow the monitor / top-k / ``last`` semantics, and a fit resumes from
``last``; ``test(ckpt_path="last")`` reloads and evaluates like the
reference's post-fit test pass.  The failure guard restores ``last`` after a
non-finite step, and SIGTERM / SIGUSR1 save ``last`` and end the fit.

The trainer runs on the task's device, which must exist when a fit or test
starts (a task made for the GPU raises without one).  Only a one-device
mesh is ported: a mesh over more devices is ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from vibravox_tpu_torch.core.callbacks import ModelSummary
from vibravox_tpu_torch.core.checkpoint import CheckpointManager
from vibravox_tpu_torch.core.guard import AnomalyDetected, FailureGuard
from vibravox_tpu_torch.core.logging import Logger, NoOpLogger
from vibravox_tpu_torch.core.profiler import StepTimer, trace_window
from vibravox_tpu_torch.device import resolve_device

__all__ = ["Trainer"]


def _as_float_logs(logs: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in logs.items()}


def _split_batch(batch: Dict[str, Any], device: torch.device) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The batch's tensors, sent to ``device``, and its host-only fields
    (the STP collate's ``phonemes_str`` list), kept on the host as the JAX
    mesh's ``split_batch`` keeps them."""
    arrays = {k: v.to(device, non_blocking=True) for k, v in batch.items() if isinstance(v, torch.Tensor)}
    return arrays, {k: v for k, v in batch.items() if not isinstance(v, torch.Tensor)}


def _check_mesh(mesh: Optional[Dict[str, Any]], device: torch.device) -> None:
    """Accepts the configs' ``{data: -1, model: 1}`` on one device; raises
    for a mesh that asks for more (``data: -1`` is every visible device)."""
    mesh = dict(mesh or {})
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    model = max(1, int(mesh.get("model", 1)))
    data = int(mesh.get("data", -1))
    data = data if data > 0 else visible // model
    if model != 1 or data != 1 or mesh.get("fsdp"):
        raise NotImplementedError(
            f"the port trains on one device; mesh {mesh} asks for {data} x {model} devices "
            f"({visible} visible) or FSDP (multi-device training is ROADMAP Queue 1 item 13; "
            "set trainer.mesh.data=1)")


class Trainer:
    """``precision``: ``"32"`` / ``"32-true"`` keep float32; ``"bf16-*"`` (and
    ``"16-*"``, which the JAX trainer maps to bf16) set the task's
    ``compute_dtype``.  ``overfit_batches``: N > 0 trains on the same first
    N batches every epoch and validates on them.

    For measurement: ``sync_every_step`` waits for the device after every
    step and records the step's wall time in ``step_seconds`` (one
    host-device synchronisation a step); ``data_wait_seconds`` holds, for
    every step, the host's wait for its batch, from the end of the previous
    step (or the epoch's start) until the batch came out of the loader and
    its copy to the device was issued.  ``logged`` keeps every scalar dict
    given to the logger, with its step."""

    def __init__(
        self,
        max_epochs: int = 1,
        check_val_every_n_epoch: int = 1,
        log_every_n_steps: int = 100,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        limit_test_batches: Optional[int] = None,
        checkpoint: Optional[CheckpointManager] = None,
        logger: Optional[Logger] = None,
        mesh: Optional[Dict[str, Any]] = None,
        seed: int = 42,
        profile_dir: Optional[str] = None,
        num_audio_logs: int = 15,
        precision: Optional[str] = None,
        overfit_batches: int = 0,
        model_summary: Optional[ModelSummary] = None,
        failure_guard: Optional[Any] = None,
        preemption_checkpoint: bool = True,
        sync_every_step: bool = False,
    ):
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.log_every_n_steps = log_every_n_steps
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.checkpoint = checkpoint
        self.logger = logger or NoOpLogger()
        self.mesh = mesh
        self.seed = seed
        self.profile_dir = profile_dir
        self.num_audio_logs = num_audio_logs
        self.precision = precision
        self.model_summary = model_summary or ModelSummary(max_depth=1)
        self.overfit_batches = int(overfit_batches)
        if self.overfit_batches:
            self.limit_train_batches = self.overfit_batches
            self.limit_val_batches = self.overfit_batches
        if failure_guard is True:
            failure_guard = FailureGuard()
        elif isinstance(failure_guard, dict):
            failure_guard = FailureGuard(**failure_guard)
        self.failure_guard: Optional[FailureGuard] = failure_guard
        # SLURM sends SIGTERM/SIGUSR1 ahead of the kill: finish the step in
        # flight, save `last`, and leave so the resubmitted job resumes
        self.preemption_checkpoint = preemption_checkpoint
        self._preempt_signum: Optional[int] = None
        self.sync_every_step = sync_every_step

        self.state = None
        self.global_step = 0
        self.current_epoch = 0
        self._num_val_runs = 0
        self.logged: List[Tuple[int, Dict[str, float]]] = []
        self.step_seconds: List[float] = []
        self.data_wait_seconds: List[float] = []

    # ------------------------------------------------------------------ #

    def _setup(self, task) -> torch.device:
        """The run's device (the task's), after the checks; applies
        ``precision``."""
        device = resolve_device(task.device)
        _check_mesh(self.mesh, device)
        if self.precision is not None:
            p = str(self.precision)
            if p in ("32", "32-true"):
                task.compute_dtype = None
            elif p.startswith(("bf16", "16")):
                task.compute_dtype = "bfloat16"
            else:
                raise ValueError(f"unsupported precision {self.precision!r}")
        return device

    @staticmethod
    def _sync(device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _log(self, scalars: Dict[str, float]) -> None:
        self.logged.append((self.global_step, scalars))
        self.logger.log_scalars(scalars, self.global_step)

    def _restore(self, task, which: str) -> None:
        self.checkpoint.restore(self.state, which, device=task.device)

    def fit(self, task, datamodule) -> None:
        datamodule.setup("fit")
        self._setup(task)
        train_loader = datamodule.train_dataloader()
        if self.state is None:
            self.state = task.init_state(self.seed)
            if self.checkpoint is not None and self.checkpoint.has_last():
                self._restore(task, "last")
                progress = self.checkpoint.trainer_state()
                self.current_epoch = int(progress.get("epoch", -1)) + 1
                self.global_step = int(progress.get("global_step", 0))

        if getattr(task, "description", None):
            self.logger.log_text("description", task.description)
        self.model_summary(self.state, self.logger)

        self._preempt_signum = None
        prev_handlers = (
            self._install_preemption_handlers()
            if self.preemption_checkpoint and self.checkpoint is not None
            else {}
        )
        try:
            self._fit_epochs(task, datamodule, train_loader)
        finally:
            self._restore_signal_handlers(prev_handlers)
        self.logger.flush()

    def _fit_epochs(self, task, datamodule, train_loader) -> None:
        device = task.device
        timer = StepTimer()
        profiler_trace = None
        epoch = self.current_epoch
        while epoch < self.max_epochs:
            self.current_epoch = epoch
            sampler = getattr(train_loader, "batch_sampler", None)
            if not hasattr(sampler, "set_epoch"):  # a stream keys its dataset
                sampler = getattr(train_loader, "dataset", None)
            if hasattr(sampler, "set_epoch"):
                # the shuffle and crops follow the trainer's epoch, so a
                # resumed run sees epoch N's batches, not epoch 0's again
                sampler.set_epoch(0 if self.overfit_batches else epoch)
            epoch_t0 = time.perf_counter()
            audio_seconds = 0.0
            anomaly: Optional[str] = None
            logs: Optional[Dict[str, Any]] = None
            preempted_mid_epoch = False
            stepped = False
            t_wait = epoch_t0
            for i, batch in enumerate(train_loader):
                if self.limit_train_batches is not None and i >= self.limit_train_batches:
                    break
                if self._preempt_signum is not None:
                    # no new step under a preemption deadline
                    preempted_mid_epoch = True
                    break
                if self.profile_dir and self.global_step == 8:
                    profiler_trace = trace_window(self.profile_dir).__enter__()
                batch, _ = _split_batch(batch, device)
                t0 = time.perf_counter()
                self.data_wait_seconds.append(t0 - t_wait)
                timer.start()
                self.state, logs = task.train_step(self.state, batch)
                timer.stop()
                if self.sync_every_step:
                    self._sync(device)
                    self.step_seconds.append(time.perf_counter() - t0)
                stepped = True
                if profiler_trace is not None and self.global_step == 10:
                    self._sync(device)
                    profiler_trace.__exit__(None, None, None)
                    profiler_trace = None
                x = batch.get("audio_body_conducted", batch.get("audio"))
                if x is not None:
                    audio_seconds += x.shape[0] * x.shape[1] / task.sample_rate
                # guard scans ride on the logging cadence, where the logs are
                # floated (host-synced) anyway
                should_log = self.global_step % self.log_every_n_steps == 0
                scan_n = self.failure_guard.scan_every_n_steps if self.failure_guard else None
                if should_log or (scan_n and self.global_step % scan_n == 0):
                    floated = _as_float_logs(logs)
                    if should_log:
                        self._log(floated)
                    if self.failure_guard is not None:
                        anomaly = self.failure_guard.scan(floated)
                        if anomaly is not None:
                            break
                self.global_step += 1
                t_wait = time.perf_counter()
            if profiler_trace is not None:  # an epoch shorter than the window
                profiler_trace.__exit__(None, None, None)
                profiler_trace = None
            self._sync(device)
            # end-of-epoch barrier: the final step's logs and the state
            # itself, before a save can overwrite `last`
            if anomaly is None and self.failure_guard is not None and logs is not None:
                anomaly = self.failure_guard.scan(_as_float_logs(logs))
            if anomaly is None and self.failure_guard is not None and stepped:
                anomaly = self.failure_guard.scan_state(self.state)
            if anomaly is not None:
                epoch = self._recover(task, anomaly)
                continue
            if preempted_mid_epoch:
                # saved with the previous epoch's marker, so the resubmitted
                # job replays the interrupted epoch from its start
                if stepped:
                    self.checkpoint.save(
                        self.state, self.global_step, {},
                        trainer_state={"epoch": epoch - 1, "global_step": self.global_step},
                    )
                self.logger.log_text(
                    "preemption",
                    f"signal {self._preempt_signum}: checkpointed at epoch "
                    f"{epoch}, step {self.global_step}; exiting for resubmission",
                )
                return
            wall = time.perf_counter() - epoch_t0
            epoch_metrics = {
                "train/epoch_wall_seconds": wall,
                "train/audio_seconds_per_second": audio_seconds / max(wall, 1e-9),
            }
            epoch_metrics.update(timer.summary("train/"))
            self._log(epoch_metrics)

            val_metrics: Dict[str, float] = {}
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_loader = train_loader if self.overfit_batches else datamodule.val_dataloader()
                val_metrics = self._evaluate(task, val_loader, "validation")
            if self.checkpoint is not None:
                self.checkpoint.save(
                    self.state, self.global_step, val_metrics,
                    trainer_state={"epoch": epoch, "global_step": self.global_step},
                )
            if self._preempt_signum is not None:
                # the epoch completed and was saved as such: the resumed job
                # starts the next one
                self.logger.log_text(
                    "preemption",
                    f"signal {self._preempt_signum}: epoch {epoch} completed "
                    f"and checkpointed; exiting for resubmission",
                )
                self.current_epoch = epoch + 1
                return
            epoch += 1
        self.current_epoch = epoch

    def _on_preempt(self, signum, frame) -> None:
        del frame
        self._preempt_signum = signum

    def _install_preemption_handlers(self) -> Dict[int, Any]:
        import signal

        prev: Dict[int, Any] = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                prev[sig] = signal.signal(sig, self._on_preempt)
            except (ValueError, OSError):  # not the main thread
                pass
        return prev

    @staticmethod
    def _restore_signal_handlers(prev: Dict[int, Any]) -> None:
        import signal

        for sig, handler in prev.items():
            signal.signal(sig, handler)

    def _recover(self, task, reason: str) -> int:
        """Restore ``last`` after a detected anomaly; return the epoch to
        resume from.  Raises :class:`AnomalyDetected` when no restore point
        exists or the guard's budget is spent."""
        guard = self.failure_guard
        restorable = self.checkpoint is not None and self.checkpoint.has_last()
        if not restorable or guard.restores_used >= guard.max_restores:
            raise AnomalyDetected(
                f"{reason}; "
                + (
                    f"restore budget exhausted ({guard.restores_used}/{guard.max_restores})"
                    if restorable
                    else "no 'last' checkpoint to restore"
                )
            )
        guard.restores_used += 1
        self._restore(task, "last")
        progress = self.checkpoint.trainer_state()
        self.global_step = int(progress.get("global_step", 0))
        next_epoch = int(progress.get("epoch", -1)) + 1
        self._log({"anomaly/restores": float(guard.restores_used)})
        self.logger.log_text(
            "anomaly/restore", f"{reason} -> restored 'last', resuming at epoch {next_epoch}"
        )
        return next_epoch

    # ------------------------------------------------------------------ #

    def _evaluate(self, task, loaders, stage: str) -> Dict[str, float]:
        limit = self.limit_val_batches if stage == "validation" else self.limit_test_batches
        if limit == 0:  # Lightning's limit_*_batches=0: no pass, no loader workers
            return {}
        self._num_val_runs += 1
        if not isinstance(loaders, dict):
            loaders = {"": loaders}
        all_metrics: Dict[str, float] = {}
        for dl_name, loader in loaders.items():
            suffix = f"/{dl_name}" if dl_name else ""
            sums: Dict[str, float] = {}
            count = 0
            for i, batch in enumerate(loader):
                if limit is not None and i >= limit:
                    break
                batch, host = _split_batch(batch, task.device)
                outputs = task.eval_step(self.state, batch)
                if host:
                    outputs["host"] = host
                logs = outputs.pop("logs", {})
                metrics = task.eval_metrics(outputs) if hasattr(task, "eval_metrics") else {}
                for k, v in {**_as_float_logs(logs), **metrics}.items():
                    sums[k] = sums.get(k, 0.0) + v
                count += 1
                if i < self.num_audio_logs:
                    self._log_audio(task, outputs, stage, dl_name, i)
                    if getattr(task, "last_decoded", None):
                        pred, target = task.last_decoded
                        self.logger.log_text(f"{stage}_{dl_name or 'main'}_{i}/decode",
                                             f"pred: {pred}\ntarget: {target}", self._num_val_runs)
            if count:
                for k, v in sums.items():
                    all_metrics[f"{stage}/{k}{suffix}"] = v / count
        if all_metrics:
            self._log(all_metrics)
        return all_metrics

    def _log_audio(self, task, outputs, stage: str, dl_name: str, batch_idx: int) -> None:
        prefix = f"{stage}_{dl_name}_" if dl_name else f"{stage}_"
        for tier in ("enhanced", "corrupted", "reference"):
            if tier in outputs:
                audio = outputs[tier][0].float().cpu().numpy()
                self.logger.log_audio(
                    f"{prefix}{batch_idx}/{tier}", audio, self._num_val_runs, task.sample_rate
                )

    # ------------------------------------------------------------------ #

    def test(self, task, datamodule, ckpt_path: Optional[str] = "last") -> Dict[str, float]:
        """Evaluate the test loaders, from checkpoint ``ckpt_path`` (``"last"``,
        ``"best"`` or a step) when the trainer has a checkpoint manager."""
        datamodule.setup("test")
        self._setup(task)
        if self.state is None:
            self.state = task.init_state(self.seed)
        if ckpt_path and self.checkpoint is not None and self.checkpoint.has_last():
            self._restore(task, ckpt_path)
        metrics = self._evaluate(task, datamodule.test_dataloader(), "test")
        if hasattr(task, "on_test_end"):
            task.on_test_end(self.state)
        self.logger.flush()
        return metrics
