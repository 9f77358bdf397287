"""Entry point of the port: config-composed training and evaluation runs.

The CLI of the repository's ``run.py`` over the same ``configs/``, on the
PyTorch port::

    python -m vibravox_tpu_torch.run lightning_datamodule=bwe lightning_module=eben \\
        callbacks=bwe_checkpoint logging=csv \\
        lightning_datamodule.dataset_name_principal=synthetic \\
        ~lightning_datamodule.data_augmentation ++trainer.max_epochs=2

composes ``configs/run.yaml`` with the overrides, seeds torch with the
config's ``seed`` (the networks are initialised when they are made), makes
the data module, task, trainer, checkpoint manager and logger, runs fit and
then ``test(ckpt_path="last")`` inside ``run_dir``, and returns the test
metrics.  A second run in the same ``run_dir`` resumes from its ``last``
checkpoint.

Every ``_target_`` under ``vibravox_tpu.`` is rewritten to the port's
``vibravox_tpu_torch.`` module of the same name, and the STP config's
``transformers.Wav2Vec2FeatureExtractor`` to the port's own extractor (the
port does not import ``transformers``).  A task with a ``tokenizer`` left
``None`` gets the data module's, as in the repository's ``run.py``.  One
top-level key is the port's own: ``device`` (``++device=cpu``), given to
every constructor of the port that takes one; absent, the run uses the GPU
and raises without one.
"""

from __future__ import annotations

import inspect
import os
import sys
from pathlib import Path
from typing import Any

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
_JAX_PREFIX = "vibravox_tpu."
_PORT_PREFIX = "vibravox_tpu_torch."
# targets outside the JAX package that the port replaces with its own
_FOREIGN_TARGETS = {
    "transformers.Wav2Vec2FeatureExtractor": "vibravox_tpu_torch.data.features.Wav2Vec2FeatureExtractor",
}


def setup_environment() -> None:
    """Zero-egress clusters: skip hub lookups instead of retrying for 30 s
    (the reference's SLURM scripts set the same offline variables)."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")


def port_targets(node: Any, device: str) -> None:
    """In place: ``vibravox_tpu.X`` targets become ``vibravox_tpu_torch.X``
    (and those of ``_FOREIGN_TARGETS`` the port's counterparts), and each
    of the port's constructors that takes a ``device`` gets ``device``
    unless its node sets one.  A target the port lacks is left
    for ``instantiate`` to report."""
    from vibravox_tpu_torch.core.config import _locate

    if isinstance(node, dict):
        target = node.get("_target_")
        if isinstance(target, str):
            if target.startswith(_JAX_PREFIX):
                target = node["_target_"] = _PORT_PREFIX + target[len(_JAX_PREFIX):]
            elif target in _FOREIGN_TARGETS:
                target = node["_target_"] = _FOREIGN_TARGETS[target]
            if target.startswith(_PORT_PREFIX) and "device" not in node:
                try:
                    takes_device = "device" in inspect.signature(_locate(target)).parameters
                except ImportError:
                    takes_device = False
                if takes_device:
                    node["device"] = device
        for value in node.values():
            port_targets(value, device)
    elif isinstance(node, list):
        for value in node:
            port_targets(value, device)


def main(argv=None) -> dict:
    setup_environment()
    import torch

    from vibravox_tpu_torch.core.config import compose, instantiate
    from vibravox_tpu_torch.device import resolve_device

    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, "run", overrides)

    if cfg.get("lightning_datamodule") in (None, {}):
        raise SystemExit("lightning_datamodule must be overridden (e.g. lightning_datamodule=bwe)")
    if cfg.get("lightning_module") in (None, {}):
        raise SystemExit("lightning_module must be overridden (e.g. lightning_module=eben)")
    device = str(resolve_device(cfg.pop("device", None)))
    port_targets(cfg, device)

    # hydra.job.chdir: each run owns its directory, where checkpoints and
    # logs are written
    run_dir = Path(cfg.get("run_dir", "outputs/run/default"))
    run_dir.mkdir(parents=True, exist_ok=True)
    old_cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        torch.manual_seed(int(cfg.get("seed", 42)))
        datamodule = instantiate(cfg.lightning_datamodule)
        task = instantiate(cfg.lightning_module)
        # a task that decodes text shares the data module's tokenizer (the
        # reference reads it through trainer.datamodule)
        if getattr(task, "tokenizer", False) is None and hasattr(datamodule, "tokenizer"):
            task.tokenizer = datamodule.tokenizer

        callbacks = cfg.get("callbacks") or {}
        checkpoint = instantiate(callbacks["checkpoint"]) if "checkpoint" in callbacks else None
        model_summary = (
            instantiate(callbacks["model_summary"]) if "model_summary" in callbacks else None
        )
        logging_cfg = cfg.get("logging") or {}
        logger = instantiate(logging_cfg["logger"]) if "logger" in logging_cfg else None

        trainer = instantiate(
            cfg.trainer, checkpoint=checkpoint, logger=logger, model_summary=model_summary
        )
        trainer.fit(task, datamodule)
        if trainer._preempt_signum is not None:
            # preempted mid-fit: `last` is saved and the kill is near; leave
            # for resubmission instead of starting the test pass
            return {}
        return trainer.test(task, datamodule, ckpt_path="last")
    finally:
        os.chdir(old_cwd)


if __name__ == "__main__":
    main()
