"""PyTorch port: the regressive-Mimi CLI on the CPU, without JAX.

``lightning_datamodule=bwe lightning_module=regressive_mimi sample_rate=24000``
with the tiny codec (``++lightning_module.mimi.preset=tiny``, still in the
config's bf16 compute) on the synthetic source with the published ``light``
augmentation, 160 ms crops (the tiny codec's 16-sample hop makes 240
transformer frames of them): fit, validation, checkpoints and
``test("last")`` with the SE metrics; then a fit cut after its first epoch
and resumed by a second call, which ends bit-equal to the uninterrupted fit.
"""

import math

import torch

from vibravox_tpu_torch.core.checkpoint import CheckpointManager
from vibravox_tpu_torch.run import main
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

CLI_ARGS = ["lightning_datamodule=bwe", "lightning_module=regressive_mimi", "sample_rate=24000",
            "lightning_datamodule.batch_size=2", "lightning_datamodule.dataset_name_principal=synthetic",
            "logging=csv", "callbacks=bwe_checkpoint", "++lightning_module.mimi.preset=tiny",
            "lightning_datamodule.collate_strategy=constant_length-160-ms", "++lightning_datamodule.synthetic_size=4",
            "++lightning_datamodule.num_workers=0", "++trainer.limit_val_batches=1",
            "++trainer.limit_test_batches=2", "++device=cpu"]


def _last(run_dir):
    return torch.load(run_dir / "checkpoints" / "last" / "state.pt", weights_only=True)


def _assert_bit_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_cli_fits_tests_and_resumes_bit_equal(tmp_path):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    metrics = main(CLI_ARGS + [f"++run_dir={whole}", "++trainer.max_epochs=2"])
    assert set(metrics) == {"test/l1_latent_loss", "test/torchmetrics_si_sdr", "test/torchmetrics_stoi"}
    assert all(math.isfinite(v) for v in metrics.values())
    manager = CheckpointManager(str(whole / "checkpoints"))
    assert manager.has_last() and manager.trainer_state() == {"epoch": 1, "global_step": 4}
    header = (whole / "csv" / "metrics.csv").read_text().splitlines()[0]
    assert "train/l1_latent_loss" in header and "validation/torchmetrics_stoi" in header
    state = _last(whole)
    assert set(state) == {"step", "model", "optimizer", "frozen"} and state["step"] == 4
    # the frozen copy is the initial encoder side; the trained one moved
    w = "encoder.conv_in.weight"
    assert not torch.equal(state["frozen"][w], state["model"][w])

    main(CLI_ARGS + [f"++run_dir={cut}", "++trainer.max_epochs=1"])
    again = main(CLI_ARGS + [f"++run_dir={cut}", "++trainer.max_epochs=2"])
    assert CheckpointManager(str(cut / "checkpoints")).trainer_state() == {"epoch": 1, "global_step": 4}
    _assert_bit_equal(_last(cut), state)
    assert again == metrics
