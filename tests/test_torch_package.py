"""PyTorch port: package boundary and device policy.

The port must stand alone: no module of ``vibravox_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax, the JAX package or
``transformers`` (the GPU machine has none of them).  Its entry points
run on the GPU unless asked for the CPU, and raise without a GPU."""

import ast
from pathlib import Path

import pytest
import torch

from vibravox_tpu_torch import resolve_device
from vibravox_tpu_torch.device import strict_float32
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.serving import EnhanceServer, StreamingEnhancer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vibravox_tpu", "transformers"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _port_files():
    files = sorted((ROOT / "vibravox_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) >= 10 and all(f.is_file() for f in files)
    offenders = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files
    }
    assert not {k: v for k, v in offenders.items() if v}


def test_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")


def test_generator_without_gpu_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EBENGenerator()


def test_servers_without_gpu_raise(no_cuda):
    model = EBENGenerator(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnhanceServer(model, bucket_seconds=(0.5,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEnhancer(model)


def test_train_slice_entry_points_without_gpu_raise(no_cuda):
    from vibravox_tpu_torch.core.optim import adam
    from vibravox_tpu_torch.data.bwe import BWEDataModule
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
    from vibravox_tpu_torch.models.melgan_discriminator import DiscriminatorMelGAN
    from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
    from vibravox_tpu_torch.tasks.eben import EBENTask

    for make in (DiscriminatorEBENMultiScales, DiscriminatorMelGAN, BWEDataModule,
                 lambda: MultiResolutionSTFTLoss((512,), (50,), (240,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EBENTask(16000, EBENGenerator(device="cpu"),
                 DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"), adam(), adam())


def test_generator_keeps_float32_convolutions_out_of_tf32():
    """The generator's convolutions run with cuDNN's float32 precision set to
    IEEE whatever the caller's setting, which is restored after the call."""
    conv = torch.backends.cudnn.conv
    caller = conv.fp32_precision
    seen = []
    model = EBENGenerator(device="cpu")
    for mod in (model.first_conv, model.last_conv):
        mod.register_forward_pre_hook(lambda *_: seen.append(conv.fp32_precision))
    try:
        conv.fp32_precision = "tf32"
        with torch.inference_mode():
            model(torch.zeros(1, model.valid_length(2000), 1))
        assert seen == ["ieee", "ieee"]
        assert conv.fp32_precision == "tf32"
        with pytest.raises(KeyError), strict_float32():
            raise KeyError("restored on error too")
        assert conv.fp32_precision == "tf32"
    finally:
        conv.fp32_precision = caller


def test_workflow_entry_points_without_gpu_raise(no_cuda, tmp_path):
    """The CLI without ``++device=cpu`` and a checkpoint restore given no
    device use the GPU, and raise for want of one; so do the trainer's fit
    and test of a task on the GPU."""
    from vibravox_tpu_torch.core.checkpoint import CheckpointManager
    from vibravox_tpu_torch.core.loop import Trainer
    from vibravox_tpu_torch.data.bwe import BWEDataModule
    from vibravox_tpu_torch.run import main

    run_dir = tmp_path / "run"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["lightning_datamodule=bwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
              "logging=csv", "lightning_datamodule.dataset_name_principal=synthetic",
              "~lightning_datamodule.data_augmentation", f"++run_dir={run_dir}"])
    assert not run_dir.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(str(tmp_path / "ckpt")).restore(object(), "last")
    task = type("GpuTask", (), {"device": torch.device("cuda")})()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer().test(task, BWEDataModule(synthetic_size=1, num_workers=0, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer().fit(task, BWEDataModule(synthetic_size=1, num_workers=0, device="cpu"))


def test_bwe_family_data_modules_without_gpu_raise(no_cuda):
    """Both BWE data modules pin their batches for the GPU unless asked for
    the CPU, and raise without one."""
    from vibravox_tpu_torch.data.bwe import BWEDataModule
    from vibravox_tpu_torch.data.noisybwe import NoisyBWEDataModule

    for make in (BWEDataModule, NoisyBWEDataModule):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(dataset_name_principal="synthetic") if make is BWEDataModule else make(dataset_name="synthetic")
        assert make(device="cpu").device == torch.device("cpu")


def test_stp_entry_points_without_gpu_raise(no_cuda, tmp_path):
    """The STP task, its data module, the model factories and the CLI use
    the GPU unless asked for the CPU, and raise without one."""
    from vibravox_tpu_torch.core.optim import adam
    from vibravox_tpu_torch.data.stp import STPDataModule
    from vibravox_tpu_torch.models.wav2vec2 import (
        save_pretrained,
        wav2vec2_for_ctc_from_config,
        wav2vec2_for_ctc_from_pretrained,
    )
    from vibravox_tpu_torch.run import main
    from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask

    model = wav2vec2_for_ctc_from_config(preset="tiny", device="cpu")
    save_pretrained(model, str(tmp_path / "w2v"))
    for make in (lambda: STPDataModule(dataset_name_principal="synthetic"),
                 lambda: wav2vec2_for_ctc_from_config(preset="tiny"),
                 lambda: wav2vec2_for_ctc_from_pretrained(str(tmp_path / "w2v")),
                 lambda: Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=adam())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert STPDataModule(dataset_name_principal="synthetic", device="cpu").device == torch.device("cpu")
    assert Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=adam(), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["lightning_datamodule=stp", "lightning_module=wav2vec2_for_stp",
              "lightning_datamodule.dataset_name_principal=synthetic",
              f"lightning_module.wav2vec2_for_ctc.pretrained_model_name_or_path={tmp_path / 'w2v'}",
              f"++run_dir={tmp_path / 'run'}"])


def test_text_metrics_have_no_fallback():
    """The CER and edit operations always run the native kernel; a failed
    build raises (its Python DP is the tests' twin, not a fallback)."""
    import inspect

    from vibravox_tpu_torch.metrics import text

    source = inspect.getsource(text)
    assert "except" not in source and "os.environ" not in source


def test_native_pipeline_has_no_switch_and_no_fallback():
    """The native collate is always used: no environment switch turns it
    off, and its loader raises a build failure instead of falling back."""
    import inspect

    from vibravox_tpu_torch.native import build, pipeline

    for module in (build, pipeline):
        source = inspect.getsource(module)
        assert "os.environ" not in source and "except" not in source
