"""PyTorch port: package boundary and device policy.

The port must stand alone: no module of ``vibravox_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax or the JAX package.  Its entry points
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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vibravox_tpu"}


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
