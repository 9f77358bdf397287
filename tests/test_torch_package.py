"""PyTorch port: package boundary and device policy.

The port must stand alone: no module of ``vibravox_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax, the JAX package or
``transformers``, ``safetensors``, ``tensorboardX`` or ``huggingface_hub`` (the GPU machine has none
of them, and the port never downloads).  Its entry points
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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vibravox_tpu", "transformers", "safetensors",
             "tensorboardX", "huggingface_hub"}


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


@pytest.mark.parametrize("backend", ["cudnn.conv", "cudnn.rnn", "cuda.matmul"])
def test_strict_float32_sets_and_restores_each_setting(backend):
    """cuDNN's convolutions and RNNs and CUDA's matmuls are IEEE float32
    inside the block, and the caller's setting is back after it, on an
    error too."""
    group, name = backend.split(".")
    setting = getattr(getattr(torch.backends, group), name)
    caller = setting.fp32_precision
    try:
        setting.fp32_precision = "tf32"
        with strict_float32():
            assert setting.fp32_precision == "ieee"
        assert setting.fp32_precision == "tf32"
        with pytest.raises(KeyError), strict_float32():
            raise KeyError("restored on error too")
        assert setting.fp32_precision == "tf32"
    finally:
        setting.fp32_precision = caller


def test_squim_lstms_run_in_ieee_float32():
    """The SQUIM objective's LSTMs run with cuDNN's RNN precision IEEE
    whatever the caller's setting, which is restored after the call."""
    from vibravox_tpu_torch.models.squim import SquimObjective, SquimObjectiveConfig

    rnn = torch.backends.cudnn.rnn
    caller = rnn.fp32_precision
    model = SquimObjective(SquimObjectiveConfig(feat_dim=8, win_len=16, d_model=8, nhead=2, hidden_dim=8,
                                                num_blocks=1, chunk_size=7))
    seen = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.LSTM):
            mod.register_forward_pre_hook(lambda *_: seen.append(rnn.fp32_precision))
    try:
        rnn.fp32_precision = "tf32"
        with torch.no_grad():
            model(torch.randn(1, 800))
        assert seen == ["ieee", "ieee"] and rnn.fp32_precision == "tf32"
    finally:
        rnn.fp32_precision = caller


def test_squim_and_hub_entry_points_without_gpu_raise(no_cuda, tmp_path):
    """The SQUIM factories and loaders, the SE metrics given SQUIM weights,
    the pretrained EBEN loader and the enhancement script use the GPU
    unless asked for the CPU, and raise without one."""
    from vibravox_tpu_torch.metrics.squim import load_squim_predictors
    from vibravox_tpu_torch.models.hub import eben_generator_from_pretrained, save_eben_generator
    from vibravox_tpu_torch.models.squim import SquimObjective, squim_objective_base, squim_subjective_base
    from vibravox_tpu_torch.scripts.eben_enhanced_vibravox import main as enhance
    from vibravox_tpu_torch.tasks.se_metrics import SEMetrics

    with torch.device("meta"):
        objective = SquimObjective()
    torch.save({k: torch.zeros(v.shape) for k, v in objective.state_dict().items()}, tmp_path / "squim_objective.pt")
    save_eben_generator(EBENGenerator(device="cpu"), tmp_path / "eben")
    for make in (squim_objective_base, squim_subjective_base, lambda: load_squim_predictors(tmp_path),
                 lambda: SEMetrics(16000, squim_dir=str(tmp_path)),
                 lambda: eben_generator_from_pretrained(tmp_path / "eben"),
                 lambda: enhance(["--dataset", "synthetic", "--weights", str(tmp_path / "eben"),
                                  "--out", str(tmp_path / "out"), "--limit", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert load_squim_predictors(tmp_path, device="cpu")[0] is not None
    assert not (tmp_path / "out").exists()


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


def test_spkv_entry_points_without_gpu_raise(no_cuda, tmp_path):
    """The embedders, the log-mel front end on a CUDA request, the SPKV task,
    its data module and the CLI use the GPU unless asked for the CPU, and
    raise without one."""
    from vibravox_tpu_torch.data.spkv import SPKVDataModule
    from vibravox_tpu_torch.models.ecapa2 import ECAPA2, ecapa2_from_config
    from vibravox_tpu_torch.models.ecapa_tdnn import ECAPATDNN
    from vibravox_tpu_torch.ops.mel import log_mel_spectrogram
    from vibravox_tpu_torch.run import main
    from vibravox_tpu_torch.tasks.ecapa2_spkv import SPKVTask

    embedder = ecapa2_from_config("tiny", device="cpu")
    for make in (ECAPA2, lambda: ECAPA2(device="cuda"), lambda: ecapa2_from_config("tiny"),
                 lambda: ECAPATDNN(channels=32, scale=4), lambda: SPKVDataModule(dataset_name="synthetic"),
                 lambda: SPKVTask(embedder=embedder)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # the front end runs K3 or its plain version by the tensor's device, and
    # nothing else: no fallback
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        log_mel_spectrogram(torch.zeros(1, 1600, device="meta"))
    import inspect

    from vibravox_tpu_torch.ops import mel

    assert "except" not in inspect.getsource(mel)
    assert SPKVTask(embedder=embedder, device="cpu").device == torch.device("cpu")
    assert SPKVDataModule(dataset_name="synthetic", device="cpu").device == torch.device("cpu")
    run_dir = tmp_path / "run"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["lightning_datamodule=spkv", "lightning_module=ecapa2", "logging=csv",
              "lightning_datamodule.dataset_name=synthetic", f"++run_dir={run_dir}"])
    assert not run_dir.exists()


def test_mimi_entry_points_without_gpu_raise(no_cuda, tmp_path):
    """The codec, the regressive-Mimi task and the CLI use the GPU unless
    asked for the CPU, and raise without one."""
    from vibravox_tpu_torch.core.optim import adam
    from vibravox_tpu_torch.models.mimi.mimi import Mimi
    from vibravox_tpu_torch.run import main
    from vibravox_tpu_torch.tasks.regressive_mimi import RegressiveMimiTask

    model = Mimi(preset="tiny", device="cpu")
    for make in (lambda: Mimi(preset="tiny"), lambda: RegressiveMimiTask(mimi=model, optimizer=adam())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert RegressiveMimiTask(mimi=model, optimizer=adam(), device="cpu").device == torch.device("cpu")
    run_dir = tmp_path / "run"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["lightning_datamodule=bwe", "lightning_module=regressive_mimi", "sample_rate=24000",
              "logging=csv", "lightning_datamodule.dataset_name_principal=synthetic",
              "++lightning_module.mimi.preset=tiny", f"++run_dir={run_dir}"])
    assert not run_dir.exists()


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


def test_every_config_target_resolves_in_the_port():
    """Every ``_target_`` under ``configs/`` names an object after the CLI's
    rewrite (``run.port_target``), as ``core/config.py::_locate`` finds it;
    none is left in the JAX package or in ``transformers``."""
    import yaml

    from vibravox_tpu_torch.core.config import _locate
    from vibravox_tpu_torch.run import port_target

    def targets(node):
        if isinstance(node, dict):
            if isinstance(node.get("_target_"), str):
                yield node["_target_"]
            for v in node.values():
                yield from targets(v)
        elif isinstance(node, list):
            for v in node:
                yield from targets(v)

    found = {t for path in sorted((ROOT / "configs").rglob("*.yaml"))
             for t in targets(yaml.safe_load(path.read_text()))}
    assert "vibravox_tpu.models.melgan_discriminator.MelganMultiScalesDiscriminator" in found and len(found) > 25
    for target in sorted(found):
        ported = port_target(target)
        assert not ported.startswith(("vibravox_tpu.", "transformers.")), ported
        assert _locate(ported) is not None, ported
