"""PyTorch port: the SPKV CLI on the CPU against the JAX package's.

``lightning_datamodule=spkv lightning_module=ecapa2 logging=csv`` on the
synthetic source (8 utterances of 4 speakers: 8 trials at batch 1) with the
tiny ECAPA2 through ``ecapa2_from_config`` and one checkpoint file, given
to both CLIs by ``++lightning_module.checkpoint_path``, once a torch state
dict and once the same weights as a TorchScript archive (the published
ECAPA2 checkpoint's format): the port's
``test/*`` metrics equal JAX's: EER and minDCF exactly (the nearest two
trials' scores are 9e-3 apart); the distance statistics within 1e-5
(measured 4.5e-6); the EER's threshold, one trial's cosine, within 5e-5
(measured 9.5e-6).  On this speech-like audio the two packages' float32
sums (their front ends alone differ by up to 4.1e-5 in near-silent mel
bins, see ``tests/test_torch_spkv_model.py``) put cosines up to 1e-5
apart.  The two tasks' embeddings of the file agree within 2e-5 of their
scale, the SPKV bar of ``tests/test_torch_spkv_model.py``.  Then the port alone: the
ECAPA-TDNN stand-in through the config, a ``same_gender`` run over a pairs
file written by the port's ``gen_pairs_for_spkv``, and the composed
config's targets.  No loader workers: the file imports JAX.
"""

import importlib.util
import math
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from vibravox_tpu_torch.models.ecapa2 import ecapa2_from_config
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
CLI_ARGS = ["lightning_datamodule=spkv", "lightning_module=ecapa2", "logging=csv",
            "lightning_datamodule.dataset_name=synthetic", "lightning_datamodule.num_workers=0",
            "lightning_module.embedder._target_=vibravox_tpu.models.ecapa2.ecapa2_from_config",
            "+lightning_module.embedder.preset=tiny", "++lightning_datamodule.synthetic_size=8"]
METRICS = {f"test/{k}" for k in (
    "equal_error_rate", "eer_threshold", "minimum_dcf",
    *(f"{d}_{s}" for d in ("cosine", "euclidean")
      for s in ("mean_same", "std_same", "mean_different", "std_different")))}
EXACT = ("test/equal_error_rate", "test/minimum_dcf")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny ECAPA2 from seed 0, its BatchNorm statistics calibrated on
    the first 2 s of the test split's utterances (each layer's running mean
    and biased variance set to its input's over the batch, in forward
    order), saved as a torch state dict in the converter layout.  Random
    statistics leave the embeddings dominated by one input-independent
    direction (every score within 1e-4 of 1, trials 1e-6 apart); the
    calibrated ones spread the scores as a trained model's are."""
    from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
    from vibravox_tpu_torch.models import ecapa2

    torch.manual_seed(0)
    model = ecapa2_from_config("tiny", device="cpu")
    source = SyntheticVibravoxSource(n_utterances=8, split="spkv-test", with_metadata=True)
    audio = torch.stack([torch.from_numpy(source[i]["audio_body_conducted"][:32000]) for i in range(len(source))])
    plain = ecapa2.batch_norm

    def calibrating(layer, x, dtype):
        dims = [d for d in range(x.dim()) if d != 1]
        layer.running_mean.copy_(x.mean(dims))
        layer.running_var.copy_(x.var(dims, correction=0))
        return plain(layer, x, dtype)

    ecapa2.batch_norm = calibrating
    try:
        with torch.no_grad():
            model(audio)
    finally:
        ecapa2.batch_norm = plain
    path = tmp_path_factory.mktemp("spkv_ckpt") / "ecapa2_tiny.pt"
    torch.save(model.state_dict(), path)
    return path


@pytest.fixture(params=["state_dict", "torchscript"])
def checkpoint_file(request, checkpoint, tmp_path):
    """``checkpoint``'s weights as a state dict, or ``torch.jit.save``d as a
    traced ``ECAPA2``."""
    if request.param == "state_dict":
        return checkpoint
    model = ecapa2_from_config("tiny", device="cpu").eval()
    model.load_state_dict(torch.load(checkpoint, weights_only=True), strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        archive = torch.jit.trace(model, torch.zeros(1, 16000), check_trace=False)
    path = tmp_path / "ecapa2_tiny_torchscript.pt"
    torch.jit.save(archive, str(path))
    return path


def _embeddings_of_both_tasks(path):
    """The port's and the JAX package's ``SPKVTask`` embedders loaded from
    ``path``, on the first 2 s of the test split's utterances."""
    import jax

    from vibravox_tpu.models.ecapa2 import PRESETS as JAX_PRESETS
    from vibravox_tpu.models.ecapa2 import ECAPA2 as JaxECAPA2
    from vibravox_tpu.tasks.ecapa2_spkv import SPKVTask as JaxSPKVTask
    from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
    from vibravox_tpu_torch.tasks.ecapa2_spkv import SPKVTask

    source = SyntheticVibravoxSource(n_utterances=8, split="spkv-test", with_metadata=True)
    audio = np.stack([source[i]["audio_body_conducted"][:32000] for i in range(len(source))])
    jax_task = JaxSPKVTask(embedder=JaxECAPA2(JAX_PRESETS["tiny"]()), checkpoint_path=str(path))
    state = jax_task.init_state(jax.random.key(0), {})
    ref = np.asarray(jax.jit(jax_task.embedder.apply)(state.params, audio))
    task = SPKVTask(embedder=ecapa2_from_config("tiny", device="cpu"), checkpoint_path=str(path), device="cpu")
    with torch.no_grad():
        ours = task.init_state(0).embedder(torch.from_numpy(audio)).numpy()
    return ours, ref


def _jax_main(argv):
    import jax

    # run.py points JAX's compile cache at its own directory: put the
    # suite's (tests/conftest.py) back, for the files that run after this one
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes")}
    spec = importlib.util.spec_from_file_location("vibravox_run", ROOT / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    try:
        return module.main(argv)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)


def test_cli_test_metrics_equal_jax(checkpoint_file, tmp_path):
    from vibravox_tpu_torch.run import main

    common = CLI_ARGS + [f"++lightning_module.checkpoint_path={checkpoint_file}"]
    ours = main(common + ["++device=cpu", f"++run_dir={tmp_path / 'port'}"])
    ref = _jax_main(common + [f"++run_dir={tmp_path / 'jax'}"])
    assert set(ours) == set(ref) == METRICS
    assert all(math.isfinite(v) for v in ours.values())
    for k in EXACT:
        assert ours[k] == ref[k], k
    assert abs(ours["test/eer_threshold"] - ref["test/eer_threshold"]) <= 5e-5
    for k in METRICS.difference(EXACT, {"test/eer_threshold"}):
        assert abs(ours[k] - ref[k]) <= 1e-5, k
    header = (tmp_path / "port" / "csv" / "metrics.csv").read_text().splitlines()[0]
    assert "test/equal_error_rate" in header and "test/minimum_dcf" in header
    ours, ref = _embeddings_of_both_tasks(checkpoint_file)
    assert np.abs(ours - ref).max() <= 2e-5 * np.abs(ref).max()


def test_cli_runs_the_ecapa_tdnn_stand_in(tmp_path):
    from vibravox_tpu_torch.run import main

    metrics = main(CLI_ARGS[:5] + ["lightning_module.embedder._target_=vibravox_tpu.models.ecapa_tdnn.ECAPATDNN",
                                   "+lightning_module.embedder.channels=32", "+lightning_module.embedder.scale=4",
                                   "++lightning_datamodule.synthetic_size=8", "++device=cpu",
                                   f"++run_dir={tmp_path}"])
    assert set(metrics) == METRICS and all(math.isfinite(v) for v in metrics.values())


def test_cli_same_gender_over_a_pairs_file(checkpoint, tmp_path):
    """A ``pairs_file`` from the port's script, with its ``same_gender``
    list: every trial pairs two utterances of one gender (the synthetic
    source's utterance i is male for odd i)."""
    from vibravox_tpu_torch.data.spkv import SPKVDataModule
    from vibravox_tpu_torch.run import main
    from vibravox_tpu_torch.scripts.gen_pairs_for_spkv import main as gen_pairs

    pairs = tmp_path / "pairs" / "same_gender.pkl"
    gen_pairs(["--dataset", "synthetic", "--output-dir", str(pairs.parent)])
    metrics = main(CLI_ARGS[:-1] + [f"++lightning_module.checkpoint_path={checkpoint}",
                                    "lightning_datamodule.gender_policy=same_gender",
                                    f"lightning_datamodule.pairs_file={pairs}", "++device=cpu", f"++run_dir={tmp_path / 'run'}"])
    assert set(metrics) == METRICS and all(math.isfinite(v) for v in metrics.values())
    dm = SPKVDataModule(dataset_name="synthetic", pairs_file=str(pairs), num_workers=0, device="cpu")
    dm.setup("test")
    side_a, side_b = (src.indices for src in dm._test_sources)
    assert len(side_a) == 120 and all(a % 2 == b % 2 for a, b in zip(side_a, side_b))


def test_spkv_config_composes_to_the_port():
    """spkv.yaml + ecapa2.yaml: the port's data module and task, the
    full-width ECAPA2 by default, the published loader settings."""
    from vibravox_tpu_torch.core.config import compose, instantiate
    from vibravox_tpu_torch.data.spkv import SPKVDataModule
    from vibravox_tpu_torch.models.ecapa2 import ECAPA2
    from vibravox_tpu_torch.run import CONFIG_DIR, port_targets
    from vibravox_tpu_torch.tasks.ecapa2_spkv import SPKVTask

    cfg = compose(CONFIG_DIR, "run", ["lightning_datamodule=spkv", "lightning_module=ecapa2"])
    port_targets(cfg, "cpu")
    assert cfg.lightning_module["embedder"]["_target_"] == "vibravox_tpu_torch.models.ecapa2.ECAPA2"
    dm = instantiate(cfg.lightning_datamodule)
    assert isinstance(dm, SPKVDataModule) and (dm.batch_size, dm.num_workers, dm.gender_policy) == (
        1, 1, "mixed_gender")
    task = instantiate(cfg.lightning_module)
    assert isinstance(task, SPKVTask) and isinstance(task.embedder, ECAPA2)
    assert task.embedder.config.gfe_channels == 1024 and task.embedder.config.compute_dtype == "float32"
    assert (task.mindcf_p_target, task.mindcf_c_fa, task.mindcf_c_fr) == (0.05, 1, 1)
