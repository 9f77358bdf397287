"""PyTorch port: the weights-day runbook, offline, on the CPU, without JAX.

``python -m vibravox_tpu_torch.scripts.weights_day --stage all
--offline-dry-run --device cpu`` in a temporary cache, asserting what
``tests/test_scripts.py::TestWeightsDayRunbook`` asserts of the JAX
runbook: the five staged artifacts, the five parity rows, the executed
``spkv_ecapa2_eval`` row's numeric EER and minDCF, and the checkpoint
variables left as they were.  Then the published formats on their own: the
staged ``ecapa2.pt`` is a TorchScript archive that ``hub.load_state_dict``
reads, a pickled eager module is refused, ``fetch`` without the dry run
refuses and names ``raw/``'s layout, each donor with one key renamed makes
``convert`` raise and name the key, and the Mimi HF writer is the exact
inverse of the reader (and, where ``transformers`` imports, loads strictly
into its ``MimiModel``).
"""

import json
import os
import re
import shutil

import pytest
import torch

from vibravox_tpu_torch.models import safetensors_io
from vibravox_tpu_torch.models.ecapa2 import ecapa2_from_config
from vibravox_tpu_torch.models.hub import is_torchscript_archive, load_state_dict
from vibravox_tpu_torch.models.mimi.convert import (
    mimi_config_from_hf,
    mimi_config_to_hf,
    mimi_state_dict_from_hf,
    mimi_state_dict_to_hf,
)
from vibravox_tpu_torch.models.mimi.mimi import Mimi
from vibravox_tpu_torch.scripts.weights_day import RAW_LAYOUT, STAGED_ENV, main
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

ARTIFACTS = ("eben_temple_vibration_pickup", "phonemizer_throat_microphone", "ecapa2", "squim", "mimi")
CONFIGS = ("spkv_ecapa2_eval", "stp_wav2vec2_throat", "bwe_eben_throat", "noisy_bwe_from_pretrained_eben",
           "mimi_regressive_bwe")


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """The runbook's ``--stage all --offline-dry-run`` once; the process's
    checkpoint variables before and after it."""
    root = tmp_path_factory.mktemp("weights_day")
    before = {k: os.environ.get(k) for k in STAGED_ENV}
    main(["--stage", "all", "--offline-dry-run", "--device", "cpu", "--cache-dir", str(root / "cache"),
          "--output", str(root / "REAL_DATA.md")])
    after = {k: os.environ.get(k) for k in STAGED_ENV}
    return root, before, after


def test_offline_dry_run_end_to_end(dry_run):
    root, before, after = dry_run
    manifest = json.loads((root / "cache/staged/manifest.json").read_text())
    assert set(manifest) == set(ARTIFACTS)
    text = (root / "REAL_DATA.md").read_text()
    rows = {line.split("|")[1].strip(): json.loads(line.split("|")[2].strip())
            for line in text.splitlines() if line.startswith("| ") and not line.startswith("| config")}
    assert set(rows) == set(CONFIGS)
    assert all(rows[name] == {"dry_run": "compose+instantiate ok"} for name in CONFIGS[1:])
    executed = rows["spkv_ecapa2_eval"]["dry_run_executed"]
    assert set(executed) == {"test/equal_error_rate", "test/minimum_dcf"}
    assert all(isinstance(v, (int, float)) for v in executed.values())
    assert after == before  # the staged donors do not leak into the process


def test_staged_ecapa2_is_a_torchscript_archive(dry_run):
    root, _, _ = dry_run
    archive = root / "cache/raw/ecapa2/ecapa2.pt"
    assert is_torchscript_archive(archive)
    sd = load_state_dict(archive)
    want = torch.jit.load(str(archive), map_location="cpu").state_dict()
    assert set(sd) == set(ecapa2_from_config("tiny", device="cpu").state_dict()) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_plain_state_dict_loads_and_pickled_module_is_refused(tmp_path):
    model = torch.nn.Linear(3, 2)
    torch.save(model.state_dict(), tmp_path / "plain.pt")
    assert not is_torchscript_archive(tmp_path / "plain.pt")
    sd = load_state_dict(tmp_path / "plain.pt")
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    torch.save(model, tmp_path / "eager.pt")
    with pytest.raises(ValueError, match="pickled Python objects"):
        load_state_dict(tmp_path / "eager.pt")


def test_fetch_without_dry_run_refuses_and_names_the_layout(tmp_path):
    with pytest.raises(SystemExit, match="never downloads") as refused:
        main(["--stage", "fetch", "--device", "cpu", "--cache-dir", str(tmp_path / "cache")])
    assert all(entry in str(refused.value) for entry in RAW_LAYOUT)
    assert not (tmp_path / "cache").exists()


@pytest.mark.parametrize("donor,weights,key", [
    ("eben_temple_vibration_pickup", "model.safetensors",
     "decoder_blocks.0.conv_trans.parametrizations.weight.original0"),
    ("phonemizer_throat_microphone", "pytorch_model.bin", "wav2vec2.encoder.layer_norm.weight"),
    ("ecapa2", "ecapa2.pt", "embedding.weight"),
    ("squim", "squim_objective.pt", "encoder.conv1d.weight"),
    ("mimi", "model.safetensors", "upsample.conv.weight"),
])
def test_convert_names_a_renamed_key(dry_run, tmp_path, donor, weights, key):
    """The donor alone in a fresh cache, one key of its weights renamed
    (ECAPA2's archive rewritten as a state dict): ``convert`` raises and
    names the key."""
    root, _, _ = dry_run
    shutil.copytree(root / "cache/raw" / donor, tmp_path / "cache/raw" / donor)
    path = tmp_path / "cache/raw" / donor / weights
    sd = load_state_dict(path)
    sd[key + "_drifted"] = sd.pop(key)
    if weights.endswith(".safetensors"):
        safetensors_io.save_file(sd, path)
    else:
        torch.save(sd, path)
    with pytest.raises((RuntimeError, KeyError), match=re.escape(key)):
        main(["--stage", "convert", "--device", "cpu", "--cache-dir", str(tmp_path / "cache")])


@pytest.fixture(scope="module")
def mimi_tiny():
    return Mimi(preset="tiny", seed=0, device="cpu")


def test_mimi_hf_writer_is_the_readers_exact_inverse(mimi_tiny):
    config, sd = mimi_tiny.config, mimi_tiny.state_dict()
    hf = mimi_state_dict_to_hf(sd, config)
    usage = hf["quantizer.acoustic_residual_vector_quantizer.layers.0.codebook.cluster_usage"]
    assert not torch.all(usage == 1)  # the division is exercised
    assert mimi_config_from_hf(json.loads(json.dumps(mimi_config_to_hf(config)))) == config
    back = mimi_state_dict_from_hf(hf, config)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_mimi_hf_layout_loads_into_transformers(mimi_tiny):
    transformers = pytest.importorskip("transformers")
    config = mimi_tiny.config
    hf_model = transformers.MimiModel(transformers.MimiConfig(**mimi_config_to_hf(config)))
    hf_model.load_state_dict(mimi_state_dict_to_hf(mimi_tiny.state_dict(), config), strict=True)
