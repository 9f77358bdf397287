"""PyTorch port: the remaining scripts against the JAX package's.

* ``upload_phonemizer_to_hub``: a port STP checkpoint holding tiny JAX
  params (converted) is exported; its ``model.safetensors`` holds exactly
  ``vibravox_tpu.models.wav2vec2.wav2vec2_params_to_torch``'s tensors, keys
  and values, and its tokenizer files are the JAX package's HF tokenizer's
  (``vocab.json``, ``special_tokens_map.json`` byte for byte) and load
  back as the port's tokenizer.
* ``test_all_phonemizers`` on that directory against the JAX script on the
  same directory: the decoded ids first, then the PER matrix and the
  confusion counts.
* ``push_dis_to_hub``: the checkpoint's discriminator loads back bit-equal
  (the JAX script writes orbax, which the port does not read).
* ``upload_vibravox_mixed_for_spkv``: npz files byte-equal to the JAX
  script's on the synthetic source (the JAX noise source seeded as the
  port's, its own ``hash(split)`` seed differing from process to process;
  the clock pinned for the zip entries' times).
* ``sweep --dry-run``: the JAX script's commands with ``run.py`` replaced by
  ``-m vibravox_tpu_torch.run``, for the three published tables.
"""

import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.data.noisybwe import NoisyBWEDataModule as JaxNoisyBWEDataModule
from vibravox_tpu.data.phonemes import build_phoneme_tokenizer
from vibravox_tpu.models.wav2vec2 import TINY_W2V2_CONFIG, Wav2Vec2Config, Wav2Vec2ForCTC
from vibravox_tpu.models.wav2vec2 import Wav2Vec2ForCTCModule, wav2vec2_params_to_torch
from vibravox_tpu.scripts import sweep as jax_sweep
from vibravox_tpu.scripts import test_all_phonemizers as jax_test_all_phonemizers
from vibravox_tpu.scripts import upload_vibravox_mixed_for_spkv as jax_mixed
from vibravox_tpu_torch.data.noisybwe import NoisyBWEDataModule
from vibravox_tpu_torch.data.phonemes import PhonemeCTCTokenizer, load_phoneme_tokenizer
from vibravox_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.hub import eben_discriminator_from_pretrained
from vibravox_tpu_torch.scripts import (
    push_dis_to_hub,
    sweep,
    test_all_phonemizers,
    upload_phonemizer_to_hub,
    upload_vibravox_mixed_for_spkv,
)
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def phonemizer(tmp_path_factory):
    """(JAX params, their config, the port's export of them)."""
    cfg = Wav2Vec2Config(**TINY_W2V2_CONFIG)
    module = Wav2Vec2ForCTCModule(cfg)
    params = jax.device_get(jax.jit(
        lambda k: module.init({"params": k}, jnp.zeros((1, 4000)), train=False)["params"])(jax.random.key(3)))
    tmp = tmp_path_factory.mktemp("phonemizer")
    (tmp / "ckpt").mkdir()
    torch.save({"step": 7, "seed": 0, "model": wav2vec2_state_dict_from_jax(params, cfg)},
               tmp / "ckpt" / "state.pt")
    upload_phonemizer_to_hub.main(["--checkpoint", str(tmp / "ckpt"), "--out", str(tmp / "export"),
                                   "--preset", "tiny"])
    return params, cfg, tmp / "export"


def test_phonemizer_export_holds_the_jax_converters_tensors(phonemizer):
    from safetensors.numpy import load_file

    params, cfg, out = phonemizer
    got = load_file(str(out / "model.safetensors"))
    want = wav2vec2_params_to_torch(params, cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


def test_phonemizer_export_tokenizer_files(phonemizer, tmp_path):
    out = phonemizer[2]
    build_phoneme_tokenizer(str(tmp_path / "vocab")).save_pretrained(str(tmp_path / "hf"))
    for name in ("vocab.json", "special_tokens_map.json"):
        assert (out / name).read_bytes() == (tmp_path / "hf" / name).read_bytes()
    back = load_phoneme_tokenizer(str(out))
    ours = load_phoneme_tokenizer()
    assert back.get_vocab() == ours.get_vocab()
    assert (back.pad_token_id, back.unk_token, back.word_delimiter_token) == (35, "<unk>", "|")


def test_phonemizer_export_refuses_a_push(phonemizer, tmp_path):
    with pytest.raises(NotImplementedError, match="needs the network"):
        upload_phonemizer_to_hub.main(["--checkpoint", "x", "--out", str(tmp_path), "--repo-id", "a/b"])


def test_phoneme_matrix_matches_jax(phonemizer, tmp_path, monkeypatch):
    from transformers import Wav2Vec2CTCTokenizer

    out = str(phonemizer[2])
    ids = {"jax": [], "port": []}

    def recording(cls, key):
        original = cls.batch_decode

        def batch_decode(self, sequences, *args, **kwargs):
            ids[key].append(np.asarray(sequences).copy())
            return original(self, sequences, *args, **kwargs)
        monkeypatch.setattr(cls, "batch_decode", batch_decode)

    recording(Wav2Vec2CTCTokenizer, "jax")
    recording(PhonemeCTCTokenizer, "port")
    common = ["--dataset", "synthetic", "--phonemizers", out, "--sensors", "headset_microphone",
              "throat_microphone", "--limit", "2"]
    jax_test_all_phonemizers.main(common + ["--out", str(tmp_path / "jax")])
    test_all_phonemizers.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert len(ids["jax"]) == len(ids["port"]) == 4
    for a, b in zip(ids["jax"], ids["port"]):
        np.testing.assert_array_equal(a, b)
    for name in ("per_matrix.json", "confusions.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == json.loads((tmp_path / "jax" / name).read_text())


def test_discriminator_export_round_trips(tmp_path):
    disc = DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu")
    (tmp_path / "ckpt").mkdir()
    torch.save({"step": 3, "discriminator": disc.state_dict(), "generator": {}}, tmp_path / "ckpt" / "state.pt")
    push_dis_to_hub.main(["--checkpoint", str(tmp_path / "ckpt"), "--out", str(tmp_path / "export")])
    out = tmp_path / "export" / "discriminator"
    assert json.loads((out / "config.json").read_text()) == {"q": 4, "min_channels": 8}
    back = eben_discriminator_from_pretrained(out, q=4, min_channels=8, device="cpu")
    want, got = disc.state_dict(), back.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(NotImplementedError, match="needs the network"):
        push_dis_to_hub.main(["--checkpoint", str(tmp_path / "ckpt"), "--out", str(tmp_path), "--repo-id", "a/b"])


def test_mixed_spkv_set_is_byte_equal_to_jax(tmp_path, monkeypatch):
    base_seed = NoisyBWEDataModule(dataset_name="synthetic", device="cpu")._noise_source("test").base_seed
    jax_noise = JaxNoisyBWEDataModule._noise_source

    def seeded(self, split):
        source = jax_noise(self, split)
        source.base_seed = base_seed
        return source

    monkeypatch.setattr(JaxNoisyBWEDataModule, "_noise_source", seeded)
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)  # the zip entries' times
    args = ["--dataset", "synthetic", "--sensors", "headset_microphone", "throat_microphone", "--seed", "3"]
    jax_mixed.main(args + ["--out", str(tmp_path / "jax")])
    upload_vibravox_mixed_for_spkv.main(args + ["--out", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 16
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    with np.load(tmp_path / "port" / names[0]) as item:
        assert sorted(item) == ["audio_mixed.headset_microphone", "audio_mixed.throat_microphone"]


@pytest.mark.parametrize("table", ["bwe", "spkv", "stp"])
@pytest.mark.parametrize("line", [None, 1])
def test_sweep_dry_run_matches_jax(table, line, capsys, monkeypatch):
    monkeypatch.delenv("SLURM_ARRAY_TASK_ID", raising=False)
    argv = [str(ROOT / "configs" / "sweeps" / f"{table}.txt"), "--dry-run"] + ([] if line is None else ["--line", "1"])
    jax_sweep.main(argv)
    want = capsys.readouterr().out.replace(str(ROOT / "run.py"), "-m vibravox_tpu_torch.run")
    sweep.main(argv)
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == (1 if line is not None else len(sweep.commands(argv[0])))


def test_sweep_reads_the_array_task_id(capsys, monkeypatch):
    monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "2")
    table = str(ROOT / "configs" / "sweeps" / "stp.txt")
    sweep.main([table, "--dry-run"])
    assert capsys.readouterr().out.strip() == "+ " + " ".join(sweep.commands(table, 2)[0])
