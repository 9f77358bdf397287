"""PyTorch port: the STP workflow around the train step, without JAX.

The CLI on the CPU (``lightning_datamodule=stp lightning_module=wav2vec2_for_stp``
with the tiny wav2vec2 and the synthetic source): fit, validation,
checkpoints, test from ``last``, then a resumed run; a resumed fit bit-equal
to an uninterrupted one with every random part on (dropout, SpecAugment,
layerdrop, one step an epoch), with 0 and 2 loader workers; the trainer's
host-only batch fields and decode logs; and the local ``from_pretrained``
directory: no ``lm_head``, a pretraining checkpoint's extra keys, the old
weight-norm names, and a hub name refused.
"""

import math
import os

import pytest
import torch

from vibravox_tpu_torch.core.checkpoint import CheckpointManager
from vibravox_tpu_torch.core.logging import Logger
from vibravox_tpu_torch.core.loop import Trainer, _split_batch
from vibravox_tpu_torch.core.optim import adam
from vibravox_tpu_torch.data.stp import STPDataModule
from vibravox_tpu_torch.models.wav2vec2 import (
    save_pretrained,
    wav2vec2_for_ctc_from_config,
    wav2vec2_for_ctc_from_pretrained,
)
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

CLI_ARGS = ["lightning_datamodule=stp", "lightning_module=wav2vec2_for_stp", "callbacks=stp_checkpoint",
            "logging=csv", "lightning_datamodule.dataset_name_principal=synthetic",
            "lightning_module/dnn_module@lightning_module.wav2vec2_for_ctc=wav2vec2_for_ctc_tiny",
            "++lightning_datamodule.synthetic_size=4", "++lightning_datamodule.batch_size=2",
            "++lightning_datamodule.num_workers=0", "++trainer.limit_val_batches=1",
            "++trainer.limit_test_batches=1", "++device=cpu"]
# every random part on, at rates the tiny model's 99 frames and 32
# channels take
NOISY = dict(hidden_dropout=0.1, activation_dropout=0.1, feat_proj_dropout=0.1, layerdrop=0.3,
             mask_time_prob=0.05, mask_feature_prob=0.25, mask_feature_length=4)


def test_cli_fits_validates_checkpoints_tests_and_resumes(tmp_path):
    from vibravox_tpu_torch.run import main

    cwd = os.getcwd()
    metrics = main(CLI_ARGS + [f"++run_dir={tmp_path}", "++trainer.max_epochs=2"])
    assert os.getcwd() == cwd
    assert set(metrics) == {"test/ctc_loss", "test/char_error_rate"}
    assert all(math.isfinite(v) for v in metrics.values())
    manager = CheckpointManager(str(tmp_path / "checkpoints"))
    assert manager.has_last() and manager.trainer_state() == {"epoch": 1, "global_step": 4}
    csv_dir = tmp_path / "csv"
    header = (csv_dir / "metrics.csv").read_text().splitlines()[0]
    assert "validation/char_error_rate" in header and "test/char_error_rate" in header
    decode = (csv_dir / "test_main_0_decode.txt").read_text()
    assert decode.startswith("pred: ") and "\ntarget: " in decode

    again = main(CLI_ARGS + [f"++run_dir={tmp_path}", "++trainer.max_epochs=3"])
    assert set(again) == set(metrics) and all(math.isfinite(v) for v in again.values())
    assert manager.trainer_state() == {"epoch": 2, "global_step": 6}


def _task(seed=0):
    model = wav2vec2_for_ctc_from_config(preset="tiny", seed=seed, device="cpu", **NOISY)
    return Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=adam(3e-4, betas=(0.5, 0.9)), device="cpu")


def _fit(ckpt_dir, max_epochs, num_workers=0, seed=0):
    trainer = Trainer(max_epochs=max_epochs, log_every_n_steps=1, check_val_every_n_epoch=100,
                      checkpoint=CheckpointManager(str(ckpt_dir)), seed=3)
    dm = STPDataModule(dataset_name_principal="synthetic", batch_size=2, num_workers=num_workers,
                       synthetic_size=2, device="cpu")
    trainer.fit(_task(seed), dm)
    return trainer


def _assert_bit_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
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
    trainer = _fit(tmp_path_factory.mktemp("stp_uninterrupted"), max_epochs=2)
    assert trainer.global_step == 2 and trainer.state.step == 2
    return trainer.state.state_dict()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_resumed_fit_is_bit_equal_to_an_uninterrupted_one(uninterrupted, tmp_path, num_workers):
    """Model, Adam, step and seed; the draws of a step depend on (seed,
    step) only, so the resumed step draws the uninterrupted one's."""
    first = _fit(tmp_path, max_epochs=1, num_workers=num_workers)
    assert first.global_step == 1
    # another init seed: everything the resumed run trains on comes from `last`
    resumed = _fit(tmp_path, max_epochs=2, num_workers=num_workers, seed=1)
    assert resumed.global_step == 2 and resumed.state.seed == 3
    _assert_bit_equal(resumed.state.state_dict(), uninterrupted)


def test_train_draws_depend_on_seed_and_step():
    """The random parts change the loss, and the same (seed, step) redraws
    the same masks: one step from the same state twice gives one loss."""
    task = _task()
    dm = STPDataModule(dataset_name_principal="synthetic", batch_size=2, num_workers=0, synthetic_size=2,
                       device="cpu")
    dm.setup("fit")
    batch, _ = _split_batch(next(iter(dm.train_dataloader())), torch.device("cpu"))
    state = task.init_state(0)
    sd = {k: v.clone() for k, v in task.wav2vec2_for_ctc.state_dict().items()}
    _, a = task.train_step(state, batch)
    task.wav2vec2_for_ctc.load_state_dict(sd)
    state = task.init_state(0)
    _, b = task.train_step(state, batch)
    task.wav2vec2_for_ctc.load_state_dict(sd)
    state = task.init_state(1)
    _, c = task.train_step(state, batch)
    assert torch.equal(a["train/ctc_loss"], b["train/ctc_loss"])
    assert not torch.equal(a["train/ctc_loss"], c["train/ctc_loss"])


class _Texts(Logger):
    def __init__(self):
        self.texts = []

    def log_scalars(self, scalars, step):
        pass

    def log_text(self, tag, text, step=0):
        self.texts.append((tag, text))


def test_host_fields_reach_eval_metrics_and_decodes_are_logged():
    batch = {"audio": torch.zeros(1, 4), "phonemes_str": ["ab"]}
    arrays, host = _split_batch(batch, torch.device("cpu"))
    assert set(arrays) == {"audio"} and host == {"phonemes_str": ["ab"]}

    logger = _Texts()
    task = _task()
    from vibravox_tpu_torch.data.phonemes import load_phoneme_tokenizer

    task.tokenizer = load_phoneme_tokenizer()
    dm = STPDataModule(dataset_name_principal="synthetic", batch_size=2, num_workers=0, synthetic_size=3,
                       device="cpu")
    trainer = Trainer(logger=logger, limit_test_batches=2)
    metrics = trainer.test(task, dm)
    assert set(metrics) == {"test/ctc_loss", "test/char_error_rate"}
    decodes = [(tag, text) for tag, text in logger.texts if tag.endswith("/decode")]
    assert [tag for tag, _ in decodes] == ["test_main_0/decode", "test_main_1/decode"]
    assert all(text.startswith("pred: ") and "\ntarget: " in text for _, text in decodes)


@pytest.fixture()
def pretraining_dir(tmp_path):
    """A pretraining checkpoint: the tiny model's weights without lm_head,
    with quantizer / project_q / project_hid keys, and the old weight_g /
    weight_v names of the positional conv."""
    model = wav2vec2_for_ctc_from_config(preset="tiny", seed=5, device="cpu")
    save_pretrained(model, str(tmp_path), with_lm_head=False)
    sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    base = "wav2vec2.encoder.pos_conv_embed.conv"
    sd[f"{base}.weight_g"] = sd.pop(f"{base}.parametrizations.weight.original0")
    sd[f"{base}.weight_v"] = sd.pop(f"{base}.parametrizations.weight.original1")
    sd["quantizer.codevectors"] = torch.zeros(1, 8, 4)
    sd["project_q.weight"], sd["project_hid.weight"] = torch.zeros(4, 4), torch.zeros(4, 32)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    return tmp_path, model


def test_from_pretrained_reads_a_local_pretraining_checkpoint(pretraining_dir):
    path, source = pretraining_dir
    model = wav2vec2_for_ctc_from_pretrained(str(path), device="cpu", layerdrop=0.05, mask_feature_prob=0.1024,
                                             mask_feature_length=64)
    assert model.load_report["dropped"] == ["project_hid.weight", "project_q.weight", "quantizer.codevectors"]
    assert model.load_report["initialised"] == ["lm_head.weight", "lm_head.bias"]
    cfg = model.config
    assert (cfg.hidden_size, cfg.layerdrop, cfg.mask_feature_length, cfg.vocab_size, cfg.pad_token_id) == (
        32, 0.05, 64, 38, 35)
    want = source.state_dict()
    for k, v in model.state_dict().items():
        if k.startswith("lm_head."):
            continue
        assert torch.equal(v, want[k]), k
    assert torch.equal(model.lm_head.bias, torch.zeros(38))
    assert 0.015 < float(model.lm_head.weight.detach().std()) < 0.025
    x = torch.randn(1, 4000)
    with torch.no_grad():
        assert torch.equal(model(x, return_features=True), source(x, return_features=True))


def test_from_pretrained_round_trip_with_lm_head(tmp_path):
    model = wav2vec2_for_ctc_from_config(preset="tiny", seed=2, device="cpu")
    save_pretrained(model, str(tmp_path))
    again = wav2vec2_for_ctc_from_pretrained(str(tmp_path), device="cpu")
    assert again.load_report == {"dropped": [], "initialised": []}
    _assert_bit_equal(again.state_dict(), model.state_dict())


def test_from_pretrained_refuses_what_is_not_a_local_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="never downloads"):
        wav2vec2_for_ctc_from_pretrained("facebook/wav2vec2-base-fr-voxpopuli-v2", device="cpu")
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        wav2vec2_for_ctc_from_pretrained(str(tmp_path), device="cpu")
    model = wav2vec2_for_ctc_from_config(preset="tiny", device="cpu")
    save_pretrained(model, str(tmp_path))
    with pytest.raises(RuntimeError, match="Missing key"):
        wav2vec2_for_ctc_from_pretrained(str(tmp_path), device="cpu", num_hidden_layers=3)
    with pytest.raises(TypeError, match="unknown"):
        wav2vec2_for_ctc_from_pretrained(str(tmp_path), device="cpu", not_a_field=1)


def test_published_stp_config_composes_to_the_port(tmp_path):
    """stp.yaml + wav2vec2_for_stp.yaml: the extractor and tokenizer targets
    are the port's, the pretrained factory reads a local directory with the
    published overrides, and the task gets the data module's tokenizer."""
    from vibravox_tpu_torch.core.config import compose, instantiate
    from vibravox_tpu_torch.data.features import Wav2Vec2FeatureExtractor
    from vibravox_tpu_torch.data.phonemes import PhonemeCTCTokenizer
    from vibravox_tpu_torch.run import CONFIG_DIR, port_targets

    save_pretrained(wav2vec2_for_ctc_from_config(preset="tiny", device="cpu"), str(tmp_path))
    cfg = compose(CONFIG_DIR, "run", ["lightning_datamodule=stp", "lightning_module=wav2vec2_for_stp",
                                      f"lightning_module.wav2vec2_for_ctc.pretrained_model_name_or_path={tmp_path}"])
    port_targets(cfg, "cpu")
    dm_cfg = cfg.lightning_datamodule
    assert dm_cfg.feature_extractor["_target_"] == "vibravox_tpu_torch.data.features.Wav2Vec2FeatureExtractor"
    dm = instantiate(dict(dm_cfg, dataset_name_principal="synthetic"))
    assert isinstance(dm.feature_extractor, Wav2Vec2FeatureExtractor) and not dm.feature_extractor.return_attention_mask
    assert isinstance(dm.tokenizer, PhonemeCTCTokenizer) and dm.num_workers == 16 and dm.batch_size == 8
    task = instantiate(cfg.lightning_module)
    c = task.wav2vec2_for_ctc.config
    assert (c.layerdrop, c.mask_time_prob, c.mask_feature_prob, c.mask_feature_length, c.hidden_dropout,
            c.final_dropout) == (0.05, 0.05, 0.1024, 64, 0.1, 0)
    assert task.freeze_feature_encoder and task.tokenizer is None
    opt = task.init_state(0).optimizer
    assert isinstance(opt, torch.optim.Adam) and opt.param_groups[0]["betas"] == (0.5, 0.9)


def test_bwe_config_targets_are_unchanged():
    """The rewrite of foreign targets touches only the STP extractor: the
    BWE / EBEN config's targets are the JAX package's, moved to the port."""
    from vibravox_tpu_torch.core.config import compose
    from vibravox_tpu_torch.run import CONFIG_DIR, port_targets

    def targets(node):
        if isinstance(node, dict):
            if isinstance(node.get("_target_"), str):
                yield node["_target_"]
            for v in node.values():
                yield from targets(v)
        elif isinstance(node, list):
            for v in node:
                yield from targets(v)

    cfg = compose(CONFIG_DIR, "run", ["lightning_datamodule=bwe", "lightning_module=eben"])
    before = list(targets(cfg))
    port_targets(cfg, "cpu")
    after = list(targets(cfg))
    assert after == [t.replace("vibravox_tpu.", "vibravox_tpu_torch.", 1) if t.startswith("vibravox_tpu.") else t
                     for t in before]
