"""Weights-day runbook: the published checkpoints read, staged and run through the port's CLI.

The port's counterpart of ``vibravox_tpu/scripts/weights_day.py``, with the
same command line and one more option, ``--device`` (absent: the GPU, which
raises without one; ``cpu``)::

    python -m vibravox_tpu_torch.scripts.weights_day --stage all [--cache-dir DIR] [--device cpu]

1. ``fetch``: the port never downloads.  Without ``--offline-dry-run`` the
   stage checks that ``<cache>/raw/`` holds what the JAX runbook's fetch
   leaves there (``RAW_LAYOUT``: ``eben_<sensor>/``,
   ``phonemizer_<sensor>/``, ``ecapa2/ecapa2.pt``,
   ``squim/squim_{objective,subjective}.pt``, ``mimi/``) and refuses,
   naming the layout and what is missing, when it does not: put the files
   there by other means (a ``raw/`` that the JAX runbook filled serves both
   packages).
2. ``convert``: every artifact of ``raw/`` read by the port's own readers,
   each of which fails on key or shape drift and names the keys, and one
   forward of each model on ``--device`` (EBEN runs K1 on the GPU, ECAPA2's
   front end K3); every output must be finite.  ``<cache>/staged/manifest.json``
   maps each artifact to its path, with the JAX runbook's keys.
3. ``parity``: the five parity configs (``PARITY_CONFIGS``) through
   ``vibravox_tpu_torch.run.main``, with ``$VIBRAVOX_ECAPA2_CKPT`` and
   ``$VIBRAVOX_SQUIM_DIR`` staged from the manifest; the metric table goes to
   ``--output``.

``--offline-dry-run`` proves the path with no network and no file from
outside: ``fetch`` writes donor checkpoints in the published formats with
the port's own writers (EBEN's hub layout, an HF wav2vec2 directory, an
ECAPA2 TorchScript archive, SQUIM's torchaudio-key state dicts, an HF Mimi
directory), tiny on the CPU and at full width on the GPU (EBEN at full
width on both); ``convert`` reads them as above; ``parity`` executes
``spkv_ecapa2_eval`` (fit and ``test("last")`` on the staged archive,
synthetic data, the environment variables set for that call only) and
composes and instantiates the other four.  As in the JAX runbook, EBEN, the
phonemizer and Mimi are staged and checked by ``needs`` but not given to
their configs.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vibravox_tpu_torch.device import DeviceLike, resolve_device

SENSORS = (
    "forehead_accelerometer",
    "rigid_in_ear_microphone",
    "soft_in_ear_microphone",
    "throat_microphone",
    "temple_vibration_pickup",
)

# what the JAX runbook's fetch leaves under <cache>/raw/
RAW_LAYOUT = (
    *(f"eben_{s}/" for s in SENSORS),
    *(f"phonemizer_{s}/" for s in SENSORS),
    "ecapa2/ecapa2.pt",
    "squim/squim_objective.pt",
    "squim/squim_subjective.pt",
    "mimi/",
)

# the JAX runbook's five parity configs, targets in the port's names; the
# executed config's embedder preset is the staged donor's (tiny on the CPU,
# full on the GPU)
PARITY_CONFIGS: List[Dict] = [
    {
        "name": "spkv_ecapa2_eval",
        "metric_keys": ["test/equal_error_rate", "test/minimum_dcf"],
        "overrides": [
            "lightning_datamodule=spkv",
            "lightning_module=ecapa2",
            "lightning_datamodule.sensor_a=headset_microphone",
            "lightning_datamodule.sensor_b=headset_microphone",
        ],
        "needs": ["ecapa2"],
        "synthetic": "lightning_datamodule.dataset_name=synthetic",
        "dryrun_execute": [
            "++lightning_module.embedder._target_=vibravox_tpu_torch.models.ecapa2.ecapa2_from_config",
            "++lightning_module.embedder.preset={ecapa2_preset}",
            "++trainer.limit_test_batches=8",
        ],
    },
    {
        "name": "stp_wav2vec2_throat",
        "metric_keys": ["test/per"],
        "overrides": [
            "lightning_datamodule=stp",
            "lightning_module=wav2vec2_for_stp",
            "lightning_datamodule.sensor=throat_microphone",
            "++trainer.max_epochs=10",
        ],
        "needs": ["phonemizer_throat_microphone"],
        "synthetic": "lightning_datamodule.dataset_name_principal=synthetic",
        # the published config reads the pretrained base from the hub
        "dryrun_overrides": [
            "lightning_module/dnn_module@lightning_module.wav2vec2_for_ctc=wav2vec2_for_ctc_tiny",
        ],
    },
    {
        "name": "bwe_eben_throat",
        "metric_keys": ["test/stoi", "test/si_sdr"],
        "overrides": [
            "lightning_datamodule=bwe",
            "lightning_module=eben",
            "lightning_datamodule.sensor=throat_microphone",
        ],
        "needs": [],
        "synthetic": "lightning_datamodule.dataset_name_principal=synthetic",
    },
    {
        "name": "noisy_bwe_from_pretrained_eben",
        "metric_keys": ["test/stoi"],
        "overrides": [
            "lightning_datamodule=noisybwe",
            "lightning_module=eben",
            "lightning_datamodule.sensor=temple_vibration_pickup",
        ],
        "needs": ["eben_temple_vibration_pickup"],
        "synthetic": "lightning_datamodule.dataset_name=synthetic",
    },
    {
        "name": "mimi_regressive_bwe",
        "metric_keys": ["test/stoi"],
        "overrides": [
            "lightning_datamodule=bwe",
            "lightning_module=regressive_mimi",
            "lightning_datamodule.sample_rate=24000",
            "lightning_datamodule.batch_size=16",
        ],
        "needs": ["mimi"],
        "synthetic": "lightning_datamodule.dataset_name_principal=synthetic",
        "dryrun_overrides": ["++lightning_module.mimi.preset=tiny"],
    },
]

STAGED_ENV = ("VIBRAVOX_ECAPA2_CKPT", "VIBRAVOX_SQUIM_DIR")


def _log(msg: str) -> None:
    print(f"[weights-day] {msg}", flush=True)


def _wave(shape, seed: int = 0) -> torch.Tensor:
    """Seeded non-zero audio (SQUIM's objective RMS-normalises its input)."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.1)


def _finite(name: str, *outputs: torch.Tensor) -> None:
    if not all(bool(torch.isfinite(o).all()) for o in outputs):
        raise ValueError(f"convert {name}: the forward gave non-finite values")


# --------------------------------------------------------------------- #
# fetch
# --------------------------------------------------------------------- #


def stage_fetch(cache: Path) -> None:
    """Checks ``raw/`` against ``RAW_LAYOUT``; the port never downloads."""
    raw = cache / "raw"
    missing = [entry for entry in RAW_LAYOUT if not (raw / entry).exists()]
    if missing:
        raise SystemExit(
            f"the port never downloads: put the published checkpoints under {raw}/ in the layout "
            f"{', '.join(RAW_LAYOUT)} (the JAX runbook's fetch stage leaves it so), or run with "
            f"--offline-dry-run; missing: {', '.join(missing)}")
    _log(f"fetch: {raw} holds every artifact")


# --------------------------------------------------------------------- #
# offline dry-run donors (the published on-disk formats, no network)
# --------------------------------------------------------------------- #

def _tiny_squim_configs():
    """The JAX runbook's tiny SQUIM donors (``tests/test_squim.py``'s twins)."""
    from vibravox_tpu_torch.models.squim import SquimObjectiveConfig, SquimSubjectiveConfig
    from vibravox_tpu_torch.models.wav2vec2 import TINY_W2V2_CONFIG, Wav2Vec2Config

    ssl = Wav2Vec2Config(**{**TINY_W2V2_CONFIG, "vocab_size": 1}, apply_spec_augment=False, layerdrop=0.0)
    return (SquimObjectiveConfig(feat_dim=8, win_len=16, d_model=8, nhead=2, hidden_dim=8, num_blocks=1, chunk_size=7),
            SquimSubjectiveConfig(proj_dim=8, att_dim=8, ssl=ssl))


def stage_make_offline_donors(cache: Path, full_width: bool) -> None:
    """Donor checkpoints in the formats ``convert`` reads, made on the CPU
    from seed 0 (torch's default initialisers where a constructor has them,
    quick at full width): tiny models, or with ``full_width`` the published
    widths."""
    from vibravox_tpu_torch.models import safetensors_io
    from vibravox_tpu_torch.models.ecapa2 import ECAPA2, PRESETS
    from vibravox_tpu_torch.models.eben_generator import EBENGenerator
    from vibravox_tpu_torch.models.hub import save_eben_generator
    from vibravox_tpu_torch.models.mimi.convert import mimi_config_to_hf, mimi_state_dict_to_hf
    from vibravox_tpu_torch.models.mimi.mimi import MimiConfig, MimiModule, tiny_config
    from vibravox_tpu_torch.models.squim import (
        SquimObjective,
        SquimObjectiveConfig,
        SquimSubjective,
        SquimSubjectiveConfig,
    )
    from vibravox_tpu_torch.models.wav2vec2 import (
        TINY_W2V2_CONFIG,
        Wav2Vec2Config,
        Wav2Vec2ForCTC,
        save_pretrained,
    )

    raw = cache / "raw"
    raw.mkdir(parents=True, exist_ok=True)

    # EBEN: the hub layout of the published Cnam-LMSSC/EBEN_* repos
    torch.manual_seed(0)
    save_eben_generator(EBENGenerator(m=4, n=32, p=2, device="cpu"), raw / "eben_temple_vibration_pickup",
                        sensor="temple_vibration_pickup")
    _log("donor eben_temple_vibration_pickup: ok")

    # phonemizer: an HF Wav2Vec2ForCTC directory (wav2vec2-base at full width)
    torch.manual_seed(0)
    phonemizer = Wav2Vec2ForCTC(Wav2Vec2Config(**({} if full_width else TINY_W2V2_CONFIG)))
    save_pretrained(phonemizer, str(raw / "phonemizer_throat_microphone"))
    _log("donor phonemizer_throat_microphone: ok")

    # ECAPA2: a TorchScript archive, the format of Jenthe/ECAPA2's ecapa2.pt
    config = PRESETS["full" if full_width else "tiny"]()
    torch.manual_seed(0)
    embedder = ECAPA2(config, device="cpu").eval()
    (raw / "ecapa2").mkdir(exist_ok=True)
    with warnings.catch_warnings():  # the trace freezes the front end's frame count: only its weights are read
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        archive = torch.jit.trace(embedder, _wave((1, 16000)), check_trace=False)
    torch.jit.save(archive, str(raw / "ecapa2/ecapa2.pt"))
    geometry = {k: getattr(config, k) for k in ("stem_channels", "gfe_channels", "res2_scale", "embed_dim")}
    geometry["lfe_stages"] = [list(s) for s in config.lfe_stages]
    (raw / "ecapa2/dryrun_config.json").write_text(json.dumps(geometry))
    _log("donor ecapa2 (TorchScript): ok")

    # SQUIM: torchaudio-key state dicts
    (raw / "squim").mkdir(exist_ok=True)
    obj_cfg, subj_cfg = (SquimObjectiveConfig(), SquimSubjectiveConfig()) if full_width else _tiny_squim_configs()
    torch.manual_seed(0)
    objective, subjective = SquimObjective(obj_cfg), SquimSubjective(subj_cfg)
    torch.save(objective.state_dict(), raw / "squim/squim_objective.pt")
    torch.save(subjective.torchaudio_state_dict(), raw / "squim/squim_subjective.pt")
    (raw / "squim/dryrun_config.json").write_text(json.dumps({"tiny_twins": not full_width}))
    _log("donor squim (objective + subjective): ok")

    # Mimi: an HF MimiModel directory, config.json + model.safetensors
    mimi_cfg = MimiConfig() if full_width else tiny_config()
    torch.manual_seed(0)
    codec = MimiModule(mimi_cfg)
    # the constructor leaves convs and codebooks unset, and Mimi(seed=...)'s
    # truncated normals are slow on the CPU at full width: a format donor
    # needs values, not a distribution
    with torch.no_grad():
        for param in codec.parameters():
            param.normal_(0.0, 0.02)
    (raw / "mimi").mkdir(exist_ok=True)
    (raw / "mimi/config.json").write_text(json.dumps(mimi_config_to_hf(mimi_cfg), indent=1))
    safetensors_io.save_file(mimi_state_dict_to_hf(codec.state_dict(), mimi_cfg), raw / "mimi/model.safetensors")
    _log("donor mimi: ok")


# --------------------------------------------------------------------- #
# convert
# --------------------------------------------------------------------- #


def _ecapa2_config(ecapa2_dir: Path):
    """The staged embedder's geometry: ``dryrun_config.json`` when the
    donor wrote one, else the published ``ECAPA2Config()``."""
    from vibravox_tpu_torch.models.ecapa2 import ECAPA2Config

    cfg_file = ecapa2_dir / "dryrun_config.json"
    if not cfg_file.exists():
        return ECAPA2Config()
    cfg_kw = json.loads(cfg_file.read_text())
    cfg_kw["lfe_stages"] = tuple(tuple(s) for s in cfg_kw["lfe_stages"])
    return ECAPA2Config(**cfg_kw)


@torch.no_grad()
def stage_convert(cache: Path, device: DeviceLike = None) -> Dict[str, str]:
    """Reads every artifact of ``raw/`` with the port's readers (each raises
    on key or shape drift), runs one forward of each on ``device``, and
    writes ``staged/manifest.json``."""
    from vibravox_tpu_torch.metrics.squim import load_squim_predictors
    from vibravox_tpu_torch.models import safetensors_io
    from vibravox_tpu_torch.models.ecapa2 import ECAPA2
    from vibravox_tpu_torch.models.hub import eben_generator_from_pretrained, load_state_dict
    from vibravox_tpu_torch.models.mimi.convert import mimi_config_from_hf, mimi_state_dict_from_hf
    from vibravox_tpu_torch.models.mimi.mimi import MimiModule
    from vibravox_tpu_torch.models.squim import SquimObjective, SquimSubjective
    from vibravox_tpu_torch.models.wav2vec2 import wav2vec2_for_ctc_from_pretrained

    dev = resolve_device(device)
    raw, staged = cache / "raw", cache / "staged"
    staged.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, str] = {}

    for d in sorted(raw.glob("eben_*")):
        model = eben_generator_from_pretrained(d, device=dev).eval()
        y, _ = model(_wave((1, model.valid_length(16000), 1)).to(dev))
        _finite(d.name, y)
        manifest[d.name] = str(d)
        _log(f"convert {d.name}: forward ok {tuple(y.shape)}")

    for d in sorted(raw.glob("phonemizer_*")):
        model = wav2vec2_for_ctc_from_pretrained(str(d), device=dev).eval()
        logits = model(_wave((1, 4000)).to(dev))
        _finite(d.name, logits)
        manifest[d.name] = str(d)
        _log(f"convert {d.name}: forward ok {tuple(logits.shape)}")

    archive = raw / "ecapa2/ecapa2.pt"
    if archive.exists():
        with torch.random.fork_rng(devices=[]):  # the throwaway initial weights leave the caller's stream alone
            embedder = ECAPA2(_ecapa2_config(archive.parent), device="cpu")
        embedder.load_state_dict(load_state_dict(archive), strict=True)
        emb = embedder.to(dev).eval()(_wave((1, 16000)).to(dev))
        _finite("ecapa2", emb)
        manifest["ecapa2"] = str(archive)  # $VIBRAVOX_ECAPA2_CKPT
        _log(f"convert ecapa2: embedding ok {tuple(emb.shape)}")

    squim_dir = raw / "squim"
    if squim_dir.is_dir():
        cfg_file = squim_dir / "dryrun_config.json"
        if cfg_file.exists() and json.loads(cfg_file.read_text()).get("tiny_twins"):
            obj_cfg, subj_cfg = _tiny_squim_configs()
            with torch.random.fork_rng(devices=[]):
                objective, subjective = SquimObjective(obj_cfg), SquimSubjective(subj_cfg)
            objective.load_state_dict(load_state_dict(squim_dir / "squim_objective.pt"), strict=True)
            subjective.load_torchaudio_state_dict(load_state_dict(squim_dir / "squim_subjective.pt"))
            objective = objective.to(dev).eval()
        else:
            objective, subjective = load_squim_predictors(squim_dir, device=dev)
            if objective is None or subjective is None:
                raise FileNotFoundError(f"{squim_dir} lacks squim_objective.pt or squim_subjective.pt")
            objective = objective[1]
        scores = objective(_wave((1, 16000)).to(dev))
        _finite("squim", *scores)
        manifest["squim"] = str(squim_dir)  # $VIBRAVOX_SQUIM_DIR
        _log("convert squim: objective forward ok, subjective loaded")

    mimi_dir = raw / "mimi"
    if mimi_dir.is_dir():
        config = mimi_config_from_hf(json.loads((mimi_dir / "config.json").read_text()))
        sd = mimi_state_dict_from_hf(safetensors_io.load_file(mimi_dir / "model.safetensors"), config)
        with torch.random.fork_rng(devices=[]):
            codec = MimiModule(config)
        codec.load_state_dict(sd, strict=True)
        codec = codec.to(dev).eval()
        t = -(-12000 // config.hop_length) * config.hop_length  # 0.5 s at 24 kHz in whole frames
        latent = codec.encode_to_latent(_wave((1, t, 1)).to(dev))
        _finite("mimi", latent)
        manifest["mimi"] = str(mimi_dir)
        _log(f"convert mimi: encode ok {tuple(latent.shape)}")

    (staged / "manifest.json").write_text(json.dumps(manifest, indent=2))
    _log(f"manifest: {staged / 'manifest.json'} ({len(manifest)} artifacts)")
    return manifest


# --------------------------------------------------------------------- #
# parity
# --------------------------------------------------------------------- #


def _ecapa2_preset(archive: Path) -> str:
    """The name of the ``ECAPA2`` preset whose geometry the staged archive has."""
    from vibravox_tpu_torch.models.ecapa2 import PRESETS

    config = _ecapa2_config(archive.parent)
    for name, make in PRESETS.items():
        if make() == config:
            return name
    raise SystemExit(f"the staged ECAPA2 ({archive}) has no preset's geometry: {config}")


def stage_parity(cache: Path, dry_run: bool, out_path: Path, extra_overrides: Optional[List[str]] = None,
                 device: Optional[str] = None) -> None:
    """The five parity configs through the port's CLI.  In a dry run
    ``spkv_ecapa2_eval`` executes and the other four are composed and
    their data module, task and trainer instantiated, not fitted."""
    from vibravox_tpu_torch import run

    manifest_path = cache / "staged/manifest.json"
    manifest = json.loads(manifest_path.read_text()) if manifest_path.exists() else {}
    on_device = [f"++device={device}"] if device else []

    def stage_env() -> None:
        """Points the tasks at the staged weights (in a dry run, only for
        the call it executes)."""
        if manifest.get("ecapa2"):
            os.environ.setdefault("VIBRAVOX_ECAPA2_CKPT", manifest["ecapa2"])
        if manifest.get("squim"):
            os.environ.setdefault("VIBRAVOX_SQUIM_DIR", manifest["squim"])

    if not dry_run:
        stage_env()

    def execute(spec, overrides):
        metrics = run.main(overrides + on_device)
        return {k: metrics.get(k) for k in spec["metric_keys"]}

    rows = []
    for spec in PARITY_CONFIGS:
        overrides = list(spec["overrides"]) + list(extra_overrides or [])
        missing = [n for n in spec["needs"] if n not in manifest]
        if missing and not dry_run:
            rows.append((spec["name"], {"SKIPPED": f"missing {missing}"}))
            _log(f"parity {spec['name']}: SKIPPED (missing {missing})")
            continue
        if not dry_run:
            picked = execute(spec, overrides)
            rows.append((spec["name"], picked))
            _log(f"parity {spec['name']}: {picked}")
            continue
        overrides = [o for o in overrides if not o.startswith("++trainer.max_epochs")] + [spec["synthetic"]] \
            + list(spec.get("dryrun_overrides", []))
        if spec.get("dryrun_execute") is not None:
            if missing:
                raise SystemExit(f"dry-run execute {spec['name']}: run the convert stage first (missing {missing})")
            preset = _ecapa2_preset(Path(manifest["ecapa2"]))
            executed = [o.format(ecapa2_preset=preset) for o in spec["dryrun_execute"]]
            if resolve_device(device).type == "cpu":
                executed.append("lightning_datamodule.num_workers=0")
            saved = {k: os.environ.get(k) for k in STAGED_ENV}
            stage_env()
            try:
                picked = execute(spec, overrides + executed + [f"++run_dir={cache / 'dryrun_runs' / spec['name']}"])
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            if any(v is None for v in picked.values()):
                raise ValueError(f"{spec['name']}: the executed dry run gave no value for some of "
                                 f"{spec['metric_keys']}: {picked}")
            rows.append((spec["name"], {"dry_run_executed": picked}))
            _log(f"parity {spec['name']}: dry-run EXECUTED {picked}")
            continue
        from vibravox_tpu_torch.core.config import compose, instantiate

        cfg = compose(run.CONFIG_DIR, "run", overrides + on_device)
        run.port_targets(cfg, str(resolve_device(cfg.pop("device", None))))
        datamodule = instantiate(cfg.lightning_datamodule)
        task = instantiate(cfg.lightning_module)
        trainer = instantiate(cfg.trainer, checkpoint=None, logger=None)
        if not (hasattr(task, "train_step") or hasattr(task, "eval_step")) or trainer is None or datamodule is None:
            raise ValueError(f"{spec['name']}: the composed config did not instantiate a task, trainer and data")
        rows.append((spec["name"], {"dry_run": "compose+instantiate ok"}))
        _log(f"parity {spec['name']}: dry-run compose+instantiate ok")

    lines = [
        "# Real-data parity results, PyTorch port" + (" (OFFLINE DRY-RUN)" if dry_run else ""),
        "",
        "Written by `python -m vibravox_tpu_torch.scripts.weights_day` — see",
        "BASELINE.md for the reference targets these compare against.",
        "",
        "| config | metrics |",
        "|---|---|",
    ]
    lines += [f"| {name} | {json.dumps(metrics)} |" for name, metrics in rows]
    out_path.write_text("\n".join(lines) + "\n")
    _log(f"wrote {out_path}")


# --------------------------------------------------------------------- #


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--stage", default="all", choices=["all", "fetch", "convert", "parity"])
    parser.add_argument("--offline-dry-run", action="store_true")
    parser.add_argument("--cache-dir", default=os.path.expanduser("~/.cache/vibravox_tpu_weights"))
    parser.add_argument("--output", default="REAL_DATA.md")
    parser.add_argument("--override", action="append", default=[],
                        help="extra run override applied to every parity config")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    cache = Path(args.cache_dir)
    dev = resolve_device(args.device)

    if args.stage in ("all", "fetch"):
        if args.offline_dry_run:
            stage_make_offline_donors(cache, full_width=dev.type == "cuda")
        else:
            stage_fetch(cache)
    if args.stage in ("all", "convert"):
        stage_convert(cache, dev)
    if args.stage in ("all", "parity"):
        stage_parity(cache, args.offline_dry_run, Path(args.output), args.override, args.device)


if __name__ == "__main__":
    main()
