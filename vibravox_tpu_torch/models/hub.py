"""Pretrained EBEN weights: load and export, from and to local paths (PyTorch).

Counterpart of ``vibravox_tpu/models/hub.py``.  The reference publishes its
EBEN networks with ``PyTorchModelHubMixin`` (``Cnam-LMSSC/EBEN_*``): a
``model.safetensors`` (or ``pytorch_model.bin``) state dict with
``weight_norm``'s ``parametrizations.weight.original0`` / ``original1``
keys, which are the port's own names, so a file loads with
``load_state_dict(strict=True)``.  Safetensors files are read and written
by the port's ``safetensors_io``.  ``load_state_dict`` also reads a
TorchScript archive (the published ECAPA2 checkpoint is one); the SPKV
task's checkpoint slot and SQUIM's loader read through it.

The port never downloads or uploads: a name that is not a local file or
directory, and ``push_eben_generator_to_hub``, raise.
"""

from __future__ import annotations

import json
import pickle
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from vibravox_tpu_torch.device import DeviceLike, resolve_device
from vibravox_tpu_torch.models import safetensors_io
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator

__all__ = [
    "eben_generator_from_pretrained",
    "eben_generator_from_state_dict",
    "eben_discriminator_from_pretrained",
    "save_eben_generator",
    "save_eben_discriminator",
    "push_eben_generator_to_hub",
    "push_folder_to_hub",
    "load_state_dict",
    "is_torchscript_archive",
    "infer_eben_hparams",
    "infer_eben_discriminator_hparams",
]

_WEIGHT_CANDIDATES = ("model.safetensors", "pytorch_model.bin", "model.pt")

PathLike = Union[str, Path]


def _resolve_weights(path: PathLike) -> Path:
    p = Path(path)
    if p.is_file():
        return p
    if p.is_dir():
        for name in _WEIGHT_CANDIDATES:
            if (p / name).is_file():
                return p / name
        raise FileNotFoundError(f"no weight file ({', '.join(_WEIGHT_CANDIDATES)}) under {p}")
    raise FileNotFoundError(
        f"{str(path)!r} is not a local file or directory: the port reads pretrained weights from a "
        "local path and never downloads (a hub repo id needs the network)")


def is_torchscript_archive(path: PathLike) -> bool:
    """Whether ``path`` is a ``torch.jit.save`` archive: a zip whose top
    folder holds ``constants.pkl`` (a ``torch.save`` zip has ``data.pkl``
    and no constants), the test ``torch.load`` makes itself."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as archive:
        return any(name.count("/") == 1 and name.endswith("/constants.pkl") for name in archive.namelist())


def load_state_dict(path: PathLike) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file; a TorchScript archive (its module's
    ``state_dict()``, read by ``torch.jit.load``); or a torch ``.bin`` /
    ``.pt`` state dict (read with ``weights_only=True``, unwrapped from a
    ``{"state_dict": ...}``).  A pickled eager module, which only
    ``weights_only=False`` would unpickle, is refused: the port does not
    unpickle code."""
    if str(path).endswith(".safetensors"):
        return safetensors_io.load_file(path)
    if is_torchscript_archive(path):
        return {k: v.detach() for k, v in torch.jit.load(str(path), map_location="cpu").state_dict().items()}
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: holds pickled Python objects (an eager module?), not a state dict or a TorchScript "
            "archive; the port reads weights with torch.load(weights_only=True) and does not unpickle code: "
            "save module.state_dict() or torch.jit.save the module") from e
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise TypeError(f"{path}: expected a state dict, got {type(obj).__name__}")
    return dict(obj)


def infer_eben_hparams(sd: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """(m, n, p) from the weight shapes, as the reference's upload script
    (``upload_eben_to_hub.py:17-20``)."""
    analysis = sd["pqmf.analysis_weights"]
    return {"m": int(analysis.shape[0]), "n": int(analysis.shape[2]), "p": int(sd["first_conv.weight"].shape[1])}


def _loaded(make, sd: Dict[str, torch.Tensor], device: DeviceLike):
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):  # the throwaway initial weights leave the caller's stream alone
        model = make()
    model.load_state_dict(sd, strict=True)
    return model.to(dev)


def eben_generator_from_state_dict(sd: Dict[str, torch.Tensor], device: DeviceLike = None) -> EBENGenerator:
    """An ``EBENGenerator`` holding ``sd``, its (m, n, p) inferred from the
    shapes; on ``device`` (``None`` for the GPU, which raises without one,
    or ``"cpu"``)."""
    return _loaded(lambda: EBENGenerator(**infer_eben_hparams(sd), device="cpu"), sd, device)


def eben_generator_from_pretrained(path: PathLike, device: DeviceLike = None) -> EBENGenerator:
    """An ``EBENGenerator`` from a weight file or a directory holding one."""
    return eben_generator_from_state_dict(load_state_dict(_resolve_weights(path)), device)


def infer_eben_discriminator_hparams(sd: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """(q, min_channels) of a ``DiscriminatorEBENMultiScales`` state dict:
    stage 0 of a band discriminator maps q bands to min_channels, stage 1
    reads min_channels / q channels a group."""
    stage = "pqmf_discriminators.0.discriminator.{}.parametrizations.weight.original1"
    c = int(sd[stage.format("0.1")].shape[0])
    return {"q": c // int(sd[stage.format("1.0")].shape[1]), "min_channels": c}


def eben_discriminator_from_pretrained(path: PathLike, q: int = 4, min_channels: int = 24,
                                       device: DeviceLike = None) -> DiscriminatorEBENMultiScales:
    sd = load_state_dict(_resolve_weights(path))
    return _loaded(lambda: DiscriminatorEBENMultiScales(q=q, min_channels=min_channels, device="cpu"), sd, device)


def save_eben_discriminator(sd: Dict[str, torch.Tensor], save_dir: PathLike) -> str:
    """Writes a ``DiscriminatorEBENMultiScales`` state dict in the layout
    ``eben_discriminator_from_pretrained`` reads: ``model.safetensors`` and
    ``config.json`` (q, min_channels).  Returns the weight file's path."""
    out = Path(save_dir)
    out.mkdir(parents=True, exist_ok=True)
    weights = out / "model.safetensors"
    safetensors_io.save_file(sd, weights)
    (out / "config.json").write_text(json.dumps(infer_eben_discriminator_hparams(sd)))
    return str(weights)


_MODEL_CARD = """---
language: fr
license: mit
tags:
  - audio
  - audio-to-audio
  - speech
datasets:
  - Cnam-LMSSC/vibravox
model-index:
  - name: EBEN(M={m},P={p},Q=?)
    results:
      - task:
          name: Bandwidth Extension
          type: speech-enhancement
        dataset:
          name: Vibravox["{sensor}"]
          type: Cnam-LMSSC/vibravox
          args: fr
        metrics:
          - name: Test STOI, in-domain training
            type: stoi
            value: {stoi}
---

# EBEN(M={m},P={p}) — trained with vibravox-tpu

Bandwidth-extension model for body-conduction sensor speech. The weights are
stored in the reference PyTorch layout and load in the reference, in
vibravox-tpu (JAX) and in its PyTorch port:

```python
from vibravox_tpu_torch.models.hub import eben_generator_from_pretrained
model = eben_generator_from_pretrained("THIS_DIRECTORY")
enhanced, bands = model(model.cut_to_valid_length(audio_16k))  # (B, T, 1)
```
"""


def save_eben_generator(model: EBENGenerator, save_dir: PathLike, sensor: str = "YOUR_MIC",
                        test_stoi: Any = "???") -> str:
    """Writes the hub layout: ``model.safetensors`` (the state dict, PQMF
    buffers included), ``config.json`` (m, n, p) and the model card
    ``README.md``.  Returns the weight file's path."""
    out = Path(save_dir)
    out.mkdir(parents=True, exist_ok=True)
    weights = out / "model.safetensors"
    safetensors_io.save_file(model.state_dict(), weights)
    (out / "config.json").write_text(json.dumps({"m": model.m, "n": model.n, "p": model.p}))
    (out / "README.md").write_text(_MODEL_CARD.format(m=model.m, p=model.p, sensor=sensor, stoi=test_stoi))
    return str(weights)


def push_eben_generator_to_hub(model: EBENGenerator, repo_id: str) -> None:
    """Refused: pushing needs the network.  ``save_eben_generator`` writes
    the files an upload would send."""
    raise NotImplementedError(
        f"pushing to the hub ({repo_id!r}) needs the network, which the port never uses; write a local "
        "directory with save_eben_generator and upload it yourself")


def push_folder_to_hub(folder: Optional[PathLike], repo_id: str) -> None:
    """Refused: pushing needs the network.  The export scripts write the
    folder an upload would send."""
    raise NotImplementedError(
        f"pushing {str(folder or 'a folder')!r} to the hub ({repo_id!r}) needs the network, which the port "
        "never uses; write the local directory and upload it yourself")
