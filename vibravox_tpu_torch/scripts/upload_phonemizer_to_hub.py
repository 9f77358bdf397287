"""Export a fine-tuned phonemizer to the HF ``Wav2Vec2ForCTC`` directory layout.

The port's counterpart of ``vibravox_tpu/scripts/upload_phonemizer_to_hub.py``
(the reference's ``scripts/upload_phonemizer_to_hub.py``): reads a
checkpoint of the port's STP trainer (a directory holding ``state.pt``, or
the file; the task state's ``model``), loads it into a ``Wav2Vec2ForCTC`` of
the default (base) config or of ``--preset tiny``, and writes
``model.safetensors`` and ``config.json`` (``models/wav2vec2.py::save_pretrained``)
with the phoneme tokenizer's files beside them: the directory that HF's
``Wav2Vec2ForCTC.from_pretrained`` and the port's
``wav2vec2_for_ctc_from_pretrained`` read.  ``--repo-id`` raises: pushing
needs the network.

Usage::

    python -m vibravox_tpu_torch.scripts.upload_phonemizer_to_hub \\
        --checkpoint outputs/run/.../checkpoints/last --out phonemizer_export/ [--preset tiny]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True, help="checkpoint directory (e.g. .../last) or its state.pt")
    parser.add_argument("--out", required=True, help="export directory")
    parser.add_argument("--repo-id", default=None, help="refused: pushing needs the network")
    parser.add_argument("--preset", default=None, help="model preset used in training (e.g. tiny)")
    args = parser.parse_args(argv)

    import torch

    from vibravox_tpu_torch.data.phonemes import load_phoneme_tokenizer
    from vibravox_tpu_torch.models.hub import push_folder_to_hub
    from vibravox_tpu_torch.models.wav2vec2 import save_pretrained, wav2vec2_for_ctc_from_config

    if args.repo_id:
        push_folder_to_hub(args.out, args.repo_id)
    path = Path(args.checkpoint)
    state = torch.load(path / "state.pt" if path.is_dir() else path, map_location="cpu", weights_only=True)
    sd = state["model"] if "model" in state else state
    # the weights only move through the host: the model is built on the CPU
    # (its random weights, from the default seed, are all replaced)
    with torch.random.fork_rng(devices=[]):
        model = wav2vec2_for_ctc_from_config(preset=args.preset, device="cpu")
    model.load_state_dict(sd, strict=True)
    save_pretrained(model, args.out, safetensors=True)
    load_phoneme_tokenizer().save_pretrained(args.out)
    print(f"exported phonemizer + tokenizer to {args.out}", flush=True)


if __name__ == "__main__":
    main()
