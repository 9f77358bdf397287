"""Export a trained EBEN discriminator.

The port's counterpart of ``vibravox_tpu/scripts/push_dis_to_hub.py`` (the
reference's ``scripts/push_dis_to_hub.py``): takes the ``discriminator`` of
a port EBEN checkpoint (a directory holding ``state.pt``, or the file) and
writes ``model.safetensors`` and ``config.json`` (q, min_channels) under
``--out``/discriminator, the layout ``models/hub.py::eben_discriminator_from_pretrained``
loads.  The JAX package writes an orbax checkpoint there instead, which the
port does not read.  ``--repo-id`` raises: pushing needs the network.

Usage::

    python -m vibravox_tpu_torch.scripts.push_dis_to_hub \\
        --checkpoint outputs/run/.../checkpoints/last --out disc_export/
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True, help="checkpoint directory (e.g. .../last) or its state.pt")
    parser.add_argument("--out", required=True, help="export directory")
    parser.add_argument("--repo-id", default=None, help="refused: pushing needs the network")
    args = parser.parse_args(argv)

    import torch

    from vibravox_tpu_torch.models.hub import push_folder_to_hub, save_eben_discriminator

    if args.repo_id:
        push_folder_to_hub(args.out, args.repo_id)
    path = Path(args.checkpoint)
    state = torch.load(path / "state.pt" if path.is_dir() else path, map_location="cpu", weights_only=True)
    sd = state["discriminator"] if "discriminator" in state else state
    weights = save_eben_discriminator(sd, Path(args.out) / "discriminator")
    print(f"exported discriminator params to {weights}", flush=True)


if __name__ == "__main__":
    main()
