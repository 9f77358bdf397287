"""Export a trained EBEN generator to the hub weight layout.

The port's counterpart of ``vibravox_tpu/scripts/upload_eben_to_hub.py``
(the reference's ``scripts/upload_eben_to_hub.py``): reads a checkpoint of
the port's trainer (``core/checkpoint.py``: a directory holding
``state.pt``, or the file), takes the EBEN task state's ``generator``,
infers (m, n, p) from its shapes and writes ``model.safetensors``,
``config.json`` and the model card (``models/hub.py::save_eben_generator``),
which the reference, the JAX package and the port load.  ``--repo-id``
raises: pushing needs the network.

Usage::

    python -m vibravox_tpu_torch.scripts.upload_eben_to_hub \\
        --checkpoint outputs/run/.../checkpoints/last --out eben_export/
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

    from vibravox_tpu_torch.models.hub import (
        eben_generator_from_state_dict,
        push_eben_generator_to_hub,
        save_eben_generator,
    )

    if args.repo_id:
        push_eben_generator_to_hub(None, args.repo_id)
    path = Path(args.checkpoint)
    state = torch.load(path / "state.pt" if path.is_dir() else path, map_location="cpu", weights_only=True)
    model = eben_generator_from_state_dict(state["generator"] if "generator" in state else state, device="cpu")
    weights = save_eben_generator(model, args.out)
    print(f"exported EBEN(m={model.m}, n={model.n}, p={model.p}) to {weights}", flush=True)


if __name__ == "__main__":
    main()
