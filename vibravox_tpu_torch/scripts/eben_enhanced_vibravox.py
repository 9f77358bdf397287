"""Enhance a dataset's test split with pretrained EBEN generators.

The port's counterpart of ``vibravox_tpu/scripts/eben_enhanced_vibravox.py``
(the reference's ``scripts/eben_enhanced_vibravox.py``): for each
body-conduction sensor, the generator of its weights enhances the test
split, utterance by utterance (cut to the generator's valid length), and
``<out>/<sensor>/{i:06d}.npz`` holds ``audio_enhanced``.  The split comes
through the BWE data module's ``resolve_source`` (``synthetic``, a
directory of npz splits, or a local hub dataset); the weights are local
files or directories (``models/hub.py``).  The generator runs on the GPU,
K1 six times an utterance, unless ``--device cpu`` is given.

Usage::

    python -m vibravox_tpu_torch.scripts.eben_enhanced_vibravox \\
        --dataset synthetic --sensors rigid_in_ear_microphone \\
        --weights path/to/eben_weights --out enhanced/ [--limit N] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="Cnam-LMSSC/vibravox")
    parser.add_argument("--subset", default="speech_clean")
    parser.add_argument("--sensors", nargs="+", default=["rigid_in_ear_microphone"])
    parser.add_argument("--weights", nargs="+", required=True, help="one weight file or directory per sensor")
    parser.add_argument("--out", required=True)
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--limit", type=int, default=None, help="enhance only the first N utterances")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if len(args.sensors) != len(args.weights):
        parser.error(f"{len(args.sensors)} sensors but {len(args.weights)} weights")

    import torch

    from vibravox_tpu_torch.data.bwe import resolve_source
    from vibravox_tpu_torch.models.hub import eben_generator_from_pretrained

    for sensor, weights in zip(args.sensors, args.weights):
        model = eben_generator_from_pretrained(weights, device=args.device).eval()
        dev = next(model.parameters()).device
        source = resolve_source(args.dataset, args.subset, "test", sensor, args.sample_rate, False)
        rows = (source[i] for i in range(len(source))) if hasattr(source, "__len__") else iter(source)
        out_dir = Path(args.out) / sensor
        out_dir.mkdir(parents=True, exist_ok=True)
        count = 0
        for i, row in enumerate(itertools.islice(rows, args.limit)):
            audio = torch.from_numpy(np.asarray(row["audio_body_conducted"], np.float32))[None, :, None]
            with torch.inference_mode():
                enhanced = model(model.cut_to_valid_length(audio.to(dev)))[0]
            np.savez(out_dir / f"{i:06d}.npz", audio_enhanced=enhanced[0, :, 0].cpu().numpy())
            count += 1
        print(f"{sensor}: enhanced {count} utterances -> {out_dir}", flush=True)


if __name__ == "__main__":
    main()
