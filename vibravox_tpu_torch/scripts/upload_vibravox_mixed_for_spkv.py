"""Build the noise-mixed SPKV test set: all sensors share one noise slice.

The port's counterpart of ``vibravox_tpu/scripts/upload_vibravox_mixed_for_spkv.py``
(the reference's ``scripts/upload_vibravox_mixed_for_spkv.py``): for each
test utterance, one noise item and one slice of it are drawn from
``np.random.default_rng(seed)`` and added to every sensor's channel; each
utterance is written as ``<out>/{i:06d}.npz`` with ``audio_mixed.<sensor>``
keys.  The speech and noise come from the noisy BWE data module's sources
(``synthetic`` or a local hub dataset).  Host work only (numpy).

Usage::

    python -m vibravox_tpu_torch.scripts.upload_vibravox_mixed_for_spkv \\
        --dataset synthetic --out mixed_spkv/
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="Cnam-LMSSC/vibravox")
    parser.add_argument("--sensors", nargs="+", default=["headset_microphone"])
    parser.add_argument("--out", required=True)
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    from vibravox_tpu_torch.data.noisybwe import NOISE_KEY, NoisyBWEDataModule

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    def module(**kwargs):
        # the sources are read on the host; the module's device only pins batches
        return NoisyBWEDataModule(dataset_name=args.dataset, sample_rate=args.sample_rate, device="cpu", **kwargs)

    noise_src = module()._noise_source("test")
    speech_srcs = {s: module(sensor=s)._speech_source("test") for s in args.sensors}
    n = len(next(iter(speech_srcs.values())))
    for i in range(n):
        noise = np.asarray(noise_src[int(rng.integers(len(noise_src)))][NOISE_KEY], np.float32)
        item = {}
        for sensor, src in speech_srcs.items():
            speech = np.asarray(src[i]["audio_body_conducted"], np.float32)
            nz = noise
            if len(nz) < len(speech):
                nz = np.tile(nz, int(np.ceil(len(speech) / len(nz))))
            start = int(rng.integers(0, len(nz) - len(speech) + 1))
            item[f"audio_mixed.{sensor}"] = speech + nz[start:start + len(speech)]
        np.savez(out / f"{i:06d}.npz", **item)
    print(f"wrote {n} mixed utterances to {out}", flush=True)


if __name__ == "__main__":
    main()
