"""Write the SPKV trial-pair pickles, as the reference's script builds them.

The port's counterpart of ``vibravox_tpu/scripts/gen_pairs_for_spkv.py``
(the reference's ``scripts/gen_pairs_for_spkv.py``): per speaker, all
same-speaker utterance pairs (ranges cut to the smallest speaker's count)
and as many random different-speaker pairs.  A mixed-gender and then a
same-gender list are drawn from one ``random.Random(seed)`` stream, so the
pickles equal the JAX script's for the same dataset.  The SPKV data module
reads one through ``pairs_file``.

Usage::

    python -m vibravox_tpu_torch.scripts.gen_pairs_for_spkv --dataset synthetic --output-dir pairs/

writes ``mixed_gender.pkl`` and ``same_gender.pkl`` under ``--output-dir``.
"""

from __future__ import annotations

import argparse
import pickle
import random
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="Cnam-LMSSC/vibravox_enhanced_by_EBEN")
    parser.add_argument("--subset", default="speech_clean")
    parser.add_argument("--sensor", default="headset_microphone")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output-dir", required=True)
    args = parser.parse_args(argv)

    from vibravox_tpu_torch.data.spkv import SPKVDataModule, generate_trial_pairs, speaker_sort_order

    dm = SPKVDataModule(dataset_name=args.dataset, subset=args.subset, sensor_a=args.sensor,
                        sensor_b=args.sensor, seed=args.seed, device="cpu")
    src = dm.load_split("test", args.sensor)
    rows = [src[i] for i in speaker_sort_order(src)]
    speakers = [str(r["speaker_id"]) for r in rows]
    genders = [str(r["gender"]) for r in rows]

    # one stream, mixed first, as the reference draws both lists
    rng = random.Random(args.seed)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for policy in ("mixed_gender", "same_gender"):
        pairs = generate_trial_pairs(speakers, genders, policy, rng=rng)
        path = out / f"{policy}.pkl"
        with open(path, "wb") as f:
            pickle.dump(pairs, f)
        print(f"wrote {len(pairs)} pairs to {path}")


if __name__ == "__main__":
    main()
