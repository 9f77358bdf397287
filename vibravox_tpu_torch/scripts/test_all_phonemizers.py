"""Cross-sensor phonemizer PER matrix.

The port's counterpart of ``vibravox_tpu/scripts/test_all_phonemizers.py``
(the reference's ``scripts/test_all_phonemizers.py``): every phonemizer
(one per training sensor) decodes every test sensor's split, giving the
phoneme error rate of each pair and the Levenshtein edit operations inside
words, counted by kind and phonemes (``metrics/text.py``, the native
Levenshtein).  A phonemizer is a local directory in HF's ``Wav2Vec2ForCTC``
layout (``upload_phonemizer_to_hub`` writes one) or ``tiny``, a random tiny
model.  The models run on the GPU unless ``--device cpu`` is given.
Writes ``per_matrix.json`` and ``confusions.json`` (the 200 most frequent).

Usage::

    python -m vibravox_tpu_torch.scripts.test_all_phonemizers \\
        --dataset synthetic --phonemizers tiny --sensors headset_microphone \\
        --out outputs/phonemizer_matrix [--limit N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

from vibravox_tpu_torch.data.sources import SENSORS


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="Cnam-LMSSC/vibravox")
    parser.add_argument("--subset", default="speech_clean")
    parser.add_argument("--sensors", nargs="+", default=list(SENSORS))
    parser.add_argument("--phonemizers", nargs="+", required=True,
                        help="local directories of Wav2Vec2-CTC phonemizers, or 'tiny' for a random model")
    parser.add_argument("--out", required=True)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from vibravox_tpu_torch.data.phonemes import load_phoneme_tokenizer
    from vibravox_tpu_torch.data.stp import STPDataModule
    from vibravox_tpu_torch.device import resolve_device
    from vibravox_tpu_torch.metrics.text import (
        char_error_rate,
        decode_operations,
        levenshtein_editops,
        split_editops,
    )
    from vibravox_tpu_torch.models.wav2vec2 import (
        wav2vec2_for_ctc_from_config,
        wav2vec2_for_ctc_from_pretrained,
    )

    device = resolve_device(args.device)
    tokenizer = load_phoneme_tokenizer()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    per_matrix = {}
    confusions: Counter = Counter()

    for phonemizer_name in args.phonemizers:
        model = (wav2vec2_for_ctc_from_config(preset="tiny", device=device) if phonemizer_name == "tiny"
                 else wav2vec2_for_ctc_from_pretrained(phonemizer_name, device=device))
        model.eval()
        for sensor in args.sensors:
            # batch 1 a test utterance, read in this process
            dm = STPDataModule(dataset_name_principal=args.dataset, subset=args.subset, sensor=sensor,
                               batch_size=1, num_workers=0, tokenizer=tokenizer, device=device)
            dm.setup("test")
            preds, targets = [], []
            for i, batch in enumerate(dm.test_dataloader()):
                if args.limit is not None and i >= args.limit:
                    break
                with torch.inference_mode():
                    ids = model(batch["audio"].to(device)).argmax(-1)
                preds.extend(tokenizer.batch_decode(ids.cpu().numpy()))
                targets.extend(batch["phonemes_str"])
            per = char_error_rate(preds, targets)
            per_matrix[f"{phonemizer_name}::{sensor}"] = per
            for pred, tgt in zip(preds, targets):
                ops = levenshtein_editops(pred, tgt)
                _, in_word, _ = split_editops(pred, tgt, ops)
                for op, a, b in decode_operations(pred, tgt, in_word):
                    confusions[(op, a, b)] += 1
            print(f"{phonemizer_name} on {sensor}: PER={per:.4f}", flush=True)

    (out_dir / "per_matrix.json").write_text(json.dumps(per_matrix, indent=1))
    (out_dir / "confusions.json").write_text(
        json.dumps({f"{op}:{a}->{b}": c for (op, a, b), c in confusions.most_common(200)},
                   ensure_ascii=False, indent=1))
    print(f"wrote {out_dir}/per_matrix.json", flush=True)
    return per_matrix


if __name__ == "__main__":
    main()
