"""Time the PyTorch port's EBEN train step and ECAPA2 embedding on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 /path/to/scripts/torch_step_times.py LABEL

It imports the port and ``chip_smoke`` from the working directory, so the
same script times another checkout too: unpack a parent commit
(``git archive``) into a git-ignored directory and run parent, change,
change, parent on one card.  Prints one JSON line: LABEL, the card's name
and power limit, and for each regime the median, p10 and p90 ms of
``STEPS`` synchronised calls after ``WARMUP``: the full eben.yaml task's
train step at batch 32 x 2.5 s (``EBENTask.train_step`` alone, no
trainer) in bfloat16 (eben.yaml's ``compute_dtype``) and in float32 (the
reference's own precision, which runs K1 and K2 in float32), and the
full-width ECAPA2's bf16 forward at 32 x 3 s (bench.py's spkv regime).
"""

import json
import subprocess
import sys

sys.path.insert(0, ".")
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WARMUP, STEPS = 3, 20


def summary(ms: list) -> dict:
    later = ms[WARMUP:]
    return {"ms_median": float(np.median(later)), "ms_p10": float(np.percentile(later, 10)),
            "ms_p90": float(np.percentile(later, 90)), "ms": later}


def main(label: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_step_times: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"label": label, "card": smi}
    rng = np.random.default_rng(8)
    ref = torch.from_numpy(rng.standard_normal((cs.TRAIN_B, cs.TRAIN_T, 1)).astype(np.float32) * 0.1).cuda()
    batch = {"audio_body_conducted": ref * 0.5, "audio_airborne": ref}
    for dtype, key in (("bfloat16", "eben_train_step_bf16_b32"), ("float32", "eben_train_step_f32_b32")):
        torch.manual_seed(0)
        task = cs.make_task("cuda", small=False, optimizer=cs.adam(3e-4, betas=(0.5, 0.9)), compute_dtype=dtype)
        state = task.init_state(0)
        out[key] = summary(cs.timed_calls(lambda: task.train_step(state, batch), WARMUP + STEPS))
        del task, state
        torch.cuda.empty_cache()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((cs.SPKV_B, cs.SPKV_T)).astype(np.float32)).cuda()
    torch.manual_seed(0)
    model = cs.ecapa2_from_config(compute_dtype="bfloat16", device="cuda").eval()
    with torch.no_grad():
        out["ecapa2_embed_bf16_b32"] = summary(cs.timed_calls(lambda: model(x), WARMUP + STEPS))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
