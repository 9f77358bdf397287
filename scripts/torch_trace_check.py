"""Count the kernels that CUDA-only torch.profiler traces of K2 record.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 scripts/torch_trace_check.py            # Kineto's default
    TEARDOWN_CUPTI=0 python3 scripts/torch_trace_check.py

One serving-forward trace first (as ``chip_smoke.py``'s profile phase
takes), then four rounds of one trace per K2 call at the training shapes,
float32 and bfloat16, each after an untraced warm-up call.  Prints one JSON
line: the number of traces, how many recorded no CUDA kernel, how many did
not record all of K2's launches, and each trace's (CUDA kernels, K2
kernels).  A trace can miss the kernels launched at its start, more often
with CUPTI torn down between traces (Kineto's default) than with
``TEARDOWN_CUPTI=0``.
"""

import json
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_trace_check: no CUDA device is available")
    cs.phase_profile()
    counts, want = [], []
    for _ in range(4):
        for i, (_, c, t) in enumerate(cs.TRAIN_SHAPES):
            for dtype in (torch.float32, torch.bfloat16):
                x, ks = cs.stack_inputs(cs.TRAIN_B, c, t, dtype, seed=100 + i)
                g = (torch.randn(x.shape) * 0.1).to("cuda", dtype)
                cs.residual_stack_backward(x, ks, g)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    cs.residual_stack_backward(x, ks, g)
                    torch.cuda.synchronize()
                events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
                counts.append((len(events), sum(any(k in e.name for k in cs.K2_KERNELS) for e in events)))
                want.append(len(cs.k2_passes(dtype)))
    print(json.dumps({"traces": len(counts), "no_cuda_kernel": sum(n == 0 for n, _ in counts),
                      "k2_incomplete": sum(k != n for (_, k), n in zip(counts, want)),
                      "counts": counts}), flush=True)


if __name__ == "__main__":
    main()
