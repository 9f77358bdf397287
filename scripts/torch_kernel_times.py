"""Time the PyTorch port's CUDA kernels K1-K4 at the main path's shapes.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 /path/to/scripts/torch_kernel_times.py LABEL

It imports the port from the working directory, so the same script times
another checkout too: unpack a parent commit (``git archive``) into a
git-ignored directory and run parent, change, change, parent on one card.
Prints one JSON line: LABEL, the card's name and power limit, and the ms
per whole wrapper call, by CUDA events, of K1 (float32 and bfloat16 at the
serving shapes, batch 8, and the training shapes, batch 32; float32 at the
batch-1 eval shapes, and there and at the serving shapes also its device
time alone, from a trace), K2 (bfloat16 and float32, training shapes; float32
also its plain version, autograd of the plain stack, with float32
convolutions in IEEE float32; and per train step, each training shape
twice as in the EBEN generator) and K3 and K4 (float32, batch 32, 2.5 s,
the three loss resolutions).
"""

import json
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vibravox_tpu_torch.device import strict_float32  # noqa: E402
from vibravox_tpu_torch.ops.fused_residual import (  # noqa: E402
    plain_residual_stack_backward,
    residual_stack,
    residual_stack_backward,
)
from vibravox_tpu_torch.ops.pallas_stft import framed_dft_backward, framed_dft_magnitude  # noqa: E402


def k1_device_us(x, ks, calls: int = 20) -> float:
    """K1's device µs a call: its kernels' durations over ``calls`` calls in
    a CUDA-only trace, summed and divided by ``calls``."""
    residual_stack(x, ks)
    torch.cuda.synchronize()

    def k1(events):
        return [e for e in events if "residual_stack" in e.name or "relayout_weights" in e.name]

    _, events = cs.cuda_trace(lambda: [residual_stack(x, ks) for _ in range(calls)],
                              lambda ev: len(k1(ev)) > 0 and len(k1(ev)) % calls == 0, "K1 calls")
    return sum(e.time_range.elapsed_us() for e in k1(events)) / calls


def main(label: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_times: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"label": label, "card": smi}
    shapes = [(cs.BATCH, c, t) for _, c, t in cs.SERVING_SHAPES] + [(cs.TRAIN_B, c, t) for _, c, t in cs.TRAIN_SHAPES]
    with torch.inference_mode():
        for b, c, t in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x, ks = cs.stack_inputs(b, c, t, dtype, seed=c)
                out[f"K1 {str(dtype)[6:]} B{b} C{c} T{t}"] = cs.cuda_ms(lambda: residual_stack(x, ks), iters=30)
        for _, c, t in cs.TRAIN_SHAPES:  # the CLI's eval batch
            x, ks = cs.stack_inputs(1, c, t, torch.float32, seed=c)
            out[f"K1 float32 B1 C{c} T{t}"] = cs.cuda_ms(lambda: residual_stack(x, ks), iters=30)
        # device time alone (µs a call, K1's kernels summed, from a trace),
        # where a whole wrapper call may wait on the host
        for b, c, t in shapes[:3] + [(1, c, t) for _, c, t in cs.TRAIN_SHAPES]:
            x, ks = cs.stack_inputs(b, c, t, torch.float32, seed=c)
            out[f"K1 float32 B{b} C{c} T{t} device_us"] = k1_device_us(x, ks)
    for _, c, t in cs.TRAIN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, ks = cs.stack_inputs(cs.TRAIN_B, c, t, dtype, seed=c)
            g = torch.randn(x.shape, device="cuda", dtype=dtype) * 0.1
            out[f"K2 {str(dtype)[6:]} B{cs.TRAIN_B} C{c} T{t}"] = cs.cuda_ms(
                lambda: residual_stack_backward(x, ks, g), iters=10)
        with strict_float32():
            out[f"K2 plain float32 B{cs.TRAIN_B} C{c} T{t}"] = cs.cuda_ms(
                lambda: plain_residual_stack_backward(x, ks, g), iters=10)
    # per train step: the generator runs each stack shape twice
    for what in ("bfloat16", "float32", "plain float32"):
        out[f"K2 {what} per step"] = 2 * sum(out[f"K2 {what} B{cs.TRAIN_B} C{c} T{t}"]
                                            for _, c, t in cs.TRAIN_SHAPES)
    x = torch.randn(cs.TRAIN_B, cs.TRAIN_T, device="cuda") * 0.1
    for fft, hop, win in cs.RESOLUTIONS:
        mag = framed_dft_magnitude(x, fft, hop, win)
        g = torch.randn_like(mag) * 1e-3
        out[f"K3 fft{fft}"] = cs.cuda_ms(lambda: framed_dft_magnitude(x, fft, hop, win), iters=20)
        out[f"K4 fft{fft}"] = cs.cuda_ms(lambda: framed_dft_backward(x, mag, g, fft, hop, win), iters=20)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
