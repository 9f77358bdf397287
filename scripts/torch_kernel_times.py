"""Time the PyTorch port's CUDA kernels K1-K4 at the main path's shapes.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 /path/to/scripts/torch_kernel_times.py LABEL

It imports the port from the working directory, so the same script times
another checkout too: unpack a parent commit (``git archive``) into a
git-ignored directory and run parent, change, change, parent on one card.
Prints one JSON line: LABEL and the ms per whole wrapper call, by CUDA
events, of K1 (float32 and bfloat16 at the serving shapes, batch 8, and the
training shapes, batch 32), K2 (bfloat16, training shapes) and K3 and K4
(float32, batch 32, 2.5 s, the three loss resolutions).
"""

import json
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vibravox_tpu_torch.ops.fused_residual import residual_stack, residual_stack_backward  # noqa: E402
from vibravox_tpu_torch.ops.pallas_stft import framed_dft_backward, framed_dft_magnitude  # noqa: E402


def main(label: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_times: no CUDA device is available")
    out = {"label": label, "card": torch.cuda.get_device_name(0)}
    shapes = [(cs.BATCH, c, t) for _, c, t in cs.SERVING_SHAPES] + [(cs.TRAIN_B, c, t) for _, c, t in cs.TRAIN_SHAPES]
    with torch.inference_mode():
        for b, c, t in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x, ks = cs.stack_inputs(b, c, t, dtype, seed=c)
                out[f"K1 {str(dtype)[6:]} B{b} C{c} T{t}"] = cs.cuda_ms(lambda: residual_stack(x, ks), iters=30)
    for _, c, t in cs.TRAIN_SHAPES:
        x, ks = cs.stack_inputs(cs.TRAIN_B, c, t, torch.bfloat16, seed=c)
        g = torch.randn(x.shape, device="cuda", dtype=torch.bfloat16) * 0.1
        out[f"K2 bfloat16 B{cs.TRAIN_B} C{c} T{t}"] = cs.cuda_ms(lambda: residual_stack_backward(x, ks, g), iters=10)
    x = torch.randn(cs.TRAIN_B, cs.TRAIN_T, device="cuda") * 0.1
    for fft, hop, win in cs.RESOLUTIONS:
        mag = framed_dft_magnitude(x, fft, hop, win)
        g = torch.randn_like(mag) * 1e-3
        out[f"K3 fft{fft}"] = cs.cuda_ms(lambda: framed_dft_magnitude(x, fft, hop, win), iters=20)
        out[f"K4 fft{fft}"] = cs.cuda_ms(lambda: framed_dft_backward(x, mag, g, fft, hop, win), iters=20)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
