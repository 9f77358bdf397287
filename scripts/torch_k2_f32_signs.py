"""Why K2's float32 bar needs the plain convolutions' rounding, on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 scripts/torch_k2_f32_signs.py

K2's float32 bar holds dx to 1e-4 and dW to 2e-4 of scale against autograd
of the plain stack.  The backward of a residual unit has the factor
leaky'(h2), which jumps from slope to 1 where h2 crosses zero, so where an
h2 lies within float32 rounding of zero, two float32 computations that sum
in different orders can take different sides and differ there by ~G.  At
each training shape (B 32, chip_smoke.py's inputs for K2) this prints, as
one JSON line, the relative errors (largest |difference| over the largest
|reference|) of dx and dW between: K2 and the plain float32 backward; the
plain float32 backward and the same in float64; and the plain float32
backward summed in another order (input channels reversed, with the
weights to match, which changes nothing but the rounding) and the plain
float32 backward.  Also the count of h2 values per unit within 1e-8, 1e-7
and 1e-6 of zero, and the card's name and power limit.  The float32
convolutions run in IEEE float32 (``strict_float32``).
"""

import json
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vibravox_tpu_torch.device import strict_float32  # noqa: E402
from vibravox_tpu_torch.ops.fused_residual import (  # noqa: E402
    plain_residual_stack_backward,
    residual_stack_backward,
)


def rel(a, b) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def errs(got, ref) -> dict:
    (dx, dws), (rdx, rdws) = got, ref
    return {"dx": rel(dx, rdx), "dw": max(rel(a, r) for a, r in zip([w for p in dws for w in p],
                                                                     [w for p in rdws for w in p]))}


def h2_per_unit(x, ks):
    out = []
    for (wd, wp), d in zip(ks, (1, 3, 9)):
        h2 = F.conv1d(F.conv1d(F.pad(x, (d, d), mode="reflect"), wd, dilation=d), wp)
        out.append(h2)
        x = x + F.leaky_relu(h2, 0.01)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_k2_f32_signs: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for i, (_, c, t) in enumerate(cs.TRAIN_SHAPES):
        # chip_smoke.py's phase_k2_parity inputs
        x, ks = cs.stack_inputs(cs.TRAIN_B, c, t, torch.float32, seed=100 + i)
        g = (torch.randn(x.shape, generator=torch.Generator().manual_seed(i)) * 0.1).to("cuda")
        flip = [0] + list(range(c - 1, 0, -1))  # input channels in another order
        with strict_float32():
            plain = plain_residual_stack_backward(x, ks, g)
            k2 = residual_stack_backward(x, ks, g)
            k64 = tuple((wd.double(), wp.double()) for wd, wp in ks)
            plain64 = plain_residual_stack_backward(x.double(), k64, g.double())
            # reversed input channels: only the stack's input is reordered
            # (the units' outputs keep their order), so run unit by unit
            dx_r, dws_r = reordered_backward(x, ks, g, flip)
            h2 = h2_per_unit(x.double(), k64)
        print(json.dumps({
            "card": smi, "B": cs.TRAIN_B, "C": c, "T": t,
            "k2_vs_plain": errs(k2, plain), "plain_vs_float64": errs(plain, plain64),
            "plain_reordered_vs_plain": errs((dx_r, dws_r), plain),
            "h2_within": {f"{th:g}": [int((v.abs() < th).sum()) for v in h2] for th in (1e-8, 1e-7, 1e-6)},
        }), flush=True)


def reordered_backward(x, ks, g, flip):
    """autograd of the plain stack with every convolution's input channels
    summed in the order ``flip`` (the same function, another rounding)."""
    flat = [w.detach().requires_grad_(True) for pair in ks for w in pair]
    xr = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = xr
        for u, d in enumerate((1, 3, 9)):
            wd, wp = flat[2 * u], flat[2 * u + 1]
            h = F.conv1d(F.pad(y[:, flip], (d, d), mode="reflect"), wd[:, flip], dilation=d)
            h2 = F.conv1d(h[:, flip], wp[:, flip])
            y = y + F.leaky_relu(h2, 0.01)
        dx, *dws = torch.autograd.grad(y, [xr, *flat], g)
    return dx, tuple((dws[2 * u], dws[2 * u + 1]) for u in range(3))


if __name__ == "__main__":
    main()
