"""PyTorch port: WavLM's gated relative-position attention
(``ops/gated_attention.py``) on the CPU.

* P's 2T - 1 diagonals (``toeplitz_diagonals``) give P back, past the
  800-frame bucket clamp too;
* the plain twin ``plain_gated_attention`` and its autograd give SDPA's
  output and gradients on the materialised bias (dD as the sums of P's
  gradient along its diagonals), in float64 within 1e-10 of scale;
* ``takes`` refuses the CPU, bfloat16 and other head widths, which stay on
  SDPA, and the kernels' wrapper refuses CPU tensors; and WavLM's kernel
  route, run here with the twin in the kernel's place, gives the library
  route's logits and gradients, with the faults of
  ``portbench/wavlm_faults.py`` reaching it.

The kernel itself runs only on the card (``tests/test_torch_cuda_kernels.py``).
"""

import contextlib
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import wavlm_faults  # noqa: E402
from vibravox_tpu_torch.models import wavlm  # noqa: E402
from vibravox_tpu_torch.ops import gated_attention as ga  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401  (autouse: torch on one thread)

SHAPES = [(1, 1, 1), (2, 3, 17), (1, 2, 63), (2, 2, 64), (1, 3, 65), (2, 2, 130), (1, 2, 300)]


def _inputs(b, h, t, seed, dtype=torch.float64):
    """q, k, v, the gate and D at the cell's scale: unit-variance heads, a
    gate in (1, 3) as a(b c - 1) + 2 gives it, D drawn N(0, 1) as
    ``rel_attn_embed``."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, 64, generator=gen, dtype=dtype) for _ in range(3))
    gate = 1.0 + 2.0 * torch.rand(b, h, t, generator=gen, dtype=dtype)
    diag = torch.randn(h, 2 * t - 1, generator=gen, dtype=dtype)
    dout = torch.randn(b, h, t, 64, generator=gen, dtype=dtype)
    return q, k, v, gate, diag, dout


def _toeplitz(diag, t):
    pos = torch.arange(t)
    return diag[:, pos[None, :] - pos[:, None] + t - 1]


def _rel(got, want):
    """The largest gap over the largest magnitude, or over 1 where that is
    smaller (dk is 0 at T = 1: softmax over one key)."""
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("t", [1, 2, 49, 161, 999])
def test_diagonals_reproduce_the_position_table(t):
    """D[h, j - i + T - 1] == P[h, i, j] for WavLM-Large's table (320
    buckets reaching 800 frames); T = 999 is past the clamp."""
    embed = torch.nn.Embedding(320, 16)
    with torch.no_grad():
        table = wavlm.relative_position_table(embed, t, 320, 800)
        diag = ga.toeplitz_diagonals(table)
    assert diag.shape == (16, 2 * t - 1)
    assert torch.equal(_toeplitz(diag, t), table)


@pytest.mark.parametrize("b,h,t", SHAPES)
def test_plain_twin_matches_sdpa_on_the_materialised_bias(b, h, t):
    q, k, v, gate, diag, dout = _inputs(b, h, t, seed=t)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, gate, diag)]
    out = ga.plain_gated_attention(*leaves)
    got = [out] + list(torch.autograd.grad(out, leaves, dout))

    ref = [x.clone().requires_grad_(True) for x in (q, k, v, gate)]
    table = _toeplitz(diag, t).requires_grad_(True)
    want_out = F.scaled_dot_product_attention(*ref[:3], attn_mask=ref[3][..., None] * table)
    want = [want_out] + list(torch.autograd.grad(want_out, ref + [table], dout))
    # P's gradient summed along each diagonal r = j - i: the gradient of D[h, r + T - 1]
    dtable = want.pop()
    want.append(torch.stack([torch.diagonal(dtable, offset=r, dim1=-2, dim2=-1).sum(-1)
                             for r in range(1 - t, t)], dim=-1))
    for name, g, w in zip(("out", "dq", "dk", "dv", "dgate", "dD"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-10, name


@pytest.mark.parametrize("device,dtype,head_dim,want", [
    ("cuda", torch.float32, 64, True),
    ("cpu", torch.float32, 64, False),
    ("cuda", torch.bfloat16, 64, False),
    ("cuda", torch.float16, 64, False),
    ("cuda", torch.float32, 32, False),
    ("cuda", torch.float32, 128, False),
])
def test_takes_only_cuda_float32_heads_of_64(device, dtype, head_dim, want):
    assert ga.takes(device, dtype, head_dim) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_refuses_cpu_tensors(dtype):
    """The wrapper runs the kernels alone: a CPU call raises, and counts no
    launch."""
    q, k, v, gate, diag, _ = _inputs(1, 2, 20, seed=5, dtype=dtype)
    before = ga.gated_attention.launches
    with pytest.raises(TypeError, match="float32 CUDA input"):
        ga.gated_attention(q, k, v, gate, diag)
    assert ga.gated_attention.launches == before


def _wavlm(**kw):
    return wavlm.wavlm_for_ctc_from_config(preset="tiny", seed=3, device="cpu", hidden_dropout=0.0,
                                          activation_dropout=0.0, feat_proj_dropout=0.0, mask_time_prob=0.0,
                                          **kw)


@pytest.mark.parametrize("kw", [{}, {"compute_dtype": "bfloat16"},
                                {"hidden_size": 128, "num_attention_heads": 2}])
def test_wavlm_stays_on_sdpa_where_the_kernel_does_not_take(kw, monkeypatch):
    """The CPU (heads of 16, and of 64), bfloat16: SDPA with the bias, no
    kernel call."""
    calls = []
    sdpa = F.scaled_dot_product_attention
    monkeypatch.setattr(F, "scaled_dot_product_attention", lambda *a, **k: calls.append(k) or sdpa(*a, **k))
    model = _wavlm(**kw)
    counts = wavlm.wavlm_attention
    before = counts.calls, counts.fused_calls, counts.bias_elements
    with torch.no_grad():
        model(torch.randn(1, 4000, generator=torch.Generator().manual_seed(0)))
    layers, heads = model.config.num_hidden_layers, model.config.num_attention_heads
    assert counts.calls - before[0] == layers and counts.fused_calls == before[1]
    assert counts.bias_elements - before[2] == layers * heads * 12 * 12  # 4000 samples: 12 frames
    assert len(calls) == layers and all(set(k) == {"attn_mask"} for k in calls)


def _loss_and_grads(model, audio):
    logits = model(audio, train=True, generator=torch.Generator().manual_seed(1))
    loss = logits.square().mean()
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return logits.detach(), {n: g for n, g in zip(params, grads) if g is not None}


@pytest.mark.parametrize("fault", [None, "gate_off", "relpos_off"])
def test_wavlm_kernel_route_matches_the_library_route(fault, monkeypatch):
    """With ``takes`` answering yes and the twin in the kernel's place, the
    CPU runs the kernel's route: P's diagonals from layer 0, the gate and the diagonals'
    gradients back to ``gru_rel_pos_*`` and ``rel_attn_embed``; its logits
    and every gradient equal the library route's (float32 sums in other
    orders), the counters read one kernel call a layer and no bias, and a
    fault of ``portbench/wavlm_faults.py`` reaches both routes alike."""
    audio = torch.randn(2, 8000, generator=torch.Generator().manual_seed(2))
    model = _wavlm(layerdrop=0.0)
    with wavlm_faults.planted(fault) if fault else contextlib.nullcontext():
        want_logits, want = _loss_and_grads(model, audio)
        monkeypatch.setattr(ga, "takes", lambda *a: True)
        monkeypatch.setattr(ga, "gated_attention", ga.plain_gated_attention)
        counts = wavlm.wavlm_attention
        before = counts.calls, counts.fused_calls, counts.bias_elements
        got_logits, got = _loss_and_grads(model, audio)
    layers = model.config.num_hidden_layers
    assert (counts.calls - before[0], counts.fused_calls - before[1], counts.bias_elements - before[2]) == (
        layers, layers, 0)
    assert float((got_logits - want_logits).abs().max()) <= 1e-5 * float(want_logits.abs().max())
    assert set(got) == set(want)
    largest = max(float(g.norm()) for g in want.values())
    for n, g in want.items():
        if n.endswith("attention.k_proj.bias"):
            continue  # 0 but for float32 noise: softmax ignores a shift common to all keys
        assert float((got[n] - g).norm()) <= 1e-4 * float(g.norm()) + 1e-6 * largest, n
    embed = "wavlm.encoder.layers.0.attention.rel_attn_embed.weight"
    if fault == "relpos_off":
        assert embed not in want
    else:
        assert float(want[embed].norm()) > 0
