"""PyTorch port: the CTC loss against ``vibravox_tpu/ops/ctc.py``.

Same logits (B = 4, T = 30, 38 classes, a numpy seed), labels and paddings
on both sides; the blank is the STP pad token (35) or 0.  Cases: repeated
labels (a blank must separate them), right-padded labels, padded frames.

Tolerances: the per-sequence losses 1e-5 relative; the gradient of their
sum with respect to the logits within 1e-5 + 4e-7 x the sequence's loss
(absolute).  The gradient is softmax minus the CTC posteriors, and each
posterior is exp(alpha + beta - loss) from float32 sums whose rounding
grows with the loss: on these inputs both float32 implementations differ
from a float64 evaluation by up to 2e-5 at a loss of 117 (about 1.7 float32
epsilons times the loss), so 1e-5 alone would test rounding, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from vibravox_tpu_torch.ops.ctc import ctc_loss
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

B, T, K, N = 4, 30, 38, 12


def _case(seed, blank, repeats, label_pad, frame_pad, scale=1.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, K)).astype(np.float32) * scale
    labels = rng.integers(0, 35, (B, N)).astype(np.int32)
    labels[labels == blank] = 36  # a label is never the blank
    if repeats:
        labels[0, 3] = labels[0, 2]
        labels[2, 1] = labels[2, 0] = labels[2, 2]
    lab_pad = np.zeros((B, N), np.float32)
    if label_pad:
        lab_pad[1, 8:] = 1
        lab_pad[2, 5:] = 1
        lab_pad[3, 1:] = 1
    fr_pad = np.zeros((B, T), np.float32)
    if frame_pad:
        fr_pad[3, 20:] = 1
        fr_pad[0, 27:] = 1
    labels = np.where(lab_pad > 0, 0, labels).astype(np.int32)
    return logits, fr_pad, labels, lab_pad


CASES = {
    "blank35_plain": (0, 35, False, False, False),
    "blank35_repeats": (1, 35, True, False, False),
    "blank35_label_padding": (2, 35, False, True, False),
    "blank35_logit_padding": (3, 35, False, False, True),
    "blank35_everything": (4, 35, True, True, True),
    "blank0_everything": (5, 0, True, True, True),
    "blank0_repeats_wide_logits": (6, 0, True, False, False, 2.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_value_and_gradient_match_jax(name):
    seed, blank, *flags = CASES[name]
    logits, fr_pad, labels, lab_pad = _case(seed, blank, *flags)
    args = (jnp.asarray(fr_pad), jnp.asarray(labels), jnp.asarray(lab_pad))

    def total(x):
        losses = jax_ctc_loss(x, *args, blank_id=blank, unroll=1)  # unroll: scheduling only
        return losses.sum(), losses

    (_, want), want_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(logits))
    want, want_grad = np.asarray(want), np.asarray(want_grad)

    x = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(x, torch.from_numpy(fr_pad), torch.from_numpy(labels), torch.from_numpy(lab_pad), blank)
    got.sum().backward()
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    err = np.abs(x.grad.numpy() - want_grad).max(axis=(1, 2))
    assert (err <= 1e-5 + 4e-7 * want).all(), (err, want)
    # padded frames get no gradient on either side
    assert np.array_equal(x.grad.numpy()[fr_pad > 0], np.zeros_like(x.grad.numpy()[fr_pad > 0]))


def test_bfloat16_logits_are_lifted_to_float32():
    logits, fr_pad, labels, lab_pad = _case(0, 35, True, True, False)
    args = (torch.from_numpy(fr_pad), torch.from_numpy(labels), torch.from_numpy(lab_pad), 35)
    half = torch.from_numpy(logits).bfloat16()
    got = ctc_loss(half, *args)
    assert got.dtype == torch.float32
    assert torch.equal(got, ctc_loss(half.float(), *args))


def test_infeasible_target_is_inf_where_jax_is_large_and_finite():
    """Five repeats of one label need 9 frames (a blank between each pair);
    with 6 there is no path.  JAX's log-zero of -1e5 gives a large finite
    loss, torch's -inf gives inf (``zero_infinity`` is off: 0 would hide
    the target).  ROADMAP Queue 3 lists the difference."""
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 6, K)).astype(np.float32)
    labels = np.array([[1, 1, 1, 1, 1], [1, 2, 3, 0, 0]], np.int32)
    lab_pad = np.array([[0, 0, 0, 0, 0], [0, 0, 0, 1, 1]], np.float32)
    fr_pad = np.zeros((2, 6), np.float32)
    want = np.asarray(jax.jit(jax_ctc_loss, static_argnames="blank_id")(
        jnp.asarray(logits), jnp.asarray(fr_pad), jnp.asarray(labels), jnp.asarray(lab_pad), blank_id=35))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(fr_pad), torch.from_numpy(labels),
                   torch.from_numpy(lab_pad), 35).numpy()
    assert np.isinf(got[0]) and got[0] > 0
    assert np.isfinite(want[0]) and want[0] > 1e4
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)  # the feasible row agrees
