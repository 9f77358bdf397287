"""PyTorch port: the int8 discriminator convolutions against the JAX package.

``quantize_symmetric`` is held bit-equal to the JAX package's (the zero and
the empty tensor included), and ``conv1d_int8_ste`` too, over strides,
dilations, groups and paddings: both quantise with the same float32
arithmetic, the int8 products are exact integers, and the rescale is the
same float32 product.  The GEMM route of a CUDA tensor (``gemm_int8_conv1d``,
its zero padding for ``torch._int_mm``) runs here on the CPU, where
``torch._int_mm`` runs too, against the int32 twin.  The straight-through
gradient equals autograd of the float convolution bit for bit.  The EBEN
and MelGAN discriminators under ``VIBRAVOX_INT8_DISC=1`` are held to the
JAX package's on the same weights (its packed stem off, so that its
conv_1 and conv_2 are int8 as the port's are) within 2e-2 of each
activation's scale: a float conv that rounds a value across a
quantisation boundary on one side moves that activation by one step, and
the step spreads through the later layers; and each stays within
``tests/test_quant.py``'s 15% of scale of the float path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vibravox_tpu.models.eben_discriminator import (
    DiscriminatorEBENMultiScales as JaxDiscriminatorEBENMultiScales,
)
from vibravox_tpu.models.melgan_discriminator import DiscriminatorMelGAN as JaxDiscriminatorMelGAN
from vibravox_tpu.ops.quant import conv1d_int8_ste as jax_conv1d_int8_ste
from vibravox_tpu.ops.quant import quantize_symmetric as jax_quantize_symmetric
from vibravox_tpu_torch.models.convert import _put_melgan, eben_discriminator_params_from_jax
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.melgan_discriminator import DiscriminatorMelGAN
from vibravox_tpu_torch.ops import quant
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

DISC_TOL, FLOAT_PATH_TOL = 2e-2, 0.15


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("shape", [(2, 8, 100), (2, 8, 0), (3, 5, 7)])
@pytest.mark.parametrize("fill", ["normal", "zeros", "ties"])
def test_quantize_symmetric_is_bit_equal_to_jax(shape, fill):
    rng = np.random.default_rng(0)
    x = {"normal": rng.standard_normal(shape) * 3, "zeros": np.zeros(shape),
         # exact halves of the scale: round half to even on both sides
         "ties": (rng.integers(-254, 255, shape) / 2.0) * (127.0 / 127.5)}[fill].astype(np.float32)
    for dims in ((0, 1, 2), (1, 2)):
        q, s = quant.quantize_symmetric(torch.from_numpy(x), dims)
        # the JAX package quantises channels-last: NCW dims (0, 1, 2) / (1, 2)
        # are NWC (0, 1, 2) / per the first axis of an (out, in, k) weight
        jq, js = jax_quantize_symmetric(jnp.asarray(x), dims)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    if fill == "zeros":
        assert not q.any() and torch.isfinite(s).all()


CONV_CASES = [  # (C_in, C_out, k, stride, pad, dilation, groups, T)
    (8, 16, 5, 1, (2, 2), 1, 1, 128),
    (8, 16, 7, 2, (3, 3), 2, 4, 128),
    (8, 16, 41, 4, (20, 20), 1, 4, 300),
    (6, 12, 7, 2, (3, 3), 3, 3, 61),
    (4, 8, 3, 1, (0, 4), 2, 2, 33),
    (24, 48, 7, 2, (3, 3), 3, 4, 20),  # K = 42 and N = 12: padded to 48 and 16
    (8, 8, 5, 1, (2, 2), 1, 1, 3),  # M = 6: padded above 16
    (8, 8, 5, 1, (0, 0), 2, 1, 4),  # the dilated window outgrows T: an empty output, as in JAX
]


def _conv_inputs(case, seed, dtype=np.float32):
    cin, cout, k, _, _, _, g, t = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, cin, t)).astype(dtype)
    w = (rng.standard_normal((cout, cin // g, k)) * 0.1).astype(dtype)
    return x, w


@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_conv_is_bit_equal_to_jax(case):
    _, _, _, stride, pad, d, g, _ = case
    x, w = _conv_inputs(case, 1)
    got = quant.conv1d_int8_ste(torch.from_numpy(x), torch.from_numpy(w), stride, pad, d, g)
    want = jax_conv1d_int8_ste(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(w.transpose(2, 1, 0)),
                               stride, pad, d, g)
    want = np.asarray(want).transpose(0, 2, 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("case", CONV_CASES)
def test_gemm_route_equals_the_int32_twin(case):
    _, _, _, stride, pad, d, g, _ = case
    x, w = _conv_inputs(case, 2)
    qx, _ = quant.quantize_symmetric(torch.from_numpy(x), (0, 1, 2))
    qw, _ = quant.quantize_symmetric(torch.from_numpy(w), (1, 2))
    twin = quant.plain_int8_conv1d(qx, qw, stride, pad, d, g)
    assert twin.dtype == torch.int32
    assert torch.equal(quant.gemm_int8_conv1d(qx, qw, stride, pad, d, g), twin)
    if twin.shape[-1] == 0:  # F.conv1d refuses a window longer than the input
        assert twin.shape == (2, case[1], 0)
        return
    # the twin is the integer convolution itself
    ref = F.conv1d(F.pad(qx.double(), pad), qw.double(), None, stride, 0, d, g)
    assert torch.equal(twin.double(), ref)


def test_int8_mm_takes_the_shape_as_given():
    a = torch.ones(32, 12, dtype=torch.int8)
    w = torch.ones(8, 12, dtype=torch.int8)
    assert torch.equal(quant.int8_mm(a, w), torch.full((32, 8), 12, dtype=torch.int32))


def test_int8_conv_counts_no_launch_on_the_cpu():
    x, w = _conv_inputs(CONV_CASES[0], 3)
    before = quant.int8_conv1d.launches
    quant.conv1d_int8_ste(torch.from_numpy(x), torch.from_numpy(w), 1, (2, 2))
    assert quant.int8_conv1d.launches == before
    with pytest.raises(TypeError, match="int8 operands"):
        quant.int8_conv1d(torch.from_numpy(x), torch.from_numpy(w), 1, (2, 2))


@pytest.mark.parametrize("case", [CONV_CASES[1], CONV_CASES[3]])
def test_straight_through_gradient_is_the_float_convs(case):
    _, _, _, stride, pad, d, g, _ = case
    x, w = _conv_inputs(case, 4)
    head = torch.from_numpy(np.random.default_rng(5).standard_normal(
        quant.conv1d_int8_ste(torch.from_numpy(x), torch.from_numpy(w), stride, pad, d, g).shape
    ).astype(np.float32))
    grads = []
    for conv in (lambda a, b: quant.conv1d_int8_ste(a, b, stride, pad, d, g),
                 lambda a, b: F.conv1d(F.pad(a, pad), b, None, stride, 0, d, g)):
        xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
        (conv(xt, wt) * head).sum().backward()
        grads.append((xt.grad, wt.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_bf16_inputs_keep_their_dtype():
    x, w = _conv_inputs(CONV_CASES[1], 6)
    y = quant.conv1d_int8_ste(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 2, (3, 3), 2, 4)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# the discriminators under VIBRAVOX_INT8_DISC=1
# ---------------------------------------------------------------------------

def _close(got: torch.Tensor, want: np.ndarray, tol: float) -> None:
    got = got.detach().numpy()
    assert got.shape == want.shape
    if want.size == 0:  # a dilated stage collapses at a short T
        return
    scale = float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture()
def jax_plain_stem(monkeypatch):
    monkeypatch.setenv("VIBRAVOX_PACKED_DISC", "0")


def _eben_inputs(seed):
    rng = np.random.default_rng(seed)
    # 1024 frames: the dilation-3 band discriminator's last stage keeps 13
    # (the float path of the port refuses a stage that collapses)
    return (rng.standard_normal((2, 1024, 4)).astype(np.float32) * 0.3,
            rng.standard_normal((2, 4096, 1)).astype(np.float32) * 0.3)


def test_eben_discriminator_int8_matches_jax(monkeypatch, jax_plain_stem):
    bands, audio = _eben_inputs(4)
    monkeypatch.delenv("VIBRAVOX_INT8_DISC", raising=False)
    plain = DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu")
    monkeypatch.setenv("VIBRAVOX_INT8_DISC", "1")
    jdisc = JaxDiscriminatorEBENMultiScales(q=4, min_channels=8)
    params = jax.device_get(jax.jit(jdisc.init)(jax.random.key(0), jnp.asarray(bands), jnp.asarray(audio)))
    disc = DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu")
    assert list(disc.state_dict()) == list(plain.state_dict())
    sd = eben_discriminator_params_from_jax(params)
    disc.load_state_dict(sd, strict=True)
    plain.load_state_dict(sd, strict=True)
    flags = [m.int8 for m in disc.modules() if hasattr(m, "int8")]
    assert flags.count(True) == 3 * 6 + 5 and not any(m.int8 for m in plain.modules() if hasattr(m, "int8"))

    ref = jax.jit(jdisc.apply)(params, jnp.asarray(bands), jnp.asarray(audio))
    with torch.no_grad():
        out = disc(torch.from_numpy(bands), torch.from_numpy(audio))
        flt = plain(torch.from_numpy(bands), torch.from_numpy(audio))
    assert [len(s) for s in out] == [len(s) for s in ref] == [9, 9, 9, 8]
    for scale_ref, scale_out, scale_flt in zip(ref, out, flt):
        for r, o, f in zip(scale_ref, scale_out, scale_flt):
            _close(o, np.asarray(r), DISC_TOL)
            _close(o, f.numpy(), FLOAT_PATH_TOL)


def test_melgan_discriminator_int8_matches_jax(monkeypatch, jax_plain_stem):
    audio = np.random.default_rng(7).standard_normal((2, 4096, 1)).astype(np.float32) * 0.3
    monkeypatch.setenv("VIBRAVOX_INT8_DISC", "1")
    jdisc = JaxDiscriminatorMelGAN(0.2)
    params = jax.device_get(jax.jit(jdisc.init)(jax.random.key(1), jnp.asarray(audio)))
    ref = jax.jit(jdisc.apply)(params, jnp.asarray(audio))  # the flag is read when the module runs
    sd = {}
    _put_melgan(sd, "discriminator", params["params"])
    sd = {k: torch.tensor(v) for k, v in sd.items()}
    disc = DiscriminatorMelGAN(device="cpu")
    disc.load_state_dict(sd, strict=True)
    monkeypatch.delenv("VIBRAVOX_INT8_DISC")
    plain = DiscriminatorMelGAN(device="cpu")
    plain.load_state_dict(sd, strict=True)
    assert [m.int8 for m in disc.modules() if hasattr(m, "int8")] == [False] + [True] * 5 + [False]

    with torch.no_grad():
        out, flt = disc(torch.from_numpy(audio)), plain(torch.from_numpy(audio))
    assert len(out) == len(ref) == 8
    for r, o, f in zip(ref, out, flt):
        _close(o, np.asarray(r), DISC_TOL)
        _close(o, f.numpy(), FLOAT_PATH_TOL)


def test_int8_discriminator_gradients_are_finite(monkeypatch):
    monkeypatch.setenv("VIBRAVOX_INT8_DISC", "1")
    bands, audio = _eben_inputs(8)
    disc = DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu")
    b, a = torch.from_numpy(bands).requires_grad_(True), torch.from_numpy(audio).requires_grad_(True)
    sum(e[-1].sum() for e in disc(b, a)).backward()
    grads = [b.grad, a.grad] + [p.grad for p in disc.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
