"""PyTorch port: PQMF bank and conv helpers against the JAX package.

Inputs are made with numpy from a seed and fed to both sides; the port runs
NCW with torch-layout weights, the JAX package NWC with WIO weights.
Tolerances: bank 1e-7 (same float64 design), convolutions 1e-5 (float32
sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.ops import conv as jconv
from vibravox_tpu.ops.pqmf import PQMF as JaxPQMF
from vibravox_tpu.ops.pqmf import design_pqmf_bank as jax_design
from vibravox_tpu_torch.ops import conv as tconv
from vibravox_tpu_torch.ops.pqmf import PQMF, design_pqmf_bank
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


def _ncw(x_nwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nwc, (0, 2, 1))))


def _nwc(x_ncw: torch.Tensor) -> np.ndarray:
    return x_ncw.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("m,n", [(4, 32), (8, 64)])
def test_bank_matches_jax(m, n):
    a, s = design_pqmf_bank(m, n, 9.0)
    ja, js = jax_design(m, n, 9.0)
    np.testing.assert_allclose(a, ja, atol=1e-7, rtol=0)
    np.testing.assert_allclose(s, js, atol=1e-7, rtol=0)
    pq = PQMF(m, n)
    assert tuple(pq.analysis_weights.shape) == (m, 1, n)
    assert tuple(pq.synthesis_weights.shape) == (m, 1, n)


@pytest.mark.parametrize("bands", [-1, 2])
def test_analysis_matches_jax(bands):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1000, 1)).astype(np.float32)
    ref = np.asarray(JaxPQMF(4, 32).analysis(jnp.asarray(x), bands=bands))
    out = _nwc(PQMF(4, 32).analysis(_ncw(x), bands=bands))
    assert out.shape == ref.shape == (2, (1000 + 30) // 4 + 1, 4 if bands == -1 else bands)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("frames", [250, 33])
def test_synthesis_matches_jax(frames):
    rng = np.random.default_rng(2)
    bands = rng.standard_normal((2, frames, 4)).astype(np.float32)
    ref = np.asarray(JaxPQMF(4, 32).synthesis(jnp.asarray(bands)))
    out = _nwc(PQMF(4, 32).synthesis(_ncw(bands)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_conv1d_reflect_same_matches_jax(dilation):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 50, 8)).astype(np.float32)
    w_wio = rng.standard_normal((3, 8, 6)).astype(np.float32) * 0.3
    ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w_wio), padding="same",
                                  dilation=dilation, pad_mode="reflect"))
    w = torch.from_numpy(np.ascontiguousarray(w_wio.transpose(2, 1, 0)))
    out = _nwc(tconv.conv1d(_ncw(x), w, padding="same", dilation=dilation, pad_mode="reflect"))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert tconv.same_pad_amount(3, dilation) == jconv.same_pad_amount(3, dilation)


@pytest.mark.parametrize("stride,pad_mode", [(2, "reflect"), (4, "zeros")])
def test_strided_conv1d_matches_jax(stride, pad_mode):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 8)).astype(np.float32)
    k = 2 * stride
    w_wio = rng.standard_normal((k, 8, 16)).astype(np.float32) * 0.3
    ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w_wio), stride=stride,
                                  padding=stride - 1, pad_mode=pad_mode))
    w = torch.from_numpy(np.ascontiguousarray(w_wio.transpose(2, 1, 0)))
    out = _nwc(tconv.conv1d(_ncw(x), w, stride=stride, padding=stride - 1, pad_mode=pad_mode))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_conv_transpose1d_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8, 8)).astype(np.float32) * 0.3  # (in, out, k)
    ref = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), stride=4, padding=2))
    out = _nwc(tconv.conv_transpose1d(_ncw(x), torch.from_numpy(w), stride=4, padding=2))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
