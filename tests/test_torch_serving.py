"""PyTorch port: EnhanceServer and StreamingEnhancer on the CPU.

The server's outputs are held to a direct forward of the same model at
1e-5 (the same float32 ops on a zero-padded batch); the port's resampler
(the native library's, with its numpy twin) is held to the JAX package's
numpy resampler at 1e-6."""

from concurrent.futures import Future

import numpy as np
import pytest
import torch

from vibravox_tpu.native.pipeline import _resample_poly_numpy
from vibravox_tpu_torch.native.pipeline import resample_poly, resample_poly_numpy
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.serving import EnhanceServer, StreamingEnhancer, _Request
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return EBENGenerator(m=4, n=32, p=2, device="cpu")


@pytest.fixture()
def server(model):
    srv = EnhanceServer(model, max_batch=4, max_delay_ms=10.0, bucket_seconds=(0.5, 1.0),
                        device="cpu")
    yield srv
    srv.close()


def _direct(model, audio):
    with torch.inference_mode():
        return model(torch.from_numpy(audio)[None, :, None])[0][0, :, 0].numpy()


def test_single_request_matches_direct_forward(server, model):
    audio = np.random.default_rng(0).standard_normal(server.buckets[0]).astype(np.float32) * 0.1
    out = server.enhance(audio)
    assert out.shape == audio.shape
    np.testing.assert_allclose(out, _direct(model, audio), atol=1e-5, rtol=0)


def test_short_request_padded_and_trimmed(server):
    n = server.buckets[0] // 2 + 3
    out = server.enhance(np.random.default_rng(1).standard_normal(n).astype(np.float32) * 0.1)
    assert out.shape == (n,)
    assert np.isfinite(out).all()


def test_concurrent_requests_batched(server, model):
    rng = np.random.default_rng(2)
    audios = [rng.standard_normal(server.buckets[0]).astype(np.float32) * 0.1 for _ in range(8)]
    futs = [server.submit(a) for a in audios]
    outs = [f.result(timeout=120) for f in futs]
    stats = server.stats()
    assert stats["served"] == 8
    assert 2 <= stats["dispatches"] < 8  # max_batch 4: grouped, never one by one
    assert stats["latency_p95_ms"] > 0
    assert stats["audio_seconds"] == pytest.approx(8 * server.buckets[0] / 16000)
    # each co-batched request gets its own row back
    np.testing.assert_allclose(outs[5], _direct(model, audios[5]), atol=1e-5, rtol=0)


def test_params_are_loaded_strictly(model):
    torch.manual_seed(1)
    other = EBENGenerator(device="cpu")  # other weights, replaced by params
    srv = EnhanceServer(other, params=model.state_dict(), bucket_seconds=(0.5,), device="cpu")
    try:
        audio = np.random.default_rng(6).standard_normal(srv.buckets[0]).astype(np.float32) * 0.1
        np.testing.assert_allclose(srv.enhance(audio), _direct(model, audio), atol=1e-5, rtol=0)
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="Missing key"):
        EnhanceServer(EBENGenerator(device="cpu"), params={}, device="cpu")


def test_warmup_resets_stats(server):
    server.warmup()
    assert server.stats()["served"] == 0
    assert server.stats()["dispatches"] == 0


def test_submit_after_close_raises(model):
    srv = EnhanceServer(model, bucket_seconds=(0.5,), device="cpu")
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.zeros(100, np.float32))


def test_close_fails_raced_requests_instead_of_hanging(model):
    srv = EnhanceServer(model, bucket_seconds=(0.5,), device="cpu")
    srv._queue.put(None)  # the worker stops; a straggler lands behind it
    srv._worker.join(timeout=10)
    assert not srv._worker.is_alive()
    fut: Future = Future()
    srv._queue.put(_Request(fut, np.zeros(100, np.float32), srv.buckets[0], 0.0))
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=10)


def test_oversize_request_rejected(server):
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        server.submit(np.zeros(10 * 16000, np.float32))


def test_arbitrary_input_rate_round_trip(server):
    n48 = (server.buckets[0] // 2) * 3
    audio = np.random.default_rng(3).standard_normal(n48).astype(np.float32) * 0.1
    out = server.enhance(audio, input_sample_rate=48000)
    assert out.shape == audio.shape
    assert np.isfinite(out).all()


@pytest.mark.parametrize("orig,new", [(48000, 16000), (16000, 48000), (44100, 16000)])
def test_resampler_matches_jax_numpy_twin(orig, new):
    x = np.random.default_rng(4).standard_normal(4000).astype(np.float32)
    ref = _resample_poly_numpy(x, orig, new)
    out = resample_poly(x, orig, new)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert resample_poly_numpy(x, orig, new).tobytes() == ref.tobytes()


def test_streaming_matches_offline_interior(model):
    chunk, context = 2048, 8192
    stream = StreamingEnhancer(model, chunk=chunk, context=context, device="cpu")
    n = model.valid_length(12 * chunk)
    audio = np.random.default_rng(5).standard_normal(n).astype(np.float32) * 0.1
    outs, pos, sizes, i = [], 0, [333, 4096, 1, 2047, 8192], 0
    while pos < n:  # irregular blocks: output must not depend on arrival shape
        outs.append(stream.push(audio[pos : pos + sizes[i % len(sizes)]]))
        pos += sizes[i % len(sizes)]
        i += 1
    outs.append(stream.flush())
    streamed = np.concatenate(outs)
    assert streamed.shape == (n,)
    interior = slice(0, n - (context + model.n))  # the flushed tail saw zeros
    np.testing.assert_allclose(streamed[interior], _direct(model, audio)[interior], atol=2e-5)
    assert stream.flush().size == 0
    with pytest.raises(RuntimeError):
        stream.push(np.zeros(1, np.float32))


def test_streaming_grid_validation(model):
    with pytest.raises(ValueError, match="stride grid"):
        StreamingEnhancer(model, chunk=1000, context=2048, device="cpu")
