"""Batched low-latency serving for the EBEN generator (PyTorch).

Counterpart of ``vibravox_tpu/serving.py`` with the same API and semantics:

* **Length buckets.**  Every request is zero-padded up to the smallest
  configured bucket (valid lengths of the model), so the device sees a few
  fixed shapes.
* **Micro-batching.**  A background worker drains the request queue, groups
  same-bucket requests up to ``max_batch`` and runs one forward per group;
  a request waits at most ``max_delay_ms`` for co-riders.
* **Static batch shapes.**  Partial groups are padded with zero rows to
  ``max_batch``.

The worker runs the model under ``torch.inference_mode()``.  With
``compute_dtype="bfloat16"`` the input is cast to bf16 and every layer casts
its effective f32 weights to bf16 at use; the output is returned as f32.
``server.stats()`` reports latency percentiles, served requests, audio
seconds and the number of batched forwards (``dispatches``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device
from vibravox_tpu_torch.host_resample import host_resample

__all__ = ["EnhanceServer", "StreamingEnhancer"]


@dataclasses.dataclass
class _Request:
    future: Future
    audio: np.ndarray
    bucket: int
    t_submit: float


class _Enhancer:
    """``(B, T) float32 numpy -> (B, T) float32 numpy`` through the model on
    ``device`` in ``compute_dtype``; the caller holds inference mode."""

    def __init__(self, model: nn.Module, params: Optional[Mapping[str, torch.Tensor]],
                 compute_dtype: Optional[str], device: DeviceLike):
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.dtype = getattr(torch, compute_dtype) if compute_dtype is not None else None

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch).to(self.device)[:, :, None]
        if self.dtype is not None:
            x = x.to(self.dtype)
        enhanced, _ = self.model(x)
        return enhanced[:, :, 0].float().cpu().numpy()


class EnhanceServer:
    """Micro-batching server around an enhancement model taking ``(B, T, 1)``
    audio and returning ``(enhanced (B, T, 1), ...)`` (the EBEN generator).

    ``params``, when given, is a state dict loaded into ``model`` with
    ``strict=True``.  ``device=None`` serves on the GPU (raises without
    one); ``"cpu"`` serves on the CPU.  The model is moved to the device."""

    def __init__(
        self,
        model: nn.Module,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        sample_rate: int = 16_000,
        max_batch: int = 8,
        max_delay_ms: float = 5.0,
        bucket_seconds: Sequence[float] = (1.0, 2.0, 4.0, 8.0),
        compute_dtype: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self._enhance = _Enhancer(model, params, compute_dtype, device)
        self.model = self._enhance.model
        self.device = self._enhance.device
        self.sample_rate = sample_rate
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.compute_dtype = compute_dtype
        self.buckets = sorted(model.valid_length(int(s * sample_rate)) for s in bucket_seconds)

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._latencies_ms: list = []
        self._audio_seconds = 0.0
        self._served = 0
        self._dispatches = 0
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ #

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request of {n} samples exceeds the largest bucket "
            f"({self.buckets[-1]}); configure a larger bucket_seconds"
        )

    def warmup(self) -> None:
        """Run one request per bucket through the worker (each bucket's
        shapes pick their kernels and allocations before real traffic), then
        reset the stats so warmup never shows in the percentiles."""
        for b in self.buckets:
            self.submit(np.zeros(b, np.float32)).result(timeout=300.0)
        with self._lock:
            self._latencies_ms = []
            self._audio_seconds = 0.0
            self._served = 0
            self._dispatches = 0

    def submit(self, audio: np.ndarray, input_sample_rate: Optional[int] = None) -> Future:
        """Enqueue a 1-D waveform; resolves to the enhanced waveform of the
        same length.

        ``input_sample_rate`` accepts requests at other rates: the audio is
        resampled to the model rate on the host and the result is resampled
        back, so callers get their own rate and length back."""
        if self._closed:
            raise RuntimeError("server is closed")
        audio = np.asarray(audio, np.float32).reshape(-1)
        in_rate = int(input_sample_rate or self.sample_rate)
        in_len = len(audio)
        if in_rate != self.sample_rate:
            audio = host_resample(audio, in_rate, self.sample_rate)
        fut: Future = Future()
        if in_rate != self.sample_rate:
            inner: Future = Future()

            def _back(f: Future):
                if f.exception() is not None:
                    fut.set_exception(f.exception())
                    return
                out = host_resample(f.result(), self.sample_rate, in_rate)
                if len(out) < in_len:  # ceil-length mismatch at the edge
                    out = np.pad(out, (0, in_len - len(out)))
                fut.set_result(out[:in_len])

            inner.add_done_callback(_back)
            target = inner
        else:
            target = fut
        # the closed-check + enqueue must be atomic with close()'s
        # closed-transition: otherwise a request enqueued between close()'s
        # sentinel and its drain would hang its caller on .result() forever
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(
                _Request(target, audio, self._bucket_for(len(audio)), time.perf_counter())
            )
        return fut

    def enhance(self, audio: np.ndarray, input_sample_rate: Optional[int] = None) -> np.ndarray:
        return self.submit(audio, input_sample_rate=input_sample_rate).result()

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies_ms) if self._latencies_ms else np.zeros(1)
            return {
                "served": self._served,
                "dispatches": self._dispatches,
                "latency_p50_ms": float(np.percentile(lat, 50)),
                "latency_p95_ms": float(np.percentile(lat, 95)),
                "audio_seconds": self._audio_seconds,
            }

    def close(self) -> None:
        # the closed-transition + sentinel happen under the same lock as
        # submit's closed-check + enqueue, so no request can land behind the
        # sentinel; the join and drain run outside the lock
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=30)
        # fail anything still queued (cannot happen via submit any more, but
        # keeps the invariant under future edits)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.future.set_exception(RuntimeError("server is closed"))

    # ------------------------------------------------------------------ #

    def _run(self) -> None:
        with torch.inference_mode():
            self._serve()

    def _serve(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                return
            group = [req]
            deadline = time.perf_counter() + self.max_delay_s
            # collect co-riders for the same bucket until full or deadline
            while len(group) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(group)
                    return
                if nxt.bucket == group[0].bucket:
                    group.append(nxt)
                else:
                    self._dispatch(group)
                    group = [nxt]
                    deadline = time.perf_counter() + self.max_delay_s
            self._dispatch(group)

    def _dispatch(self, group) -> None:
        bucket = group[0].bucket
        batch = np.zeros((self.max_batch, bucket), np.float32)
        for row, req in enumerate(group):
            batch[row, : len(req.audio)] = req.audio
        try:
            out = self._enhance(batch)
        except Exception as exc:  # surface execution errors to every waiter
            for req in group:
                req.future.set_exception(exc)
            return
        now = time.perf_counter()
        with self._lock:
            self._dispatches += 1
            for req in group:
                self._latencies_ms.append((now - req.t_submit) * 1e3)
                self._audio_seconds += len(req.audio) / self.sample_rate
                self._served += 1
        for row, req in enumerate(group):
            req.future.set_result(out[row, : len(req.audio)].copy())


class StreamingEnhancer:
    """Bounded-latency streaming enhancement over an unbounded audio stream.

    The generator is a finite-receptive-field FIR stack, so overlap windowing
    is exact: each window covers ``context`` samples either side of the
    ``chunk`` it emits, and windows start on the model's stride grid
    (multiples of ``model.multiple``) so every downsampling phase matches
    offline processing.  The first window consumes the signal head directly
    and emits its leading ``context + chunk`` samples, so the streamed
    output equals the offline forward everywhere except the flushed tail,
    where zeros stand in for samples the stream never saw.

    The first output arrives after ``latency_samples`` inputs; the steady
    state lag is ``chunk + right_context``.

    Usage::

        stream = StreamingEnhancer(model)
        for block in microphone:         # arbitrary block sizes
            out = stream.push(block)     # enhanced samples as they're ready
        tail = stream.flush()            # drain with zero right-padding
    """

    def __init__(
        self,
        model: nn.Module,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        chunk: int = 4096,
        context: int = 8192,
        compute_dtype: Optional[str] = None,
        device: DeviceLike = None,
    ):
        multiple = int(model.multiple)
        if chunk % multiple or context % multiple:
            raise ValueError(
                f"chunk and context must be multiples of the model stride grid "
                f"({multiple}); got chunk={chunk}, context={context}"
            )
        self._enhance = _Enhancer(model, params, compute_dtype, device)
        self.model = self._enhance.model
        self.chunk = int(chunk)
        self.context = int(context)
        # left context and chunk stay on the stride grid; the right context
        # absorbs the model's valid-length adjustment
        self._window = int(model.valid_length(2 * self.context + self.chunk))
        self._right_context = self._window - self.context - self.chunk
        if self._right_context <= 0:
            raise ValueError("context too small for the model's valid-length grid")
        self._buf = np.zeros(0, np.float32)
        self._first = True
        self._pushed = 0
        self._emitted = 0
        self._flushed = False

    @property
    def latency_samples(self) -> int:
        """Samples buffered before the first output (one full window)."""
        return self._window

    def _emit_ready(self) -> np.ndarray:
        outs = []
        with torch.inference_mode():
            while len(self._buf) >= self._window:
                y = self._enhance(self._buf[None, : self._window])[0]
                if self._first:
                    outs.append(y[: self.context + self.chunk].copy())
                    self._first = False
                else:
                    outs.append(y[self.context : self.context + self.chunk].copy())
                self._buf = self._buf[self.chunk :]
        out = np.concatenate(outs) if outs else np.zeros(0, np.float32)
        self._emitted += out.size
        return out

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed captured samples; returns enhanced samples as they complete
        (possibly empty: output arrives ``latency_samples`` behind input)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._pushed += samples.size
        self._buf = np.concatenate([self._buf, samples])
        return self._emit_ready()

    def flush(self) -> np.ndarray:
        """End of stream: zero-pad the right context and emit the remainder."""
        if self._flushed:
            return np.zeros(0, np.float32)
        self._flushed = True
        owed = self._pushed - self._emitted
        if owed <= 0:
            return np.zeros(0, np.float32)
        pad = self._window + self.chunk  # covers any final partial window
        self._buf = np.concatenate([self._buf, np.zeros(pad, np.float32)])
        out = self._emit_ready()
        return out[:owed]
