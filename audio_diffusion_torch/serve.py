"""Serving: a microbatching generation service (counterpart of
audio_diffusion_tpu/serve.py).

:class:`GenerationService` accepts concurrent generation requests, groups
them by *signature* (input shape and dtype, the conditioning's structure,
the static sampling options), assembles fixed-size batches, padding a
partial batch by replicating its last request, and runs them on one worker
thread that owns the card. Results come back as futures holding host numpy
arrays::

    service = GenerationService(model, num_steps=50, batch_size=8)
    futs = [service.submit(noise_i) for noise_i in requests]
    audio = [f.result() for f in futs]            # [channels, length] each
    service.close()

To serve EMA weights while training continues, or a quantized dict
(``ops/quant.py``), pass a parameter snapshot:
``GenerationService(model, params=trainer.ema_params)``.

Grad mode is thread-local in PyTorch, so the worker runs every batch under
``torch.inference_mode()`` itself. Autoregressive models (``DiffusionAR``)
are not batchable this way: their sample takes no per-request array; call
them directly.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .diffusion import noise as _noise

__all__ = ["GenerationService", "to_pcm16"]


def _is_arraylike(v: Any) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _is_text(v: Any) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) > 0
            and all(isinstance(s, str) for s in v))


def _signature(primary, cond: Dict[str, Any], num_steps: int) -> Tuple:
    """Requests batch together iff their signatures are equal: same input
    shape and dtype, same conditioning structure, identical static values.
    Per-request data (arrays, text) contributes its STRUCTURE only: two
    requests with different prompts share one batch."""
    if isinstance(primary, _SeedNoise):
        head: Tuple = ("seednoise", primary.channels, primary.length)
    else:
        head = ("primary", tuple(primary.shape), str(primary.dtype))
    items: List[Tuple] = [("num_steps", num_steps), head]
    for k in sorted(cond):
        v = cond[k]
        if _is_arraylike(v):
            items.append((k, tuple(v.shape), str(v.dtype)))
        elif _is_text(v):
            items.append((k, "text", len(v)))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            # Numerically equal scalars of different types (5 vs 5.0)
            # share one bucket.
            items.append((k, "num", float(v)))
        else:
            items.append((k, repr(v)))
    return tuple(items)


def to_pcm16(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM of float audio, on x's device, bit for bit what the WAV
    writer stores (``data/wavio.cpp``): clip to [-1, 1], scale by 32767 in
    float32, round half away from zero, truncate."""
    v = torch.clamp(x.to(torch.float32), -1.0, 1.0) * 32767.0
    half = torch.where(v >= 0, 0.5, -0.5).to(torch.float32)
    return torch.trunc(v + half).to(torch.int16)


class _SeedNoise:
    """Marker primary: the noise is drawn on the device from this seed, so
    the request carries a seed instead of a [channels, length] array."""

    __slots__ = ("seed", "channels", "length")

    def __init__(self, seed: int, channels: int, length: int):
        self.seed = seed
        self.channels = channels
        self.length = length


class _Request:
    __slots__ = ("primary", "cond", "num_steps", "future", "t_enqueue")

    def __init__(self, primary, cond, num_steps):
        self.primary = primary
        self.cond = cond
        self.num_steps = num_steps
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


class GenerationService:
    """Microbatching sampling server around a (task) DiffusionModel.

    Parameters
    ----------
    model:
        Any model exposing ``sample`` with a per-request array as first
        argument (DiffusionModel, DiffusionUpsampler, DiffusionVocoder,
        DiffusionAE via ``decode``: see ``method``; an
        ``export.ArtifactSampler``), and its ``device``.
    num_steps:
        Default sampling steps (overridable per request).
    batch_size:
        Device batch size. Partial batches are padded by replicating the
        last request, so every batch of a signature has one shape.
    max_wait_ms:
        How long to hold an incomplete batch open for more requests.
    params:
        Optional parameter snapshot (e.g. ``trainer.ema_params``, or a dict
        from :func:`audio_diffusion_torch.quantize_params`) used for every
        batch; defaults to the model's live parameters.
    method:
        Name of the model method to call (default ``"sample"``; use
        ``"decode"`` to serve DiffusionAE latents).
    result_format:
        ``"float32"`` (default): futures resolve to float32 audio.
        ``"pcm16"``: the audio is quantized to int16 on the card
        (:func:`to_pcm16`, what the WAV writer stores) and futures resolve
        to int16 arrays, a quarter of the bytes to copy to the host.
        Divide by 32767 to recover floats.
    """

    def __init__(self, model, *, num_steps: int = 50, batch_size: int = 8,
                 max_wait_ms: float = 100.0, params: Optional[Dict] = None,
                 method: str = "sample", result_format: str = "float32"):
        assert batch_size >= 1
        assert result_format in ("float32", "pcm16"), result_format
        self._model = model
        self._device = torch.device(model.device)
        self._method = method
        self._result_format = result_format
        self._num_steps = num_steps
        self._batch_size = batch_size
        self._max_wait = max_wait_ms / 1e3
        self._params = params
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_served = 0
        self._n_batches = 0
        self._n_padded = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- public
    def submit(self, primary, *, num_steps: Optional[int] = None,
               **cond) -> Future:
        """Enqueue one request. ``primary`` is the per-request array (noise
        for sample; low-rate audio for an upsampler; a mel for a vocoder; a
        latent for an autoencoder's decode), WITHOUT the batch dimension:
        ``[channels, length]``, a numpy array or a tensor. Conditioning
        kwargs are per request: arrays (stacked into the device batch, no
        batch dim, e.g. ``embedding=[64, 768]``), ``text=`` as one string
        (or a 1-element list), and scalars (equal across a batch: static
        config, e.g. ``embedding_scale=5.0``). Returns a Future resolving to
        the generated ``[channels, length]`` numpy array."""
        if not isinstance(primary, (_SeedNoise, torch.Tensor)):
            primary = np.asarray(primary)
        if isinstance(cond.get("text"), str):
            cond["text"] = [cond["text"]]
        for k, v in cond.items():
            if _is_text(v) and len(v) != 1:
                raise ValueError(
                    f"{k}= must hold exactly one string per request "
                    f"(one request = one sample); got {len(v)}")
            if not (_is_arraylike(v) or _is_text(v)
                    or isinstance(v, (int, float, bool, str, type(None)))):
                raise TypeError(
                    f"unsupported conditioning value for {k}= "
                    f"({type(v).__name__}): pass arrays, text, or scalars "
                    "— structured conditioning (e.g. channels=[...]) "
                    "isn't batchable; call the model directly")
        req = _Request(primary, cond, num_steps or self._num_steps)
        # The closed-check and the enqueue are one step against close():
        # a request enqueued after the worker's last drain would hold an
        # unresolved future forever.
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("service is closed")
            with self._stats_lock:
                self._n_requests += 1
            self._queue.put(req)
        return req.future

    def submit_seed(self, seed: int, *, length: int, channels: int = 2,
                    num_steps: Optional[int] = None, **cond) -> Future:
        """Like :meth:`submit`, but the standard-normal noise
        ``[channels, length]`` is drawn on the card from a generator seeded
        with ``seed`` (through ``diffusion.noise.normal``): the request
        ships a seed instead of the array. Deterministic per seed and
        independent of the batch's other requests and of the slot."""
        seed = int(seed)
        if not 0 <= seed < 2**32:
            # Fail THIS request at submit time, not its whole batch.
            raise ValueError(f"seed must be in [0, 2**32), got {seed}")
        return self.submit(_SeedNoise(seed, channels, length),
                           num_steps=num_steps, **cond)

    def generate(self, primary=None, *, length: Optional[int] = None,
                 channels: int = 2, seed: Optional[int] = None,
                 num_steps: Optional[int] = None, **cond) -> np.ndarray:
        """Blocking convenience: submit and wait. Without ``primary`` the
        noise ``[channels, length]`` is drawn on the card from ``seed``."""
        if primary is None:
            assert length is not None, "pass primary= or length="
            return self.submit_seed(seed or 0, length=length,
                                    channels=channels,
                                    num_steps=num_steps, **cond).result()
        return self.submit(primary, num_steps=num_steps, **cond).result()

    def update_params(self, params: Optional[Dict]) -> None:
        """Swap the parameter snapshot used by SUBSEQUENT batches (push
        ``trainer.ema_params`` while training continues, or a quantized
        dict). One reference assignment: a batch in flight finishes on the
        old snapshot and no request fails. ``None`` serves the model's live
        parameters again."""
        self._params = params

    @property
    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "padded_slots": self._n_padded,
                "mean_occupancy": (
                    self._n_served / self._n_batches / self._batch_size
                    if self._n_batches else 0.0),
            }

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Drain pending requests and stop the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # sentinel
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        """Worker entry: the batching loop, guarded so that an unexpected
        error in the bucketing or flush logic itself (outside _run_batch's
        per-batch guard) fails every pending and queued future instead of
        killing the thread silently and hanging all callers."""
        buckets: Dict[Tuple, List[_Request]] = {}
        try:
            self._run_loop(buckets)
        except BaseException as e:
            with self._submit_lock:
                self._closed = True  # reject further submits
            pending = [r for reqs in buckets.values() for r in reqs]
            while True:  # drain anything already enqueued
                try:
                    item = self._queue.get_nowait()
                except queue_mod.Empty:
                    break
                if item is not None:
                    pending.append(item)
            for r in pending:
                if not r.future.done():
                    r.future.set_exception(
                        RuntimeError(f"GenerationService worker died: {e!r}"))
            raise

    def _run_loop(self, buckets: Dict[Tuple, List[_Request]]) -> None:
        done = False

        def bucket(item) -> bool:
            nonlocal done
            if item is None:
                done = True
                return False
            try:
                sig = _signature(item.primary, item.cond, item.num_steps)
            except BaseException as e:
                # A malformed request fails ALONE at bucketing time.
                if not item.future.done():
                    item.future.set_exception(e)
                return True
            buckets.setdefault(sig, []).append(item)
            return True

        while not (done and not buckets and self._queue.empty()):
            # Deadline: the oldest held request's max-wait expiry.
            now = time.monotonic()
            deadlines = [reqs[0].t_enqueue + self._max_wait
                         for reqs in buckets.values() if reqs]
            timeout = (max(min(deadlines) - now, 0.0) if deadlines
                       else None)
            if done:
                timeout = 0.0
            try:
                bucket(self._queue.get(timeout=timeout))
            except queue_mod.Empty:
                pass  # timer fired / drain pass
            # Drain everything already enqueued before deciding what to
            # flush: requests that arrive while a batch computes coalesce
            # instead of expiring into batches of one.
            while True:
                try:
                    bucket(self._queue.get_nowait())
                except queue_mod.Empty:
                    break

            now = time.monotonic()
            for sig in list(buckets):
                reqs = buckets[sig]
                expired = reqs[0].t_enqueue + self._max_wait <= now
                if len(reqs) >= self._batch_size or done or expired:
                    # Flush full chunks; a fresh partial tail (flushed
                    # only by fullness) waits for its own deadline.
                    n_flush = len(reqs)
                    if not (done or expired):
                        n_flush -= n_flush % self._batch_size
                    # The requests stay in their bucket until their batches
                    # have run, so the guard in _run still sees them if
                    # _run_batch itself raises.
                    for i in range(0, n_flush, self._batch_size):
                        self._run_batch(reqs[i:i + self._batch_size])
                    if n_flush < len(reqs):
                        buckets[sig] = reqs[n_flush:]
                    else:
                        del buckets[sig]

    def _seed_noise(self, seeds: List[int], channels: int,
                    length: int) -> torch.Tensor:
        """[len(seeds), channels, length] float32 on the card: row i from
        its own generator seeded with ``seeds[i]``."""
        return torch.stack([
            _noise.normal(torch.Generator(device=self._device).manual_seed(s),
                          (channels, length), torch.float32, self._device)
            for s in seeds])

    def _stack(self, values: List) -> torch.Tensor:
        return torch.stack([torch.as_tensor(v, device=self._device)
                            for v in values])

    def _run_batch(self, reqs: List[_Request]) -> None:
        n = len(reqs)
        pad = self._batch_size - n
        try:
            with torch.inference_mode():
                if isinstance(reqs[0].primary, _SeedNoise):
                    sn = reqs[0].primary
                    batch = self._seed_noise(
                        [r.primary.seed for r in reqs]
                        + [reqs[-1].primary.seed] * pad,
                        sn.channels, sn.length)
                else:
                    batch = self._stack([r.primary for r in reqs]
                                        + [reqs[-1].primary] * pad)
                cond: Dict[str, Any] = {}
                for k, v0 in reqs[0].cond.items():
                    if _is_arraylike(v0):
                        cond[k] = self._stack([r.cond[k] for r in reqs]
                                              + [reqs[-1].cond[k]] * pad)
                    elif _is_text(v0):
                        cond[k] = ([r.cond[k][0] for r in reqs]
                                   + [reqs[-1].cond[k][0]] * pad)
                    else:
                        cond[k] = v0  # static: identical across the batch
                # The snapshot rides the explicit params= override: no
                # shared state is swapped, so a trainer or a direct
                # model.sample in another thread never observes it.
                if self._params is not None:
                    cond["params"] = self._params
                out = getattr(self._model, self._method)(
                    batch, num_steps=reqs[0].num_steps, **cond)
                out = (to_pcm16(out) if self._result_format == "pcm16"
                       else out.to(torch.float32))
                host = out.cpu().numpy()
            with self._stats_lock:
                self._n_batches += 1
                self._n_served += n
                self._n_padded += pad
            for i, r in enumerate(reqs):
                if not r.future.done():  # the caller may have cancelled
                    r.future.set_result(host[i])
        except Exception as e:  # surface to all callers of this batch
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
