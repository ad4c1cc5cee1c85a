"""HTTP front end: the microbatching service over the network (counterpart
of audio_diffusion_tpu/server.py; the HTTP layer is the standard
library's).

Concurrent HTTP requests coalesce into the fixed-size device batches of a
:class:`~audio_diffusion_torch.serve.GenerationService`, without clients
knowing about each other.

Endpoints
---------
``GET /healthz``
    Liveness: ``{"ok": true}``.
``GET /stats``
    Service counters (requests, batches, padding, occupancy) plus the
    server's static config.
``POST /generate``
    JSON body. The noise is drawn on the card from ``seed``
    (deterministic per seed)::

        {"seed": 1, "length": 262144, "num_steps": 50, "channels": 2}

    Any other keys are forwarded as conditioning (``"text": "..."`` for a
    text-conditional model, scalars such as ``"embedding_scale": 5``,
    numeric lists as arrays). Response: a PCM16 ``audio/wav`` body
    (quantized on the card when the service runs ``result_format="pcm16"``)
    with ``X-Sample-Rate`` and ``X-Seed`` headers.
``POST /transform``
    The body is a WAV file that a task model transforms: a
    ``DiffusionUpsampler`` bandwidth-extends it, a ``DiffusionVocoder``
    re-vocodes its mel spectrogram, a ``DiffusionAE`` round-trips it through
    its latent. The query string carries options: ``/transform?num_steps=25``.
    Inputs of one length batch together.

Start it from the CLI::

    python -m audio_diffusion_torch serve --model run1/model --port 8000
"""
from __future__ import annotations

import io
import json
import struct
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

__all__ = ["wav_bytes", "make_server", "HttpGenerationServer"]


def wav_bytes(data, sample_rate: int) -> bytes:
    """Encode ``[channels, frames]`` audio as an in-memory PCM16 WAV file.

    int16 input is written bit-exactly (the service's
    ``result_format="pcm16"`` arrays); float input is quantized with the
    rule of the native writer (``data/wavio.cpp``), so both paths give the
    same file.
    """
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr[None]
    assert arr.ndim == 2, f"expected [channels, frames], got {arr.shape}"
    if arr.dtype != np.int16:
        # Bit-match the native writer (wavio.cpp): float32 arithmetic,
        # round half away from zero, truncating C cast, symmetric clip
        # (input clipped to [-1, 1] -> floor is -32767).
        v = arr.astype(np.float32) * np.float32(32767.0)
        v = (v + np.where(v >= 0, np.float32(0.5),
                          np.float32(-0.5))).astype(np.float32)
        arr = np.clip(np.trunc(v), -32767, 32767).astype(np.int16)
    channels, frames = arr.shape
    pcm = np.ascontiguousarray(arr.T).tobytes()  # interleaved frames
    byte_rate = sample_rate * channels * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt " + \
        struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate,
                    channels * 2, 16) + \
        b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


class _Handler(BaseHTTPRequestHandler):
    # One request handler per connection thread (ThreadingHTTPServer);
    # every handler blocks on its own Future, so N concurrent clients put
    # N requests in the service queue and the batcher coalesces them.
    protocol_version = "HTTP/1.1"
    server: "HttpGenerationServer"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    # ------------------------------------------------------------ helpers
    def _json(self, code: int, obj: Dict[str, Any]) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _wav(self, audio, headers: Dict[str, str]) -> None:
        body = wav_bytes(audio, self.server.sample_rate)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Sample-Rate", str(self.server.sample_rate))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    # ------------------------------------------------------------- routes
    def do_GET(self) -> None:
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, {"ok": True})
        elif path == "/stats":
            self._json(200, {**self.server.service.stats,
                             "task": self.server.task,
                             "sample_rate": self.server.sample_rate,
                             "default_length": self.server.default_length})
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def do_POST(self) -> None:
        path = urlparse(self.path).path
        try:
            if path == "/generate":
                self._generate()
            elif path == "/transform":
                self._transform()
            else:
                self._json(404, {"error": f"unknown path {path}"})
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # batch/device failure -> this caller only
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def _generate(self) -> None:
        raw = self._read_body()
        req = json.loads(raw.decode()) if raw else {}
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        seed = int(req.pop("seed", 0))
        length = int(req.pop("length", self.server.default_length))
        channels = int(req.pop("channels", self.server.channels))
        num_steps = req.pop("num_steps", None)
        if num_steps is not None:
            num_steps = int(num_steps)
        if self.server.task != "unconditional":
            raise ValueError(
                f"/generate draws from noise; a {self.server.task} model "
                "transforms input audio — POST the WAV to /transform")
        # Numeric JSON lists are conditioning arrays (e.g. "embedding":
        # [[...]...] — precomputed text embeddings); string lists stay
        # text. Scalars pass through untouched.
        for k, v in req.items():
            if isinstance(v, list) and v and not isinstance(v[0], str):
                req[k] = np.asarray(v, np.float32)
        fut = self.server.service.submit_seed(
            seed, length=length, channels=channels, num_steps=num_steps,
            **req)
        audio = fut.result(timeout=self.server.request_timeout)
        self._wav(audio, {"X-Seed": str(seed)})

    def _transform(self) -> None:
        if self.server.task == "unconditional":
            raise ValueError("this server runs an unconditional model; "
                             "use POST /generate")
        body = self._read_body()
        if not body[:4] == b"RIFF":
            raise ValueError("/transform body must be a WAV file")
        from .data import wav_read

        # The native decoder reads paths; spool the upload to a temp file.
        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            tmp.write(body)
            tmp.flush()
            audio = wav_read(tmp.name)
        q = parse_qs(urlparse(self.path).query)
        num_steps = int(q["num_steps"][0]) if "num_steps" in q else None
        model = self.server.model
        if self.server.task == "vocoder":
            # The mel front end runs here (this handler's thread); the
            # service batches the spectrograms.
            with torch.inference_mode():
                primary = model.to_spectrogram(torch.as_tensor(
                    audio[None], device=model.device))[0]
        elif self.server.task == "autoencoder":
            # Latent round trip: encode here, the service batches the
            # diffusion decodes (GenerationService(method="decode")).
            primary = model.encode(audio[None])[0]
        else:  # upsampler: the low-rate audio is the request payload
            primary = audio
        fut = self.server.service.submit(primary, num_steps=num_steps)
        out = fut.result(timeout=self.server.request_timeout)
        self._wav(out, {"X-Input-Frames": str(audio.shape[-1])})


class HttpGenerationServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to a GenerationService. Threaded is the
    point: each HTTP request in flight waits in its own handler thread on
    ``Future.result()`` while the one service worker runs device
    batches."""

    daemon_threads = True

    def __init__(self, address, service, *, sample_rate: int,
                 default_length: int, channels: int = 2,
                 task: str = "unconditional", model=None,
                 request_timeout: float = 600.0, verbose: bool = False):
        self.service = service
        self.sample_rate = sample_rate
        self.default_length = default_length
        self.channels = channels
        self.task = task
        self.model = model
        self.request_timeout = request_timeout
        self.verbose = verbose
        super().__init__(address, _Handler)


def make_server(service, *, sample_rate: int, default_length: int,
                channels: int = 2, task: str = "unconditional", model=None,
                host: str = "127.0.0.1", port: int = 0,
                request_timeout: float = 600.0,
                verbose: bool = False) -> HttpGenerationServer:
    """Build (but don't start) the HTTP server; ``port=0`` picks a free
    port (``server.server_address[1]``). Call ``serve_forever()`` or run
    it in a thread; ``shutdown()`` stops it. The caller owns the
    service's lifecycle (close it after shutdown)."""
    if task in ("upsampler", "vocoder", "autoencoder") and model is None:
        raise ValueError(f"task={task!r} needs model= (the vocoder's mel "
                         "front end / the autoencoder's encoder / task "
                         "sample paths run on it)")
    return HttpGenerationServer(
        (host, port), service, sample_rate=sample_rate,
        default_length=default_length, channels=channels, task=task,
        model=model, request_timeout=request_timeout, verbose=verbose)
