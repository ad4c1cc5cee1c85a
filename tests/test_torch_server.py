"""The port's HTTP front end (server.py) on the CPU: WAV encoding (bit for
bit the JAX package's ``wav_bytes`` and the native writer's), /generate
batching and determinism, /transform routing for an upsampler and an
autoencoder, the error codes. The cases of tests/test_server.py, on the
port's models."""
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from audio_diffusion_tpu import wav_bytes as jax_wav_bytes
from audio_diffusion_torch import (DiffusionAE, DiffusionModel,
                                   DiffusionUpsampler, GenerationService,
                                   MelEncoder1d, UNetV0, make_server,
                                   wav_bytes)
from audio_diffusion_torch.data import wav_read, wav_write

torch.set_num_threads(2)

TINY = dict(net_t=UNetV0, in_channels=2, channels=[8, 16], factors=[1, 2],
            items=[1, 1], modulation_features=32, device="cpu")


def _parse_wav(body: bytes):
    with wave.open(io.BytesIO(body)) as w:
        assert w.getsampwidth() == 2
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        arr = pcm.reshape(-1, w.getnchannels()).T
        return arr, w.getframerate()


def _post(url: str, body: bytes, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read()


# --------------------------------------------------------------- wav_bytes
def test_wav_bytes_matches_native_writer(tmp_path):
    """The in-memory encoder and the C++ writer produce the same PCM for
    the same float audio (shared clip(round(x*32767)) quantization)."""
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 500)) * 0.5).astype(np.float32)
    mem, sr = _parse_wav(wav_bytes(audio, 16000))
    wav_write(tmp_path / "a.wav", audio, 16000)
    disk = wav_read(tmp_path / "a.wav")
    assert sr == 16000
    # Native reader returns floats (pcm/32768); the roundtrip must be
    # BIT-exact if both writers quantized identically.
    np.testing.assert_array_equal(mem / np.float32(32768.0), disk)


def test_wav_bytes_int16_passthrough():
    pcm = np.array([[-32768, -1, 0, 1, 32767]], np.int16)
    out, _ = _parse_wav(wav_bytes(pcm, 8000))
    np.testing.assert_array_equal(out, pcm)


def test_wav_bytes_mono_1d():
    out, _ = _parse_wav(wav_bytes(np.zeros(64, np.float32), 8000))
    assert out.shape == (1, 64)


@pytest.mark.parametrize("kind", ["float", "int16", "mono"])
def test_wav_bytes_equals_jax_bytes(kind):
    """The same file, byte for byte, as the JAX package's encoder."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.3, 1.3, (2, 777)).astype(np.float32)
    x[0, :4] = [0.5 / 32767, -0.5 / 32767, 1.5 / 32767, -2.5 / 32767]
    data = {"float": x, "int16": (x * 20000).astype(np.int16),
            "mono": x[0]}[kind]
    assert wav_bytes(data, 44100) == jax_wav_bytes(data, 44100)


# ----------------------------------------------------------- /generate
@pytest.fixture(scope="module")
def http_server():
    model = DiffusionModel(**TINY)
    service = GenerationService(model, num_steps=2, batch_size=2,
                                max_wait_ms=150.0, result_format="pcm16")
    server = make_server(service, sample_rate=16000, default_length=256,
                         host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield base
    server.shutdown()
    service.close()


def test_healthz_and_stats(http_server):
    code, body = _get(http_server + "/healthz")
    assert code == 200 and json.loads(body) == {"ok": True}
    code, body = _get(http_server + "/stats")
    stats = json.loads(body)
    assert code == 200
    assert stats["task"] == "unconditional"
    assert stats["sample_rate"] == 16000


def test_generate_concurrent_requests_batch_and_are_deterministic(
        http_server):
    """Two concurrent POSTs with the same signature share one device
    batch; per-seed determinism survives HTTP + PCM16."""
    results = {}

    def hit(tag, seed):
        results[tag] = _post(http_server + "/generate",
                             json.dumps({"seed": seed}).encode())

    threads = [threading.Thread(target=hit, args=(i, seed))
               for i, seed in enumerate([7, 7, 9])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    for code, headers, body in results.values():
        assert code == 200
        assert headers["Content-Type"] == "audio/wav"
        audio, sr = _parse_wav(body)
        assert audio.shape == (2, 256) and sr == 16000
    assert results[0][2] == results[1][2]  # same seed -> same WAV bytes
    assert results[0][2] != results[2][2]
    code, body = _get(http_server + "/stats")
    stats = json.loads(body)
    assert stats["requests"] >= 3 and stats["batches"] >= 2


def test_stats_serves_the_recent_batches(http_server):
    """``/stats`` passes the service's batch timeline through as JSON."""
    code, _, _ = _post(http_server + "/generate",
                    json.dumps({"seed": 5}).encode())
    assert code == 200
    code, body = _get(http_server + "/stats")
    assert code == 200
    recent = json.loads(body)["recent_batches"]
    assert recent and recent[-1]["num_steps"] == 2
    assert set(recent[-1]) == {
        "requests", "padded", "num_steps", "profiled", "queue_wait_s",
        "assemble_s", "dispatch_s", "device_wait_s", "reply_s"}
    assert len(recent[-1]["queue_wait_s"]) == recent[-1]["requests"]


def test_generate_num_steps_and_length_override(http_server):
    code, headers, body = _post(
        http_server + "/generate",
        json.dumps({"seed": 1, "length": 128, "num_steps": 1}).encode())
    assert code == 200
    audio, _ = _parse_wav(body)
    assert audio.shape == (2, 128)
    assert headers["X-Seed"] == "1"


def test_generate_error_paths(http_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_server + "/generate", b"not json")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_server + "/generate", json.dumps({"seed": -1}).encode())
    assert e.value.code == 400  # submit_seed range check fails alone
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(http_server + "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        # transform on an unconditional server is a client error
        _post(http_server + "/transform", b"RIFFxxxx")
    assert e.value.code == 400


# ----------------------------------------------------------- /transform
def test_transform_upsampler(tmp_path):
    model = DiffusionUpsampler(upsample_factor=4, **TINY)
    service = GenerationService(model, num_steps=2, batch_size=1,
                                max_wait_ms=10.0, result_format="pcm16")
    server = make_server(service, sample_rate=16000, default_length=256,
                         task="upsampler", model=model,
                         host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        low = (np.random.default_rng(0).standard_normal((2, 64)) * 0.3
               ).astype(np.float32)
        code, headers, body = _post(base + "/transform?num_steps=2",
                                    wav_bytes(low, 4000), "audio/wav")
        assert code == 200
        audio, _ = _parse_wav(body)
        assert audio.shape == (2, 256)  # 4x bandwidth extension
        assert headers["X-Input-Frames"] == "64"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/generate", json.dumps({"seed": 1}).encode())
        assert e.value.code == 400  # task servers transform, not generate
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/transform", b"nonsense-not-a-wav")
        assert e.value.code == 400
    finally:
        server.shutdown()
        service.close()


def test_make_server_requires_model_for_task():
    with pytest.raises(ValueError):
        make_server(object(), sample_rate=16000, default_length=256,
                    task="vocoder")


def test_transform_autoencoder():
    """AE over HTTP: the upload is encoded to the latent on the handler
    thread and diffusion-decoded in the batched service (method='decode');
    the response round-trips the audio at the input length."""
    encoder = MelEncoder1d(in_channels=2, channels=32, out_channels=4,
                           factors=[2], num_blocks=[1], mel_channels=16,
                           mel_n_fft=64, mel_sample_rate=16000, device="cpu")
    model = DiffusionAE(net_t=UNetV0, in_channels=2, encoder=encoder,
                        inject_depth=2, channels=[8, 16, 32],
                        factors=[1, 4, 8], items=[1, 1, 1],
                        modulation_features=32, device="cpu")
    service = GenerationService(model, num_steps=2, batch_size=1,
                                max_wait_ms=10.0, result_format="pcm16",
                                method="decode")
    server = make_server(service, sample_rate=16000, default_length=1024,
                         task="autoencoder", model=model,
                         host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        x = (np.random.default_rng(1).standard_normal((2, 1024)) * 0.3
             ).astype(np.float32)
        code, headers, body = _post(base + "/transform?num_steps=2",
                                    wav_bytes(x, 16000), "audio/wav")
        assert code == 200
        audio, sr = _parse_wav(body)
        assert audio.shape == (2, 1024) and sr == 16000
        assert headers["X-Input-Frames"] == "1024"
    finally:
        server.shutdown()
        service.close()


def test_generate_with_embedding_conditioning():
    """Text-conditional serving without local T5: the JSON carries the
    precomputed embedding as a nested list, plus a CFG scale scalar."""
    model = DiffusionModel(
        net_t=UNetV0, in_channels=1, channels=[8, 32], factors=[1, 4],
        items=[1, 1], cross_attentions=[0, 1], attention_heads=2,
        attention_features=8, modulation_features=32,
        use_embedding_cfg=True, embedding_max_length=8,
        embedding_features=16, device="cpu")
    service = GenerationService(model, num_steps=2, batch_size=1,
                                max_wait_ms=10.0, result_format="pcm16")
    server = make_server(service, sample_rate=8000, default_length=256,
                         channels=1, host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        emb = np.random.default_rng(0).standard_normal((8, 16)).round(3)
        body = json.dumps({"seed": 4, "embedding": emb.tolist(),
                           "embedding_scale": 3.0}).encode()
        code, headers, resp = _post(base + "/generate", body)
        assert code == 200
        audio, sr = _parse_wav(resp)
        assert audio.shape == (1, 256) and sr == 8000
        # Same seed, different embedding -> different audio (the
        # conditioning actually reaches the net).
        emb2 = np.random.default_rng(1).standard_normal((8, 16)).round(3)
        body2 = json.dumps({"seed": 4, "embedding": emb2.tolist(),
                            "embedding_scale": 3.0}).encode()
        _, _, resp2 = _post(base + "/generate", body2)
        audio2, _ = _parse_wav(resp2)
        assert not np.array_equal(audio, audio2)
    finally:
        server.shutdown()
        service.close()
