"""The port's GenerationService (serve.py): batching, padding, seeds,
pcm16, conditioning, task models and the error paths of tests/test_serve.py,
held against the port's own ``model.sample`` bit for bit and against the
JAX package's service on the same requests, with the same weights
(``params_from_jax``).

Bars: a served row equals ``model.sample`` of the same padded batch bit for
bit; against JAX's service (same requests; for seeds, JAX's draws fed
through ``diffusion.noise.normal``): max-abs < 1e-3 and MSE <= 1e-6
(ROADMAP's bar); pcm16 bit-equal to JAX's ``to_pcm16`` and to the WAV
writer's bytes.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import GenerationService as JaxGenerationService
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_torch import (DiffusionAE, DiffusionModel,
                                   DiffusionUpsampler, GenerationService,
                                   MelEncoder1d, UNetV0, params_from_jax,
                                   quantize_params)
from audio_diffusion_torch import serve as serve_mod
from audio_diffusion_torch.data import wav_write
from audio_diffusion_torch.diffusion import noise as noise_mod
from audio_diffusion_torch.ops.text import StubTextEncoder

torch.set_num_threads(2)

LENGTH = 256
TINY = dict(in_channels=2, channels=[8, 16], factors=[1, 2], items=[1, 1],
            modulation_features=32)


def random_tree(net, seed):
    shapes = jax.eval_shape(lambda: net.module.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 2, LENGTH)),
        jnp.zeros((1,))))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        a = rs.randn(*s.shape)
        if "freqs" in name:
            return (16.0 * a).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * a).astype(np.float32)
        fan_in = 3 * s.shape[1] if len(s.shape) == 3 else (
            s.shape[0] if len(s.shape) == 2 else 100)
        return (a / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **TINY)
    tree = random_tree(jax_model.net, seed=0)
    jax_model.params = {"net": tree}
    model = DiffusionModel(net_t=UNetV0, device="cpu", **TINY)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)
    return jax_model, model


def noises(n, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((2, LENGTH)).astype(np.float32)
            for _ in range(n)]


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err < 1e-3 and np.mean((got - want) ** 2) <= 1e-6, err


def test_batches_padding_and_rows_equal_model_sample(pair):
    jax_model, model = pair
    reqs = noises(6)
    with GenerationService(model, num_steps=4, batch_size=4,
                           max_wait_ms=200.0) as svc:
        outs = [f.result(timeout=120) for f in
                [svc.submit(n) for n in reqs]]
    s = svc.stats
    # 6 requests at batch 4: two batches, the second padded by 2.
    assert s["requests"] == 6 and s["batches"] == 2
    assert s["padded_slots"] == 2
    assert s["mean_occupancy"] == pytest.approx(6 / 8)
    # Each row equals model.sample of the same padded batch, bit for bit.
    first = model.sample(torch.from_numpy(np.stack(reqs[:4])), num_steps=4)
    second = model.sample(torch.from_numpy(np.stack(
        reqs[4:] + [reqs[5]] * 2)), num_steps=4)
    want = torch.cat([first, second[:2]]).numpy()
    np.testing.assert_array_equal(np.stack(outs), want)
    # Against the JAX package's service on the same requests.
    with JaxGenerationService(jax_model, num_steps=4, batch_size=4,
                              max_wait_ms=200.0) as jsvc:
        jouts = [f.result(timeout=120) for f in
                 [jsvc.submit(n) for n in reqs]]
    close(np.stack(outs), np.stack(jouts))


def test_seed_noise_matches_jax_draws(pair, monkeypatch):
    """submit_seed draws each request's noise from a generator seeded with
    its seed, through noise.normal: fed JAX's draws for that seed, the
    service gives JAX's service's audio."""
    jax_model, model = pair

    def jax_normal(generator, shape, dtype, device):
        key = jax.random.key(generator.initial_seed())
        draw = np.asarray(jax.random.normal(key, tuple(shape), jnp.float32))
        return torch.from_numpy(draw).to(dtype=dtype, device=device)

    seeds = [3, 7, 2**32 - 1]
    with JaxGenerationService(jax_model, num_steps=3, batch_size=2,
                              max_wait_ms=200.0) as jsvc:
        want = [f.result(timeout=120) for f in
                [jsvc.submit_seed(s, length=LENGTH) for s in seeds]]
    monkeypatch.setattr(noise_mod, "normal", jax_normal)
    with GenerationService(model, num_steps=3, batch_size=2,
                           max_wait_ms=200.0) as svc:
        got = [f.result(timeout=120) for f in
               [svc.submit_seed(s, length=LENGTH) for s in seeds]]
    close(np.stack(got), np.stack(want))


def test_submit_seed_is_deterministic_and_independent_of_batch(pair):
    _, model = pair
    with GenerationService(model, num_steps=2, batch_size=2,
                           max_wait_ms=100.0) as svc:
        f7, f8 = (svc.submit_seed(s, length=LENGTH) for s in (7, 8))
        o7_shared, o8 = f7.result(timeout=120), f8.result(timeout=120)
        o7_alone = svc.submit_seed(7, length=LENGTH).result(timeout=120)
        g8, g7 = (svc.submit_seed(s, length=LENGTH) for s in (8, 7))
        o7_slot1 = g7.result(timeout=120)
        g8.result(timeout=120)
        g = svc.generate(length=LENGTH, seed=7)
    assert o7_shared.shape == (2, LENGTH) and np.isfinite(o7_shared).all()
    np.testing.assert_array_equal(o7_alone, o7_shared)
    np.testing.assert_array_equal(o7_slot1, o7_shared)
    np.testing.assert_array_equal(g, o7_shared)
    assert np.abs(o7_shared - o8).max() > 0


def test_pcm16_bit_equal_to_jax_and_wav_writer(pair, tmp_path):
    _, model = pair
    rs = np.random.default_rng(1)
    x = np.concatenate([
        rs.uniform(-1.2, 1.2, 3989),
        np.array([0.5, -0.5, 1.5 / 32767, -1.5 / 32767, 2.5 / 32767,
                  1.0, -1.0, 0.0, -0.0, 1 - 1e-7, -1 + 1e-7]),
    ]).astype(np.float32).reshape(2, -1)
    got = serve_mod.to_pcm16(torch.from_numpy(x)).numpy()
    with JaxGenerationService(None, batch_size=1) as jax_svc:
        want = np.asarray(jax_svc._to_pcm16(jnp.asarray(x)))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    wav_write(tmp_path / "x.wav", x, 16000)
    raw = np.frombuffer((tmp_path / "x.wav").read_bytes()[44:], np.int16)
    np.testing.assert_array_equal(raw, got.T.reshape(-1))
    # Through the service: the int16 result is the float result's pcm16.
    noise = noises(1, 5)[0]
    with GenerationService(model, num_steps=2, batch_size=1) as svc:
        f32 = svc.submit(noise).result(timeout=120)
    with GenerationService(model, num_steps=2, batch_size=1,
                           result_format="pcm16") as svc:
        pcm = svc.submit(noise).result(timeout=120)
    assert pcm.dtype == np.int16
    np.testing.assert_array_equal(
        pcm, serve_mod.to_pcm16(torch.from_numpy(f32)).numpy())


def test_mixed_signatures_and_error_propagates(pair):
    _, model = pair
    with GenerationService(model, num_steps=2, batch_size=4,
                           max_wait_ms=50.0) as svc:
        f1 = svc.submit(np.zeros((2, LENGTH), np.float32))
        f2 = svc.submit(np.zeros((2, 2 * LENGTH), np.float32))
        f3 = svc.submit(np.zeros((2, LENGTH), np.float32), num_steps=3)
        outs = [f.result(timeout=120) for f in (f1, f2, f3)]
        # A length the net cannot take fails its batch's future.
        bad = svc.submit(np.zeros((2, LENGTH - 1), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=120)
    assert [o.shape for o in outs] == [(2, LENGTH), (2, 2 * LENGTH),
                                       (2, LENGTH)]
    assert svc.stats["batches"] == 3


def test_params_snapshot_and_update_params(pair):
    """The snapshot rides the params= override and never touches the
    model's module: another thread polls the module's parameters while the
    worker runs. update_params swaps the snapshot for later batches; a
    quantized dict serves like model.sample of it."""
    _, model = pair
    live = {k: v.detach().clone() for k, v in model.params.items()}
    ids = {k: id(v) for k, v in model.params.items()}
    zero = {k: torch.zeros_like(v) for k, v in model.params.items()}
    noise = noises(1, 2)[0]
    with GenerationService(model, num_steps=4, batch_size=1,
                           params=zero) as svc:
        fut = svc.submit(noise)
        while not fut.done():
            for k, v in model.net.module.named_parameters():
                assert id(v) == ids[k] and torch.equal(v, live[k]), k
        served = fut.result(timeout=120)
        q = quantize_params(model.params, min_size=256)
        svc.update_params(q)
        quantized = svc.submit(noise).result(timeout=120)
        svc.update_params(None)
        again = svc.submit(noise).result(timeout=120)
    batch = torch.from_numpy(noise)[None]
    direct = model.sample(batch, num_steps=4)[0].numpy()
    assert np.abs(served - direct).max() > 0
    np.testing.assert_array_equal(again, direct)
    np.testing.assert_array_equal(
        quantized, model.sample(batch, num_steps=4, params=q)[0].numpy())
    for k, v in model.params.items():
        assert torch.equal(v, live[k]), k


def test_malformed_request_fails_alone(pair, monkeypatch):
    _, model = pair
    real_signature = serve_mod._signature

    def picky(primary, cond, num_steps):
        if cond.get("poison"):
            raise RuntimeError("signature exploded")
        return real_signature(primary, cond, num_steps)

    with GenerationService(model, num_steps=2, batch_size=1,
                           max_wait_ms=20.0) as svc:
        monkeypatch.setattr(serve_mod, "_signature", picky)
        bad = svc.submit(np.zeros((2, LENGTH), np.float32), poison=True)
        with pytest.raises(RuntimeError, match="signature exploded"):
            bad.result(timeout=30)
        good = svc.submit(np.zeros((2, LENGTH), np.float32))
        assert good.result(timeout=120).shape == (2, LENGTH)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_crash_fails_pending_futures(pair):
    _, model = pair
    svc = GenerationService(model, num_steps=2, batch_size=4,
                            max_wait_ms=50.0)
    try:
        def boom(reqs):
            raise RuntimeError("flush exploded")

        svc._run_batch = boom
        f1 = svc.submit(np.zeros((2, LENGTH), np.float32))
        f2 = svc.submit(np.zeros((2, LENGTH), np.float32))
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="worker died"):
                f.result(timeout=30)
        svc._worker.join(timeout=30)
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit(np.zeros((2, LENGTH), np.float32))
    finally:
        svc._closed = True  # the worker is dead; close() would wait on it


def test_seed_range_structured_cond_and_scalar_signatures(pair):
    _, model = pair
    with GenerationService(model, num_steps=2, batch_size=1) as svc:
        for seed in (-1, 2**32):
            with pytest.raises(ValueError, match=r"seed must be in"):
                svc.submit_seed(seed, length=LENGTH)
        with pytest.raises(TypeError, match="structured conditioning"):
            svc.submit(np.zeros((2, LENGTH), np.float32),
                       channels=[None, np.zeros((4, 64))])
        with pytest.raises(ValueError, match="exactly one string"):
            svc.submit(np.zeros((2, LENGTH), np.float32), text=["a", "b"])
        out = svc.submit_seed(2**32 - 1, length=LENGTH).result(timeout=120)
    assert out.shape == (2, LENGTH)
    prim = np.zeros((2, LENGTH), np.float32)
    sig = serve_mod._signature
    assert sig(prim, {"embedding_scale": 5}, 2) == sig(
        prim, {"embedding_scale": 5.0}, 2)
    assert sig(prim, {"flag": True}, 2) != sig(prim, {"flag": 1}, 2)
    assert sig(prim, {}, 2) == sig(torch.from_numpy(prim).numpy(), {}, 2)


def test_text_conditional_serving():
    """Different prompts share one batch; the worker's text= goes through
    the net's text encoder."""
    model = DiffusionModel(
        net_t=UNetV0, device="cpu", in_channels=2, channels=[8, 16],
        factors=[1, 2], items=[1, 1], attentions=[0, 1],
        cross_attentions=[0, 1], attention_heads=2, attention_features=8,
        modulation_features=32, use_text_conditioning=True,
        use_embedding_cfg=True, embedding_max_length=8,
        embedding_features=16,
        text_encoder=StubTextEncoder(max_length=8, features=16))
    noise = noises(1)[0]
    with GenerationService(model, num_steps=2, batch_size=2,
                           max_wait_ms=200.0) as svc:
        f1 = svc.submit(noise, text="a dog barking", embedding_scale=3.0)
        f2 = svc.submit(noise, text=["rain"], embedding_scale=3.0)
        o1, o2 = f1.result(timeout=300), f2.result(timeout=300)
    assert svc.stats["batches"] == 1
    assert np.isfinite(o1).all() and np.abs(o1 - o2).max() > 0
    want = model.sample(torch.from_numpy(np.stack([noise, noise])),
                        num_steps=2, text=["a dog barking", "rain"],
                        embedding_scale=3.0).numpy()
    np.testing.assert_array_equal(np.stack([o1, o2]), want)


def test_serves_upsampler_and_autoencoder_decode():
    up = DiffusionUpsampler(net_t=UNetV0, device="cpu", upsample_factor=2,
                            **TINY)
    low = noises(1)[0][:, :128]
    with GenerationService(up, num_steps=2, batch_size=2,
                           max_wait_ms=10.0) as svc:
        out = svc.submit(low).result(timeout=120)
    assert out.shape == (2, LENGTH) and np.isfinite(out).all()
    ae = DiffusionAE(net_t=UNetV0, in_channels=2, inject_depth=2,
                     encoder=MelEncoder1d(
                         in_channels=2, channels=32, out_channels=4,
                         factors=[2], num_blocks=[1], mel_channels=16,
                         mel_n_fft=64, mel_sample_rate=16000, device="cpu"),
                     channels=[8, 16, 32], factors=[1, 4, 8],
                     items=[1, 1, 1], modulation_features=32, device="cpu")
    audio = torch.from_numpy(np.stack(noises(1, 3))) * 0.1
    latent = ae.encode(audio)
    q = quantize_params(ae.params, min_size=256)  # the encoder's too
    assert any(hasattr(v, "qscale") for k, v in q.items()
               if k.startswith("encoder/"))
    with GenerationService(ae, num_steps=2, batch_size=2, method="decode",
                           max_wait_ms=10.0, params=q) as svc:
        out = svc.submit(latent[0]).result(timeout=120)
    assert out.shape == (2, LENGTH) and np.isfinite(out).all()
    want = ae.decode(latent[:1].repeat(2, 1, 1), params=q, num_steps=2,
                     generator=torch.Generator().manual_seed(0))
    assert want.shape == (2, 2, LENGTH)
    assert torch.isfinite(ae.encode(audio, params=q)).all()


def test_service_worker_runs_in_inference_mode(pair):
    """Grad mode is thread-local: the worker sets inference mode itself."""
    _, model = pair
    seen = {}
    real = model.sample

    def spy(*args, **kwargs):
        seen["inference"] = torch.is_inference_mode_enabled()
        seen["thread"] = threading.current_thread() is not \
            threading.main_thread()
        return real(*args, **kwargs)

    model.sample = spy
    try:
        with GenerationService(model, num_steps=1, batch_size=1) as svc:
            svc.submit(noises(1)[0]).result(timeout=60)
    finally:
        del model.sample
    assert seen == {"inference": True, "thread": True}


class _StubModel:
    """A model whose sample halves its input."""

    device = torch.device("cpu")

    def sample(self, x, num_steps, **kwargs):
        return x * 0.5


STAGES = ("assemble_s", "dispatch_s", "device_wait_s", "reply_s")


@pytest.mark.parametrize("case", ["timeline", "capped", "profiled"])
def test_stats_recent_batches(case):
    """``stats["recent_batches"]``: one JSON-ready dict per batch, oldest
    first, with each request's queue wait, the four stage times and the
    batch's steps; at most the last 64; ``profiled`` where a torch profiler
    ran at the batch's start."""
    import json

    from torch.profiler import ProfilerActivity, profile

    x = np.ones((2, 8), np.float32)
    if case == "timeline":
        with GenerationService(_StubModel(), num_steps=3, batch_size=2,
                               max_wait_ms=20.0) as svc:
            futs = [svc.submit(x) for _ in range(3)]
            outs = [f.result(timeout=30) for f in futs]
        assert all(np.array_equal(o, x * 0.5) for o in outs)
        stats = json.loads(json.dumps(svc.stats))
        recent = stats["recent_batches"]
        assert stats["batches"] == len(recent) >= 2
        assert sum(b["requests"] for b in recent) == 3
        for b in recent:
            assert b["num_steps"] == 3 and b["profiled"] is False
            assert b["requests"] + b["padded"] == 2
            assert len(b["queue_wait_s"]) == b["requests"]
            assert all(0.0 <= w < 30.0 for w in b["queue_wait_s"])
            assert all(isinstance(b[k], float) and 0.0 <= b[k] < 30.0
                       for k in STAGES)
    elif case == "capped":
        cap = GenerationService.RECENT_BATCHES
        with GenerationService(_StubModel(), batch_size=1,
                               max_wait_ms=1.0) as svc:
            for f in [svc.submit(x, num_steps=i + 1)
                      for i in range(cap + 6)]:
                f.result(timeout=30)
        recent = svc.stats["recent_batches"]
        assert svc.stats["batches"] == cap + 6 and len(recent) == cap
        assert [b["num_steps"] for b in recent] == list(range(7, cap + 7))
    else:
        with GenerationService(_StubModel(), num_steps=2, batch_size=1,
                               max_wait_ms=1.0) as svc:
            svc.submit(x).result(timeout=30)
            with profile(activities=[ProfilerActivity.CPU]):
                svc.submit(x).result(timeout=30)
            svc.submit(x).result(timeout=30)
        assert [b["profiled"] for b in svc.stats["recent_batches"]] == [
            False, True, False]
