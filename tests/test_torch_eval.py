"""The port's evaluation (audio_diffusion_torch.eval and .embed) against
the JAX package's on the CPU: the metrics on the same numpy inputs, the
embedder's ``embed`` and one AdamW step of its ``train`` with the same
parameters (carried across by ``convert.embedder_params_from_flax``) and
the JAX package's draws fed through ``diffusion/noise.py``; the port's
``train`` separating the files, and a ``save``/``load`` round trip. The
embedder is the tiny one of tests/test_embed.py.

Tolerances. The metrics are the same numpy code: equal to 1e-12. The
embedder in float32: ``embed`` max-abs ≤ 1e-5 (both units vectors; the
convs and the mel sum in another order), at a crop of 1,088 samples whose
17 mel frames make the SAME padding of both strided convs asymmetric. One
AdamW step (lr 3e-4, decay 1e-4): Adam's first step is about
−lr·sign(g), so where |g| exceeds 1e-3 of its leaf's largest (and 1e-6 of
the gradient norm) every parameter is within 1e-6 of optax's, and
elsewhere, where a sign may differ, within 2·lr (the bars of
tests/test_torch_train.py).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_diffusion_tpu.eval as jax_eval
from audio_diffusion_tpu import CorpusEmbedder as JaxEmbedder
from audio_diffusion_tpu import (
    frechet_embedding_distance as jax_frechet_embedding_distance)
import audio_diffusion_torch.embed as port_embed
from audio_diffusion_torch import CorpusEmbedder, frechet_embedding_distance
from audio_diffusion_torch import eval as port_eval
from audio_diffusion_torch.convert import (embedder_params_from_flax,
                                           embedder_params_to_flax)
from audio_diffusion_torch.diffusion import noise as port_noise

torch.set_num_threads(2)

SR = 8000
CROP = 1088  # 17 mel frames: odd, so SAME pads one more on the right
LR = 3e-4  # CorpusEmbedder.train's default, as the JAX package's
TINY = dict(features=8, sample_rate=SR, crop=CROP, n_mels=24, n_fft=256,
            hop=64, widths=(24, 32))


def toy_corpus(n_files=6, frames=4096, seed=0):
    """Tones at distinct pitches and one noise file (tests/test_embed.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / SR
    files = [(0.4 * (np.sin(2 * np.pi * 120 * (i + 1) * t) + 0.3 * np.sin(
        2 * np.pi * 2.7 * 120 * (i + 1) * t))).astype(np.float32)
        for i in range(n_files - 1)]
    files.append(rng.standard_normal(frames).astype(np.float32) * 0.2)
    return np.stack(files)[:, None, :]


def metric_inputs():
    rs = np.random.default_rng(3)
    a = (rs.standard_normal((6, 2, 4096)) * 0.3).astype(np.float32)
    b = (rs.standard_normal((5, 2, 4096)) * 0.1).astype(np.float32)
    return a, b


METRICS = {
    "band_profile": lambda m, a, b: m.band_profile(a, SR),
    "band_profile_fifths": lambda m, a, b: m.band_profile(
        b[0], SR, fmin=40.0, bands_per_octave=5),
    "band_distance": lambda m, a, b: m.band_distance(
        m.band_profile(a, SR), m.band_profile(b, SR)),
    "frechet_band_distance": lambda m, a, b: m.frechet_band_distance(
        a, b, SR),
    "frechet_gaussian": lambda m, a, b: m._frechet_gaussian(
        a.reshape(6, -1)[:, :12].astype(np.float64),
        b.reshape(5, -1)[:, :12].astype(np.float64), ridge=0.0,
        shrinkage=1e-3),
    "pairwise_diversity": lambda m, a, b: m.pairwise_diversity(a, SR),
    "log_spectral_distance": lambda m, a, b: m.log_spectral_distance(
        a[0], a[1]),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    a, b = metric_inputs()
    got = METRICS[name](port_eval, a, b)
    want = METRICS[name](jax_eval, a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_frechet_embedding_distance_matches_jax():
    rs = np.random.default_rng(4)
    a, b = rs.standard_normal((10, 8)), rs.standard_normal((9, 8)) + 0.3
    got = frechet_embedding_distance(a, b)
    assert got == pytest.approx(jax_frechet_embedding_distance(a, b),
                                abs=1e-12)
    assert frechet_embedding_distance(a, a) == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(AssertionError, match=">= 2"):
        frechet_embedding_distance(a[:1], b)


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX embedder, its parameters for 6 classes (Flax init from a
    key) and the port embedder."""
    emb = JaxEmbedder(**TINY)
    key = jax.random.key(0)
    params = emb._build(6).init(key, emb._mel_mono(
        jnp.asarray(toy_corpus()[:1, :, :CROP])))
    return emb, key, params, CorpusEmbedder(device="cpu", **TINY)


def test_embed_matches_jax_at_odd_frames(jax_pair):
    emb, _, params, port = jax_pair
    audio = np.random.default_rng(5).standard_normal((3, 2, 2 * CROP + 100))
    audio = (audio * 0.3).astype(np.float32)
    assert port._mel_mono(torch.from_numpy(audio[..., :CROP])).shape[-1] \
        == 17
    want = emb.embed(params, audio)
    got = port.embed(embedder_params_from_flax(params), audio)
    assert got.shape == want.shape == (3, 8)
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_embedder_params_roundtrip_strict(jax_pair):
    _, _, params, _ = jax_pair
    state = embedder_params_from_flax(params)
    assert sorted(state) == ["Conv_0.bias", "Conv_0.weight", "Conv_1.bias",
                             "Conv_1.weight", "Dense_0.bias",
                             "Dense_0.weight", "Dense_1.weight"]
    assert tuple(state["Conv_0.weight"].shape) == (24, 24, 5)  # [out, in, k]
    back = embedder_params_to_flax(state)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    extra = {"params": {**params["params"], "Conv_0": {
        **params["params"]["Conv_0"], "stray": np.zeros(2)}}}
    with pytest.raises(ValueError, match="unconsumed"):
        embedder_params_from_flax(extra)
    with pytest.raises(ValueError, match="unexpected"):
        embedder_params_to_flax({**state, "Conv_0.scale": state[
            "Conv_0.bias"]})


def test_one_adamw_step_matches_optax(jax_pair, monkeypatch):
    """``train(steps=1)`` from the JAX init: the JAX step's draws (file
    index and crop position from the folded key) fed through the hooks,
    the initial parameters put in place of the port's init."""
    emb, key, params, port = jax_pair
    corpus = toy_corpus()
    want = embedder_params_from_flax(emb.train(corpus, key=key, steps=1,
                                               batch=4))
    kf, kp = jax.random.split(jax.random.fold_in(key, 0))
    draws = [np.array(jax.random.randint(kf, (4,), 0, 6)),
             np.array(jax.random.randint(kp, (4,), 0,
                                         corpus.shape[-1] - CROP + 1))]

    def randint(generator, low, high, shape, device):
        a = torch.from_numpy(draws.pop(0)).to(torch.int64)
        assert tuple(a.shape) == tuple(shape) and int(a.max()) < high
        return a

    start = embedder_params_from_flax(params)

    def init_from_jax(net, generator):
        net.load_state_dict(start, strict=True)

    grads = {}

    class Recording(torch.optim.AdamW):
        def step(self, closure=None):
            names = dict(zip(map(id, self.param_groups[0]["params"]),
                             start))
            grads.update({names[id(p)]: p.grad.detach().clone()
                          for p in self.param_groups[0]["params"]})
            return super().step(closure)

    monkeypatch.setattr(port_noise, "randint", randint)
    monkeypatch.setattr(port_embed, "init_module", init_from_jax)
    monkeypatch.setattr(torch.optim, "AdamW", Recording)
    got = port.train(corpus, steps=1, batch=4)
    assert not draws and sorted(got) == sorted(want) == sorted(grads)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()])))
    for name, w in want.items():
        diff = (got[name] - w).abs()
        assert not torch.equal(w, start[name]), name
        assert float(diff.max()) <= 2 * LR + 1e-6, name
        # Adam's first step is about −lr·sign(g): the sign is beyond the
        # rounding where |g| clears 1e-3 of its leaf's largest.
        g = grads[name].abs()
        clear = g > max(1e-3 * float(g.max()), 1e-6 * norm)
        assert bool(clear.any()), name
        assert float(diff[clear].max()) <= 1e-6, name


def test_train_separates_files_and_embeds_unit_vectors():
    corpus = toy_corpus()
    emb = CorpusEmbedder(device="cpu", **dict(TINY, crop=1024))
    params = emb.train(corpus, generator=torch.Generator().manual_seed(0),
                       steps=150, batch=16)
    feats = emb.embed(params, corpus[:, :, :2048])
    assert feats.shape == (6, 8)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0,
                               atol=1e-4)
    a = emb.embed(params, corpus[:, :, :1024])
    b = emb.embed(params, corpus[:, :, 1024:2048])
    same = np.mean(np.sum(a * b, -1))
    cross = np.mean([np.dot(a[i], b[j]) for i, j in
                     itertools.permutations(range(6), 2)])
    assert same > cross + 0.1, (same, cross)


def test_save_load_roundtrip(tmp_path):
    corpus = toy_corpus()
    emb = CorpusEmbedder(device="cpu", **TINY)
    params = emb.train(corpus, steps=3, batch=8)
    before = emb.embed(params, corpus[:, :, :CROP])
    emb.save(params, tmp_path / "emb.pt")
    again = CorpusEmbedder(device="cpu", **TINY)
    restored = again.load(tmp_path / "emb.pt", num_classes=6)
    assert all(torch.equal(restored[k], v) for k, v in params.items())
    np.testing.assert_array_equal(again.embed(restored, corpus[:, :, :CROP]),
                                  before)
    with pytest.raises(RuntimeError, match="size mismatch"):
        CorpusEmbedder(device="cpu", **TINY).load(tmp_path / "emb.pt",
                                                  num_classes=5)


def test_embedder_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        assert CorpusEmbedder(**TINY).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CorpusEmbedder(**TINY)
