"""The port's T5 encoder stack (``ops.t5``) and ``RandomT5TextEncoder``
against transformers' ``FlaxT5EncoderModel``, the model the JAX package's
``RandomT5TextEncoder`` builds, with the Flax weights carried across by
``convert.t5_params_from_flax``; and the text-conditional path through the
port's encoder against the JAX package's on the net of
tests/test_conditioning.py.

Bars: token ids bit for bit; the encoder's f32 output max-abs ≤
1e-5·max|y|, padded rows exactly 0, the dtype of the JAX package's (float64:
its f32 output times an int32 mask); the train loss with embedding dropout
0 rel 1e-5; a 2-step guided sample max-abs 5e-3 (the guided bar of
tests/test_torch_conditioning.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu.diffusion.core import alpha_beta as jax_alpha_beta
from audio_diffusion_tpu.ops.text import RandomT5TextEncoder as JaxT5
from audio_diffusion_torch import DiffusionModel, UNetV0, params_from_jax
from audio_diffusion_torch.convert import t5_params_from_flax
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from audio_diffusion_torch.ops.t5 import T5EncoderStack
from audio_diffusion_torch.ops.text import RandomT5TextEncoder
from test_conditioning import COND, EMB_FEATURES, EMB_LENGTH, LENGTH
from test_torch_unet import jax_net_and_params

torch.set_num_threads(2)

CAPTIONS = ["a dog barking", "", "pluie fine sur le toit, très douce",
            "x" * 20 + " longer than the encoder's max_length of sixteen",
            "é漢字"]


@pytest.fixture(scope="module")
def encoders():
    """(JAX's encoder, the port's with the Flax weights)."""
    jax_enc = JaxT5(max_length=16, features=32, num_layers=2, num_heads=4,
                    seed=3)
    enc = RandomT5TextEncoder(max_length=16, features=32, num_layers=2,
                              num_heads=4, device="cpu")
    enc.stack.load_state_dict(t5_params_from_flax(jax_enc._model.params),
                              strict=True)
    return jax_enc, enc


def test_tokenizer_matches_jax(encoders):
    jax_enc, enc = encoders
    got, want = enc._tokenize(CAPTIONS), jax_enc._tokenize(CAPTIONS)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and got[3].all()  # empty; truncated to 16 bytes


def test_stack_matches_flax(encoders):
    jax_enc, enc = encoders
    want, got = jax_enc(CAPTIONS), enc(CAPTIONS)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == (len(CAPTIONS), 16, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    pad = enc._tokenize(CAPTIONS) == 0
    assert (got[pad] == 0).all() and (np.abs(got[~pad]).max(-1) > 0).all()


def test_relative_position_buckets_match_flax():
    """The bidirectional buckets (32, max distance 128) at every offset of
    a 512-token sequence, against Flax's."""
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention
    from audio_diffusion_torch.ops.t5 import relative_position_bucket

    pos = np.arange(512)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(FlaxT5Attention._relative_position_bucket(
        jnp.asarray(rel, jnp.int32)))
    got = relative_position_bucket(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, want)


def test_t5_params_from_flax_is_strict(encoders):
    jax_enc, _ = encoders
    params = jax.tree_util.tree_map(np.asarray, jax_enc._model.params)
    state = t5_params_from_flax({"params": params})
    assert set(state) == set(T5EncoderStack(d_model=32, d_ff=64, num_layers=2,
                                            device="cpu").state_dict())
    leftover = {**params, "extra": {"kernel": np.zeros(1)}}
    with pytest.raises(ValueError, match="unconsumed"):
        t5_params_from_flax(leftover)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["encoder"]["block"]["1"]["layer"]["1"]["DenseReluDense"]["wo"]
    with pytest.raises(ValueError, match="missing"):
        t5_params_from_flax(missing)
    # Only block 0 holds the relative-position bias.
    moved = jax.tree_util.tree_map(lambda a: a, params)
    sa = moved["encoder"]["block"]["1"]["layer"]["0"]["SelfAttention"]
    sa["relative_attention_bias"] = {"embedding": np.zeros((32, 4))}
    with pytest.raises(ValueError, match="unconsumed"):
        t5_params_from_flax(moved)


def test_random_weights_follow_flax_initializers():
    """One seed gives the same weights wherever the stack runs; each weight
    has the standard deviation of its Flax initializer."""
    a = RandomT5TextEncoder(max_length=8, features=64, num_heads=4,
                            device="cpu", seed=1)
    b = RandomT5TextEncoder(max_length=8, features=64, num_heads=4,
                            device="cpu", seed=1)
    for (name, p), q in zip(a.stack.state_dict().items(),
                            b.stack.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.stack.state_dict()
    inner = 64
    for name, std in [("shared.weight", 1.0),
                      ("encoder.block.0.layer.1.DenseReluDense.wi.weight",
                       64 ** -0.5),
                      ("encoder.block.0.layer.0.SelfAttention.q.weight",
                       (inner * 16) ** -0.5)]:
        assert sd[name].std().item() == pytest.approx(std, rel=0.1), name
    assert (sd["encoder.final_layer_norm.weight"] == 1).all()


def test_process_cond_casts_float64_to_float32(encoders):
    """``text=`` through an encoder that returns float64 (this one does, as
    JAX's does) reaches the net as float32, as jnp.asarray with x64 off
    gives it."""
    _, enc = encoders
    model = DiffusionModel(device="cpu", text_encoder=enc,
                           **{**COND, "net_t": UNetV0,
                              "embedding_max_length": 16})
    cond = model._process_cond({"text": ["rain"]})
    assert cond["embedding"].dtype == torch.float32
    assert cond["embedding"].shape == (1, 16, EMB_FEATURES)


@pytest.fixture(scope="module")
def conditioned():
    """The net of tests/test_conditioning.py (cross-attention at levels 1
    and 2, CFG) in both packages with one seeded tree, and the JAX test's
    encoder (one layer) with its Flax weights in both."""
    jax_enc = JaxT5(max_length=EMB_LENGTH, features=EMB_FEATURES,
                    num_layers=1, num_heads=4, seed=0)
    enc = RandomT5TextEncoder(max_length=EMB_LENGTH, features=EMB_FEATURES,
                              num_layers=1, num_heads=4, device="cpu")
    enc.stack.load_state_dict(t5_params_from_flax(jax_enc._model.params))
    cfg = {k: v for k, v in COND.items() if k not in ("net_t",)}
    net, _, tree = jax_net_and_params(seed=12, **{
        k: v for k, v in cfg.items() if k != "use_text_conditioning"})
    jax_model = JaxDiffusionModel(text_encoder=jax_enc, **COND)
    jax_model.params = {"net": tree}
    model = DiffusionModel(device="cpu", text_encoder=enc, **cfg,
                           net_t=UNetV0)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)
    return net, jax_model, model


def test_real_t5_architecture_text_path(conditioned):
    """tests/test_conditioning.py::test_real_t5_architecture_text_path
    through the port: the train loss (embedding dropout 0; σ and noise from
    numpy) and a 2-step guided sample, against the JAX package with the
    same encoder weights."""
    net, jax_model, model = conditioned
    texts = ["a dog barking", "rain"]
    rs = np.random.RandomState(4)
    audio = rs.randn(2, 2, LENGTH).astype(np.float32)
    noise = rs.randn(2, 2, LENGTH).astype(np.float32)
    sigmas = np.array([0.3, 0.7], np.float32)
    emb_j = jax_model._process_cond({"text": texts})["embedding"]
    assert emb_j.dtype == jnp.float32

    def jax_loss(p):
        a, b = jax_alpha_beta(jnp.asarray(sigmas)[:, None, None])
        x_noisy = a * audio + b * noise
        v = net.apply(p, x_noisy, jnp.asarray(sigmas), embedding=emb_j,
                      embedding_mask_proba=0.0)
        return jnp.mean((v - (a * noise - b * audio)) ** 2)

    want = float(jax.jit(jax_loss)(jax_model.params["net"]))
    emb = model._process_cond({"text": texts})["embedding"]
    np.testing.assert_allclose(emb.numpy(), np.asarray(emb_j), atol=1e-5)
    got = v_loss(model.net, model.params, torch.from_numpy(audio),
                 torch.from_numpy(sigmas), torch.from_numpy(noise),
                 embedding=emb, embedding_mask_proba=0.0).item()
    assert got == pytest.approx(want, rel=1e-5)

    start = rs.randn(2, 2, LENGTH).astype(np.float32)
    want = np.asarray(jax_model.sample(jnp.asarray(start), text=texts,
                                       embedding_scale=3.0, num_steps=2))
    out = model.sample(start, text=texts, embedding_scale=3.0, num_steps=2)
    assert out.shape == (2, 2, LENGTH) and torch.isfinite(out).all()
    assert np.abs(out.numpy() - want).max() <= 5e-3
