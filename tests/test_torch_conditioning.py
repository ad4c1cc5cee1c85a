"""The port's conditioned U-Net (cross-attention, context injection and
classifier-free guidance) and its text routing, against the JAX package on
the 3-level, 256-sample net of tests/test_torch_unet.py with
``cross_attentions=[0, 0, 1]``, ``context_channels=[0, 0, 5]`` and CFG over
an 8 × 32 embedding, as in tests/test_parity_full_model.py. Weights are a
seeded numpy tree in the JAX layout, carried across by ``params_from_jax``;
inputs are seeded numpy.

Bars: the f32 forward max-abs < 1e-3 and MSE < 1e-8, the guided forward
(scale 3) max-abs < 5e-3, and a 4-step guided sample MSE ≤ 1e-6 (the bars of
test_parity_full_model.py); bf16 the bar of test_torch_unet.py (max-abs
0.125, MSE 3e-4).
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.ops.net import cast_inference_params as jax_cast
from audio_diffusion_tpu.ops.text import StubTextEncoder as JaxStub
from audio_diffusion_torch import (UNetV0, cast_inference_params,
                                   params_to_jax, presets)
from audio_diffusion_torch.ops.text import StubTextEncoder
from audio_diffusion_torch.ops.unet import ClassifierFreeGuidanceWrapper
from test_torch_unet import (CFG, LENGTH, cond_inputs, jax_net_and_params,
                             port_model)

torch.set_num_threads(2)

COND = dict(cross_attentions=[0, 0, 1], context_channels=[0, 0, 5],
            use_embedding_cfg=True, embedding_max_length=8,
            embedding_features=32)


def to_torch(kw):
    """jnp conditioning kwargs -> torch tensors (None stays None)."""
    def conv(v):
        if isinstance(v, list):
            return [conv(t) for t in v]
        return None if v is None else torch.from_numpy(np.array(v))
    return {k: conv(v) for k, v in kw.items()}


@pytest.fixture(scope="module")
def pair():
    """(the JAX net's jitted apply, its config, its tree, the port model)."""
    net, cfg, tree = jax_net_and_params(seed=11, **COND)
    apply = jax.jit(net.apply, static_argnames=("embedding_scale",
                                                "embedding_mask_proba"))
    return apply, cfg, tree, port_model(cfg, tree)


def inputs(seed, batch=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 2, LENGTH).astype(np.float32)
    return x, cond_inputs({**CFG, **COND}, batch=batch, rs=rs)


def port_apply(model, x, sigma, params=None, **kw):
    with torch.inference_mode():
        return model.net.apply(
            model.params if params is None else params, torch.from_numpy(x),
            torch.full((x.shape[0],), sigma), **kw).numpy()


def test_forward_parity_conditioned_f32(pair):
    apply, cfg, tree, model = pair
    x, cond = inputs(1)
    for sigma in (0.1, 0.5, 0.9):
        want = np.asarray(apply(tree, jnp.asarray(x),
                                jnp.full((2,), sigma, jnp.float32), **cond))
        got = port_apply(model, x, sigma, **to_torch(cond))
        assert np.abs(got - want).max() < 1e-3, sigma
        assert np.mean((got - want) ** 2) < 1e-8, sigma


def test_guided_forward_parity(pair):
    apply, cfg, tree, model = pair
    x, cond = inputs(2)
    want = np.asarray(apply(
        tree, jnp.asarray(x), jnp.full((2,), 0.3, jnp.float32),
        embedding_scale=3.0, **cond))
    got = port_apply(model, x, 0.3, embedding_scale=3.0, **to_torch(cond))
    assert np.abs(got - want).max() < 5e-3
    plain = port_apply(model, x, 0.3, **to_torch(cond))
    assert np.abs(got - plain).max() > 1e-3  # guidance changed the output


def test_no_embedding_uses_fixed_embedding(pair):
    apply, cfg, tree, model = pair
    x, cond = inputs(3)
    channels = to_torch(cond)["channels"]
    fixed = model.params["inner.fixed_embedding"].detach()
    got = port_apply(model, x, 0.4, channels=channels)
    want = port_apply(model, x, 0.4, channels=channels,
                      embedding=fixed[None].expand(2, -1, -1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("proba", [0.0, 1.0])
def test_mask_proba_0_and_1_match_jax(pair, proba):
    """p = 0 keeps every row's embedding and p = 1 replaces every row's with
    the fixed one, in both packages: deterministic, whatever the stream."""
    apply, cfg, tree, model = pair
    x, cond = inputs(4)
    want = np.asarray(apply(tree, jnp.asarray(x),
                            jnp.full((2,), 0.6, jnp.float32),
                            embedding_mask_proba=proba,
                            key=jax.random.key(0), **cond))
    tcond = to_torch(cond)
    got = port_apply(model, x, 0.6, embedding_mask_proba=proba,
                     generator=torch.Generator().manual_seed(0), **tcond)
    assert np.abs(got - want).max() < 1e-3
    assert np.mean((got - want) ** 2) < 1e-8
    if proba == 1.0:
        tcond.pop("embedding")
    np.testing.assert_array_equal(got, port_apply(model, x, 0.6, **tcond))


def test_mask_half_is_per_row_and_seeded(pair):
    apply, cfg, tree, model = pair
    x, cond = inputs(5, batch=8)
    tcond = to_torch(cond)
    drawn = []
    draw = ClassifierFreeGuidanceWrapper.draw_mask

    def spy(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ClassifierFreeGuidanceWrapper, "draw_mask",
                   staticmethod(spy))
        got = port_apply(model, x, 0.5, embedding_mask_proba=0.5,
                         generator=torch.Generator().manual_seed(3), **tcond)
    mask = drawn[0].reshape(-1).numpy()
    assert drawn[0].shape == (8, 1, 1) and 0 < mask.sum() < 8
    cond_out = port_apply(model, x, 0.5, **tcond)
    tcond.pop("embedding")
    fixed_out = port_apply(model, x, 0.5, **tcond)
    want = np.where(mask[:, None, None], fixed_out, cond_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The loss draws σ, the noise and the mask from its generator: the same
    # seed gives the same loss.
    xt = torch.from_numpy(x)
    emb, channels = to_torch(cond)["embedding"], tcond["channels"]
    losses = [model.loss(model.params, torch.Generator().manual_seed(9), xt,
                         embedding=emb, channels=channels,
                         embedding_mask_proba=0.5) for _ in range(2)]
    assert torch.equal(losses[0], losses[1])
    with pytest.raises(ValueError, match="generator"):
        port_apply(model, x, 0.5, embedding_mask_proba=0.5,
                   **to_torch(cond))


def test_guided_sample_parity(pair):
    apply, cfg, tree, model = pair
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **cfg)
    jax_model.params = {"net": tree}
    noise, cond = inputs(6)
    want = np.asarray(jax_model.sample(jnp.asarray(noise), num_steps=4,
                                       embedding_scale=3.0, **cond))
    got = model.sample(noise, num_steps=4, embedding_scale=3.0,
                       **to_torch(cond)).numpy()
    assert np.mean((got - want) ** 2) <= 1e-6


def test_bf16_guided_forward():
    """In bf16 the guided output is, bit for bit, out_fixed + s·(out −
    out_fixed) of its two passes, and each pass stays within the bf16 bar of
    the JAX package's. (Against JAX's guided output the gap grows with s:
    the passes' gaps enter as s and s − 1, past the one-pass bar at
    s = 3.)"""
    net, cfg, tree = jax_net_and_params(seed=12, dtype=jnp.bfloat16, **COND)
    model = port_model({**CFG, **COND}, tree, dtype=torch.bfloat16)
    x, cond = inputs(7)
    params = cast_inference_params(model.params, torch.bfloat16)
    jax_params = jax_cast(tree, jnp.bfloat16)
    # The fixed embedding is rounded to bf16 with the rest, as in JAX.
    assert params["inner.fixed_embedding"].dtype == torch.bfloat16
    assert jax_params["inner"]["fixed_embedding"].dtype == jnp.bfloat16
    apply = jax.jit(net.apply)
    sig = jnp.full((2,), 0.5, jnp.float32)
    fixed_cond = {"channels": cond["channels"]}
    passes = []
    for kw in (cond, fixed_cond):
        want = np.asarray(apply(jax_params, jnp.asarray(x), sig, **kw))
        got = port_apply(model, x, 0.5, params=params, **to_torch(kw))
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 0.125
        assert np.mean((got - want) ** 2) < 3e-4
        passes.append(got)
    out, out_fixed = passes
    guided = port_apply(model, x, 0.5, params=params, embedding_scale=3.0,
                        **to_torch(cond))
    np.testing.assert_array_equal(guided, out_fixed + 3.0 * (out - out_fixed))


def test_stub_text_encoder_matches_jax():
    texts = ["a dog barking", "rain on a roof", "", "x " * 80]
    for kw in (dict(), dict(max_length=8, features=32)):
        got = StubTextEncoder(**kw)(texts)
        want = JaxStub(**kw)(texts)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_text_routing(pair):
    apply, cfg, tree, model = pair
    stub = StubTextEncoder(max_length=8, features=32)
    text_model = port_model(cfg, tree, use_text_conditioning=True,
                            text_encoder=stub)
    assert text_model.net.text_encoder is stub
    noise, cond = inputs(8)
    tcond = to_torch(cond)
    tcond.pop("embedding")
    texts = ["a dog barking", "rain"]
    got = text_model.sample(noise, num_steps=2, text=texts,
                            embedding_scale=2.0, **tcond)
    want = text_model.sample(noise, num_steps=2, embedding_scale=2.0,
                             embedding=torch.from_numpy(stub(texts)), **tcond)
    assert torch.equal(got, want)
    loss = text_model(noise, text=texts, generator=torch.Generator(), **tcond)
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="not both"):
        text_model.sample(noise, num_steps=2, text=texts,
                          embedding=torch.from_numpy(stub(texts)), **tcond)
    with pytest.raises(ValueError, match="use_text_conditioning"):
        model.sample(noise, num_steps=2, text=texts, **tcond)


def test_missing_conditioning_raises(pair):
    apply, cfg, tree, model = pair
    x, cond = inputs(9)
    tcond = to_torch(cond)
    with pytest.raises(ValueError, match="context_channels"):
        port_apply(model, x, 0.5, embedding=tcond["embedding"])
    bad = [None, None, tcond["channels"][2][..., :16]]
    with pytest.raises(ValueError, match="context length"):
        port_apply(model, x, 0.5, embedding=tcond["embedding"], channels=bad)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # generator= is not an unused kwarg
        port_apply(model, x, 0.5, generator=torch.Generator(), **tcond)


def test_text_conditional_preset_builds_with_jax_names():
    """TEXT_CONDITIONAL_48K with the stub encoder builds (on the meta
    device: no memory), and its parameters are the JAX init's, name for name
    and shape for shape."""
    stub = StubTextEncoder()
    net = UNetV0(dim=1, device="meta", text_encoder=stub,
                 **presets.TEXT_CONDITIONAL_48K)
    assert net.text_encoder is stub
    cfg = {k: v for k, v in presets.TEXT_CONDITIONAL_48K.items()
           if k != "use_text_conditioning"}
    jax_net = JaxUNetV0(dim=1, **cfg)
    shapes = jax.eval_shape(lambda: jax_net.module.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 2, 4096)),
        jnp.zeros((1,)), embedding=jnp.zeros((1, 64, 768))))["params"]
    want = {jax.tree_util.keystr(p): tuple(s.shape)
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    probe = {k: torch.zeros(0) for k in net.module.state_dict()}
    paths = jax.tree_util.tree_flatten_with_path(params_to_jax(probe))[0]
    assert {jax.tree_util.keystr(p) for p, _ in paths} == set(want)
    for name, p in net.module.state_dict().items():
        path = name.split(".")
        shape = tuple(p.shape)
        if path[-1] == "weight":
            path[-1], shape = "kernel", shape[::-1]
        assert want["".join(f"['{k}']" for k in path)] == shape, name


def test_text_conditioning_without_encoder_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.*T5"):
        UNetV0(dim=1, device="cpu", use_text_conditioning=True,
               **{**CFG, **COND})
    with pytest.raises(ValueError, match="embedding_max_length"):
        UNetV0(dim=1, device="cpu", **{**CFG, **COND,
                                       "embedding_max_length": None})
    with pytest.raises(ValueError, match="embedding_features"):
        UNetV0(dim=1, device="cpu", **CFG, cross_attentions=[0, 0, 1])


def test_conditioned_gradients_match_jax(pair):
    """Every gradient of the v-loss (σ and noise from numpy) through
    cross-attention, context injection and CFG, against jax.grad of the same
    loss: within 1e-3 of its leaf's largest value plus 1e-6·grad_norm, the
    train-step bar of test_torch_train.py. With p = 1 every row's embedding
    is the fixed one, so it takes a gradient too."""
    from audio_diffusion_tpu.diffusion.core import alpha_beta as jax_ab
    from audio_diffusion_torch import params_from_jax
    from audio_diffusion_torch.diffusion.vdiffusion import v_loss

    apply, cfg, tree, model = pair
    proba = 1.0
    x, cond = inputs(10)
    rs = np.random.RandomState(11)
    noise = rs.randn(*x.shape).astype(np.float32)
    sigmas = rs.uniform(0.1, 0.9, size=(2,)).astype(np.float32)

    def jax_loss(params):
        alphas, betas = jax_ab(jnp.asarray(sigmas)[:, None, None])
        x_noisy = alphas * x + betas * noise
        v = apply(params, x_noisy, jnp.asarray(sigmas),
                  embedding_mask_proba=proba, key=jax.random.key(0), **cond)
        return jnp.mean((v - (alphas * noise - betas * x)) ** 2)

    want = params_from_jax(jax.grad(jax_loss)(tree))
    params = model.params
    loss = v_loss(model.net, params, torch.from_numpy(x),
                  torch.from_numpy(sigmas), torch.from_numpy(noise),
                  embedding_mask_proba=proba,
                  generator=torch.Generator().manual_seed(0),
                  **to_torch(cond))
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    norm = math.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item() + 1e-6 * norm, name
    assert got["inner.fixed_embedding"].any()
