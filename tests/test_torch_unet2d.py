"""The port's 2-D U-Net (``UNetV0(dim=2)``, ``ops/unet2d.py::XUNet2d``)
against the JAX package's on the config of tests/test_parity_unet2d.py
(cross-attention, context injection at level 1, modulation), with the same
weights: a seeded numpy tree in the JAX layout, carried across by
``params_from_jax``. The helpers serve the 3-D and whole-slice files too.

Tolerances.
- float32: max-abs < 1e-3 and MSE < 1e-8, the bar of
  test_parity_full_model.py (measured max-abs 2.1e-6 at max|y| 3.7, MSE
  1.1e-13).
- bfloat16: the two packages round at the same points (flax's GroupNorm
  order, the conv's bias added to the rounded product), but XLA rounds
  SiLU's sigmoid and the product separately and sums a conv in another
  order, so the outputs differ by a few bf16 ulps of max|y|: measured
  max-abs 0.039 at max|y| 2.53 (bf16's ulp there is 2^-6, so 2.5 ulps)
  and MSE 8.0e-5; the bounds are four ulps of max|y| and MSE 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.ops import quant as jq
from audio_diffusion_tpu.ops.net import cast_inference_params as jax_cast
from audio_diffusion_torch import (DiffusionModel, QTensor, UNetV0,
                                   cast_inference_params, params_from_jax,
                                   params_to_jax, quantize_params)
from audio_diffusion_torch.ops.unet2d import XUNet2d

torch.set_num_threads(2)

ND_CFG = dict(in_channels=3, channels=[8, 16, 32], factors=[1, 2, 2],
              items=[1, 2, 1], attentions=[0, 0, 1],
              cross_attentions=[0, 0, 1], context_channels=[0, 8, 0],
              attention_heads=2, attention_features=8, resnet_groups=4,
              modulation_features=16, embedding_features=12)
SPATIAL = {2: (16, 16), 3: (8, 16, 16)}
EMBEDDING = (5, 12)


def nd_inputs(cfg, dim, seed, batch=2):
    """Seeded numpy (x, σ, conditioning) for a net built from ``cfg``:
    ``embedding`` where it cross-attends or has CFG, and ``channels`` with a
    [batch, ctx, *spatial_i] tensor at each injecting depth."""
    rs = np.random.RandomState(seed)
    f32 = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    x = f32(batch, cfg["in_channels"], *SPATIAL[dim])
    sigmas = rs.uniform(0.1, 0.9, size=(batch,)).astype(np.float32)
    cond = {}
    if any(cfg.get("cross_attentions") or []) or cfg.get("use_embedding_cfg"):
        cond["embedding"] = f32(batch, cfg.get("embedding_max_length",
                                               EMBEDDING[0]),
                                cfg["embedding_features"])
    if any(cfg.get("context_channels") or []):
        scale = np.cumprod(cfg["factors"])
        cond["channels"] = [
            f32(batch, c, *(s // k for s in SPATIAL[dim])) if c else None
            for c, k in zip(cfg["context_channels"], scale)]
    return x, sigmas, cond


def bf16_ulps(y, n=4):
    """``n`` bf16 ulps at max|y| (8 significant bits)."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7)


def to_jax(cond):
    return {k: ([None if c is None else jnp.asarray(c) for c in v]
                if isinstance(v, list) else jnp.asarray(v))
            for k, v in cond.items()}


def to_torch(cond):
    return {k: ([None if c is None else torch.from_numpy(c) for c in v]
                if isinstance(v, list) else torch.from_numpy(v))
            for k, v in cond.items()}


def jax_nd_net_and_tree(dim, seed=0, cfg=None, **overrides):
    """The JAX ``UNetV0(dim=dim)`` and a seeded random parameter tree of
    its shape (every leaf random, so the zero-initialized gates carry
    signal too)."""
    cfg = {**(ND_CFG if cfg is None else cfg), **overrides}
    net = JaxUNetV0(dim=dim, **cfg)
    x, sigmas, cond = nd_inputs(cfg, dim, 0)
    shapes = jax.eval_shape(lambda: net.module.init(
        {"params": jax.random.key(0)}, jnp.asarray(x),
        jnp.asarray(sigmas) if net.uses_sigma else None,
        **to_jax(cond)))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        a = rs.randn(*s.shape)
        if "freqs" in name:
            a = a * 16.0
        elif "scale" in name:
            a = 1.0 + 0.1 * a
        elif len(s.shape) >= 2:  # fan-in: every axis but the last
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return net, cfg, jax.tree_util.tree_map_with_path(leaf, shapes)


def port_nd_model(dim, cfg, tree, **kwargs):
    model = DiffusionModel(net_t=UNetV0, dim=dim, device="cpu", **cfg,
                           **kwargs)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)
    return model


def port_forward(model, x, sigmas, cond, params=None):
    with torch.inference_mode():
        return model.net.apply(
            model.params if params is None else params, torch.from_numpy(x),
            None if sigmas is None else torch.from_numpy(sigmas),
            **to_torch(cond)).numpy()


@pytest.fixture(scope="module")
def pair():
    net, cfg, tree = jax_nd_net_and_tree(2)
    return net, cfg, tree, port_nd_model(2, cfg, tree)


def test_forward_parity_f32(pair):
    net, cfg, tree, model = pair
    apply = jax.jit(net.apply)
    for seed in (1, 2):
        x, sigmas, cond = nd_inputs(cfg, 2, seed)
        want = np.asarray(apply(tree, jnp.asarray(x), jnp.asarray(sigmas),
                                **to_jax(cond)))
        got = port_forward(model, x, sigmas, cond)
        assert got.shape == x.shape
        assert np.abs(got - want).max() < 1e-3, seed
        assert np.mean((got - want) ** 2) < 1e-8, seed


def test_forward_parity_bf16():
    net, cfg, tree = jax_nd_net_and_tree(2, seed=1, dtype=jnp.bfloat16)
    model = port_nd_model(2, ND_CFG, tree, dtype=torch.bfloat16)
    x, sigmas, cond = nd_inputs(cfg, 2, 3)
    want = np.asarray(jax.jit(net.apply)(
        jax_cast(tree, jnp.bfloat16), jnp.asarray(x), jnp.asarray(sigmas),
        **to_jax(cond)))
    got = port_forward(model, x, sigmas, cond, params=cast_inference_params(
        model.params, torch.bfloat16))
    assert got.dtype == np.float32  # back in the input's dtype
    assert np.abs(got - want).max() <= bf16_ulps(want)
    assert np.mean((got - want) ** 2) < 2e-4


def test_forward_parity_no_modulation():
    """No modulation and no time conditioning: the skips are a Dense over
    cat([h, skip])."""
    net, cfg, tree = jax_nd_net_and_tree(
        2, seed=2, use_modulation=False, use_time_conditioning=False,
        cross_attentions=[0, 0, 0], context_channels=[0, 0, 0])
    model = port_nd_model(2, cfg, tree)
    assert set(tree["skip_0"]) == {"kernel", "bias"}
    x, _, _ = nd_inputs(cfg, 2, 4)
    want = np.asarray(jax.jit(net.apply)(tree, jnp.asarray(x)))
    got = port_forward(model, x, None, {})
    assert np.abs(got - want).max() < 1e-3
    assert np.mean((got - want) ** 2) < 1e-8


def test_guidance_with_embedding_matches_jax():
    """Classifier-free guidance (a batch-doubled pass) with embedding= at
    scale 3."""
    net, cfg, tree = jax_nd_net_and_tree(
        2, seed=3, use_embedding_cfg=True, embedding_max_length=5,
        context_channels=[0, 0, 0])
    model = port_nd_model(2, cfg, tree)
    x, sigmas, cond = nd_inputs(cfg, 2, 5)
    want = np.asarray(jax.jit(net.apply, static_argnames="embedding_scale")(
        tree, jnp.asarray(x), jnp.asarray(sigmas), embedding_scale=3.0,
        **to_jax(cond)))
    with torch.inference_mode():
        got = model.net.apply(model.params, torch.from_numpy(x),
                              torch.from_numpy(sigmas), embedding_scale=3.0,
                              **to_torch(cond)).numpy()
    assert np.abs(got - want).max() < 1e-3
    assert np.mean((got - want) ** 2) < 1e-8


def test_params_round_trip_and_strictness(pair):
    net, cfg, tree, model = pair
    state = params_from_jax(tree)
    assert len(state) == len(jax.tree_util.tree_leaves(tree))
    assert set(state) == set(model.net.module.state_dict())
    # A conv kernel keeps its JAX layout and name; a Dense kernel becomes
    # an nn.Linear weight.
    stack = tree["inner"]["items_down_1"]
    np.testing.assert_array_equal(
        state["inner.items_down_1.ResnetItem2d_1.Conv2d_0.Conv_0.kernel"],
        stack["ResnetItem2d_1"]["Conv2d_0"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(
        state["inner.items_down_1.Dense_1.weight"].numpy(),
        stack["Dense_1"]["kernel"].T)
    back = params_to_jax(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, tree))
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["inner"]["items_up_1"]["ModulationItem2d_0"]["stray"] = np.zeros(3)
    with pytest.raises(ValueError, match="stray"):
        params_from_jax(extra)
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["inner"]["proj_out"]["Conv_0"]["bias"]
    with pytest.raises(ValueError, match="bias"):
        params_from_jax(missing)
    with pytest.raises(ValueError, match="stray"):
        params_to_jax({**state, "inner.stray": torch.zeros(2)})


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_jax_bit_for_bit(pair, bits):
    """int8/int4 leaves of the port equal the JAX package's (quantized
    eagerly) bit for bit: 4-D conv kernels along Cout, Dense weights along
    their output rows."""
    net, cfg, tree, model = pair
    got = quantize_params(params_from_jax(tree), min_size=256, bits=bits)
    want = params_from_jax(jq.quantize_params(tree, min_size=256, bits=bits))
    assert set(got) == set(want)
    quantized = [n for n, v in want.items() if isinstance(v, QTensor)]
    assert any(n.endswith("Conv_0.kernel") for n in quantized)
    assert any(n.endswith(".weight") for n in quantized)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, QTensor):
            assert isinstance(g, QTensor), name
            assert (g.bits, g.channel_axis, g.shape) == (
                w.bits, w.channel_axis, w.shape), name
            assert torch.equal(g.q, w.q) and torch.equal(g.qscale,
                                                         w.qscale), name
        else:
            assert torch.equal(g, w), name


def test_default_init_matches_flax():
    """lecun-normal conv kernels with fan-in kh·kw·Cin, zero-initialized
    modulation and skip gates (the identity at init), unit GroupNorm
    scales."""
    model = DiffusionModel(net_t=UNetV0, dim=2, device="cpu", seed=5,
                           **ND_CFG)
    p = model.params
    k = p["inner.items_up_1.ResnetItem2d_1.Conv2d_1.Conv_0.kernel"]
    assert k.shape == (3, 3, 16, 16)
    std = np.sqrt(1.0 / (9 * 16))
    assert abs(k.std().item() - std) < 0.1 * std
    assert k.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not p["inner.items_down_0.ModulationItem2d_0.Dense_0.weight"].any()
    assert not p["inner.skip_1.weight"].any()
    assert torch.equal(p["inner.GroupNorm_0.scale"], torch.ones(8))
    x, sigmas, cond = nd_inputs(ND_CFG, 2, 6)
    assert np.isfinite(port_forward(model, x, sigmas, cond)).all()


def test_activations_stay_channels_last(pair):
    """Every conv reads a channels-last view and hands back a contiguous
    [B, H, W, C] activation: no NCHW copies around the convs."""
    net, cfg, tree, model = pair
    seen = []
    xunet = model.net.module.inner
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(
            (args[0].is_contiguous(), out.is_contiguous())))
        for name, m in xunet.named_modules() if name.endswith("Conv2d_0")]
    try:
        x, sigmas, cond = nd_inputs(cfg, 2, 7)
        port_forward(model, x, sigmas, cond)
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(a and b for a, b in seen)


def test_construction_errors_and_spatial_checks(pair):
    net, cfg, tree, model = pair
    with pytest.raises(ValueError, match="dim=1"):
        UNetV0(dim=2, device="cpu", use_pallas=True, **ND_CFG)
    with pytest.raises(ValueError, match="channel_change"):
        UNetV0(dim=2, device="cpu", channel_change="first_item",
               lane_fold=False, **ND_CFG)
    with pytest.raises(ValueError, match="dim must be"):
        UNetV0(dim=4, device="cpu", **ND_CFG)
    assert isinstance(model.net.module.inner, XUNet2d)
    x, sigmas, cond = nd_inputs(cfg, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        port_forward(model, x[..., :14], sigmas, cond)
    cond["channels"][1] = cond["channels"][1][..., :4]
    with pytest.raises(ValueError, match="context spatial"):
        port_forward(model, x, sigmas, cond)
