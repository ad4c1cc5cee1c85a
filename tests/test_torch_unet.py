"""The port's U-Net (audio_diffusion_torch) against the JAX package's UNetV0
on the 3-level config of tests/test_parity_full_model.py, with the same
weights: a seeded numpy tree in the JAX layout, carried across by
``params_from_jax``.

Tolerances. float32: max-abs < 1e-3 and MSE < 1e-8, the bar of
test_parity_full_model.py (measured: max-abs 2.2e-6, MSE 1.1e-13).
bfloat16: the two packages round at different points inside the resnet
items (the port follows the Pallas kernel's rounding, the JAX lax path
rounds the GroupNorm output and the conv bias in bf16), so the outputs
differ by a few bf16 ulps of max|y| = 4.25: measured max-abs 0.0625 and
MSE 1.2e-4; the bounds are max-abs 0.125 and MSE 3e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.ops.net import cast_inference_params as jax_cast
from audio_diffusion_torch import (DiffusionModel, UNetV0,
                                   cast_inference_params, params_from_jax)

torch.set_num_threads(2)

LENGTH = 256
CFG = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
           items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
           attention_features=8, modulation_features=64)


def jax_net_and_params(seed=0, length=LENGTH, **overrides):
    """The JAX net and a seeded random parameter tree of its shape (every
    leaf random, so the zero-initialized gates carry signal too)."""
    cfg = {**CFG, **overrides}
    net = JaxUNetV0(dim=1, **cfg)
    x = jnp.zeros((2, 2, length))
    sigmas = jnp.zeros((2,)) if net.uses_sigma else None
    shapes = jax.eval_shape(lambda: net.module.init(
        {"params": jax.random.key(0)}, x, sigmas))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        a = rs.randn(*s.shape)
        if "freqs" in name:
            a = a * 16.0
        elif "scale" in name:
            a = 1.0 + 0.1 * a
        elif len(s.shape) == 3:  # conv3 kernels [3, Cin, Cout]
            a = a / np.sqrt(3 * s.shape[1])
        elif len(s.shape) == 2:
            a = a / np.sqrt(s.shape[0])
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return net, cfg, jax.tree_util.tree_map_with_path(leaf, shapes)


def port_model(cfg, tree, **kwargs):
    model = DiffusionModel(net_t=UNetV0, device="cpu", **cfg, **kwargs)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    net, cfg, tree = jax_net_and_params()
    return net, tree, port_model(cfg, tree)


def test_forward_parity_f32(pair):
    net, tree, model = pair
    x = np.random.RandomState(1).randn(2, 2, LENGTH).astype(np.float32)
    apply = jax.jit(net.apply)
    for sigma in (0.0, 0.25, 0.5, 0.9):
        want = np.asarray(apply(tree, jnp.asarray(x),
                                jnp.full((2,), sigma, jnp.float32)))
        with torch.inference_mode():
            got = model.net.apply(model.params, torch.from_numpy(x),
                                  torch.full((2,), sigma)).numpy()
        assert np.abs(got - want).max() < 1e-3, sigma
        assert np.mean((got - want) ** 2) < 1e-8, sigma


def test_forward_parity_bf16():
    net, cfg, tree = jax_net_and_params(dtype=jnp.bfloat16)
    model = port_model(CFG, tree, dtype=torch.bfloat16)
    x = np.random.RandomState(2).randn(2, 2, LENGTH).astype(np.float32)
    want = np.asarray(jax.jit(net.apply)(
        jax_cast(tree, jnp.bfloat16), jnp.asarray(x),
        jnp.full((2,), 0.5, jnp.float32)))
    with torch.inference_mode():
        got = model.net.apply(
            cast_inference_params(model.params, torch.bfloat16),
            torch.from_numpy(x), torch.full((2,), 0.5))
    assert got.dtype == torch.float32  # back in the input's dtype
    got = got.numpy()
    assert np.abs(got - want).max() <= 0.125
    assert np.mean((got - want) ** 2) < 3e-4


def test_forward_parity_no_modulation():
    """SkipCat path: no modulation, no time conditioning."""
    net, cfg, tree = jax_net_and_params(
        seed=3, use_modulation=False, use_time_conditioning=False)
    model = port_model(cfg, tree)
    assert "skip_0" in tree and "kernel" in tree["skip_0"]
    x = np.random.RandomState(4).randn(2, 2, LENGTH).astype(np.float32)
    want = np.asarray(jax.jit(net.apply)(tree, jnp.asarray(x)))
    with torch.inference_mode():
        got = model.net.apply(model.params, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() < 1e-3
    assert np.mean((got - want) ** 2) < 1e-8


def test_params_from_jax_consumes_every_leaf(pair):
    net, tree, model = pair
    state = params_from_jax(tree)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(state) == n_leaves
    assert set(state) == set(model.net.module.state_dict())
    # Dense kernels [in, out] arrive as Linear weights [out, in].
    kernel = tree["inner"]["items_down_0"]["ResnetModItem_0"]["mod_dense"][
        "kernel"]
    np.testing.assert_array_equal(
        state["inner.items_down_0.ResnetModItem_0.mod_dense.weight"].numpy(),
        kernel.T)


def test_params_from_jax_rejects_leftovers(pair):
    net, tree, model = pair
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["inner"]["items_up_1"]["ResnetModItem_0"]["stray"] = np.zeros(3)
    with pytest.raises(ValueError, match="stray"):
        params_from_jax(extra)
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["inner"]["mystery_0"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="mystery_0"):
        params_from_jax(extra)


def test_default_init_matches_flax_distributions():
    """Initializers: lecun-normal kernels (truncated at ±2σ), zero-init
    modulation and skip gates, normal(16) freqs, unit GN scales."""
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=5, **CFG)
    p = model.params
    k = p["inner.items_up_1.ResnetModItem_1.conv2_kernel"]
    std = np.sqrt(1.0 / (3 * 32))
    assert abs(k.std().item() - std) < 0.1 * std
    assert k.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not p["inner.items_down_1.ResnetModItem_0.mod_dense.weight"].any()
    assert not p["inner.skip_0.Dense_0.weight"].any()
    assert torch.equal(p["inner.out_gn_scale"], torch.ones(8))
    assert abs(p["sigma_embedding.freqs"].std().item() - 16.0) < 4.0
    again = DiffusionModel(net_t=UNetV0, device="cpu", seed=5, **CFG)
    assert all(torch.equal(v, again.params[n]) for n, v in p.items())
    # initialize() redraws every parameter, none left as it was.
    with torch.no_grad():
        for v in again.params.values():
            v.fill_(float("nan"))
    again.initialize(torch.zeros(1, 2, LENGTH),
                     generator=torch.Generator().manual_seed(5))
    assert all(torch.isfinite(v).all() for v in again.params.values())
    with pytest.raises(ValueError, match="channels"):
        again.initialize(torch.zeros(1, 3, LENGTH))


@pytest.mark.parametrize("kwargs", [
    dict(dim=2), dict(use_embedding_cfg=True), dict(use_text_conditioning=True),
    dict(cross_attentions=[0, 0, 1]), dict(context_channels=[0, 0, 4]),
    dict(use_remat=True), dict(channel_change="first_item")])
def test_unported_options_raise(kwargs):
    cfg = {**CFG, **kwargs}
    dim = cfg.pop("dim", 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNetV0(dim=dim, device="cpu", **cfg)


def test_unported_call_kwargs_raise(pair):
    net, tree, model = pair
    x = torch.zeros(1, 2, LENGTH)
    sig = torch.zeros(1)
    with torch.inference_mode():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model.net.apply(model.params, x, sig,
                            embedding=torch.zeros(1, 4, 8))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model.net.apply(model.params, x, sig, return_hidden=True)
        with pytest.raises(TypeError, match="use_embedding_cfg"):
            model.net.apply(model.params, x, sig, embedding_scale=3.0)
        with pytest.raises(ValueError, match="divisible"):
            model.net.apply(model.params, torch.zeros(1, 2, 100), sig)


@pytest.mark.slow
def test_forward_parity_full_readme_geometry():
    """All 9 levels of the README flagship geometry (length scaled down to
    2^15 for the CPU), the port against the JAX net on the same weights, in
    float32: MSE ≤ 1e-3 and max-abs < 5e-2, the bar of
    test_parity_full_model.py for this geometry. Marked slow: the two nets
    hold the flagship's parameters, and the JAX one is compiled for the CPU."""
    from audio_diffusion_torch import presets

    net, cfg, tree = jax_net_and_params(
        seed=5, length=2**15, modulation_features=1024,
        **presets.UNCONDITIONAL_48K)
    model = port_model(cfg, tree)
    x = np.random.RandomState(6).randn(1, 2, 2**15).astype(np.float32)
    want = np.asarray(jax.jit(net.apply)(tree, jnp.asarray(x),
                                         jnp.full((1,), 0.5, jnp.float32)))
    with torch.inference_mode():
        got = model.net.apply(model.params, torch.from_numpy(x),
                              torch.full((1,), 0.5)).numpy()
    err = np.abs(got - want).max()
    mse = float(np.mean((got - want) ** 2))
    assert mse <= 1e-3 and err < 5e-2, f"MSE {mse}, max err {err}"
