"""Encoder reuse in the port: the XUNet's ``return_hidden``/``hidden`` hooks
and ``VSampler(encoder_reuse=k)``, against the JAX package's sampler with the
same k, on the 3-level, 256-sample net of tests/test_torch_unet.py (and its
conditioned variant with guidance), with the same weights and seeded numpy
noise. Bars: k = 1 bit-equal to the plain loop; k = 2 waveform MSE ≤ 1e-6 in
float32 against JAX, with and without guidance (the sample bar of
test_parity_full_model.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_torch import Net, VSampler
from audio_diffusion_torch.ops.unet import _check_unused_kwargs
from test_torch_conditioning import COND, inputs, to_torch
from test_torch_unet import LENGTH, jax_net_and_params, port_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def plain():
    net, cfg, tree = jax_net_and_params(seed=21)
    return cfg, tree, port_model(cfg, tree)


@pytest.fixture(scope="module")
def guided():
    net, cfg, tree = jax_net_and_params(seed=22, **COND)
    return cfg, tree, port_model(cfg, tree)


def noise(seed, batch=1):
    return np.random.RandomState(seed).randn(batch, 2, LENGTH).astype(
        np.float32)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_hidden_roundtrip_is_exact(guided, scale):
    """Decoding the state captured at the same (x, σ) gives the full
    forward's bits; under guidance the state is the doubled pass's."""
    cfg, tree, model = guided
    x, cond = inputs(31)
    xt, sig, cond = torch.from_numpy(x), torch.full((2,), 0.4), to_torch(cond)
    with torch.inference_mode():
        full, enc = model.net.apply(model.params, xt, sig, return_hidden=True,
                                    embedding_scale=scale, **cond)
        again = model.net.apply(model.params, xt, sig, hidden=enc,
                                embedding_scale=scale, **cond)
    assert enc[0].shape[0] == (2 if scale == 1.0 else 4)
    assert len(enc[1]) == len(cfg["channels"]) - 1
    assert torch.equal(full, again)


def test_hidden_uses_current_sigma(plain):
    cfg, tree, model = plain
    xt = torch.from_numpy(noise(32, batch=2))
    with torch.inference_mode():
        _, enc = model.net.apply(model.params, xt, torch.full((2,), 0.9),
                                 return_hidden=True)
        a = model.net.apply(model.params, xt, torch.full((2,), 0.9),
                            hidden=enc)
        b = model.net.apply(model.params, xt, torch.full((2,), 0.1),
                            hidden=enc)
    assert (a - b).abs().max().item() > 1e-6


def test_encoder_reuse_1_is_the_plain_loop(plain):
    cfg, tree, model = plain
    x = noise(33)
    assert torch.equal(model.sample(x, num_steps=8),
                       model.sample(x, num_steps=8, encoder_reuse=1))


def test_encoder_reuse_2_matches_jax(plain):
    cfg, tree, model = plain
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **cfg)
    jax_model.params = {"net": tree}
    x = noise(34)
    want = np.asarray(jax_model.sample(jnp.asarray(x), num_steps=8,
                                       encoder_reuse=2))
    got = model.sample(x, num_steps=8, encoder_reuse=2).numpy()
    assert np.mean((got - want) ** 2) <= 1e-6
    exact = model.sample(x, num_steps=8).numpy()
    assert np.abs(got - exact).max() > 0  # a different trajectory


def test_encoder_reuse_2_with_guidance_matches_jax(guided):
    cfg, tree, model = guided
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **cfg)
    jax_model.params = {"net": tree}
    x, cond = inputs(35)
    want = np.asarray(jax_model.sample(jnp.asarray(x), num_steps=4,
                                       embedding_scale=4.0, encoder_reuse=2,
                                       **cond))
    got = model.sample(x, num_steps=4, embedding_scale=4.0, encoder_reuse=2,
                       **to_torch(cond)).numpy()
    assert np.mean((got - want) ** 2) <= 1e-6


def test_encoder_runs_once_per_chunk(plain):
    cfg, tree, model = plain
    calls = {"down": 0, "up": 0}
    xunet = model.net.module.inner
    hooks = [getattr(xunet, f"items_{side}_0").register_forward_hook(
        lambda *_, side=side: calls.__setitem__(side, calls[side] + 1))
        for side in ("down", "up")]
    try:
        model.sample(noise(36), num_steps=6, encoder_reuse=3)
    finally:
        for h in hooks:
            h.remove()
    assert calls == {"down": 2, "up": 6}


def test_encoder_reuse_requires_divisible_steps(plain):
    cfg, tree, model = plain
    with pytest.raises(ValueError, match="divisible by encoder_reuse"):
        model.sample(noise(37), num_steps=7, encoder_reuse=2)


def test_encoder_reuse_rejected_on_nets_without_hooks():
    """A net that does not implement the hooks fails loudly instead of
    returning a tensor that the sampler would unpack as (v, enc)."""

    class NoReuse(nn.Module):
        def __init__(self):
            super().__init__()
            self.g = nn.Parameter(torch.ones(()))

        def forward(self, x, sigmas=None, **kwargs):
            _check_unused_kwargs(kwargs)
            return x * self.g

    sampler = VSampler(Net(NoReuse(), in_channels=2, out_channels=2))
    params = dict(sampler.net.module.named_parameters())
    x = torch.from_numpy(noise(38))
    with torch.inference_mode():
        assert torch.isfinite(sampler.sample(params, x, num_steps=4)).all()
        with pytest.raises(TypeError, match="encoder reuse"):
            sampler.sample(params, x, num_steps=4, encoder_reuse=2)
