"""The port's 50-step VSampler against the JAX package's, from identical
numpy noise and the same weights (carried across by ``params_from_jax``),
on the 3-level config of tests/test_parity_full_model.py.

Tolerance: waveform MSE ≤ 1e-6 in float32, the bar of
test_parity_full_model.py (measured: 3.1e-13).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_torch import (DiffusionModel, LinearSchedule, UNetV0,
                                   UniformLambdaSchedule, VSampler,
                                   params_from_jax)
from audio_diffusion_torch.diffusion import alpha_beta

torch.set_num_threads(2)

LENGTH = 256
CFG = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
           items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
           attention_features=8, modulation_features=64)


def random_tree(net, seed):
    """A seeded random parameter tree of the JAX net's shape."""
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


def test_sample_50step_waveform_parity():
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **CFG)
    tree = random_tree(jax_model.net, seed=0)
    jax_model.params = {"net": tree}
    model = DiffusionModel(net_t=UNetV0, device="cpu", **CFG)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)

    noise = np.random.RandomState(3).randn(1, 2, LENGTH).astype(np.float32)
    want = np.asarray(jax_model.sample(jnp.asarray(noise), num_steps=50))
    got = model.sample(noise, num_steps=50)
    assert got.shape == (1, 2, LENGTH) and got.dtype == torch.float32
    assert np.mean((got.numpy() - want) ** 2) <= 1e-6


def test_sample_params_override_and_determinism():
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **CFG)
    other = DiffusionModel(net_t=UNetV0, device="cpu", seed=2, **CFG)
    noise = torch.randn(1, 2, LENGTH, generator=torch.Generator().manual_seed(0))
    a = model.sample(noise, num_steps=3)
    assert torch.equal(a, model.sample(noise, num_steps=3))
    b = model.sample(noise, num_steps=3, params=other.params)
    assert torch.equal(b, other.sample(noise, num_steps=3))
    # The override left the model's own parameters in place.
    assert torch.equal(a, model.sample(noise, num_steps=3))


def test_schedules_match_jax():
    from audio_diffusion_tpu.diffusion.schedules import (
        LinearSchedule as JaxLinear, UniformLambdaSchedule as JaxUniform)
    for n in (2, 3, 4, 51):
        np.testing.assert_allclose(LinearSchedule()(n).numpy(),
                                   np.asarray(JaxLinear()(n)), atol=1e-7)
        np.testing.assert_array_equal(UniformLambdaSchedule()(n).numpy(),
                                      np.asarray(JaxUniform()(n)))
    a, b = alpha_beta(torch.tensor([0.0, 0.5, 1.0]))
    np.testing.assert_allclose((a * a + b * b).numpy(), 1.0, atol=1e-6)


def test_sampler_routing_and_unported_options():
    model = DiffusionModel(net_t=UNetV0, device="cpu",
                           sampler_schedule=UniformLambdaSchedule(), **CFG)
    assert isinstance(model.sampler, VSampler)
    assert isinstance(model.sampler.schedule, UniformLambdaSchedule)
    noise = torch.zeros(1, 2, LENGTH)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.sample(noise, num_steps=4, encoder_reuse=2)
    # diffusion_* kwargs reach the diffusion (None: its default U[0, 1)).
    model = DiffusionModel(net_t=UNetV0, device="cpu",
                           diffusion_sigma_distribution=None, **CFG)
    assert (model.diffusion.sigma_distribution.vmin,
            model.diffusion.sigma_distribution.vmax) == (0.0, 1.0)
