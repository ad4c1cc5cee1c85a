"""The port's DPMSampler and SDESampler against the JAX package's, on the
3-level, 256-sample net of tests/test_torch_unet.py with the same weights (a
seeded numpy tree carried across by ``params_from_jax``) and seeded numpy
noise. Where the JAX sampler draws noise from its key, the test draws the
same arrays from the same keys and feeds them to the port through
``diffusion.noise.normal``.

Bars: float32 waveform MSE ≤ 1e-6, the bar of tests/test_torch_sampler.py;
a bf16 carry the bf16 bar of tests/test_torch_unet.py (max-abs 0.125, MSE
3e-4) for one step, and over 8 steps no more than 1.25 times the JAX
package's own bf16 error against the f32 solution (see the test); with a
net whose output is exact in bf16, the bf16 update bit for bit.
``SDESampler(eta=0)`` must give the port's ``VSampler`` output bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu.diffusion import DPMSampler as JaxDPMSampler
from audio_diffusion_tpu.diffusion import SDESampler as JaxSDESampler
from audio_diffusion_tpu.ops.net import cast_inference_params as jax_cast
from audio_diffusion_torch import (DiffusionModel, DPMSampler, SDESampler,
                                   UNetV0, VSampler)
from audio_diffusion_torch.diffusion import noise as port_noise
from test_torch_conditioning import COND, to_torch
from test_torch_unet import (CFG, LENGTH, cond_inputs, jax_net_and_params,
                             port_model)

torch.set_num_threads(2)

STEPS = 8


def feed(monkeypatch, arrays):
    """Replace the port's noise source with ``arrays``, in order; each draw
    must ask for the shape and dtype of the array it takes."""
    queue = [np.asarray(a) for a in arrays]

    def normal(generator, shape, dtype, device):
        a = torch.from_numpy(np.array(queue.pop(0), dtype=np.float32))
        assert tuple(a.shape) == tuple(shape)
        return a.to(dtype=dtype, device=device)

    monkeypatch.setattr(port_noise, "normal", normal)
    return queue


def sde_noise(key, shape, steps, dtype=jnp.float32):
    """The ε arrays JAX's SDESampler draws: one split of the carried key per
    step."""
    out = []
    for _ in range(steps):
        key, k_eps = jax.random.split(key)
        out.append(jax.random.normal(k_eps, shape, dtype))
    return out


@pytest.fixture(scope="module")
def pair():
    net, cfg, tree = jax_net_and_params(seed=5)
    return net, tree, port_model(cfg, tree)


def start_noise(seed, batch=1):
    return np.random.RandomState(seed).randn(batch, 2, LENGTH).astype(
        np.float32)


@pytest.mark.parametrize("reuse", [1, 2])
def test_dpm_matches_jax(pair, reuse):
    net, tree, model = pair
    x = start_noise(1)
    jax_sampler = JaxDPMSampler(net)
    want = np.asarray(jax.jit(
        lambda p, x: jax_sampler.sample(p, x, STEPS, encoder_reuse=reuse))(
            tree, jnp.asarray(x)))
    with torch.inference_mode():
        got = DPMSampler(model.net).sample(
            model.params, torch.from_numpy(x), STEPS,
            encoder_reuse=reuse).numpy()
    assert np.isfinite(got).all()
    assert np.mean((got - want) ** 2) <= 1e-6
    # Second order: not the first-order VSampler's result on this schedule.
    with torch.inference_mode():
        first = VSampler(model.net, DPMSampler(model.net).schedule).sample(
            model.params, torch.from_numpy(x), STEPS).numpy()
    assert np.abs(got - first).max() > 1e-3


def test_dpm_guided_matches_jax():
    net, cfg, tree = jax_net_and_params(seed=11, **COND)
    model = port_model(cfg, tree)
    x = start_noise(2, batch=2)
    cond = cond_inputs({**CFG, **COND}, batch=2,
                       rs=np.random.RandomState(3))
    jax_sampler = JaxDPMSampler(net)
    want = np.asarray(jax.jit(lambda p, x, c: jax_sampler.sample(
        p, x, STEPS, embedding_scale=3.0, **c))(tree, jnp.asarray(x), cond))
    with torch.inference_mode():
        got = DPMSampler(model.net).sample(
            model.params, torch.from_numpy(x), STEPS, embedding_scale=3.0,
            **to_torch(cond)).numpy()
    assert np.mean((got - want) ** 2) <= 1e-6


def test_dpm_bf16_carry_within_bf16_bar():
    """A bf16 carry (bf16 net, bf16 x and x0_prev): one step is within the
    bf16 bar of tests/test_torch_unet.py of the JAX bf16 step. Over 8 steps
    the second-order extrapolation compounds each package's own roundings
    (measured port vs JAX max-abs 0.22, MSE 8.1e-4), so there both are held
    to the f32 solution: the port's bf16 error may not exceed 1.25 times the
    JAX package's (measured max-abs 0.119 vs 0.139, MSE 4.9e-4 vs
    6.0e-4)."""
    net, cfg, tree = jax_net_and_params(seed=5, dtype=jnp.bfloat16)
    net32, _, _ = jax_net_and_params(seed=5)
    model = port_model(CFG, tree, dtype=torch.bfloat16)
    x = start_noise(4)

    def jax_run(n, steps, p, x):
        return np.asarray(jax.jit(lambda p, x: JaxDPMSampler(n).sample(
            p, x, steps))(p, x).astype(jnp.float32))

    def port_run(steps):
        with torch.inference_mode():
            out = DPMSampler(model.net).sample(
                model.params, torch.from_numpy(x).to(torch.bfloat16), steps)
        assert out.dtype == torch.bfloat16
        return out.float().numpy()

    bf16 = lambda steps: jax_run(  # noqa: E731
        net, steps, jax_cast(tree, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    got, want = port_run(1), bf16(1)
    assert np.abs(got - want).max() <= 0.125
    assert np.mean((got - want) ** 2) < 3e-4
    exact = jax_run(net32, STEPS, tree, jnp.asarray(x))
    got, want = port_run(STEPS), bf16(STEPS)
    assert np.abs(got - exact).max() <= 1.25 * np.abs(want - exact).max()
    assert (np.mean((got - exact) ** 2)
            <= 1.25 * np.mean((want - exact) ** 2))


class _FlipNet:
    """A stand-in net, v = flip(x)·0.5, whose output is exact in the carry
    dtype on either side, so only the sampler's own arithmetic differs."""

    compute_dtype = None

    def apply(self, params, x, sigmas, **kwargs):  # the JAX package's Net
        return jnp.flip(x, -1) * 0.5

    def run(self, params, fn):  # the port's Net
        return fn(lambda x, sigmas, **kwargs: torch.flip(x, [-1]) * 0.5)


def test_dpm_bf16_update_bit_equal_to_jax():
    """The bf16 update alone, with the net taken out: the f32 coefficient
    math and the roundings of the carry and of x0_prev to bf16 give JAX's
    bits at every step count. Keeping x0_prev in f32 instead differs from
    step 3 on (step 2 reads x0 of σ = 1, which is −v and exact)."""
    x = start_noise(4)
    for steps in (2, 3, STEPS):
        want = np.asarray(jax.jit(lambda x: JaxDPMSampler(_FlipNet()).sample(
            {}, x, steps))(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        with torch.inference_mode():
            got = DPMSampler(_FlipNet()).sample(
                {}, torch.from_numpy(x).to(torch.bfloat16), steps)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_dpm_coefficients_match_jax_schedule():
    """λ clamped through 1e-7 keeps both endpoints finite; the first step's
    h_prev is 1 and the last step's α_{i+1}(1 − e^{−h}) is α_s = 1."""
    co = DPMSampler(None).coefficients(STEPS)
    for name, t in co.items():
        assert t.shape == (STEPS,) and t.dtype == torch.float32, name
        assert torch.isfinite(t).all(), name
    assert co["sigma"][0] == 1.0 and co["ratio"][-1] == 0.0


def test_sde_eta0_equals_vsampler_bit_for_bit(pair):
    net, tree, model = pair
    x = torch.from_numpy(start_noise(5))
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        got = SDESampler(model.net, eta=0.0).sample(model.params, gen, x, 6)
        want = VSampler(model.net).sample(model.params, x, 6)
    assert torch.equal(got, want)


def test_sde_matches_jax_with_injected_noise(pair, monkeypatch):
    net, tree, model = pair
    x = start_noise(6)
    key = jax.random.key(9)
    jax_sampler = JaxSDESampler(net, eta=0.5)
    want = np.asarray(jax.jit(lambda p, k, x: jax_sampler.sample(
        p, k, x, STEPS))(tree, key, jnp.asarray(x)))
    queue = feed(monkeypatch, sde_noise(key, x.shape, STEPS))
    with torch.inference_mode():
        got = SDESampler(model.net, eta=0.5).sample(
            model.params, torch.Generator(), torch.from_numpy(x),
            STEPS).numpy()
    assert not queue  # one draw per step
    assert np.mean((got - want) ** 2) <= 1e-6


@pytest.mark.parametrize("eta", [-0.1, 1.5])
def test_sde_eta_outside_unit_interval_raises(eta):
    with pytest.raises(ValueError, match="eta"):
        SDESampler(None, eta=eta)


def test_model_routes_generator_to_stochastic_samplers(monkeypatch):
    """``DiffusionModel.sample`` passes the model's generator (or the
    caller's) to a sampler that draws noise, and refuses one for a
    deterministic sampler."""
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=2,
                           sampler_t=SDESampler, sampler_eta=0.3, **CFG)
    assert model.sampler.eta == 0.3
    x = torch.from_numpy(start_noise(7))
    a = model.sample(x, num_steps=3, generator=torch.Generator().manual_seed(4))
    b = model.sample(x, num_steps=3, generator=torch.Generator().manual_seed(4))
    c = model.sample(x, num_steps=3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    det = DiffusionModel(net_t=UNetV0, device="cpu", **CFG)
    with pytest.raises(ValueError, match="deterministic"):
        det.sample(x, num_steps=2, generator=torch.Generator())
