"""The port's VInpainter and generate_long against the JAX package's, on the
3-level, 256-sample net of tests/test_torch_unet.py with the same weights
and seeded numpy inputs. The JAX inpainter draws its noise from
``fold_in(fold_in(key_loop, r), i)`` (step i, resample r); the test draws
the same arrays from the same keys and feeds them to the port, in its order
(step outer, resample inner), through ``diffusion.noise.normal``.

Bars: float32 MSE ≤ 1e-6, the bar of tests/test_torch_sampler.py; the known
region and the seams exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu import generate_long as jax_generate_long
from audio_diffusion_tpu.diffusion import VInpainter as JaxVInpainter
from audio_diffusion_torch import (UniformLambdaSchedule, VInpainter,
                                   generate_long)
from audio_diffusion_torch import longform
from test_torch_samplers_more import feed
from test_torch_unet import CFG, LENGTH, jax_net_and_params, port_model

torch.set_num_threads(2)


def inpaint_noise(key, shape, steps, resamples, with_start):
    """The arrays JAX's VInpainter draws from ``key``, in the port's order:
    the start noise (when it draws one), then per step i and resample r."""
    key_init, key_loop = jax.random.split(key)
    out = [jax.random.normal(key_init, shape)] if with_start else []
    for i in range(steps):
        for r in range(resamples):
            k = jax.random.fold_in(jax.random.fold_in(key_loop, r), i)
            out.append(jax.random.normal(k, shape))
    return out


@pytest.fixture(scope="module")
def pair():
    net, cfg, tree = jax_net_and_params(seed=8)
    return net, tree, port_model(cfg, tree)


def source_and_mask(seed):
    rs = np.random.RandomState(seed)
    source = rs.randn(1, 2, LENGTH).astype(np.float32)
    mask = np.zeros((1, 2, LENGTH), bool)
    mask[..., :64] = True
    mask[..., 200:] = True
    return source, mask


@pytest.mark.parametrize("given_start", [False, True])
def test_inpainter_matches_jax(pair, monkeypatch, given_start):
    net, tree, model = pair
    source, mask = source_and_mask(1)
    start = np.random.RandomState(2).randn(*source.shape).astype(np.float32)
    extra = dict(x_noisy=start) if given_start else {}
    key = jax.random.key(5)
    steps, resamples = 4, 2
    want = np.asarray(jax.jit(lambda p, k, s, m, **kw: JaxVInpainter(
        net).sample(p, k, s, m, steps, resamples, **kw))(
            tree, key, jnp.asarray(source), jnp.asarray(mask),
            **{k: jnp.asarray(v) for k, v in extra.items()}))
    queue = feed(monkeypatch, inpaint_noise(key, source.shape, steps,
                                            resamples, not given_start))
    with torch.inference_mode():
        got = VInpainter(model.net).sample(
            model.params, torch.Generator(), torch.from_numpy(source),
            torch.from_numpy(mask), steps, resamples,
            **{k: torch.from_numpy(v) for k, v in extra.items()}).numpy()
    assert not queue
    assert np.mean((got - want) ** 2) <= 1e-6
    # At σ = 0 the known region is the source itself (α = 1, β = 0).
    np.testing.assert_array_equal(got[mask], source[mask])
    assert np.abs(got[~mask] - source[~mask]).max() > 0


def test_inpainter_rejects_zero_resamples(pair):
    net, tree, model = pair
    source, mask = source_and_mask(1)
    with pytest.raises(ValueError, match="num_resamples"):
        VInpainter(model.net).sample(
            model.params, torch.Generator(), torch.from_numpy(source),
            torch.from_numpy(mask), 2, 0)


def long_noise(key, batch, channels, window, overlap, length, steps,
               resamples):
    """The arrays JAX's generate_long draws from ``key``: the first window's
    noise, then each continuation window's inpainter noise."""
    k0, key = jax.random.split(key)
    out = [jax.random.normal(k0, (batch, channels, window), jnp.float32)]
    produced = window
    while produced < length:
        key, kw = jax.random.split(key)
        out += inpaint_noise(kw, (batch, channels, window), steps, resamples,
                             True)
        produced += window - overlap
    return out


def test_generate_long_matches_jax(monkeypatch):
    net, cfg, tree = jax_net_and_params(seed=9)
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **CFG)
    jax_model.params = {"net": tree}
    model = port_model(cfg, tree)
    geometry = dict(length=600, window=LENGTH, overlap=64, num_steps=3,
                    num_resamples=2)
    key = jax.random.key(3)
    want = np.asarray(jax_generate_long(jax_model, key=key, **geometry))
    queue = feed(monkeypatch, long_noise(key, 1, 2, LENGTH, 64, 600, 3, 2))
    windows = []
    inpaint = VInpainter.sample

    def spy(self, params, generator, source, mask, *args, **kwargs):
        out = inpaint(self, params, generator, source, mask, *args, **kwargs)
        windows.append((source.clone(), out.clone()))
        return out

    monkeypatch.setattr(VInpainter, "sample", spy)
    got = generate_long(model, **geometry)
    assert not queue
    assert got.shape == (1, 2, 600) and got.dtype == torch.float32
    assert np.mean((got.numpy() - want) ** 2) <= 1e-6
    # Each continuation window's known region is the previous tail, bit for
    # bit, and the stitched audio carries on from it.
    assert len(windows) == 2
    for source, out in windows:
        assert torch.equal(out[..., :64], source[..., :64])
    np.testing.assert_array_equal(windows[1][0][..., :64],
                                  got[..., 384:448])


def test_generate_long_make_inpainter_uses_model_schedule():
    schedule = UniformLambdaSchedule()
    model = port_model(CFG, jax_net_and_params(seed=9)[2],
                       sampler_schedule=schedule)
    assert longform.make_inpainter(model).schedule is schedule


@pytest.mark.parametrize("length,overlap", [(200, 64), (600, 256),
                                            (600, 0)])
def test_generate_long_rejects_bad_geometry(length, overlap):
    model = port_model(CFG, jax_net_and_params(seed=9)[2])
    with pytest.raises(ValueError):
        generate_long(model, length=length, window=LENGTH, overlap=overlap,
                      num_steps=2)
