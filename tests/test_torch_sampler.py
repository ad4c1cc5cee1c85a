"""The port's 50-step VSampler against the JAX package's, from identical
numpy noise and the same weights (carried across by ``params_from_jax``),
on the 3-level config of tests/test_parity_full_model.py.

Tolerance: waveform MSE ≤ 1e-6 in float32, the bar of
test_parity_full_model.py (measured: 3.1e-13).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from audio_diffusion_torch import (ARVSampler, DiffusionAR, DiffusionModel,
                                   DPMSampler, LinearSchedule, SDESampler,
                                   UNetV0, UniformLambdaSchedule, VSampler,
                                   params_from_jax, spans)
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
    noise = torch.randn(1, 2, LENGTH, generator=torch.Generator().manual_seed(0))
    # encoder_reuse reaches the sampler: chunks of 2 steps, so 3 steps raise.
    out = model.sample(noise, num_steps=4, encoder_reuse=2)
    assert out.shape == noise.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="divisible by encoder_reuse"):
        model.sample(noise, num_steps=3, encoder_reuse=2)
    # diffusion_* kwargs reach the diffusion (None: its default U[0, 1)).
    model = DiffusionModel(net_t=UNetV0, device="cpu",
                           diffusion_sigma_distribution=None, **CFG)
    assert (model.diffusion.sigma_distribution.vmin,
            model.diffusion.sigma_distribution.vmax) == (0.0, 1.0)
    # sampler_t= and sampler_* kwargs route the other samplers: DPM on its
    # uniform-λ default schedule (encoder reuse too), SDE with its eta.
    model = DiffusionModel(net_t=UNetV0, device="cpu", sampler_t=DPMSampler,
                           **CFG)
    assert isinstance(model.sampler, DPMSampler)
    assert isinstance(model.sampler.schedule, UniformLambdaSchedule)
    out = model.sample(noise, num_steps=4, encoder_reuse=2)
    assert out.shape == noise.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="divisible by encoder_reuse"):
        model.sample(noise, num_steps=3, encoder_reuse=2)
    model = DiffusionModel(net_t=UNetV0, device="cpu", sampler_t=SDESampler,
                           sampler_eta=0.0, **CFG)
    assert isinstance(model.sampler, SDESampler) and model.sampler.eta == 0.0
    assert isinstance(model.sampler.schedule, LinearSchedule)
    out = model.sample(noise, num_steps=3)
    assert out.shape == noise.shape and torch.isfinite(out).all()


def test_unroll_is_accepted_and_ignored():
    """The JAX sampler's scan ``unroll=`` (passed by its export path): the
    port's Python loop takes it without a warning and gives the same bits."""
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=3, **CFG)
    noise = torch.randn(1, 2, LENGTH, generator=torch.Generator().manual_seed(1))
    want = model.sample(noise, num_steps=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = model.sample(noise, num_steps=4, unroll=2)
    assert torch.equal(got, want)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(prof, name):
    return sorted((e for e in prof.events() if e.name == name),
                  key=lambda e: e.time_range.start)


@pytest.mark.parametrize("case", ["off", "on", "open_across_start",
                                  "open_across_stop", "flag"])
def test_span_helper(case, monkeypatch):
    """``spans.span`` is a shared no-op with no profiler running (no
    ``record_function`` made), a ``record_function`` while one runs, and
    raises nothing when the profiler starts or stops while it is open; the
    profiler's process-wide flag it reads follows ``start``/``stop``."""
    made = []

    def counting(name):
        made.append(name)
        return record_function(name)

    monkeypatch.setattr(spans, "record_function", counting)
    x = torch.ones(8)
    if case == "off":
        assert not spans.profiling()
        first, second = spans.span("t.a"), spans.span("t.b")
        assert first is second
        with first:
            x.add(1)
        assert made == []
    elif case == "on":
        with _cpu_profile() as prof:
            assert spans.profiling()
            with spans.span("t.on"):
                x.add(1)
        assert made == ["t.on"] and len(_named(prof, "t.on")) == 1
    elif case == "open_across_start":
        prof = _cpu_profile()
        with spans.span("t.early"):
            prof.start()
            x.add(1)
        prof.stop()
        assert made == [] and _named(prof, "t.early") == []
    elif case == "open_across_stop":
        prof = _cpu_profile()
        prof.start()
        with spans.span("t.late"):
            x.add(1)
            prof.stop()
        assert made == ["t.late"] and len(_named(prof, "t.late")) == 1
    else:
        import torch.autograd.profiler as autograd_profiler

        assert autograd_profiler._is_profiler_enabled is False
        prof = _cpu_profile()
        prof.start()
        assert autograd_profiler._is_profiler_enabled is True
        prof.stop()
        assert autograd_profiler._is_profiler_enabled is False
        assert not spans.profiling()


@pytest.mark.parametrize("sampler", ["v", "dpm", "sde", "ar"])
def test_one_sampler_step_span_per_step(sampler):
    """Under a CPU profiler, each step of every sampler loop is one
    ``sampler.step`` range, in order, holding that step's net pass; without
    a profiler the loop makes no range."""
    steps = 2
    if sampler == "ar":
        model = DiffusionAR(net_t=UNetV0, in_channels=1, length=128,
                            num_splits=4, channels=[8, 16], factors=[1, 2],
                            items=[1, 1], device="cpu")
        current = torch.randn(1, 1, 128,
                              generator=torch.Generator().manual_seed(0))
        sigmas = ARVSampler(None, 1, 128, 4).get_sigmas_ladder(1, steps)

        def run():
            return model.sampler.sample_loop(model.params, current, sigmas)
    else:
        t = {"v": VSampler, "dpm": DPMSampler, "sde": SDESampler}[sampler]
        model = DiffusionModel(net_t=UNetV0, device="cpu", sampler_t=t,
                               **CFG)
        noise = torch.randn(1, 2, LENGTH,
                            generator=torch.Generator().manual_seed(0))

        def run():
            kw = ({"generator": torch.Generator().manual_seed(1)}
                  if sampler == "sde" else {})
            return model.sample(noise, num_steps=steps, **kw)

    want = run()
    with _cpu_profile() as prof:
        with record_function("t.sample"):
            got = run()
    assert torch.equal(got, want)
    ranges = _named(prof, "sampler.step")
    assert len(ranges) == steps
    outer = _named(prof, "t.sample")[0]
    assert all(r.cpu_parent is not None and r.cpu_parent.id == outer.id
               for r in ranges)
    assert ranges[0].time_range.end <= ranges[1].time_range.start
    assert all(r.cpu_children for r in ranges)
