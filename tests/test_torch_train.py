"""The port's training path (audio_diffusion_torch: ``VDiffusion`` loss,
``DiffusionModel.loss``, ``make_train_step``) against the JAX package's on
the 3-level config of tests/test_parity_full_model.py, on the CPU: the same
weights (a seeded numpy tree, carried across by ``params_from_jax``), batch,
σ and noise made with numpy.

A JAX gradient tree has the shape of the parameter tree, so
``params_from_jax`` also carries gradients and updated parameters into the
port's names (Dense transposes included), and every leaf is compared.

Tolerances.
- Loss vs JAX: rel 1e-4, the bar of test_parity_full_model.py (measured
  8e-8 in float32).
- One train step in float32: loss and grad_norm rel 1e-4; every gradient
  within 1e-3 of its leaf's largest value (measured ≤ 2e-6). Adam's first
  step is −lr·g/(|g| + 1e-8), about −lr·sign(g): where |g| > 1e-6 in both
  packages the updated parameters agree to 5e-7 (a few float32 ulps of a
  parameter near 1); elsewhere a sign may differ, and they agree to 2·lr.
  "> 1e-6" and the gradients' absolute floor are 1e-6·grad_norm (1e-4·
  grad_norm under bfloat16): a bias that a one-channel-per-group GroupNorm
  removes has a gradient of rounding noise only.
- One train step with bfloat16 compute (float32 master parameters): the two
  packages round at different points inside the resnet items, measured loss
  rel 8e-4, grad_norm rel 1e-3 and gradients within 0.039 of each leaf's
  largest value; bounds 1e-2, 2e-2 and 0.1. The update is compared where
  |g| exceeds a quarter of its leaf's largest value in both packages (so the
  sign is beyond the rounding noise): 5e-7.
- Accumulation, steps_per_call, EMA and PCM16 identities run inside the
  port alone: see each test.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_diffusion_tpu.diffusion.core import alpha_beta as jax_alpha_beta
from audio_diffusion_tpu.diffusion.vdiffusion import mse_loss as jax_mse_loss
from audio_diffusion_tpu.parallel.train_step import (
    make_train_step as jax_make_train_step)
from audio_diffusion_torch import (DiffusionModel, UNetV0, UniformDistribution,
                                   VDiffusion, make_train_step,
                                   params_from_jax)
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from test_torch_unet import CFG, LENGTH, jax_net_and_params, port_model

torch.set_num_threads(2)

LR = 1e-4


def batch_sigma_noise(seed, b=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 2, LENGTH).astype(np.float32)
    noise = rs.randn(b, 2, LENGTH).astype(np.float32)
    sigmas = rs.uniform(0.1, 0.9, size=(b,)).astype(np.float32)
    return x, sigmas, noise


def jax_loss_fn(net):
    """The JAX VDiffusion loss (vdiffusion.py:61-71) with σ and the noise
    passed in, not drawn from the key."""
    def loss_fn(params, key, x, sigmas=None, noise=None):
        alphas, betas = jax_alpha_beta(sigmas[:, None, None].astype(x.dtype))
        x_noisy = alphas * x + betas * noise
        v_target = alphas * noise - betas * x
        return jax_mse_loss(net.apply(params, x_noisy, sigmas), v_target)
    return loss_fn


def port_loss_fn(model):
    def loss_fn(params, generator, x, sigmas=None, noise=None):
        return v_loss(model.net, params, x, sigmas, noise)
    return loss_fn


def test_vdiffusion_loss_matches_jax():
    net, cfg, tree = jax_net_and_params()
    model = port_model(cfg, tree)
    x, sigmas, noise = batch_sigma_noise(4)
    want = float(jax.jit(jax_loss_fn(net))(
        tree, None, jnp.asarray(x), sigmas=jnp.asarray(sigmas),
        noise=jnp.asarray(noise)))
    got = float(v_loss(model.net, model.params, torch.from_numpy(x),
                       torch.from_numpy(sigmas),
                       torch.from_numpy(noise)).detach())
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_one_train_step_matches_jax(compute):
    bf16 = compute == "bfloat16"
    overrides = dict(dtype=jnp.bfloat16) if bf16 else {}
    net, cfg, tree = jax_net_and_params(**overrides)
    model = port_model(CFG, tree, **(dict(dtype=torch.bfloat16) if bf16 else {}))
    x, sigmas, noise = batch_sigma_noise(7)
    cond_j = dict(sigmas=jnp.asarray(sigmas), noise=jnp.asarray(noise))
    cond_t = dict(sigmas=torch.from_numpy(sigmas),
                  noise=torch.from_numpy(noise))

    init_j, step_j = jax_make_train_step(
        jax_loss_fn(net), optax.adam(LR, b1=0.9), donate=False)
    state_j, metrics_j = step_j(init_j(tree, jax.random.key(0)),
                                jnp.asarray(x), **cond_j)
    new_j = params_from_jax(state_j.params)
    # The JAX step's own gradients: Adam's first moment after one step from
    # zero is (1 − b1)·g (one more float32 rounding, 1e-7 of each value).
    grads_j = params_from_jax(jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / (1.0 - 0.9), state_j.opt_state[0].mu))

    loss_t = port_loss_fn(model)
    old = {k: v.detach().clone() for k, v in model.params.items()}
    grads_t = dict(zip(model.params, torch.autograd.grad(
        loss_t(model.params, None, torch.from_numpy(x), **cond_t),
        list(model.params.values()))))
    init_t, step_t = make_train_step(
        loss_t, functools.partial(torch.optim.Adam, lr=LR))
    state = init_t(model.params, torch.Generator().manual_seed(0))
    state, metrics_t = step_t(state, torch.from_numpy(x), **cond_t)

    loss_rel, norm_rel, grad_rel, sure = (
        (1e-2, 2e-2, 0.1, 0.25) if bf16 else (1e-4, 1e-4, 1e-3, 0.0))
    assert float(metrics_t["loss"]) == pytest.approx(
        float(metrics_j["loss"]), rel=loss_rel)
    assert float(metrics_t["grad_norm"]) == pytest.approx(
        float(metrics_j["grad_norm"]), rel=norm_rel)
    assert int(metrics_t["step"]) == int(metrics_j["step"]) == 1
    # Updated in place: the state holds the model's own parameters.
    assert all(state.params[k] is v for k, v in model.params.items())
    assert set(grads_t) == set(grads_j) == set(new_j)
    noise_floor = (1e-4 if bf16 else 1e-6) * float(metrics_j["grad_norm"])
    unclear = []
    for name, want in grads_j.items():
        got, want = grads_t[name].numpy(), want.numpy()
        top = np.abs(want).max()
        assert np.isfinite(got).all(), name
        assert np.abs(got - want).max() <= grad_rel * top + noise_floor, name
        moved = model.params[name].detach().numpy()
        diff = np.abs(moved - new_j[name].numpy())
        assert diff.max() <= 2 * LR + 5e-7, name
        # The update, where Adam's step is beyond doubt −lr·sign(g).
        floor = max(noise_floor, sure * top)
        clear = (np.abs(want) > floor) & (np.abs(got) > floor)
        if not clear.any():
            unclear.append(name)
            continue
        assert diff[clear].max() <= 5e-7, name
        assert np.abs(moved - old[name].numpy())[clear].min() > 0.5 * LR, name
    # A bias added just before a GroupNorm with one channel per group (8
    # channels, 8 groups) is removed by it: its gradient is rounding noise.
    assert all(n.endswith("bias") for n in unclear) and len(unclear) <= 6, \
        unclear


def fresh_model(seed=1, **kwargs):
    """A port model whose zero-initialized gates carry signal too."""
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=seed, **CFG,
                           **kwargs)
    with torch.no_grad():
        for p in model.params.values():
            if not p.any():
                p.normal_(0.0, 0.05, generator=model.generator)
    return model


def test_accum_steps_equals_one_step_on_the_whole_batch():
    """Two microbatches of two, summed and halved, against the batch of four
    with the same σ and noise, under plain SGD (an update linear in the
    gradient): loss and grad_norm rel 1e-5, parameters atol 1e-6 (float32
    sums in another order)."""
    x, sigmas, noise = (torch.from_numpy(a) for a in batch_sigma_noise(9, b=4))
    results = []
    for accum in (1, 2):
        model = fresh_model()
        init, step = make_train_step(
            port_loss_fn(model), functools.partial(torch.optim.SGD, lr=0.1),
            accum_steps=accum)
        state = init(model.params, torch.Generator().manual_seed(0))
        state, metrics = step(state, x, sigmas=sigmas, noise=noise)
        results.append((metrics, {k: v.detach() for k, v in
                                  state.params.items()}))
    (m1, p1), (m2, p2) = results
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    for name in p1:
        torch.testing.assert_close(p2[name], p1[name], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="accum_steps"):
        step(state, x[:3], sigmas=sigmas[:3], noise=noise[:3])


def test_steps_per_call_equals_separate_calls():
    """K = 2 stacked batches in one call against two calls, σ and noise drawn
    from equally seeded generators: bit-equal parameters and metrics."""
    batches = torch.from_numpy(
        np.random.RandomState(11).randn(2, 2, 2, LENGTH).astype(np.float32))
    adam = functools.partial(torch.optim.Adam, lr=LR)
    one, two = fresh_model(), fresh_model()
    init, step = make_train_step(one.loss, adam)
    state = init(one.params, torch.Generator().manual_seed(5))
    separate = []
    for b in batches:
        state, metrics = step(state, b)
        separate.append(metrics)
    init, step = make_train_step(two.loss, adam, steps_per_call=2)
    state2, stacked = step(init(two.params, torch.Generator().manual_seed(5)),
                           batches)
    for key in ("loss", "grad_norm", "step"):
        assert stacked[key].shape == (2,)
        assert torch.equal(stacked[key],
                           torch.stack([m[key] for m in separate]))
    assert stacked["step"].tolist() == [1, 2]
    assert all(torch.equal(v, two.params[k]) for k, v in one.params.items())
    with pytest.raises(ValueError, match="steps_per_call"):
        step(state2, batches[0, :1])


def test_ema_after_one_step():
    """ema = decay·p0 + (1 − decay)·p1, atol = rtol = 2e-7 (a float32 ulp);
    none without ema_decay."""
    model = fresh_model()
    p0 = {k: v.detach().clone() for k, v in model.params.items()}
    init, step = make_train_step(
        model.loss, functools.partial(torch.optim.Adam, lr=LR), ema_decay=0.9)
    state = init(model.params, torch.Generator().manual_seed(2))
    assert all(torch.equal(state.ema[k], p0[k]) for k in p0)
    state, _ = step(state, torch.from_numpy(batch_sigma_noise(3)[0]))
    for k, p1 in model.params.items():
        assert not torch.equal(p1, p0[k]), k
        torch.testing.assert_close(state.ema[k], 0.9 * p0[k] + 0.1 * p1.detach(),
                                   atol=2e-7, rtol=2e-7)
    init, _ = make_train_step(model.loss, torch.optim.Adam)
    assert init(model.params, torch.Generator()).ema is None


def test_multi_gpu_options_raise():
    """mesh= takes a DeviceMesh, and anything else raises a TypeError that
    names it; zero1=True without a mesh is a no-op, as in the JAX package:
    after two Adam steps the parameters and moments are bit-equal to
    zero1=False."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(fresh_model().loss, torch.optim.Adam, mesh=object())
    x, sigmas, noise = (torch.from_numpy(a) for a in batch_sigma_noise(5))
    states = []
    for zero1 in (False, True):
        model = fresh_model()
        init, step = make_train_step(
            port_loss_fn(model), functools.partial(torch.optim.Adam, lr=LR),
            zero1=zero1)
        state = init(model.params, torch.Generator().manual_seed(0))
        for _ in range(2):
            state, _ = step(state, x, sigmas=sigmas, noise=noise)
        assert not state.shards
        states.append(state)
    plain, zero = states
    for name, p in plain.params.items():
        assert torch.equal(zero.params[name], p), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(zero.optimizer.state[zero.params[name]][key],
                               plain.optimizer.state[p][key]), (name, key)


def test_pcm16_batch_gives_the_float_decodes_loss_bit_for_bit():
    model = fresh_model()
    pcm = torch.from_numpy(np.random.RandomState(13).randint(
        -32768, 32768, size=(2, 2, LENGTH)).astype(np.int16))
    decoded = pcm.to(torch.float32) / 32768.0
    losses = [model.loss(model.params, torch.Generator().manual_seed(4), x)
              for x in (pcm, decoded)]
    assert torch.equal(losses[0], losses[1])
    # The train step dequantizes too.
    init, step = make_train_step(model.loss, torch.optim.SGD)
    state = init(model.params, torch.Generator().manual_seed(4))
    _, metrics = step(state, pcm)
    assert torch.equal(metrics["loss"], losses[0].detach())


def test_model_call_is_the_loss_on_the_live_parameters():
    model = fresh_model()
    x = batch_sigma_noise(15)[0]
    want = model.loss(model.params, torch.Generator().manual_seed(6),
                      torch.from_numpy(x))
    loss = model(x, generator=torch.Generator().manual_seed(6))
    assert loss.ndim == 0 and torch.equal(loss, want)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.params.values())
    # Without generator= the model's own generator is drawn from: two
    # calls see different σ and noise.
    assert not torch.equal(model(x), model(x))


def test_diffusion_kwargs_reach_the_diffusion():
    calls = []

    def loss_fn(pred, target):
        calls.append(pred.shape)
        return torch.mean(torch.abs(pred - target))

    model = DiffusionModel(
        net_t=UNetV0, device="cpu", loss_fn=loss_fn,
        diffusion_sigma_distribution=UniformDistribution(0.25, 0.5), **CFG)
    assert isinstance(model.diffusion, VDiffusion)
    assert model.diffusion.sigma_distribution.vmax == 0.5
    model(np.zeros((3, 2, LENGTH), np.float32))
    assert calls == [(3, 2, LENGTH)]


def test_save_load_round_trip(tmp_path):
    model, other = fresh_model(seed=1), fresh_model(seed=2)
    assert not all(torch.equal(v, other.params[k])
                   for k, v in model.params.items())
    model.save(tmp_path / "model.pt")
    loaded = other.load(tmp_path / "model.pt")
    assert loaded.keys() == model.params.keys()
    assert all(torch.equal(v, other.params[k])
               for k, v in model.params.items())
    wide = DiffusionModel(net_t=UNetV0, device="cpu",
                          **{**CFG, "modulation_features": 32})
    with pytest.raises(RuntimeError, match="size mismatch"):
        wide.load(tmp_path / "model.pt")


@pytest.mark.parametrize("vmin,vmax", [(0.0, 1.0), (0.2, 0.3)])
def test_uniform_distribution(vmin, vmax):
    dist = UniformDistribution(vmin, vmax)
    a = dist(torch.Generator().manual_seed(3), 4096)
    b = dist(torch.Generator().manual_seed(3), 4096)
    assert a.dtype == torch.float32 and a.shape == (4096,)
    assert torch.equal(a, b)
    assert a.min() >= vmin and a.max() < vmax
    assert abs(a.mean().item() - (vmin + vmax) / 2) < 0.02 * (vmax - vmin)
    assert not torch.equal(a, dist(torch.Generator().manual_seed(4), 4096))


def test_loss_is_the_v_objective():
    """v_loss against the formula written out, on a net that returns zeros:
    mean((α·noise − β·x)²)."""
    model = fresh_model()
    x, sigmas, noise = (torch.from_numpy(a) for a in batch_sigma_noise(17))

    class Zero:
        def apply(self, params, x_noisy, s, **kwargs):
            return torch.zeros_like(x_noisy)

    a = torch.cos(sigmas * math.pi / 2)[:, None, None]
    b = torch.sin(sigmas * math.pi / 2)[:, None, None]
    want = torch.mean((a * noise - b * x) ** 2)
    torch.testing.assert_close(v_loss(Zero(), None, x, sigmas, noise), want)
    assert v_loss(model.net, model.params, x, sigmas, noise).ndim == 0
