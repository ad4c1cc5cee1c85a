"""The 2-D slice as a whole: ``DiffusionModel(net_t=UNetV0, dim=2)``'s
sample, loss and train step against the JAX model's, on the config of
tests/test_torch_unet2d.py with the same weights, the same seeded numpy
noise, σ and conditioning.

Bars (float32): a 4-step VSampler sample, with and without
``encoder_reuse=2``, waveform MSE <= 1e-6 (the sample bar of
test_parity_full_model.py); the v-loss at fixed σ and noise rel 1e-5 and
each gradient within 1e-4 of its leaf's largest value against
``jax.grad``; activation checkpointing (both policies) bit-equal to the
net without it. The other samplers, the train step and the model's own
loss run through the 2-D net on the port alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.diffusion.core import alpha_beta as jax_alpha_beta
from audio_diffusion_tpu.diffusion.vdiffusion import mse_loss as jax_mse_loss
from audio_diffusion_torch import (DiffusionModel, DPMSampler, SDESampler,
                                   UNetV0, make_train_step, params_from_jax)
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from test_torch_unet2d import (ND_CFG, jax_nd_net_and_tree, nd_inputs,
                               port_nd_model, to_jax, to_torch)

torch.set_num_threads(2)

REMAT_POLICIES = [None, "dots_with_no_batch_dims_saveable"]


@pytest.fixture(scope="module")
def pair():
    net, cfg, tree = jax_nd_net_and_tree(2, seed=11)
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, dim=2, **cfg)
    jax_model.params = {"net": tree}
    return net, cfg, tree, jax_model, port_nd_model(2, cfg, tree)


@pytest.mark.parametrize("reuse", [1, 2])
def test_sample_matches_jax(pair, reuse):
    net, cfg, tree, jax_model, model = pair
    x, _, cond = nd_inputs(cfg, 2, 12, batch=1)
    want = np.asarray(jax_model.sample(jnp.asarray(x), num_steps=4,
                                       encoder_reuse=reuse, **to_jax(cond)))
    got = model.sample(x, num_steps=4, encoder_reuse=reuse, **to_torch(cond))
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert np.mean((got.numpy() - want) ** 2) <= 1e-6


def loss_inputs(cfg, seed):
    x, sigmas, cond = nd_inputs(cfg, 2, seed)
    noise = np.random.RandomState(seed + 100).randn(*x.shape).astype(
        np.float32)
    return x, sigmas, noise, cond


def port_loss_and_grads(model, x, sigmas, noise, cond):
    params = model.params
    loss = v_loss(model.net, params, torch.from_numpy(x),
                  torch.from_numpy(sigmas), torch.from_numpy(noise),
                  **to_torch(cond))
    return loss.detach(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def test_loss_and_gradients_match_jax(pair):
    """The v-loss at fixed σ and noise (vdiffusion.py of the JAX package,
    σ broadcast over [B, C, H, W]) and its gradient in every leaf."""
    net, cfg, tree, jax_model, model = pair
    x, sigmas, noise, cond = loss_inputs(cfg, 13)

    def jax_loss(p):
        alphas, betas = jax_alpha_beta(jnp.asarray(sigmas)[:, None, None,
                                                           None])
        x_noisy = alphas * x + betas * noise
        return jax_mse_loss(net.apply(p, x_noisy, jnp.asarray(sigmas),
                                      **to_jax(cond)),
                            alphas * noise - betas * x)

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(tree)
    loss, grads = port_loss_and_grads(model, x, sigmas, noise, cond)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want = params_from_jax(want)
    assert set(want) == set(grads)
    for name, w in want.items():
        w = w.numpy()
        err = np.abs(grads[name].numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_is_bit_equal(pair, policy):
    net, cfg, tree, jax_model, model = pair
    x, sigmas, noise, cond = loss_inputs(cfg, 14)
    loss0, grads0 = port_loss_and_grads(model, x, sigmas, noise, cond)
    remat = port_nd_model(2, cfg, tree, use_remat=True, remat_policy=policy)
    assert remat.net.module.inner.use_remat
    loss, grads = port_loss_and_grads(remat, x, sigmas, noise, cond)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(grads[n], grads0[n]) for n in grads0)


@pytest.mark.parametrize("sampler", ["dpm", "sde"])
def test_other_samplers_run_the_2d_net(pair, sampler):
    """DPM-Solver++ (with encoder reuse) and the SDE sampler on the 2-D
    net: finite samples of the input's shape, deterministic where they
    should be."""
    net, cfg, tree, jax_model, _ = pair
    kwargs = (dict(sampler_t=DPMSampler) if sampler == "dpm" else
              dict(sampler_t=SDESampler, sampler_eta=0.5))
    model = port_nd_model(2, cfg, tree, **kwargs)
    x, _, cond = nd_inputs(cfg, 2, 15, batch=1)
    if sampler == "dpm":
        a = model.sample(x, num_steps=4, encoder_reuse=2, **to_torch(cond))
        b = model.sample(x, num_steps=4, encoder_reuse=2, **to_torch(cond))
    else:
        a, b = (model.sample(x, num_steps=4,
                             generator=torch.Generator().manual_seed(0),
                             **to_torch(cond)) for _ in range(2))
    assert a.shape == x.shape and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_train_steps_lower_the_loss():
    """``DiffusionModel(dim=2)``'s loss (σ and noise drawn from its
    generator) is finite; Adam steps through ``make_train_step`` on a fixed
    batch, σ and noise move every parameter and lower the loss."""
    model = DiffusionModel(net_t=UNetV0, dim=2, device="cpu", seed=3,
                           **{**ND_CFG, "cross_attentions": [0, 0, 0],
                              "context_channels": [0, 0, 0]})
    x, sigmas, noise, _ = loss_inputs(ND_CFG, 16)
    x = torch.from_numpy(x).clamp(-1, 1)
    assert torch.isfinite(model(x))
    sigmas, noise = torch.from_numpy(sigmas), torch.from_numpy(noise)
    before = {k: v.detach().clone() for k, v in model.params.items()}
    init, step = make_train_step(
        lambda p, gen, batch: v_loss(model.net, p, batch, sigmas, noise),
        functools.partial(torch.optim.Adam, lr=1e-3))
    state = init(model.params, torch.Generator().manual_seed(0))
    losses = []
    for _ in range(5):
        state, metrics = step(state, x)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not [k for k, v in model.params.items()
                if torch.equal(v.detach(), before[k])]
