"""The port's autoregressive model (``DiffusionAR``: ``ARVDiffusion`` and
``ARVSampler`` over a net with no time conditioning and no modulation, so
every resnet item takes the fused item's no-modulation branch) against the
JAX package's, on the config of tests/test_task_models.py::test_diffusion_ar
(channels [8, 16], factors [1, 2], items [1, 1], one channel of 128 samples
in 4 splits). Weights are a seeded numpy tree in the JAX layout, carried
across by ``params_from_jax``. Where JAX draws from its keys, the test draws
the same arrays and feeds them to the port through ``diffusion.noise.normal``.

Bars: the σ ladder bit for bit; ``sample_loop`` and ``sample`` MSE ≤ 1e-6
(the bar of tests/test_torch_sampler.py); the loss rel 1e-6; every f32
gradient within 1e-4 of its leaf's largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionAR as JaxDiffusionAR
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.diffusion import ARVSampler as JaxARVSampler
from audio_diffusion_torch import (ARVDiffusion, ARVSampler, DiffusionAR,
                                   UNetV0, params_from_jax, params_to_jax)
from audio_diffusion_torch.diffusion import arv_loss
from test_torch_samplers_more import feed
from test_torch_unet import jax_net_and_params

torch.set_num_threads(2)

LENGTH, SPLITS = 128, 4
AR = dict(channels=[8, 16], factors=[1, 2], items=[1, 1])
# The JAX net DiffusionAR builds for one data channel.
NET = dict(AR, in_channels=2, out_channels=1, attentions=[0, 0],
           use_time_conditioning=False, use_modulation=False)


@pytest.fixture(scope="module")
def pair():
    """(the JAX DiffusionAR with a seeded tree, the tree, the port's)."""
    _, _, tree = jax_net_and_params(seed=4, length=LENGTH, **NET)
    jax_ar = JaxDiffusionAR(net_t=JaxUNetV0, in_channels=1, length=LENGTH,
                            num_splits=SPLITS, **AR)
    jax_ar.params = {"net": tree}
    ar = DiffusionAR(net_t=UNetV0, in_channels=1, length=LENGTH,
                     num_splits=SPLITS, device="cpu", **AR)
    ar.net.module.load_state_dict(params_from_jax(tree), strict=True)
    return jax_ar, tree, ar


def ar_noise(key, b, c, length, splits, num_chunks):
    """The arrays JAX's ARVSampler.sample draws from ``key``: the start
    window's noise, the ladder's entry noise, one fresh split per shift."""
    key_start, key_ladder, key_fresh = jax.random.split(key, 3)
    out = [jax.random.normal(key_start, (b, c, length), jnp.float32),
           jax.random.normal(key_ladder, (b, c, length), jnp.float32)]
    out += [jax.random.normal(jax.random.fold_in(key_fresh, j),
                              (b, c, length // splits), jnp.float32)
            for j in range(num_chunks)]
    return out


@pytest.mark.parametrize("items,splits,steps", [(3, 4, 5), (2, 6, 3),
                                                (1, 2, 8)])
def test_sigmas_ladder_bit_equal(items, splits, steps):
    length = 12 * splits
    want = np.asarray(JaxARVSampler(None, 1, length, splits).get_sigmas_ladder(
        num_items=items, num_steps_per_split=steps))
    got = ARVSampler(None, 1, length, splits).get_sigmas_ladder(items, steps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (steps + 1, items, 1, length)


def test_sample_loop_matches_jax(pair):
    jax_ar, tree, ar = pair
    rs = np.random.RandomState(1)
    current = rs.randn(2, 1, LENGTH).astype(np.float32)
    sigmas = ARVSampler(None, 1, LENGTH, SPLITS).get_sigmas_ladder(2, 3)
    want = np.asarray(jax.jit(jax_ar.sampler.sample_loop)(
        tree, jnp.asarray(current), jnp.asarray(sigmas.numpy())))
    with torch.inference_mode():
        got = ar.sampler.sample_loop(ar.params, torch.from_numpy(current),
                                     sigmas).numpy()
    assert np.mean((got - want) ** 2) <= 1e-6


@pytest.mark.parametrize("num_chunks", [SPLITS, 6])
def test_sample_matches_jax(pair, monkeypatch, num_chunks):
    """The whole autoregressive sample through ``DiffusionModel.sample``,
    with no positional tensor: start window, ladder, rolling window."""
    jax_ar, tree, ar = pair
    key = jax.random.key(2)
    kw = dict(num_items=2, num_chunks=num_chunks, num_steps=8)
    want = np.asarray(jax_ar.sample(key=key, **kw))
    queue = feed(monkeypatch, ar_noise(key, 2, 1, LENGTH, SPLITS, num_chunks))
    if num_chunks == SPLITS:  # the first window is the whole result
        del queue[1:]
    got = ar.sample(**kw)
    assert not queue
    assert got.shape == (2, 1, num_chunks * LENGTH // SPLITS)
    assert got.dtype == torch.float32
    assert np.mean((got.numpy() - want) ** 2) <= 1e-6


def test_sample_counts_net_passes(pair):
    """num_steps + num_chunks · num_steps / num_splits passes (the start
    window, then the ladder per shift), as in the JAX package."""
    _, _, ar = pair
    calls = []
    apply = ar.net.module.forward

    def counted(*args, **kwargs):
        calls.append(1)
        return apply(*args, **kwargs)

    ar.net.module.forward = counted
    try:
        ar.sample(num_items=1, num_chunks=6, num_steps=8)
    finally:
        del ar.net.module.forward
    assert len(calls) == 8 + 6 * 8 // SPLITS


def test_sampler_and_diffusion_reject_bad_geometry():
    with pytest.raises(ValueError, match="even"):
        ARVSampler(None, 1, 96, 3)
    with pytest.raises(ValueError, match="divisible"):
        ARVSampler(None, 1, 130, 4)
    with pytest.raises(ValueError, match="divisible"):
        ARVDiffusion(None, 130, 4)
    sampler = ARVSampler(None, 1, LENGTH, SPLITS)
    with pytest.raises(ValueError, match="at least 4 chunks"):
        sampler.sample({}, torch.Generator(), 1, 3, 8)
    with pytest.raises(ValueError, match="num_steps"):
        sampler.sample({}, torch.Generator(), 1, 6, 2)


def loss_inputs(seed):
    rs = np.random.RandomState(seed)
    return rs.randn(2, 1, LENGTH).astype(np.float32)


def jax_loss_and_draws(jax_ar, tree, x, key):
    """JAX's ARVDiffusion loss and gradient at ``key``, and the σ [b, 1,
    splits] and noise it drew there."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_ar.diffusion.loss(p, key, jnp.asarray(x))))(tree)
    key_sigma, key_noise, _ = jax.random.split(key, 3)
    sigmas = jax.random.uniform(key_sigma, (x.shape[0], 1, SPLITS))
    noise = jax.random.normal(key_noise, x.shape)
    return float(loss), grads, np.asarray(sigmas), np.asarray(noise)


def test_loss_and_gradients_match_jax(pair):
    """The loss with JAX's σ and noise, within 1e-6 relative, and every
    gradient of the no-modulation items (and the rest of the net) within
    1e-4 of its leaf's largest value. As in tests/test_torch_train.py the
    absolute floor is 1e-6·grad_norm: level 0 has one channel per group, so
    its second GroupNorm removes conv 1's bias, whose gradient is rounding
    noise in both packages."""
    jax_ar, tree, ar = pair
    x = loss_inputs(3)
    want, grads_j, sigmas, noise = jax_loss_and_draws(jax_ar, tree, x,
                                                      jax.random.key(6))
    params = ar.params
    loss = arv_loss(ar.net, params, torch.from_numpy(x),
                    torch.tensor(sigmas), torch.tensor(noise))
    assert loss.item() == pytest.approx(want, rel=1e-6)
    grads_t = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))
    grads_j = params_from_jax(grads_j)
    assert set(grads_j) == set(grads_t)
    assert any("ResnetModItem" in k for k in grads_t)
    norm = torch.sqrt(sum(g.square().sum() for g in grads_j.values()))
    for name, g in grads_t.items():
        scale = grads_j[name].abs().max().item()
        err = (g - grads_j[name]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-6 * norm.item(), (name, err, scale)


def test_arvdiffusion_draws_sigma_then_noise(pair):
    """``ARVDiffusion.loss`` draws σ [b, 1, splits] from U[0, 1), then the
    noise, from its generator: the loss is :func:`arv_loss` at those
    draws."""
    _, _, ar = pair
    x = torch.from_numpy(loss_inputs(4))
    got = ar.loss(ar.params, torch.Generator().manual_seed(5), x)
    gen = torch.Generator().manual_seed(5)
    sigmas = torch.rand((2, 1, SPLITS), generator=gen)
    noise = torch.randn(x.shape, generator=gen)
    want = arv_loss(ar.net, ar.params, x, sigmas, noise)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="length"):
        ar.loss(ar.params, gen, x[..., :64])
    # A training call on the live parameters gives a finite loss.
    assert torch.isfinite(ar(x))


def test_initialize_takes_the_data_channels():
    """``initialize`` checks an example batch of the data's channels (the
    net's σ channel is the diffusion's), as the JAX model's does."""
    ar = DiffusionAR(net_t=UNetV0, in_channels=1, length=LENGTH,
                     num_splits=SPLITS, device="cpu", **AR)
    params = ar.initialize(torch.zeros(1, 1, LENGTH),
                           generator=torch.Generator().manual_seed(1))
    assert set(params) == set(ar.net.module.state_dict())
    with pytest.raises(ValueError, match="net takes 1"):
        ar.initialize(torch.zeros(1, 2, LENGTH))


def test_ar_tree_round_trip_and_names(pair):
    """The AR net's tree (no σ embedding, no modulation leaves, SkipCat
    merges) crosses both ways bit for bit, and the port's names and shapes
    are those of ``jax.eval_shape`` of the JAX init."""
    jax_ar, tree, ar = pair
    back = params_to_jax(params_from_jax(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))
    shapes = jax.eval_shape(lambda: jax_ar.diffusion.init_net_params(
        jax.random.key(0), jnp.zeros((1, 1, LENGTH))))
    want = {jax.tree_util.keystr(p): tuple(s.shape)
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(ar.params))[0]
    assert {jax.tree_util.keystr(p): tuple(a.shape) for p, a in got} == want
    assert not any("mod" in k or "sigma" in k for k in want)
