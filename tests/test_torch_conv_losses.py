"""The port's general convolutions (``ops.conv``) and structured loss
(``losses``) against the JAX package's on the same numpy inputs.

Bars: the convolutions and the loss in float32, max-abs ≤ 1e-5·max(1,
max|y|) (sums in other orders; measured ≤ 1e-6); the loss's gradient
within 1e-5 of its largest value; the loss as a ``DiffusionModel``
``loss_fn`` through the 3-level net of tests/test_torch_unet.py, rel 1e-4
(the net's own float32 gap, tests/test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu.diffusion.core import alpha_beta as jax_alpha_beta
from audio_diffusion_tpu.losses import (
    MultiResolutionSTFTLoss as JaxMultiResolutionSTFTLoss)
from audio_diffusion_tpu.losses import (
    multi_resolution_stft_loss as jax_mrstft)
from audio_diffusion_tpu.ops import conv as jax_conv
from audio_diffusion_torch import (MultiResolutionSTFTLoss,
                                   multi_resolution_stft_loss)
from audio_diffusion_torch.diffusion.vdiffusion import v_loss
from audio_diffusion_torch.ops import conv
from test_torch_unet import jax_net_and_params, port_model

torch.set_num_threads(2)

SMALL_STFT = dict(fft_sizes=(128, 64), hop_sizes=(32, 16),
                  win_lengths=(96, 40))


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def assert_close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())


def channels_last(t):
    return jnp.asarray(np.asarray(t).transpose(0, 2, 1))


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), (2, 3, 1, 1), (3, 1, 2, 1), (1, 2, 1, 2), (2, (1, 4), 1, 1),
    (1, 0, 3, 4)])
def test_conv1d_matches_jax(stride, padding, dilation, groups):
    x = rand(1, 2, 8, 37)  # [B, C, L]
    k = rand(2, 5, 8 // groups, 4)  # [K, Cin/groups, Cout]
    got = conv.conv1d(torch.from_numpy(x), torch.from_numpy(k), stride,
                      padding, dilation, groups).numpy()
    want = np.asarray(jax_conv.conv1d(channels_last(x), jnp.asarray(k),
                                      stride, padding, dilation, groups))
    assert_close(got, want.transpose(0, 2, 1))
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    assert got.shape[-1] == (37 + lo + hi - dilation * 4 - 1) // stride + 1


@pytest.mark.parametrize("stride,padding", [(1, 0), (4, 2), (2, 3), (3, 0)])
def test_conv_transpose1d_matches_jax(stride, padding):
    """An asymmetric kernel: JAX flips it inside an input-dilated conv,
    torch's transposed conv does not, with the weight permuted."""
    x = rand(3, 2, 6, 19)
    k = rand(4, 8, 6, 3)
    k[0] += 3.0  # taps far from symmetric
    got = conv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(k),
                                stride, padding).numpy()
    want = np.asarray(jax_conv.conv_transpose1d(
        channels_last(x), jnp.asarray(k), stride, padding))
    assert got.shape[-1] == (19 - 1) * stride - 2 * padding + 8
    assert_close(got, want.transpose(0, 2, 1))


def flax_params(module, x):
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x))
    rs = np.random.RandomState(5)
    return jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, padding=1),
    dict(kernel_size=8, stride=4, padding=2, padding_mode="reflect",
         use_bias=False),
    dict(kernel_size=5, dilation=2, groups=2, padding=4)])
def test_conv1d_module_matches_flax(kw):
    x = rand(6, 2, 6, 64)
    jmod = jax_conv.Conv1d(features=4, **kw)
    params = flax_params(jmod, channels_last(x))
    mod = conv.Conv1d(6, 4, device="cpu", **kw)
    mod.load_state_dict({k: torch.from_numpy(v)
                         for k, v in params["params"].items()}, strict=True)
    want = np.asarray(jmod.apply(params, channels_last(x)))
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert_close(got, want.transpose(0, 2, 1))


def test_conv_transpose1d_module_matches_flax():
    x = rand(7, 2, 16, 8)
    kw = dict(kernel_size=12, stride=4, padding=4)
    jmod = jax_conv.ConvTranspose1d(features=1, use_bias=False, **kw)
    params = flax_params(jmod, channels_last(x))
    mod = conv.ConvTranspose1d(16, 1, use_bias=False, device="cpu", **kw)
    mod.load_state_dict({"kernel": torch.from_numpy(
        params["params"]["kernel"])}, strict=True)
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 1, 32)
    assert_close(got, np.asarray(jmod.apply(params, channels_last(
        x))).transpose(0, 2, 1))


def test_conv_rejects_unknown_padding_mode():
    with pytest.raises(ValueError, match="padding_mode"):
        conv.Conv1d(2, 2, 3, padding_mode="circular", device="cpu")


def test_multi_resolution_stft_loss_matches_jax():
    """The default (auraloss) resolutions on 4096 samples."""
    pred, target = rand(8, 2, 1, 4096), rand(9, 2, 1, 4096)
    got = multi_resolution_stft_loss(torch.from_numpy(pred),
                                     torch.from_numpy(target))
    want = float(jax_mrstft(jnp.asarray(pred), jnp.asarray(target)))
    assert got.item() == pytest.approx(want, rel=1e-5)
    assert MultiResolutionSTFTLoss()(torch.from_numpy(pred),
                                     torch.from_numpy(target)) == got


def test_multi_resolution_stft_loss_gradient_matches_jax():
    pred, target = rand(10, 2, 2, 512), rand(11, 2, 2, 512)
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = multi_resolution_stft_loss(p, torch.from_numpy(target),
                                      **SMALL_STFT)
    (got,) = torch.autograd.grad(loss, [p])
    want = np.asarray(jax.grad(lambda a: jax_mrstft(
        a, jnp.asarray(target), **SMALL_STFT))(jnp.asarray(pred)))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_stft_loss_as_model_loss_fn():
    """``DiffusionModel(loss_fn=MultiResolutionSTFTLoss(...))``: the
    v-objective scored by the STFT loss at given σ and noise, against the
    JAX net's output scored by the JAX loss; the net's parameters get a
    gradient through the FFT."""
    net, cfg, tree = jax_net_and_params(seed=3)
    model = port_model(cfg, tree, loss_fn=MultiResolutionSTFTLoss(
        **SMALL_STFT))
    rs = np.random.RandomState(12)
    x, noise = rs.randn(2, 2, 256), rs.randn(2, 2, 256)
    x, noise = x.astype(np.float32), noise.astype(np.float32)
    sigmas = np.array([0.3, 0.7], np.float32)
    alphas, betas = jax_alpha_beta(jnp.asarray(sigmas)[:, None, None])
    v_pred = net.apply(tree, alphas * x + betas * noise, jnp.asarray(sigmas))
    want = float(JaxMultiResolutionSTFTLoss(**SMALL_STFT)(
        v_pred, alphas * noise - betas * x))
    params = model.params
    got = v_loss(model.net, params, torch.from_numpy(x),
                 torch.from_numpy(sigmas), torch.from_numpy(noise),
                 model.diffusion.loss_fn)
    assert got.item() == pytest.approx(want, rel=1e-4)
    grads = torch.autograd.grad(got, list(params.values()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.isfinite(model(torch.from_numpy(x)))
