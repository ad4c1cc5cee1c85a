"""The v-objective training loss (counterpart of
audio_diffusion_tpu/diffusion/vdiffusion.py).

A loss is a function of ``(params, generator, x, **cond)``: the randomness
comes from an explicit ``torch.Generator``, as the JAX loss takes a key. The
arithmetic after the draws is :func:`v_loss`, which takes σ and the noise as
arguments. :class:`ARVDiffusion` is the autoregressive variant, with
:func:`arv_loss` after its draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import Tensor

from ..ops.net import Net
from . import noise as _noise
from .core import alpha_beta, extend_dim
from .distributions import Distribution, UniformDistribution

__all__ = ["Diffusion", "VDiffusion", "ARVDiffusion", "mse_loss", "v_loss",
           "arv_loss"]


def mse_loss(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean(torch.square(pred - target))


def v_loss(net: Net, params, x: Tensor, sigmas: Tensor, noise: Tensor,
           loss_fn: Callable[[Tensor, Tensor], Tensor] = mse_loss,
           **kwargs) -> Tensor:
    """The v-objective at given σ [B] and noise (shaped like x): the net sees
    x_noisy = α·x + β·noise and σ, and is held to v = α·noise − β·x.
    ``kwargs`` reach the net (a ``generator=`` among them feeds CFG's
    embedding dropout)."""
    sigmas_batch = extend_dim(sigmas, dim=x.ndim).to(x.dtype)
    alphas, betas = alpha_beta(sigmas_batch)
    x_noisy = alphas * x + betas * noise
    v_target = alphas * noise - betas * x
    v_pred = net.apply(params, x_noisy, sigmas, **kwargs)
    return loss_fn(v_pred, v_target)


def _check_example(x: Optional[Tensor], channels: int) -> None:
    if x is not None and x.shape[1] != channels:
        raise ValueError(f"example batch has {x.shape[1]} channels, the "
                         f"net takes {channels}")


class Diffusion:
    """Interface of the diffusion methods."""

    net: Net

    def init_net_params(self, generator: torch.Generator,
                        x: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Draw the net's parameters from ``generator``. ``x`` is an
        optional example batch [B, C, T], checked against the net's input
        layout, which depends on the diffusion method."""
        _check_example(x, self.net.in_channels)
        return self.net.init(generator)

    def loss(self, params: Dict[str, Tensor], generator: torch.Generator,
             x: Tensor, **kwargs) -> Tensor:
        raise NotImplementedError()

    def __call__(self, params: Dict[str, Tensor], generator: torch.Generator,
                 x: Tensor, **kwargs) -> Tensor:
        return self.loss(params, generator, x, **kwargs)


class VDiffusion(Diffusion):
    """v-objective loss: predict v = α·noise − β·x at a random σ per batch
    element. ``loss_fn`` is injectable (structured losses work)."""

    def __init__(self, net: Net,
                 sigma_distribution: Optional[Distribution] = None,
                 loss_fn: Callable[[Tensor, Tensor], Tensor] = mse_loss):
        self.net = net
        self.sigma_distribution = sigma_distribution or UniformDistribution()
        self.loss_fn = loss_fn

    def loss(self, params: Dict[str, Tensor], generator: torch.Generator,
             x: Tensor, **kwargs) -> Tensor:
        """σ, then the noise, are drawn from ``generator``, which lives on
        x's device; the net draws what it needs after them (CFG's embedding
        mask, one Bernoulli per batch row)."""
        sigmas = self.sigma_distribution(generator, x.shape[0])
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return v_loss(self.net, params, x, sigmas, noise, self.loss_fn,
                      generator=generator, **kwargs)


def arv_loss(net: Net, params, x: Tensor, sigmas: Tensor, noise: Tensor,
             loss_fn: Callable[[Tensor, Tensor], Tensor] = mse_loss,
             **kwargs) -> Tensor:
    """The autoregressive v-objective at given σ [B, 1, num_splits] (one
    per split, repeated over each split's positions) and noise (shaped like
    x): σ rides as an extra input channel and the net takes no σ."""
    split_length = x.shape[-1] // sigmas.shape[-1]
    sigmas = sigmas.repeat_interleave(split_length, dim=-1)
    alphas, betas = alpha_beta(sigmas)
    x_noisy = alphas * x + betas * noise
    v_target = alphas * noise - betas * x
    channels = torch.cat([x_noisy, sigmas], dim=1)
    v_pred = net.apply(params, channels, None, **kwargs)
    return loss_fn(v_pred, v_target)


class ARVDiffusion(Diffusion):
    """Autoregressive v-objective: an independent σ per split, fed to the
    net as an extra input channel instead of an embedding. The net takes
    ``in_channels + 1`` channels and has no time conditioning."""

    def __init__(self, net: Net, length: int, num_splits: int,
                 loss_fn: Callable[[Tensor, Tensor], Tensor] = mse_loss):
        if length % num_splits:
            raise ValueError("length must be divisible by num_splits")
        self.net = net
        self.length = length
        self.num_splits = num_splits
        self.split_length = length // num_splits
        self.loss_fn = loss_fn

    def init_net_params(self, generator: torch.Generator,
                        x: Optional[Tensor] = None) -> Dict[str, Tensor]:
        # The net sees x with σ as one more channel.
        _check_example(x, self.net.in_channels - 1)
        return self.net.init(generator)

    def loss(self, params: Dict[str, Tensor], generator: torch.Generator,
             x: Tensor, **kwargs) -> Tensor:
        """σ [B, 1, num_splits] ~ U[0, 1), then the noise, drawn from
        ``generator``."""
        b, _, t = x.shape
        if t != self.length:
            raise ValueError(f"input length {t} must match length "
                             f"{self.length}")
        sigmas = torch.rand((b, 1, self.num_splits), generator=generator,
                            device=x.device, dtype=x.dtype)
        noise = _noise.normal(generator, x.shape, x.dtype, x.device)
        return arv_loss(self.net, params, x, sigmas, noise, self.loss_fn,
                        generator=generator, **kwargs)
