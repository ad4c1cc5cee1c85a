"""The v-objective training loss (counterpart of
audio_diffusion_tpu/diffusion/vdiffusion.py).

A loss is a function of ``(params, generator, x, **cond)``: the randomness
comes from an explicit ``torch.Generator``, as the JAX loss takes a key. The
arithmetic after the draws is :func:`v_loss`, which takes σ and the noise as
arguments.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import Tensor

from ..ops.net import Net
from .core import alpha_beta, extend_dim
from .distributions import Distribution, UniformDistribution

__all__ = ["Diffusion", "VDiffusion", "mse_loss", "v_loss"]


def mse_loss(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean(torch.square(pred - target))


def v_loss(net: Net, params, x: Tensor, sigmas: Tensor, noise: Tensor,
           loss_fn: Callable[[Tensor, Tensor], Tensor] = mse_loss,
           **kwargs) -> Tensor:
    """The v-objective at given σ [B] and noise (shaped like x): the net sees
    x_noisy = α·x + β·noise and σ, and is held to v = α·noise − β·x."""
    sigmas_batch = extend_dim(sigmas, dim=x.ndim).to(x.dtype)
    alphas, betas = alpha_beta(sigmas_batch)
    x_noisy = alphas * x + betas * noise
    v_target = alphas * noise - betas * x
    v_pred = net.apply(params, x_noisy, sigmas, **kwargs)
    return loss_fn(v_pred, v_target)


class Diffusion:
    """Interface of the diffusion methods."""

    net: Net

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
        x's device."""
        sigmas = self.sigma_distribution(generator, x.shape[0])
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return v_loss(self.net, params, x, sigmas, noise, self.loss_fn,
                      **kwargs)
