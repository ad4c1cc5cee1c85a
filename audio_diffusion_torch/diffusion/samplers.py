"""Samplers (counterpart of audio_diffusion_tpu/diffusion/samplers.py).

The JAX package compiles the step loop into one ``lax.scan``; here it is a
Python loop that launches each step's work on the device without waiting
for it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from ..ops.net import Net, cast_inference_params
from .core import alpha_beta
from .schedules import LinearSchedule, Schedule

__all__ = ["Sampler", "VSampler"]


class Sampler:
    """Interface for samplers."""

    net: Net

    def sample(self, params: Dict[str, Tensor], *args, **kwargs) -> Tensor:
        raise NotImplementedError()

    def __call__(self, params: Dict[str, Tensor], *args, **kwargs) -> Tensor:
        return self.sample(params, *args, **kwargs)


class VSampler(Sampler):
    """Deterministic angular-DDIM v-sampler. Per step::

        v      = net(x, σ_i)
        x_pred = α_i·x − β_i·v        (denoised estimate)
        n_pred = β_i·x + α_i·v        (noise estimate)
        x      = α_{i+1}·x_pred + β_{i+1}·n_pred
    """

    def __init__(self, net: Net, schedule: Optional[Schedule] = None):
        self.net = net
        self.schedule = schedule or LinearSchedule()

    def sample(self, params: Dict[str, Tensor], x_noisy: Tensor,
               num_steps: int, show_progress: bool = False, unroll: int = 1,
               encoder_reuse: int = 1, **kwargs) -> Tensor:
        """``unroll`` is the JAX sampler's scan unrolling, accepted and
        ignored: a Python loop has no scan to unroll.

        ``encoder_reuse=k`` (k > 1) runs the net's down path (encoder) only
        on the first step of each chunk of k steps (``return_hidden=True``)
        and decodes the k − 1 steps after it from that encoder state with
        the current σ (``hidden=``). Approximate; k = 1 is the exact
        sampler. ``num_steps`` must be a multiple of k."""
        k = int(encoder_reuse)
        if k > 1 and num_steps % k:
            raise ValueError(
                f"num_steps ({num_steps}) must be divisible by encoder_reuse "
                f"({k}): the encoder runs once per chunk of k steps")
        b = x_noisy.shape[0]
        params = cast_inference_params(params, self.net.compute_dtype)
        # σ/α/β stay f32 under a bf16 carry; only the carry is in x's dtype.
        sigmas_host = self.schedule(num_steps + 1).to(torch.float32)
        sigmas = sigmas_host.to(x_noisy.device)
        alphas, betas = alpha_beta(sigmas)

        def loop(net):
            x = x_noisy
            for i in range(num_steps):
                # The net sees σ in the carry dtype.
                sig = sigmas[i].expand(b).to(x.dtype)
                if k <= 1:
                    v = net(x, sig, **kwargs)
                elif i % k == 0:
                    v, enc = net(x, sig, return_hidden=True, **kwargs)
                else:
                    v = net(x, sig, hidden=enc, **kwargs)
                xf, vf = x.float(), v.float()
                x_pred = alphas[i] * xf - betas[i] * vf
                noise_pred = betas[i] * xf + alphas[i] * vf
                x = (alphas[i + 1] * x_pred
                     + betas[i + 1] * noise_pred).to(x.dtype)
                if show_progress:
                    print(f"Sampling (noise={float(sigmas_host[i]):.2f})")
            return x

        return self.net.run(params, loop)
