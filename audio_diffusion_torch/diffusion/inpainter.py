"""RePaint-style inpainting (counterpart of
audio_diffusion_tpu/diffusion/inpainter.py). Per step i, ``num_resamples``
times: a v-step, renoised to level i (to level i + 1 on the last resample),
then the known region (``mask`` True) overwritten with the source noised to
that level.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from ..ops.net import Net, cast_inference_params
from . import noise
from .core import alpha_beta
from .samplers import run_steps
from .schedules import LinearSchedule, Schedule

__all__ = ["Inpainter", "VInpainter"]


class Inpainter:
    """Interface for inpainters."""

    net: Net


class VInpainter(Inpainter):

    def __init__(self, net: Net, schedule: Optional[Schedule] = None):
        self.net = net
        self.schedule = schedule or LinearSchedule()

    def sample(self, params: Dict[str, Tensor], generator: torch.Generator,
               source: Tensor, mask: Tensor, num_steps: int,
               num_resamples: int, show_progress: bool = False,
               x_noisy: Optional[Tensor] = None, **kwargs) -> Tensor:
        """Inpaint ``source`` [B, C, T] where ``mask`` is False. Draws, in
        order: ``x_noisy`` when it is not given (in ``source``'s dtype),
        then one source noise per resample, step i outer and resample r
        inner. σ, α and β are f32; the result of each resample is cast to
        ``x_noisy``'s dtype."""
        if num_resamples < 1:
            raise ValueError(
                "num_resamples must be >= 1 (0 would skip every denoising "
                "step and return the starting noise unchanged)")
        params = cast_inference_params(params, self.net.compute_dtype)
        if x_noisy is None:
            x_noisy = noise.normal(generator, source.shape, source.dtype,
                                   source.device)
        b = x_noisy.shape[0]
        sigmas_host = self.schedule(num_steps + 1).to(torch.float32)
        sigmas = sigmas_host.to(x_noisy.device)
        alphas, betas = alpha_beta(sigmas)
        mask = mask.to(torch.bool)

        def loop(step_net):
            x = x_noisy
            for i in range(num_steps):
                net = step_net()  # quantized dicts: dequantized per step
                for r in range(num_resamples):
                    v = net(x, sigmas[i].expand(b).to(x.dtype), **kwargs)
                    xf, vf = x.float(), v.float()
                    x_pred = alphas[i] * xf - betas[i] * vf
                    noise_pred = betas[i] * xf + alphas[i] * vf
                    # Stay at level i while resampling; step to i + 1 on
                    # the last resample.
                    j = i + 1 if r == num_resamples - 1 else i
                    x = alphas[j] * x_pred + betas[j] * noise_pred
                    eps = noise.normal(generator, source.shape, source.dtype,
                                       source.device)
                    s_noisy = (alphas[j] * source.float()
                               + betas[j] * eps.float())
                    x = torch.where(mask, s_noisy, x).to(x_noisy.dtype)
                if show_progress:
                    print(f"Inpainting (noise={float(sigmas_host[i]):.2f})")
            return x

        return run_steps(self.net, params, loop)

    def __call__(self, params: Dict[str, Tensor], *args, **kwargs) -> Tensor:
        return self.sample(params, *args, **kwargs)
