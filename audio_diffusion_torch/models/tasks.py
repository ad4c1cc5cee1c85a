"""Task models built on :class:`DiffusionModel` (counterpart of
audio_diffusion_tpu/models/tasks.py). Ported so far: ``DiffusionAR``."""
from __future__ import annotations

from typing import Callable

from ..diffusion.samplers import ARVSampler
from ..diffusion.vdiffusion import ARVDiffusion
from .model import DiffusionModel

__all__ = ["DiffusionAR"]


class DiffusionAR(DiffusionModel):
    """Autoregressive diffusion model: the net takes ``in_channels`` + 1
    channels (σ as a channel), gives ``in_channels``, and has no time
    conditioning and no modulation, so every resnet item runs the fused
    kernels' no-modulation branch::

        ar = DiffusionAR(net_t=UNetV0, in_channels=1, length=2**16,
                         num_splits=4, **presets._NET_9LEVEL)
        loss = ar(audio)                                  # [B, 1, 2**16]
        out = ar.sample(num_items=1, num_chunks=16, num_steps=64)
    """

    def __init__(self, in_channels: int, length: int, num_splits: int,
                 diffusion_t: Callable = ARVDiffusion,
                 sampler_t: Callable = ARVSampler, **kwargs):
        super().__init__(
            in_channels=in_channels + 1,
            out_channels=in_channels,
            diffusion_t=diffusion_t,
            diffusion_length=length,
            diffusion_num_splits=num_splits,
            sampler_t=sampler_t,
            sampler_in_channels=in_channels,
            sampler_length=length,
            sampler_num_splits=num_splits,
            use_time_conditioning=False,
            use_modulation=False,
            **kwargs,
        )
