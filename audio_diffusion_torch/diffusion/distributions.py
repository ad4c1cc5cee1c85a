"""Sigma distributions for training-time noise levels (counterpart of
audio_diffusion_tpu/diffusion/distributions.py). A draw takes an explicit
``torch.Generator`` where the JAX package takes a PRNG key."""
from __future__ import annotations

import torch
from torch import Tensor

from . import noise

__all__ = ["Distribution", "UniformDistribution"]


class Distribution:
    """Interface: ``dist(generator, num_samples) -> [num_samples]`` of σ."""

    def __call__(self, generator: torch.Generator, num_samples: int) -> Tensor:
        raise NotImplementedError()


class UniformDistribution(Distribution):
    """σ ~ U[vmin, vmax), float32, on the generator's device, drawn through
    ``diffusion/noise.py``."""

    def __init__(self, vmin: float = 0.0, vmax: float = 1.0):
        self.vmin, self.vmax = vmin, vmax

    def __call__(self, generator: torch.Generator, num_samples: int) -> Tensor:
        u = noise.uniform(generator, (num_samples,), torch.float32,
                          generator.device)
        return self.vmin + (self.vmax - self.vmin) * u
