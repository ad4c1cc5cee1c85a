"""Pure diffusion math (counterpart of audio_diffusion_tpu/diffusion/core.py)."""
from __future__ import annotations

from math import pi
from typing import Tuple

import torch
from torch import Tensor

__all__ = ["alpha_beta", "extend_dim", "pad_dims", "clip", "linspace"]


def alpha_beta(sigmas: Tensor) -> Tuple[Tensor, Tensor]:
    """Trigonometric noise schedule: α=cos(σπ/2), β=sin(σπ/2)."""
    angle = sigmas * (pi / 2)
    return torch.cos(angle), torch.sin(angle)


def extend_dim(x: Tensor, dim: int) -> Tensor:
    """Append trailing singleton axes until ``x.ndim == dim``."""
    return x.reshape(x.shape + (1,) * (dim - x.ndim))


def pad_dims(x: Tensor, ndim: int) -> Tensor:
    """Append ``ndim`` trailing singleton axes."""
    return x.reshape(x.shape + (1,) * ndim)


def clip(x: Tensor, dynamic_threshold: float = 0.0) -> Tensor:
    """Static clamp to [-1, 1], or Imagen-style dynamic thresholding at the
    ``dynamic_threshold`` quantile of |x| per batch row."""
    if dynamic_threshold == 0.0:
        return torch.clamp(x, -1.0, 1.0)
    x_flat = x.reshape(x.shape[0], -1)
    scale = torch.quantile(x_flat.abs(), dynamic_threshold, dim=-1)
    scale = torch.clamp(scale, min=1.0)
    scale = extend_dim(scale, dim=x.ndim)
    return torch.maximum(torch.minimum(x, scale), -scale) / scale


def linspace(start: float, stop: float, num: int, device=None) -> Tensor:
    """float32 ``num`` points from ``start`` to ``stop`` with the JAX
    package's rounding (``jnp.linspace`` under XLA): ``start·(1 − s) +
    stop·s`` with s = k·f32(1/d) for k < d = num − 1, then ``stop``
    exactly."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    div = num - 1
    recip = torch.ones((), dtype=torch.float32, device=device) / div
    step = torch.arange(div, dtype=torch.float32, device=device) * recip
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32,
                                        device=device)])
