"""Plain reference of what the generation service derives from a request:
its noise, drawn from the request's own seed, and its PCM16 reply."""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["seed_noise", "pcm16"]


def seed_noise(seed: int, channels: int, length: int, device) -> Tensor:
    """Standard-normal float32 [channels, length] from a generator on
    ``device`` seeded with the request's seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((channels, length), generator=gen, dtype=torch.float32,
                       device=device)


def pcm16(x: Tensor) -> Tensor:
    """int16 PCM of float audio as a WAV writer stores it: clip to [-1, 1],
    scale by 32767, round half away from zero."""
    v = torch.clamp(x.float(), -1.0, 1.0) * 32767.0
    return torch.trunc(v + torch.where(v >= 0, 0.5, -0.5)).to(torch.int16)
