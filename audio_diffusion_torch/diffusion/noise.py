"""The one source of fresh Gaussian noise inside the samplers, the
inpainter, long-form generation and the autoregressive loss.

Every such draw calls :func:`normal` through this module, so a test can
replace it (``monkeypatch.setattr(noise, "normal", ...)``) to feed noise
made elsewhere, for example the arrays the JAX package draws from its keys.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor

__all__ = ["normal"]


def normal(generator: torch.Generator, shape: Sequence[int], dtype,
           device) -> Tensor:
    """Standard normal draws of ``shape`` and ``dtype`` on ``device``, from
    ``generator`` (which lives on that device)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=device)

