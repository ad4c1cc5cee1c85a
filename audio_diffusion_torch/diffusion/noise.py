"""The one source of fresh random draws inside the samplers, the inpainter,
long-form generation, the autoregressive loss, distillation's teacher
targets and the corpus embedder.

Every such draw calls :func:`normal`, :func:`randint` or :func:`uniform`
through this module, so a test can replace one
(``monkeypatch.setattr(noise, "normal", ...)``) to feed draws made
elsewhere, for example the arrays the JAX package draws from its keys.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor

__all__ = ["normal", "randint", "uniform"]


def normal(generator: torch.Generator, shape: Sequence[int], dtype,
           device) -> Tensor:
    """Standard normal draws of ``shape`` and ``dtype`` on ``device``, from
    ``generator`` (which lives on that device)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=device)


def randint(generator: torch.Generator, low: int, high: int,
            shape: Sequence[int], device) -> Tensor:
    """int64 draws uniform over ``[low, high)`` of ``shape`` on ``device``,
    from ``generator`` (which lives on that device)."""
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=device)


def uniform(generator: torch.Generator, shape: Sequence[int], dtype,
            device) -> Tensor:
    """Draws uniform over ``[0, 1)`` of ``shape`` and ``dtype`` on
    ``device``, from ``generator`` (which lives on that device)."""
    return torch.rand(tuple(shape), generator=generator, dtype=dtype,
                      device=device)
