"""Small helpers (own copies of audio_diffusion_tpu/utils/__init__.py:103-180)
and the device rule of the port."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, TypeVar, Union

import torch

T = TypeVar("T")

__all__ = ["exists", "default", "groupby", "dequant_pcm16", "resolve_device"]


def exists(val: Optional[T]) -> bool:
    return val is not None


def default(val: Optional[T], d: Union[Callable[[], T], T]) -> T:
    """Null-coalescing with lazy default (callable defaults are invoked)."""
    if exists(val):
        return val  # type: ignore[return-value]
    return d() if callable(d) else d


def group_dict_by_prefix(prefix: str, d: Dict) -> Tuple[Dict, Dict]:
    """Split a dict into (keys with prefix, keys without)."""
    with_prefix: Dict = {}
    without_prefix: Dict = {}
    for key, value in d.items():
        (with_prefix if key.startswith(prefix) else without_prefix)[key] = value
    return with_prefix, without_prefix


def groupby(prefix: str, d: Dict, keep_prefix: bool = False) -> Tuple[Dict, Dict]:
    """Extract prefixed kwargs, stripping the prefix unless keep_prefix."""
    kwargs_with_prefix, kwargs = group_dict_by_prefix(prefix, d)
    if keep_prefix:
        return kwargs_with_prefix, kwargs
    return {k[len(prefix):]: v for k, v in kwargs_with_prefix.items()}, kwargs


def dequant_pcm16(x):
    """Dequantize int16 PCM audio to float32 in [-1, 1); anything else passes
    through unchanged. x / 32768 with power-of-two factors reproduces the
    float32 decode of the same samples bit for bit."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int16:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the CUDA card. Without one, the caller must ask for the
    CPU explicitly: the port never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
