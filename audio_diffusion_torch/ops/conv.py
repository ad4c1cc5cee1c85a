"""1-D convolutions with torch's geometry and the JAX package's parameter
layout (counterpart of audio_diffusion_tpu/ops/conv.py).

Activations are channels-first [B, C, L], as ``F.conv1d`` takes them.
Kernels keep the JAX layout [K, Cin/groups, Cout] (bias [Cout]), so a JAX
parameter tree carries across as a copy; they are permuted to torch's
layout at each call. Output lengths:

- conv1d:            (L + 2p − d·(k−1) − 1)//s + 1
- conv_transpose1d:  (L−1)·s − 2p + k

The JAX transposed conv is an input-dilated conv with the kernel flipped
along K and padding k − 1 − p on both sides; that is torch's
``conv_transpose1d`` with the weight ``kernel.permute(1, 2, 0)`` and no
flip. The port computes it as one product of the input with the kernel
(every position's K output taps) and their :func:`overlap_add`, cropped
by the padding: library calls that give the same bits on every run,
forward and backward. On an H100 cuDNN's transposed conv picks an
algorithm that sums with atomics (a vocoder sample then changes between
runs on the same noise), and its deterministic one is slow at the
vocoder's ``to_flat`` shape (``PERF.md`` §6).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .layers import lecun_normal_, new_param

__all__ = ["conv1d", "conv_transpose1d", "overlap_add", "Conv1d",
           "ConvTranspose1d"]


def conv1d(x: Tensor, kernel: Tensor, stride: int = 1,
           padding: Union[int, Sequence[int]] = 0, dilation: int = 1,
           groups: int = 1) -> Tensor:
    """x [B, Cin, L], kernel [K, Cin/groups, Cout] -> [B, Cout, L']. An int
    ``padding`` pads both sides; a pair pads (left, right)."""
    if not isinstance(padding, int):
        lo, hi = padding
        x = F.pad(x, (lo, hi))
        padding = 0
    return F.conv1d(x, kernel.permute(2, 1, 0), stride=stride,
                    padding=padding, dilation=dilation, groups=groups)


def overlap_add(frames: Tensor, stride: int) -> Tensor:
    """Frames [..., L, K] summed at every ``stride`` positions: frame t's
    tap k lands at t·stride + k of [..., (L−1)·stride + K]. The frames are
    cut into ceil(K / stride) stride-long slices (the last zero-padded),
    and slice j of every frame is one strided copy shifted by j·stride, so
    the sum takes a fixed order."""
    *lead, length, k = frames.shape
    n = -(-k // stride)
    frames = F.pad(frames, (0, n * stride - k))
    out = None
    for j in range(n):
        part = frames[..., j * stride:(j + 1) * stride].reshape(
            lead + [length * stride])
        part = F.pad(part, (j * stride, (n - 1 - j) * stride))
        out = part if out is None else out + part
    return out[..., :(length - 1) * stride + k]


def conv_transpose1d(x: Tensor, kernel: Tensor, stride: int = 1,
                     padding: int = 0) -> Tensor:
    """x [B, Cin, L], kernel [K, Cin, Cout] -> [B, Cout, (L−1)·s − 2p + K]:
    output position t·s − p + k receives x[:, :, t] · kernel[k]."""
    taps = torch.einsum("bil,kio->bolk", x, kernel)  # [B, Cout, L, K]
    out = overlap_add(taps, stride)
    return out[..., padding:out.shape[-1] - padding]


def _cast(t: Optional[Tensor], dtype) -> Optional[Tensor]:
    return t.to(dtype) if t is not None and dtype is not None else t


class Conv1d(nn.Module):
    """Conv1d on [B, C, L] with torch-style int padding; ``kernel``
    [K, Cin/groups, Cout] (lecun-normal) and ``bias`` [Cout] (zeros).
    ``padding_mode='reflect'`` reflect-pads before an unpadded conv. With
    ``dtype`` set, input and parameters are cast to it."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, use_bias: bool = True,
                 padding_mode: str = "zeros", dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if padding_mode not in ("zeros", "reflect"):
            raise ValueError(f"padding_mode {padding_mode!r}: 'zeros' or "
                             "'reflect'")
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.padding_mode, self.dtype = groups, padding_mode, dtype
        p = dict(dtype=param_dtype, device=device)
        self.kernel = new_param(kernel_size, in_channels // groups, features,
                                **p)
        self.bias = new_param(features, **p) if use_bias else None

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        k, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, k * cin, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        x, kernel = _cast(x, self.dtype), _cast(self.kernel, self.dtype)
        pad = self.padding
        if self.padding_mode == "reflect" and pad > 0:
            x = F.pad(x, (pad, pad), mode="reflect")
            pad = 0
        y = conv1d(x, kernel, self.stride, pad, self.dilation, self.groups)
        if self.bias is not None:
            y = y + _cast(self.bias, self.dtype)[:, None]
        return y


class ConvTranspose1d(nn.Module):
    """Transposed conv on [B, C, L] with torch's geometry; ``kernel``
    [K, Cin, Cout] (lecun-normal over Cin·K, as flax's) and ``bias``
    [Cout]."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        p = dict(dtype=param_dtype, device=device)
        self.kernel = new_param(kernel_size, in_channels, features, **p)
        self.bias = new_param(features, **p) if use_bias else None

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        k, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, k * cin, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        x, kernel = _cast(x, self.dtype), _cast(self.kernel, self.dtype)
        y = conv_transpose1d(x, kernel, self.stride, self.padding)
        if self.bias is not None:
            y = y + _cast(self.bias, self.dtype)[:, None]
        return y
