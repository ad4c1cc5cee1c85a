"""Windowed-sinc resampling (counterpart of
audio_diffusion_tpu/dsp/resample.py): a bank of ``factor_out`` polyphase
sinc kernels applied as one strided convolution.
"""
from __future__ import annotations

from math import ceil, pi

import torch
import torch.nn.functional as F
from torch import Tensor

__all__ = ["resample", "downsample", "upsample"]


def _sinc_kernels(factor_in: int, factor_out: int, rolloff: float,
                  lowpass_filter_width: int, device) -> Tensor:
    """The polyphase bank [factor_out, 1, K] in float32, built in the JAX
    package's order: the taps clipped and scaled by π, the window, the
    sinc, the scale."""
    base_factor = min(factor_in, factor_out) * rolloff
    width = ceil(lowpass_filter_width * factor_in / base_factor)
    f32 = dict(dtype=torch.float32, device=device)
    idx = torch.arange(-width, width + factor_in, **f32) / factor_in
    phase = torch.arange(0, -factor_out, -1, **f32) / factor_out
    t = phase[:, None] + idx[None, :]  # [factor_out, K]
    t = torch.clamp(t * base_factor, -lowpass_filter_width,
                    lowpass_filter_width) * pi
    window = torch.cos(t / lowpass_filter_width / 2) ** 2
    scale = base_factor / factor_in
    safe = torch.where(t == 0, torch.ones_like(t), t)
    kernels = torch.where(t == 0, torch.ones_like(t), torch.sin(t) / safe)
    kernels = kernels * window * scale
    return kernels[:, None, :]


def resample(waveforms: Tensor, factor_in: int, factor_out: int,
             rolloff: float = 0.99, lowpass_filter_width: int = 6) -> Tensor:
    """Sinc-interpolation resample of [b, c, t] by factor_out/factor_in, to
    ``int(factor_out · t / factor_in)`` samples."""
    b, c, length = waveforms.shape
    length_target = int(factor_out * length / factor_in)
    base_factor = min(factor_in, factor_out) * rolloff
    width = ceil(lowpass_filter_width * factor_in / base_factor)
    kernels = _sinc_kernels(factor_in, factor_out, rolloff,
                            lowpass_filter_width, waveforms.device)
    x = waveforms.reshape(b * c, 1, length)
    x = F.pad(x, (width, width + factor_in))
    y = F.conv1d(x, kernels.to(x.dtype), stride=factor_in)
    # Polyphase interleave: output sample l·factor_out + k comes from frame
    # l, phase k; the conv gives [(bc), factor_out, L].
    y = y.transpose(1, 2).reshape(b, c, -1)
    return y[..., :length_target]


def downsample(waveforms: Tensor, factor: int, **kwargs) -> Tensor:
    return resample(waveforms, factor_in=factor, factor_out=1, **kwargs)


def upsample(waveforms: Tensor, factor: int, **kwargs) -> Tensor:
    return resample(waveforms, factor_in=1, factor_out=factor, **kwargs)
