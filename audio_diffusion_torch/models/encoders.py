"""Encoders for :class:`DiffusionAE` (counterpart of
audio_diffusion_tpu/models/encoders.py): ``MelEncoder1d`` and the
``TanhBottleneck`` it ends in.

Module and parameter names follow the JAX encoder's flax tree
(``Conv1d_0``, ``ResnetItem_i``, ``Downsample_j``, ``GroupNorm_0``,
``Conv1d_1``), so ``convert.params_from_jax`` carries it across as a copy.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor

from ..dsp import MelSpectrogram
from ..ops.conv import Conv1d
from ..ops.layers import GroupNorm, init_module
from ..ops.unet import Downsample, ResnetModItem
from ..utils import prod, resolve_device
from .model import EncoderBase

__all__ = ["MelEncoder1d", "TanhBottleneck"]

# GroupNorm groups of the items and of the final norm.
_GROUPS = 8


def TanhBottleneck(x: Tensor) -> Tensor:
    """Squashes a latent into (−1, 1)."""
    return torch.tanh(x)


class MelEncoder1d(EncoderBase):
    """Waveform -> mel -> conv-resnet stack -> bottleneck latent::

        mel [b, c, f, l] (float32) folded to [b, c·f, l]
        Conv1d(k=3) -> per stage: num_blocks × ResnetItem, patch Downsample
        -> GroupNorm (flax's: eps 1e-6, one-pass moments) -> SiLU
        -> Conv1d(k=3) -> bottleneck

    The items are :class:`ops.unet.ResnetModItem` without modulation: on a
    CUDA tensor each runs the fused resnet kernels, forward and backward.
    ``downsample_factor = mel_hop_length · prod(factors)``, so the latent of
    T samples has T / downsample_factor positions. Parameters (float32
    masters, cast to ``dtype`` at each use) live on ``device`` (``None``
    means the CUDA card) and are drawn from seed 0; ``DiffusionAE`` draws
    them again from its own generator.
    """

    def __init__(
        self,
        in_channels: int,
        channels: int = 512,
        out_channels: int = 32,
        factors: Sequence[int] = (2,),
        num_blocks: Sequence[int] = (2,),
        mel_channels: int = 80,
        mel_n_fft: int = 1024,
        mel_hop_length: Optional[int] = None,
        mel_sample_rate: int = 48000,
        mel_normalize_log: bool = True,
        bottleneck: Optional[Callable[[Tensor], Tensor]] = TanhBottleneck,
        dtype=None,
        device=None,
    ):
        super().__init__()
        if len(factors) != len(num_blocks):
            raise ValueError("factors and num_blocks must have the same "
                             "length")
        mel_hop_length = mel_hop_length or mel_n_fft // 4
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.downsample_factor = mel_hop_length * prod(list(factors))
        self.bottleneck = bottleneck
        self.to_mel = MelSpectrogram(
            n_fft=mel_n_fft, hop_length=mel_hop_length, win_length=mel_n_fft,
            sample_rate=mel_sample_rate, n_mel_channels=mel_channels,
            normalize_log=mel_normalize_log)
        device = resolve_device(device)
        common = dict(dtype=dtype, device=device)
        self.Conv1d_0 = Conv1d(in_channels * mel_channels, channels, 3,
                               padding=1, **common)
        self.layout = []
        items = 0
        for stage, (factor, blocks) in enumerate(zip(factors, num_blocks)):
            for _ in range(blocks):
                name = f"ResnetItem_{items}"
                items += 1
                self.add_module(name, ResnetModItem(
                    channels, _GROUPS, use_modulation=False, **common))
                self.layout.append(name)
            self.add_module(f"Downsample_{stage}", Downsample(
                channels, channels, factor, **common))
            self.layout.append(f"Downsample_{stage}")
        self.GroupNorm_0 = GroupNorm(channels, _GROUPS, **common)
        self.Conv1d_1 = Conv1d(channels, out_channels, 3, padding=1, **common)
        init_module(self, torch.Generator(device=device).manual_seed(0))

    def forward(self, x: Tensor, with_info: bool = False):
        """x [b, c, t] -> latent [b, out_channels, t / downsample_factor]
        (and ``{}`` with ``with_info``)."""
        mel = self.to_mel(x)
        b, c, f, length = mel.shape
        h = self.Conv1d_0(mel.reshape(b, c * f, length))
        h = h.transpose(1, 2).contiguous()  # [b, l, C] for the items
        for name in self.layout:
            h = getattr(self, name)(h)
        h = F.silu(self.GroupNorm_0(h))
        latent = self.Conv1d_1(h.transpose(1, 2))
        if self.bottleneck is not None:
            latent = self.bottleneck(latent)
        return (latent, {}) if with_info else latent
