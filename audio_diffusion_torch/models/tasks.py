"""Task models built on :class:`DiffusionModel` (counterpart of
audio_diffusion_tpu/models/tasks.py): the autoencoder ``DiffusionAE``, the
bandwidth extender ``DiffusionUpsampler``, the mel vocoder
``DiffusionVocoder`` and the autoregressive ``DiffusionAR``.

The autoencoder's encoder and the vocoder's learned ``to_flat`` are
trainable extras of the model (:meth:`DiffusionModel.split_params`): they
live on the model's device, ride in ``model.params`` under the prefixes
``encoder/`` and ``to_flat/``, and train with the net. Every fresh draw of
noise goes through :func:`diffusion.noise.normal`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import Tensor
from torch.func import functional_call

from ..diffusion import noise as _noise
from ..diffusion.samplers import ARVSampler
from ..diffusion.vdiffusion import ARVDiffusion
from ..dsp import MelSpectrogram, downsample, upsample
from ..ops.components import AppendChannelsPlugin
from ..ops.conv import ConvTranspose1d
from ..utils import closest_power_2, default, dequant_pcm16, groupby
from .model import AdapterBase, DiffusionModel, EncoderBase

__all__ = ["DiffusionAE", "DiffusionUpsampler", "DiffusionVocoder",
           "DiffusionAR"]

Params = Dict[str, Tensor]


class DiffusionAE(DiffusionModel):
    """Diffusion autoencoder: the encoder's latent is injected as context
    channels at ``inject_depth``, and the encoder trains jointly with the
    net::

        encoder = MelEncoder1d(in_channels=2, channels=512, factors=[2],
                               num_blocks=[12], out_channels=32,
                               mel_channels=80)
        ae = DiffusionAE(net_t=UNetV0, inject_depth=6, encoder=encoder,
                         **presets.AUTOENCODER_48K)
        loss = ae(audio)                       # [B, 2, 2**18]
        latent = ae.encode(audio)              # [B, 32, 512]
        out = ae.decode(latent, num_steps=50)  # [B, 2, 2**18]
    """

    def __init__(self, in_channels: int, channels: Sequence[int],
                 encoder: EncoderBase, inject_depth: int,
                 latent_factor: Optional[int] = None,
                 adapter: Optional[AdapterBase] = None, **kwargs):
        if not 0 <= inject_depth < len(channels):
            raise ValueError(
                f"inject_depth={inject_depth} out of range for a "
                f"{len(channels)}-level net (0..{len(channels) - 1})")
        context_channels = [0] * len(channels)
        context_channels[inject_depth] = encoder.out_channels
        super().__init__(in_channels=in_channels, channels=channels,
                         context_channels=context_channels, **kwargs)
        self.in_channels = in_channels
        self.encoder = self._add_extra("encoder", encoder)
        self.inject_depth = inject_depth
        self.latent_factor = default(latent_factor, encoder.downsample_factor)
        self.adapter = adapter

    def _example(self, x: Tensor) -> Tensor:
        return self.adapter.encode(x) if self.adapter is not None else x

    def _encode(self, params: Params, x: Tensor):
        return functional_call(self.encoder, params, (x,),
                               {"with_info": True}, strict=True)

    def loss(self, params: Params, generator: torch.Generator, x: Tensor,
             with_info: bool = False, **kwargs):
        """The v-objective of the net conditioned on the encoder's latent of
        ``x`` (injected at ``inject_depth``); gradients reach the encoder.
        ``channels=`` is the model's own and cannot be passed."""
        if "channels" in kwargs:
            raise ValueError(
                "DiffusionAE injects its encoder's latent as channels= at "
                "inject_depth; pass other context through another kwarg")
        x = dequant_pcm16(x)
        net_params, extras = self.split_params(params)
        latent, info = self._encode(extras["encoder"], x)
        channels = [None] * self.inject_depth + [latent]
        loss = self.diffusion.loss(net_params, generator, self._example(x),
                                   channels=channels, **kwargs)
        return (loss, info) if with_info else loss

    def encode(self, x, with_info: bool = False,
               params: Optional[Params] = None):
        """The latent of audio ``x`` [B, C, T] (moved to the model's
        device): [B, out_channels, T / downsample_factor]."""
        _, extras = self.split_params(default(params, self.params))
        with torch.inference_mode():
            x = torch.as_tensor(x, device=self.device)
            latent, info = self._encode(extras["encoder"], dequant_pcm16(x))
        return (latent, info) if with_info else latent

    def decode(self, latent, generator: Optional[torch.Generator] = None,
               params: Optional[Params] = None, **kwargs) -> Tensor:
        """Audio from a latent [B, out_channels, L]: a sample of
        ``closest_power_2(L · latent_factor)`` samples conditioned on it,
        from noise in the latent's dtype drawn from ``generator``."""
        if "channels" in kwargs:
            raise ValueError("DiffusionAE.decode conditions on the given "
                             "latent; channels= cannot be passed")
        generator = default(generator, self.generator)
        latent = torch.as_tensor(latent, device=self.device)
        length = closest_power_2(latent.shape[2] * self.latent_factor)
        with torch.inference_mode():
            noise = _noise.normal(generator,
                                  (latent.shape[0], self.in_channels, length),
                                  latent.dtype, self.device)
        out = self._sample(default(params, self.params), generator, noise,
                           channels=[None] * self.inject_depth + [latent],
                           **kwargs)
        return self.adapter.decode(out) if self.adapter is not None else out


class DiffusionUpsampler(DiffusionModel):
    """Bandwidth extension: the net sees its input with the lossy
    ``upsample(downsample(x))`` round trip appended as channels::

        up = DiffusionUpsampler(net_t=UNetV0, upsample_factor=16,
                                **presets.UPSAMPLER_16X)
        loss = up(audio)                           # [B, 2, 2**18]
        out = up.sample(low, num_steps=50)         # [B, 2, 2**14] -> 2**18
    """

    def __init__(self, in_channels: int, upsample_factor: int,
                 net_t: Callable, **kwargs):
        self.upsample_factor = upsample_factor
        super().__init__(net_t=AppendChannelsPlugin(net_t,
                                                    channels=in_channels),
                         in_channels=in_channels, **kwargs)
        self.in_channels = in_channels

    def reupsample(self, x: Tensor) -> Tensor:
        return upsample(downsample(x, factor=self.upsample_factor),
                        factor=self.upsample_factor)

    def loss(self, params: Params, generator: torch.Generator, x: Tensor,
             **kwargs) -> Tensor:
        x = dequant_pcm16(x)
        return self.diffusion.loss(self.split_params(params)[0], generator,
                                   x, append_channels=self.reupsample(x),
                                   **kwargs)

    def sample(self, downsampled, generator: Optional[torch.Generator] = None,
               params: Optional[Params] = None, **kwargs) -> Tensor:
        """``upsample_factor`` times longer audio from ``downsampled``
        [B, C, T], sampled from noise drawn from ``generator``."""
        generator = default(generator, self.generator)
        with torch.inference_mode():
            reupsampled = upsample(
                torch.as_tensor(downsampled, device=self.device),
                factor=self.upsample_factor)
            noise = _noise.normal(generator, reupsampled.shape,
                                  reupsampled.dtype, self.device)
        return self._sample(default(params, self.params), generator, noise,
                            append_channels=reupsampled, **kwargs)


class DiffusionVocoder(DiffusionModel):
    """Mel spectrogram -> waveform. Channels fold into the batch
    ([b, c, t] -> [b·c, 1, t]); the mel is stretched to the waveform's
    length by the learned bias-free transposed conv ``to_flat``
    (k = win, stride = hop, float32) and appended as one channel::

        voc = DiffusionVocoder(net_t=UNetV0, **presets.VOCODER_48K)
        loss = voc(audio)                          # [B, 2, 2**18]
        out = voc.sample(voc.to_spectrogram(audio), num_steps=50)

    ``mel_*`` kwargs configure :class:`dsp.MelSpectrogram`;
    ``in_channels`` is ignored.
    """

    def __init__(self, net_t: Callable, mel_channels: int, mel_n_fft: int,
                 mel_hop_length: Optional[int] = None,
                 mel_win_length: Optional[int] = None,
                 in_channels: int = 1, **kwargs):
        mel_hop_length = default(mel_hop_length, mel_n_fft // 4)
        mel_win_length = default(mel_win_length, mel_n_fft)
        mel_kwargs, kwargs = groupby("mel_", kwargs)
        super().__init__(net_t=AppendChannelsPlugin(net_t, channels=1),
                         in_channels=1, **kwargs)
        self.to_spectrogram = MelSpectrogram(
            n_fft=mel_n_fft, hop_length=mel_hop_length,
            win_length=mel_win_length, n_mel_channels=mel_channels,
            **mel_kwargs)
        self.to_flat = self._add_extra("to_flat", ConvTranspose1d(
            mel_channels, 1, kernel_size=mel_win_length,
            stride=mel_hop_length,
            padding=(mel_win_length - mel_hop_length) // 2, use_bias=False,
            device=self.device))

    def _example(self, x: Tensor) -> Tensor:
        return x.reshape(-1, 1, x.shape[-1])

    def _flatten(self, params: Params, spec: Tensor) -> Tensor:
        """[N, f, l] mel -> [N, 1, l·hop] conditioning channel."""
        return functional_call(self.to_flat, params, (spec,), strict=True)

    def loss(self, params: Params, generator: torch.Generator, x: Tensor,
             **kwargs) -> Tensor:
        x = dequant_pcm16(x)
        net_params, extras = self.split_params(params)
        spec = self.to_spectrogram(x)  # [b, c, f, l]
        flat = self._flatten(extras["to_flat"], spec.flatten(0, 1))
        return self.diffusion.loss(net_params, generator, self._example(x),
                                   append_channels=flat, **kwargs)

    def sample(self, spectrogram, generator: Optional[torch.Generator] = None,
               params: Optional[Params] = None, **kwargs) -> Tensor:
        """A waveform [..., l·hop] from a mel [..., f, l] (any leading dims,
        a stereo mel [b, 2, f, l] included), from noise drawn from
        ``generator``."""
        generator = default(generator, self.generator)
        params = default(params, self.params)
        with torch.inference_mode():
            spectrogram = torch.as_tensor(spectrogram, device=self.device)
            lead = spectrogram.shape[:-2]
            flat = self._flatten(self.split_params(params)[1]["to_flat"],
                                 spectrogram.reshape(
                                     (-1,) + spectrogram.shape[-2:]))
            noise = _noise.normal(generator, flat.shape, flat.dtype,
                                  self.device)
        waveform = self._sample(params, generator, noise,
                                append_channels=flat, **kwargs)
        return waveform.reshape(lead + (waveform.shape[-1],))


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
