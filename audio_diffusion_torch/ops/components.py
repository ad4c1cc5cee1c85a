"""Network factory ``UNetV0`` (counterpart of
audio_diffusion_tpu/ops/components.py), dim 1, 2 or 3, with the same flat
kwargs, and the net plugins ``LTPlugin`` and ``AppendChannelsPlugin``,
which wrap a factory into another with the same call."""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch import Tensor, nn

from ..utils import default, resolve_device
from .conv import Conv1d, ConvTranspose1d
from .net import Net
from .unet import (AppendChannelsWrapper, ClassifierFreeGuidanceWrapper,
                   TimeConditioningWrapper, XUNet)
from .unet2d import XUNet2d
from .unet3d import XUNet3d

__all__ = ["UNetV0", "XUNet", "LTPlugin", "AppendChannelsPlugin"]


def UNetV0(
    dim: int,
    in_channels: int,
    channels: Sequence[int],
    factors: Sequence[int],
    items: Sequence[int],
    attentions: Optional[Sequence[int]] = None,
    cross_attentions: Optional[Sequence[int]] = None,
    context_channels: Optional[Sequence[int]] = None,
    attention_features: Optional[int] = None,
    attention_heads: Optional[int] = None,
    embedding_features: Optional[int] = None,
    resnet_groups: int = 8,
    use_modulation: bool = True,
    modulation_features: int = 1024,
    embedding_max_length: Optional[int] = None,
    use_time_conditioning: bool = True,
    use_embedding_cfg: bool = False,
    use_text_conditioning: bool = False,
    out_channels: Optional[int] = None,
    text_encoder: Optional[Any] = None,
    lane_fold: bool = True,
    use_pallas: bool = False,
    use_remat: bool = False,
    remat_policy: Optional[str] = None,
    channel_change: str = "resample",
    dtype: Optional[torch.dtype] = None,
    param_dtype: torch.dtype = torch.float32,
    device=None,
) -> Net:
    """Declarative U-Net factory; returns a :class:`Net` whose module lives
    on ``device`` (``None`` means the CUDA card). The module is the XUNet,
    wrapped in classifier-free guidance (``use_embedding_cfg``), wrapped in
    time conditioning, as in the JAX package. With
    ``use_text_conditioning`` the ``text_encoder`` (for example
    ``ops.text.RandomT5TextEncoder`` or ``ops.text.StubTextEncoder``) is
    attached as ``net.text_encoder``, and
    the model layer turns ``text=`` into ``embedding=`` with it.

    ``dim`` 1 builds the 1-D ``XUNet`` ([B, C, T]), 2 ``XUNet2d`` ([B, C,
    H, W]) and 3 ``XUNet3d`` ([B, C, D, H, W]). ``lane_fold`` and
    ``use_pallas`` are the JAX package's TPU switches: they are accepted and
    ignored (the port never folds lanes, and every 1-D resnet item of
    constant width runs the fused kernels, forward and backward, on a CUDA
    tensor), except where the JAX factory refuses them: ``use_pallas=True``
    at dim 2/3, and ``lane_fold=True`` with ``channel_change="first_item"``
    raise ``ValueError``. ``channel_change`` (``"resample"`` or
    ``"first_item"``) is a dim-1 switch: dim 2 refuses ``"first_item"``,
    and dim 3 ignores it, as the JAX factory does. Not ported, and raising
    ``NotImplementedError``: the pretrained T5 encoder
    (``use_text_conditioning`` without a ``text_encoder``: its ``t5-base``
    weights are not in the repository).

    ``use_remat`` checkpoints each level's item stack (its activations are
    recomputed in the backward); ``remat_policy`` is None (recompute
    everything) or ``"dots_with_no_batch_dims_saveable"`` (keep the Dense
    products); another name raises ``ValueError``.
    """
    if dim not in (1, 2, 3):
        raise ValueError(f"UNetV0: dim must be 1, 2 or 3, got {dim}")
    if dim == 2 and channel_change != "resample":
        raise ValueError("channel_change is a dim=1 parity-mode switch")
    if dim > 1 and use_pallas:
        raise ValueError("use_pallas is implemented for dim=1 only")
    if dim == 1 and channel_change == "first_item" and lane_fold:
        raise ValueError("channel_change='first_item' is a parity-mode "
                         "geometry; build with lane_fold=False")
    num_layers = len(channels)
    attentions = default(attentions, [0] * num_layers)
    cross_attentions = default(cross_attentions, [0] * num_layers)
    context_channels = default(context_channels, [0] * num_layers)
    xs = (channels, factors, items, attentions, cross_attentions,
          context_channels)
    if not all(len(x) == num_layers for x in xs):
        raise ValueError(
            "channels/factors/items/attentions/cross_attentions/"
            "context_channels must all have the same length")
    if use_text_conditioning and text_encoder is None:
        raise NotImplementedError(
            "UNetV0 use_text_conditioning without text_encoder= builds the "
            "pretrained T5TextEncoder (t5-base), whose weights are not in "
            "the repository (ROADMAP: the pretrained T5 weights); pass a "
            "text_encoder such as ops.text.RandomT5TextEncoder or "
            "ops.text.StubTextEncoder, or condition with embedding=")
    if use_time_conditioning and not use_modulation:
        raise ValueError("use_time_conditioning requires use_modulation=True")
    if use_embedding_cfg and (embedding_max_length is None
                              or embedding_features is None):
        raise ValueError("use_embedding_cfg requires embedding_max_length "
                         "and embedding_features")

    device = resolve_device(device)
    out_channels = default(out_channels, in_channels)
    common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
    unet_kwargs = dict(
        in_channels=in_channels, out_channels=out_channels,
        channels=tuple(channels), factors=tuple(factors), items=tuple(items),
        attentions=tuple(attentions),
        cross_attentions=tuple(cross_attentions),
        context_channels=tuple(context_channels),
        embedding_features=embedding_features,
        attention_heads=default(attention_heads, 8),
        attention_features=default(attention_features, 64),
        resnet_groups=resnet_groups, use_modulation=use_modulation,
        modulation_features=modulation_features, use_remat=use_remat,
        remat_policy=remat_policy, **common)
    if dim == 1:
        module: nn.Module = XUNet(channel_change=channel_change,
                                  **unet_kwargs)
    else:
        module = (XUNet2d if dim == 2 else XUNet3d)(**unet_kwargs)
    if use_embedding_cfg:
        module = ClassifierFreeGuidanceWrapper(
            module, embedding_max_length, embedding_features, **common)
    if use_time_conditioning:
        module = TimeConditioningWrapper(module, modulation_features, **common)
    net = Net(module, in_channels=in_channels, out_channels=out_channels,
              uses_sigma=use_time_conditioning, compute_dtype=dtype)
    if use_text_conditioning:
        net.text_encoder = text_encoder
    return net


def _wrap(inner_net: Net, module: nn.Module, in_channels: int,
          out_channels: int) -> Net:
    """A Net around ``module`` with the inner net's contract: σ use,
    compute dtype and text encoder."""
    net = Net(module, in_channels=in_channels, out_channels=out_channels,
              uses_sigma=inner_net.uses_sigma,
              compute_dtype=inner_net.compute_dtype)
    net.text_encoder = inner_net.text_encoder
    return net


class _LTModule(nn.Module):
    """Learned transform around a net: a reflect-padded strided ``encode``
    conv (k = window, no bias) from C to C·num_filters channels, the inner
    net, and the mirrored ``decode`` transposed conv back; both pad
    window // 2 − stride // 2 and compute in the inner net's dtype. With
    ``return_hidden`` the inner net's encoder state passes through."""

    def __init__(self, inner: nn.Module, in_channels: int,
                 in_channel_transform: int, out_channel_transform: int,
                 out_channels: int, window_length: int, stride: int,
                 dtype=None, device=None):
        super().__init__()
        padding = window_length // 2 - stride // 2
        common = dict(stride=stride, padding=padding, use_bias=False,
                      dtype=dtype, device=device)
        self.inner = inner
        self.encode = Conv1d(in_channels, in_channel_transform, window_length,
                             padding_mode="reflect", **common)
        self.decode = ConvTranspose1d(out_channel_transform, out_channels,
                                      window_length, **common)

    def forward(self, x: Tensor, sigmas: Optional[Tensor] = None, **kwargs):
        h = self.inner(self.encode(x), sigmas, **kwargs)
        if kwargs.get("return_hidden", False):
            h, enc = h
            return self.decode(h), enc
        return self.decode(h)


def LTPlugin(net_t: Callable[..., Net], num_filters: int, window_length: int,
             stride: int) -> Callable[..., Net]:
    """Learned Transform Plugin: ``net_t``'s net runs on a learned strided
    framing of the signal (``num_filters`` channels per input channel, 1 /
    ``stride`` of its length) and a learned transposed conv maps it back::

        net_t = LTPlugin(UNetV0, num_filters=4, window_length=8, stride=4)
        model = DiffusionModel(net_t=net_t, in_channels=2, ...)

    The framing convs live on the inner net's device."""

    def _factory(dim: int = 1, in_channels: int = 1,
                 out_channels: Optional[int] = None, **kwargs) -> Net:
        out_channels = default(out_channels, in_channels)
        in_transform = in_channels * num_filters
        out_transform = out_channels * num_filters
        inner_net = net_t(dim=dim, in_channels=in_transform,
                          out_channels=out_transform, **kwargs)
        device = next(inner_net.module.parameters()).device
        module = _LTModule(inner_net.module, in_channels, in_transform,
                           out_transform, out_channels, window_length,
                           stride, dtype=inner_net.compute_dtype,
                           device=device)
        return _wrap(inner_net, module, in_channels, out_channels)

    return _factory


def AppendChannelsPlugin(net_t: Callable[..., Net],
                         channels: int) -> Callable[..., Net]:
    """The inner net takes ``in_channels + channels``: the ``channels`` of
    ``append_channels=`` are concatenated to its input
    (:class:`ops.unet.AppendChannelsWrapper`). The upsampler and the
    vocoder condition through it."""

    def _factory(in_channels: int, out_channels: Optional[int] = None,
                 **kwargs) -> Net:
        out_channels = default(out_channels, in_channels)
        inner_net = net_t(in_channels=in_channels + channels,
                          out_channels=out_channels, **kwargs)
        return _wrap(inner_net, AppendChannelsWrapper(inner_net.module),
                     in_channels, out_channels)

    return _factory
