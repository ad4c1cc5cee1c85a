"""Network factory ``UNetV0`` (counterpart of
audio_diffusion_tpu/ops/components.py), dim=1, with the same flat kwargs."""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..utils import default, resolve_device
from .net import Net
from .unet import TimeConditioningWrapper, XUNet

__all__ = ["UNetV0", "XUNet"]


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
    on ``device`` (``None`` means the CUDA card).

    ``lane_fold`` and ``use_pallas`` are the JAX package's TPU switches: they
    are accepted and ignored (the port never folds lanes, and every resnet
    item runs the fused kernels, forward and backward, on a CUDA tensor). Not
    ported yet, and raising ``NotImplementedError``: dim 2/3, cross-attention,
    context injection, CFG, text conditioning, remat (activation
    checkpointing) and ``channel_change="first_item"``.
    """
    if dim != 1:
        raise NotImplementedError(
            f"UNetV0 dim={dim} is not ported yet (ROADMAP: dim 2/3)")
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
    unported = {
        "use_embedding_cfg": (use_embedding_cfg, "conditioning"),
        "use_text_conditioning": (use_text_conditioning or
                                  text_encoder is not None, "conditioning"),
        "cross_attentions": (any(cross_attentions), "conditioning"),
        "context_channels": (any(context_channels), "conditioning"),
        "use_remat": (use_remat or remat_policy is not None,
                      "trainer and data"),
        "channel_change": (channel_change != "resample", "parity geometry"),
    }
    for name, (asked, item) in unported.items():
        if asked:
            raise NotImplementedError(
                f"UNetV0 {name} is not ported yet (ROADMAP: {item})")
    if use_time_conditioning and not use_modulation:
        raise ValueError("use_time_conditioning requires use_modulation=True")

    device = resolve_device(device)
    out_channels = default(out_channels, in_channels)
    common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
    module = XUNet(
        in_channels=in_channels, out_channels=out_channels,
        channels=tuple(channels), factors=tuple(factors), items=tuple(items),
        attentions=tuple(attentions),
        attention_heads=default(attention_heads, 8),
        attention_features=default(attention_features, 64),
        resnet_groups=resnet_groups, use_modulation=use_modulation,
        modulation_features=modulation_features, **common)
    if use_time_conditioning:
        module = TimeConditioningWrapper(module, modulation_features, **common)
    return Net(module, in_channels=in_channels, out_channels=out_channels,
               uses_sigma=use_time_conditioning, compute_dtype=dtype)
