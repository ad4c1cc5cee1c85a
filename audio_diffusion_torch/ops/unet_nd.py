"""The N-d U-Net body behind ``XUNet2d`` and ``XUNet3d`` (counterparts of
audio_diffusion_tpu/ops/unet2d.py and unet3d.py, which differ only in
rank): the same level structure, conditioning contract and encoder reuse
as the 1-D ``XUNet``.

Activations stay channels-last and contiguous inside the net ([B, H, W, C]
or [B, D, H, W, C]), so the Dense layers, the patch reshapes and the
attention's flattening are views. Each k=3 "SAME" conv runs as
``F.conv2d``/``F.conv3d`` on ``h.permute(0, -1, 1, ...)``: that view is
``torch.channels_last`` (``channels_last_3d``), which cuDNN convolves
without a copy. The public boundary is [B, C, *spatial].

No hand-written kernel runs here: the JAX package runs no Pallas kernel at
dim 2/3 either (its factory asserts ``not use_pallas``). The items are
flax's: a resnet item (GN -> SiLU -> conv, twice, + identity) and a
separate modulation item, ``GroupNorm`` with flax's numerics (eps 1e-5),
context injection as an inline Dense over ``cat([x, ctx])``. Parameter
names and layouts follow the JAX tree: a conv kernel stays
``...Conv_0.kernel`` [k, ..., Cin, Cout]; a Dense kernel becomes
``weight`` [out, in].
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .attention import AttentionItem, CrossAttentionItem
from .layers import Dense, GroupNorm, lecun_normal_, new_param
from .unet import _cast, _check_remat_policy, _check_unused_kwargs, run_stack

__all__ = ["ConvNd", "ResnetItemNd", "ModulationItemNd", "DownsampleNd",
           "UpsampleNd", "ItemStackNd", "XUNetNd"]

_GN_EPS = 1e-5
_CONV = {2: F.conv2d, 3: F.conv3d}


def _features_view(v: Tensor, dim: int) -> Tensor:
    """[B, C] -> [B, 1, ..., 1, C], broadcasting over ``dim`` spatial axes."""
    return v.reshape(v.shape[:1] + (1,) * dim + v.shape[1:])


class _ConvKernel(nn.Module):
    """flax ``nn.Conv``'s parameters: ``kernel`` [k, ..., Cin, Cout] and
    ``bias`` [Cout]."""

    def __init__(self, dim: int, in_features: int, features: int,
                 kernel_size: int, param_dtype=torch.float32, device=None):
        super().__init__()
        p = dict(dtype=param_dtype, device=device)
        self.kernel = new_param(*(kernel_size,) * dim, in_features, features,
                                **p)
        self.bias = new_param(features, **p)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[:-1]),
                      generator)
        nn.init.zeros_(self.bias)


class ConvNd(nn.Module):
    """The JAX package's ``Conv2d``/``Conv3d``: a k=3 "SAME" conv of
    channels-last [B, *spatial, Cin] (flax ``nn.Conv`` as ``Conv_0``),
    computed in ``dtype``; the bias is added to the rounded product, as
    flax adds it."""

    def __init__(self, dim: int, in_features: int, features: int,
                 kernel_size: int = 3, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.Conv_0 = _ConvKernel(dim, in_features, features, kernel_size,
                                  param_dtype, device)

    def forward(self, h: Tensor) -> Tensor:
        d = self.dim
        h, k, b = (_cast(t, self.dtype)
                   for t in (h, self.Conv_0.kernel, self.Conv_0.bias))
        # [k, ..., Cin, Cout] -> [Cout, Cin, k, ...]; h as NC* over its
        # channels-last memory.
        w = k.permute(d + 1, d, *range(d))
        y = _CONV[d](h.permute(0, d + 1, *range(1, d + 1)), w,
                     padding=k.shape[0] // 2)
        return y.permute(0, *range(2, d + 2), 1) + b


class ResnetItemNd(nn.Module):
    """(GN -> SiLU -> conv) × 2 + identity (``ResnetItem2d``/``3d``)."""

    def __init__(self, dim: int, channels: int, groups: int = 8, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        conv = f"Conv{dim}d"
        self.GroupNorm_0 = GroupNorm(channels, groups, _GN_EPS, **common)
        self.add_module(f"{conv}_0", ConvNd(dim, channels, channels,
                                            **common))
        self.GroupNorm_1 = GroupNorm(channels, groups, _GN_EPS, **common)
        self.add_module(f"{conv}_1", ConvNd(dim, channels, channels,
                                            **common))
        self.convs = (f"{conv}_0", f"{conv}_1")

    def forward(self, x: Tensor) -> Tensor:
        h = getattr(self, self.convs[0])(F.silu(self.GroupNorm_0(x)))
        h = getattr(self, self.convs[1])(F.silu(self.GroupNorm_1(h)))
        return x + h


class ModulationItemNd(nn.Module):
    """x + GN(x)·(1 + scale) + shift, (scale, shift) = Dense(SiLU(features))
    zero-initialized (``ModulationItem2d``/``3d``)."""

    def __init__(self, dim: int, channels: int, modulation_features: int,
                 groups: int = 8, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dim = dim
        self.GroupNorm_0 = GroupNorm(channels, groups, _GN_EPS, **common)
        self.Dense_0 = Dense(modulation_features, 2 * channels,
                             zero_init=True, **common)

    def forward(self, x: Tensor, features: Tensor) -> Tensor:
        h = self.GroupNorm_0(x)
        mod = _features_view(self.Dense_0(F.silu(features.to(h.dtype))),
                             self.dim)
        scale, shift = mod.chunk(2, dim=-1)
        return x + h * (1.0 + scale) + shift


class DownsampleNd(nn.Module):
    """Patch downsample: non-overlapping f^dim patches (a reshape and one
    transpose, patch-position-major), then ``Dense_0`` to ``features``."""

    def __init__(self, dim: int, in_channels: int, features: int,
                 factor: int, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim, self.factor = dim, factor
        self.Dense_0 = Dense(factor ** dim * in_channels, features,
                             dtype=dtype, param_dtype=param_dtype,
                             device=device)

    def forward(self, x: Tensor) -> Tensor:
        f, d = self.factor, self.dim
        if f > 1:
            b, *spatial, c = x.shape
            split = [n for s in spatial for n in (s // f, f)]
            # [B, S1/f, f, S2/f, f, ..., C] -> [B, S1/f, S2/f, ..., f, f,
            # ..., C]: (0, 1, 3, 2, 4, 5) in 2-D, (0, 1, 3, 5, 2, 4, 6, 7)
            # in 3-D.
            order = (0, *range(1, 2 * d, 2), *range(2, 2 * d + 1, 2),
                     2 * d + 1)
            x = x.reshape(b, *split, c).permute(order).reshape(
                b, *(s // f for s in spatial), f ** d * c)
        return self.Dense_0(x)


class UpsampleNd(nn.Module):
    """Patch upsample: ``Dense_0`` to f^dim·features, then each position's
    patch laid out in place (the inverse reshape)."""

    def __init__(self, dim: int, in_channels: int, features: int,
                 factor: int, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim, self.factor, self.features = dim, factor, features
        self.Dense_0 = Dense(in_channels, factor ** dim * features,
                             dtype=dtype, param_dtype=param_dtype,
                             device=device)

    def forward(self, x: Tensor) -> Tensor:
        f, d = self.factor, self.dim
        x = self.Dense_0(x)
        if f > 1:
            b, *spatial, _ = x.shape
            # [B, S1, S2, ..., f, f, ..., F] -> [B, S1, f, S2, f, ..., F]:
            # (0, 1, 3, 2, 4, 5) in 2-D, (0, 1, 4, 2, 5, 3, 6, 7) in 3-D.
            order = (0, *(a for i in range(1, d + 1) for a in (i, i + d)),
                     2 * d + 1)
            x = x.reshape(b, *spatial, *(f,) * d, self.features).permute(
                order).reshape(b, *(s * f for s in spatial), self.features)
        return x


class ItemStackNd(nn.Module):
    """One level's items: ([Resnet][Modulation][context Dense][Attn]·a
    [CrossAttn]·c) × items, with flax's per-class module names
    (``ResnetItem2d_k``, ``ModulationItem2d_k``, ``Dense_k``,
    ``AttentionItem_k``, ``CrossAttentionItem_k``)."""

    def __init__(self, dim: int, channels: int, items: int, attentions: int,
                 cross_attentions: int, context_channels: int,
                 use_modulation: bool, resnet_groups: int,
                 attention_heads: int, attention_features: int,
                 modulation_features: Optional[int],
                 embedding_features: Optional[int], dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dim = dim
        self.layout = []
        for it in range(items):
            resnet = f"ResnetItem{dim}d_{it}"
            self.add_module(resnet, ResnetItemNd(dim, channels, resnet_groups,
                                                 **common))
            mod = f"ModulationItem{dim}d_{it}" if use_modulation else None
            if mod:
                self.add_module(mod, ModulationItemNd(
                    dim, channels, modulation_features, resnet_groups,
                    **common))
            inject = f"Dense_{it}" if context_channels else None
            if inject:
                self.add_module(inject, Dense(channels + context_channels,
                                              channels, **common))
            attns = [f"AttentionItem_{it * attentions + a}"
                     for a in range(attentions)]
            for name in attns:
                self.add_module(name, AttentionItem(
                    channels, attention_heads, attention_features, **common))
            crosses = [f"CrossAttentionItem_{it * cross_attentions + a}"
                       for a in range(cross_attentions)]
            for name in crosses:
                self.add_module(name, CrossAttentionItem(
                    channels, embedding_features, attention_heads,
                    attention_features, **common))
            self.layout.append((resnet, mod, inject, attns, crosses))

    def forward(self, x: Tensor, features: Optional[Tensor],
                embedding: Optional[Tensor] = None,
                context: Optional[Tensor] = None) -> Tensor:
        spatial = x.shape[1:-1]
        for resnet, mod, inject, attns, crosses in self.layout:
            x = getattr(self, resnet)(x)
            if mod:
                if features is None:
                    raise ValueError("modulation requires features (enable "
                                     "time conditioning or pass features=)")
                x = getattr(self, mod)(x, features)
            if inject:
                if context is None:
                    raise ValueError(
                        "this depth was built with context_channels > 0; "
                        "pass channels=[...] with a tensor at this depth")
                ctx = context.movedim(1, -1).to(x.dtype)
                if ctx.shape[1:-1] != spatial:
                    raise ValueError(f"context spatial {tuple(ctx.shape[1:-1])}"
                                     f" != {tuple(spatial)} at this depth")
                x = x + getattr(self, inject)(torch.cat([x, ctx], dim=-1))
            if attns or crosses:
                if crosses and embedding is None:
                    raise ValueError("cross attention requires embedding= "
                                     "(or text= at the model layer)")
                flat = x.reshape(x.shape[0], -1, x.shape[-1])
                for name in attns:
                    flat = getattr(self, name)(flat)
                for name in crosses:
                    flat = getattr(self, name)(flat, embedding)
                x = flat.reshape(x.shape)
        return x


class XUNetNd(nn.Module):
    """The U-Net over ``dim`` spatial axes. Per level i:
      down:  DownsampleNd(factor_i, -> channels_i); down-items
      inner: next level (the innermost level has no skip)
      up:    skip merge; up-items; UpsampleNd(factor_i)
    then ``GroupNorm_0`` -> SiLU -> ``proj_out`` (k=3 conv). The skip merge
    is the gate h + skip·(1 + Dense(SiLU(features))) with modulation, a
    Dense over cat([h, skip]) without. I/O [B, C, *spatial]; ``channels=``
    context tensors [B, ctx, *spatial_i]."""

    def __init__(self, dim: int, in_channels: int, out_channels: int,
                 channels: Sequence[int], factors: Sequence[int],
                 items: Sequence[int], attentions: Sequence[int],
                 cross_attentions: Optional[Sequence[int]] = None,
                 context_channels: Optional[Sequence[int]] = None,
                 embedding_features: Optional[int] = None,
                 attention_heads: int = 8, attention_features: int = 64,
                 resnet_groups: int = 8, use_modulation: bool = True,
                 modulation_features: Optional[int] = None,
                 use_remat: bool = False, remat_policy: Optional[str] = None,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        _check_remat_policy(remat_policy)
        n = len(channels)
        cross_attentions = cross_attentions or [0] * n
        context_channels = context_channels or [0] * n
        if any(cross_attentions) and embedding_features is None:
            raise ValueError("cross_attentions requires embedding_features "
                             "(the width of embedding=)")
        self.dim, self.num_levels = dim, n
        self.factors = tuple(factors)
        self.use_modulation, self.dtype = use_modulation, dtype
        self.use_remat, self.remat_policy = use_remat, remat_policy
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)

        def stack(i: int) -> ItemStackNd:
            return ItemStackNd(dim, channels[i], items[i], attentions[i],
                               cross_attentions[i], context_channels[i],
                               use_modulation, resnet_groups, attention_heads,
                               attention_features, modulation_features,
                               embedding_features, **common)

        prev_c = in_channels
        for i in range(n):
            self.add_module(f"down_{i}", DownsampleNd(
                dim, prev_c, channels[i], factors[i], **common))
            self.add_module(f"items_down_{i}", stack(i))
            prev_c = channels[i]
        for i in range(n):
            if i < n - 1:
                self.add_module(f"skip_{i}", (
                    Dense(modulation_features, channels[i], zero_init=True,
                          **common) if use_modulation else
                    Dense(2 * channels[i], channels[i], **common)))
            self.add_module(f"items_up_{i}", stack(i))
            out_c = channels[i - 1] if i > 0 else channels[0]
            self.add_module(f"up_{i}", UpsampleNd(dim, channels[i], out_c,
                                                  factors[i], **common))
        self.GroupNorm_0 = GroupNorm(channels[0], resnet_groups, _GN_EPS,
                                     **common)
        self.proj_out = ConvNd(dim, channels[0], out_channels, **common)

    def _stack(self, name: str, h: Tensor, *args) -> Tensor:
        return run_stack(getattr(self, name), self.use_remat,
                         self.remat_policy, h, *args)

    def forward(self, x: Tensor, sigmas: Optional[Tensor] = None, *,
                features: Optional[Tensor] = None,
                embedding: Optional[Tensor] = None,
                channels: Optional[Sequence[Optional[Tensor]]] = None,
                hidden=None, return_hidden: bool = False, **unused_kwargs):
        """As ``XUNet.forward``: ``channels`` is padded with ``None`` to the
        number of levels; ``return_hidden=True`` also returns the encoder
        state ``(bottleneck, skips)`` (opaque, channels-last), and
        ``hidden=state`` decodes that state with the current
        ``features``."""
        _check_unused_kwargs(unused_kwargs)
        total_factor = math.prod(self.factors)
        spatial = tuple(x.shape[-self.dim:])
        if any(s % total_factor for s in spatial):
            raise ValueError(
                f"input spatial dims {spatial} must be divisible by the "
                f"product of the downsampling factors ({total_factor})")
        contexts = list(channels or [])
        contexts += [None] * (self.num_levels - len(contexts))

        if hidden is not None:
            h, skips = hidden[0], list(hidden[1])
        else:
            h = _cast(x.movedim(1, -1), self.dtype).contiguous()
            skips = []
            for i in range(self.num_levels):
                h = getattr(self, f"down_{i}")(h)
                h = self._stack(f"items_down_{i}", h, features, embedding,
                                contexts[i])
                if i < self.num_levels - 1:
                    skips.append(h)
        enc = (h, tuple(skips))
        for i in reversed(range(self.num_levels)):
            if i < self.num_levels - 1:
                skip, merge = skips.pop(), getattr(self, f"skip_{i}")
                if self.use_modulation:
                    gate = merge(F.silu(features.to(h.dtype)))
                    h = h + skip * (1.0 + _features_view(gate, self.dim))
                else:
                    h = merge(torch.cat([h, skip], dim=-1))
            h = self._stack(f"items_up_{i}", h, features, embedding,
                            contexts[i])
            h = getattr(self, f"up_{i}")(h)
        h = self.proj_out(F.silu(self.GroupNorm_0(h)))
        out = h.movedim(-1, 1).to(x.dtype)
        return (out, enc) if return_hidden else out
