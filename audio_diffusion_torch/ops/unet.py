"""The U-Net compute core (counterpart of audio_diffusion_tpu/ops/unet.py).

Activations are channels-last [B, L, C] inside the net (C contiguous, the
K axis of every product); the public boundary stays [B, C, T]. The JAX
package's TPU layout devices are not ported: no lane folding, no lane→group
matrices, no VMEM guard. This is the math the JAX net computes with
``lane_fold=False``.

Every ``ResnetModItem`` runs the fused resnet item
(``ops/kernels/resnet.py``): the CUDA kernels, forward and backward, on a
CUDA tensor, its plain version on a CPU tensor. Parameters are float32
masters cast to the compute dtype at each use, so gradients arrive in
float32. Parameter names follow the JAX parameter tree, so
``convert.params_from_jax`` is a renaming plus the Dense transposes.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .attention import AttentionItem
from .kernels import resnet as resnet_kernel
from .layers import Dense, lecun_normal_, new_param

__all__ = [
    "group_norm",
    "ResnetModItem",
    "Downsample",
    "Upsample",
    "SkipCat",
    "SkipModulate",
    "ItemStack",
    "XUNet",
    "SigmaEmbedding",
    "TimeConditioningWrapper",
]


def _cast(t: Tensor, dtype) -> Tensor:
    return t.to(dtype) if dtype is not None else t


def group_norm(x: Tensor, groups: int, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    """GroupNorm on [B, L, C]: f32 one-pass moments E[x²] − E[x]² per
    (batch, group), variance clamped at 0; the normalized value is cast to
    x's dtype before the scale and bias, as the JAX lax path does."""
    b, l, c = x.shape
    xg = x.reshape(b, l, groups, c // groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    meansq = xg.square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(torch.clamp(meansq - mean * mean, min=0.0) + eps)
    xn = ((xg - mean) * rstd).reshape(b, l, c)
    return xn.to(x.dtype) * scale + bias


def conv3(x: Tensor, kernel: Tensor, bias: Tensor) -> Tensor:
    """k=3, padding-1 conv of [B, L, Cin] with [3, Cin, Cout] as one product
    over the three taps; tap t reads position l − 1 + t."""
    length = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1))
    taps = torch.cat([xp[:, t:t + length] for t in range(3)], dim=-1)
    return taps @ kernel.reshape(-1, kernel.shape[-1]) + bias


def _check_unused_kwargs(unused: dict) -> None:
    """CFG knobs reaching a net without guidance are a hard error (guidance
    would be silently skipped); other unknown kwargs warn."""
    cfg_keys = {"embedding_scale", "embedding_mask_proba"}
    bad = cfg_keys & unused.keys()
    if bad:
        raise TypeError(
            f"{sorted(bad)} requires a net built with use_embedding_cfg=True; "
            "this net has no CFG plugin, so guidance would be silently "
            "skipped")
    if unused:
        warnings.warn(
            f"conditioning kwargs {sorted(unused)} are not consumed by this "
            "net (typo, or a plugin that would consume them is not enabled)",
            stacklevel=3)


class ResnetModItem(nn.Module):
    """(GN -> SiLU -> conv3) × 2 + identity, then the optional modulation
    epilogue x + GN(x)·(1 + scale) + shift with (scale, shift) =
    Dense(SiLU(features)), zero-initialized. One fused kernel per item."""

    def __init__(self, channels: int, groups: int = 8,
                 use_modulation: bool = True,
                 modulation_features: Optional[int] = None, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        c = channels
        self.groups, self.use_modulation, self.dtype = groups, use_modulation, dtype
        p = dict(dtype=param_dtype, device=device)
        self.gn1_scale, self.gn1_bias = new_param(c, **p), new_param(c, **p)
        self.conv1_kernel, self.conv1_bias = new_param(3, c, c, **p), new_param(c, **p)
        self.gn2_scale, self.gn2_bias = new_param(c, **p), new_param(c, **p)
        self.conv2_kernel, self.conv2_bias = new_param(3, c, c, **p), new_param(c, **p)
        if use_modulation:
            self.mod_gn_scale, self.mod_gn_bias = new_param(c, **p), new_param(c, **p)
            self.mod_dense = Dense(modulation_features, 2 * c, zero_init=True,
                                   dtype=dtype, param_dtype=param_dtype,
                                   device=device)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        c = self.conv1_kernel.shape[1]
        for name, t in self.named_parameters(recurse=False):
            if name.endswith("_kernel"):
                lecun_normal_(t, 3 * c, generator)
            elif name.endswith("_scale"):
                nn.init.ones_(t)
            else:
                nn.init.zeros_(t)

    def forward(self, x: Tensor, features: Optional[Tensor] = None) -> Tensor:
        cast = lambda t: _cast(t, self.dtype)  # noqa: E731
        mods = modb = mgs = mgb = None
        if self.use_modulation:
            if features is None:
                raise ValueError("modulation requires features (enable time "
                                 "conditioning or pass features=)")
            mod = self.mod_dense(F.silu(features.to(x.dtype)))
            mods, modb = (t.contiguous() for t in mod.chunk(2, dim=-1))
            mgs, mgb = cast(self.mod_gn_scale), cast(self.mod_gn_bias)
        return resnet_kernel.fused_resnet_item(
            x, cast(self.gn1_scale), cast(self.gn1_bias),
            cast(self.conv1_kernel), cast(self.conv1_bias),
            cast(self.gn2_scale), cast(self.gn2_bias),
            cast(self.conv2_kernel), cast(self.conv2_bias),
            mods, modb, mgs, mgb, groups=self.groups, eps=1e-5,
            use_modulation=self.use_modulation)


class Downsample(nn.Module):
    """Patch downsample: frames of ``factor`` positions (a reshape,
    position-major) times one [factor·Cin, Cout] kernel."""

    def __init__(self, in_channels: int, features: int, factor: int,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        self.factor, self.dtype = factor, dtype
        p = dict(dtype=param_dtype, device=device)
        self.kernel = new_param(factor * in_channels, features, **p)
        self.bias = new_param(features, **p)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        x, w, b = (_cast(t, self.dtype) for t in (x, self.kernel, self.bias))
        bsz, length, c = x.shape
        return x.reshape(bsz, length // self.factor, self.factor * c) @ w + b


class Upsample(nn.Module):
    """Patch upsample: one [Cin, factor·Cout] kernel (bias [factor·Cout],
    one copy per position), then a reshape into position-major frames."""

    def __init__(self, in_channels: int, features: int, factor: int,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        self.factor, self.features, self.dtype = factor, features, dtype
        p = dict(dtype=param_dtype, device=device)
        self.kernel = new_param(in_channels, factor * features, **p)
        self.bias = new_param(factor * features, **p)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        x, w, b = (_cast(t, self.dtype) for t in (x, self.kernel, self.bias))
        y = x @ w + b
        return y.reshape(x.shape[0], x.shape[1] * self.factor, self.features)


class SkipCat(nn.Module):
    """Skip merge by channel concat + a [2C, C] kernel back to width."""

    def __init__(self, channels: int, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        p = dict(dtype=param_dtype, device=device)
        self.kernel = new_param(2 * channels, channels, **p)
        self.bias = new_param(channels, **p)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor, skip: Tensor,
                features: Optional[Tensor] = None) -> Tensor:
        x, skip, w, b = (_cast(t, self.dtype)
                         for t in (x, skip, self.kernel, self.bias))
        return torch.cat([x, skip], dim=-1) @ w + b


class SkipModulate(nn.Module):
    """Skip merge gated by the modulation features: x + skip·(1 + gate),
    gate = Dense(SiLU(features)), zero-initialized."""

    def __init__(self, channels: int, modulation_features: int, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.Dense_0 = Dense(modulation_features, channels, zero_init=True,
                             dtype=dtype, param_dtype=param_dtype,
                             device=device)

    def forward(self, x: Tensor, skip: Tensor, features: Tensor) -> Tensor:
        gate = self.Dense_0(F.silu(features.to(x.dtype)))[:, None, :]
        return x + skip.to(x.dtype) * (1.0 + gate)


class ItemStack(nn.Module):
    """One level's repeated item sequence: ([Resnet+Mod][Attn]·a) × items."""

    def __init__(self, channels: int, items: int, attentions: int,
                 use_modulation: bool, resnet_groups: int,
                 attention_heads: int, attention_features: int,
                 modulation_features: Optional[int], dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.items, self.attentions = items, attentions
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        for it in range(items):
            self.add_module(f"ResnetModItem_{it}", ResnetModItem(
                channels, resnet_groups, use_modulation, modulation_features,
                **common))
            for a in range(attentions):
                self.add_module(f"AttentionItem_{it * attentions + a}",
                                AttentionItem(channels, attention_heads,
                                              attention_features, **common))

    def forward(self, x: Tensor, features: Optional[Tensor]) -> Tensor:
        for it in range(self.items):
            x = getattr(self, f"ResnetModItem_{it}")(x, features)
            for a in range(self.attentions):
                x = getattr(self, f"AttentionItem_{it * self.attentions + a}")(x)
        return x


class XUNet(nn.Module):
    """The U-Net, written iteratively. Per level i:
      down:  Downsample(factor_i, -> channels_i); down-items
      inner: next level (the innermost level has no skip)
      up:    SkipMerge(inner, skip, features); up-items; Upsample(factor_i)
    then GN -> SiLU -> conv3 to ``out_channels``. I/O is [B, C, T]."""

    def __init__(self, in_channels: int, out_channels: int,
                 channels: Sequence[int], factors: Sequence[int],
                 items: Sequence[int], attentions: Sequence[int],
                 attention_heads: int = 8, attention_features: int = 64,
                 resnet_groups: int = 8, use_modulation: bool = True,
                 modulation_features: Optional[int] = None, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.num_levels = len(channels)
        self.factors = tuple(factors)
        self.resnet_groups = resnet_groups
        self.use_modulation = use_modulation
        self.dtype = dtype
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)

        def stack(i: int) -> ItemStack:
            return ItemStack(channels[i], items[i], attentions[i],
                             use_modulation, resnet_groups, attention_heads,
                             attention_features, modulation_features, **common)

        prev_c = in_channels
        for i in range(self.num_levels):
            self.add_module(f"down_{i}", Downsample(prev_c, channels[i],
                                                    factors[i], **common))
            self.add_module(f"items_down_{i}", stack(i))
            prev_c = channels[i]
        for i in range(self.num_levels):
            if i < self.num_levels - 1:
                self.add_module(f"skip_{i}", (
                    SkipModulate(channels[i], modulation_features, **common)
                    if use_modulation else SkipCat(channels[i], **common)))
            self.add_module(f"items_up_{i}", stack(i))
            out_c = channels[i - 1] if i > 0 else channels[0]
            self.add_module(f"up_{i}", Upsample(channels[i], out_c, factors[i],
                                                **common))
        c0 = channels[0]
        p = dict(dtype=param_dtype, device=device)
        self.out_gn_scale, self.out_gn_bias = new_param(c0, **p), new_param(c0, **p)
        self.out_kernel = new_param(3, c0, out_channels, **p)
        self.out_bias = new_param(out_channels, **p)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        nn.init.ones_(self.out_gn_scale)
        nn.init.zeros_(self.out_gn_bias)
        lecun_normal_(self.out_kernel, 3 * self.out_kernel.shape[1], generator)
        nn.init.zeros_(self.out_bias)

    def forward(self, x: Tensor, sigmas: Optional[Tensor] = None, *,
                features: Optional[Tensor] = None,
                embedding: Optional[Tensor] = None,
                channels: Optional[Sequence[Optional[Tensor]]] = None,
                hidden=None, return_hidden: bool = False,
                **unused_kwargs) -> Tensor:
        if embedding is not None:
            raise NotImplementedError(
                "embedding= (cross-attention conditioning) is not ported yet "
                "(ROADMAP: conditioning)")
        if channels is not None and any(c is not None for c in channels):
            raise NotImplementedError(
                "channels= (context injection) is not ported yet "
                "(ROADMAP: conditioning)")
        if hidden is not None or return_hidden:
            raise NotImplementedError(
                "hidden=/return_hidden= (encoder reuse) is not ported yet "
                "(ROADMAP: encoder reuse)")
        _check_unused_kwargs(unused_kwargs)
        total_factor = math.prod(self.factors)
        if x.shape[-1] % total_factor:
            raise ValueError(
                f"input length {x.shape[-1]} must be divisible by the product "
                f"of the downsampling factors ({total_factor})")

        h = _cast(x.transpose(1, 2), self.dtype)  # [B, T, C]
        skips = []
        for i in range(self.num_levels):
            h = getattr(self, f"down_{i}")(h)
            h = getattr(self, f"items_down_{i}")(h, features)
            if i < self.num_levels - 1:
                skips.append(h)
        for i in reversed(range(self.num_levels)):
            if i < self.num_levels - 1:
                skip = getattr(self, f"skip_{i}")
                h = skip(h, skips.pop(), features)
            h = getattr(self, f"items_up_{i}")(h, features)
            h = getattr(self, f"up_{i}")(h)

        cast = lambda t: _cast(t, self.dtype)  # noqa: E731
        h = group_norm(h, self.resnet_groups, cast(self.out_gn_scale),
                       cast(self.out_gn_bias))
        h = conv3(F.silu(h), cast(self.out_kernel), cast(self.out_bias))
        return h.transpose(1, 2).to(x.dtype)


class SigmaEmbedding(nn.Module):
    """σ -> modulation features: learned Fourier features [sin, cos, σ]
    (angles and ``freqs`` in f32) + Dense -> GELU -> Dense."""

    def __init__(self, features: int, fourier_dim: int = 256, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.freqs = new_param(fourier_dim // 2, dtype=param_dtype,
                               device=device)
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.Dense_0 = Dense(fourier_dim + 1, features, **common)
        self.Dense_1 = Dense(features, features, **common)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        self.freqs.normal_(0.0, 16.0, generator=generator)

    def forward(self, sigmas: Tensor) -> Tensor:
        angles = sigmas[:, None].float() * self.freqs.float()[None, :] * (
            2.0 * math.pi)
        emb = torch.cat([torch.sin(angles), torch.cos(angles),
                         sigmas[:, None].float()], dim=-1)
        emb = _cast(emb, self.dtype)
        h = F.gelu(self.Dense_0(emb), approximate="tanh")
        return self.Dense_1(h)


class TimeConditioningWrapper(nn.Module):
    """σ -> features, added to user-passed features, then the inner net."""

    def __init__(self, inner: nn.Module, modulation_features: int, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.inner = inner
        self.sigma_embedding = SigmaEmbedding(
            modulation_features, dtype=dtype, param_dtype=param_dtype,
            device=device)

    def forward(self, x: Tensor, sigmas: Optional[Tensor] = None, *,
                features: Optional[Tensor] = None, **kwargs) -> Tensor:
        if sigmas is None:
            raise ValueError("time conditioning requires sigmas")
        if sigmas.ndim == 0:
            sigmas = sigmas.expand(x.shape[0])
        time_features = self.sigma_embedding(sigmas)
        if features is not None:
            time_features = time_features + features.to(time_features.dtype)
        return self.inner(x, None, features=time_features, **kwargs)
