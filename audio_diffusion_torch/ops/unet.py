"""The U-Net compute core (counterpart of audio_diffusion_tpu/ops/unet.py).

Activations are channels-last [B, L, C] inside the net (C contiguous, the
K axis of every product); the public boundary stays [B, C, T]. The JAX
package's TPU layout devices are not ported: no lane folding, no lane→group
matrices, no VMEM guard. This is the math the JAX net computes with
``lane_fold=False``.

Every ``ResnetModItem`` of constant width runs the fused resnet item
(``ops/kernels/resnet.py``): the CUDA kernels, forward and backward, on a
CUDA tensor, its plain version on a CPU tensor. A width-changing item
(``channel_change="first_item"``) runs the JAX lax path's plain math.
Parameters are float32 masters cast to the compute dtype at each use, so
gradients arrive in float32. Parameter names follow the JAX parameter tree, so
``convert.params_from_jax`` and ``params_to_jax`` are a renaming plus the
Dense transposes.
"""
from __future__ import annotations

import functools
import math
import warnings
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.utils import checkpoint as torch_checkpoint

from .attention import AttentionItem, CrossAttentionItem
from .kernels import resnet as resnet_kernel
from .layers import Dense, lecun_normal_, new_param

__all__ = [
    "group_norm",
    "ResnetModItem",
    "Downsample",
    "Upsample",
    "SkipCat",
    "SkipModulate",
    "InjectChannelsItem",
    "ItemStack",
    "XUNet",
    "SigmaEmbedding",
    "TimeConditioningWrapper",
    "ClassifierFreeGuidanceWrapper",
    "AppendChannelsWrapper",
]


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """Selective checkpointing that keeps the outputs of matrix products
    without batch dimensions (``mm``/``addmm``: every Dense) and recomputes
    the rest, as JAX's policy of that name. The fused resnet item launches
    its kernel outside the dispatcher, so its forward runs again in the
    backward, as a ``pallas_call`` does under the JAX policy."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


# remat_policy names (jax.checkpoint_policies entries) the port supports;
# None recomputes everything.
REMAT_POLICIES = {
    "dots_with_no_batch_dims_saveable": _dots_with_no_batch_dims_saveable,
}


def _check_remat_policy(name: Optional[str]) -> None:
    if name is not None and name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; supported: None "
                         f"(full recompute), {', '.join(REMAT_POLICIES)}")


def run_stack(stack: nn.Module, use_remat: bool,
              remat_policy: Optional[str], h: Tensor, *args) -> Tensor:
    """One level's item stack; with ``use_remat`` and gradients on, under
    activation checkpointing (the counterpart of ``nn.remat(ItemStack,
    policy=...)``): its activations are recomputed in the backward, all of
    them or, with ``remat_policy``, all but the saved products. The graph is
    the one without remat, so the gradients are the same bits."""
    if not (use_remat and torch.is_grad_enabled()):
        return stack(h, *args)
    context_fn = torch_checkpoint.noop_context_fn
    if remat_policy is not None:
        context_fn = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            REMAT_POLICIES[remat_policy])
    return torch_checkpoint.checkpoint(
        stack, h, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=context_fn)


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
    would be silently skipped), and so are the encoder-reuse kwargs reaching
    a net without the hooks (its output would be mis-unpacked as (v, enc));
    other unknown kwargs warn. ``generator`` (the loss's random stream) is
    consumed only by stochastic conditioning and is otherwise ignored, as
    the JAX net ignores an unused ``key``."""
    cfg_keys = {"embedding_scale", "embedding_mask_proba"}
    bad = cfg_keys & unused.keys()
    if bad:
        raise TypeError(
            f"{sorted(bad)} requires a net built with use_embedding_cfg=True; "
            "this net has no CFG plugin, so guidance would be silently "
            "skipped")
    reuse = {"hidden", "return_hidden"} & unused.keys()
    if reuse:
        raise TypeError(
            f"{sorted(reuse)}: this net does not implement encoder reuse; "
            "drop encoder_reuse from the sampler call")
    unused = set(unused) - {"generator"}
    if unused:
        warnings.warn(
            f"conditioning kwargs {sorted(unused)} are not consumed by this "
            "net (typo, or a plugin that would consume them is not enabled)",
            stacklevel=3)


class ResnetModItem(nn.Module):
    """(GN -> SiLU -> conv3) × 2 + identity, then the optional modulation
    epilogue x + GN(x)·(1 + scale) + shift with (scale, shift) =
    Dense(SiLU(features)), zero-initialized. One fused kernel per item.

    With ``in_channels`` other than ``channels`` (``channel_change=
    "first_item"``), the item changes width: the first GroupNorm and conv
    read ``in_channels`` and the identity becomes a 1×1 conv
    (``shortcut_kernel`` [Cin, C], ``shortcut_bias``). That item runs the
    plain math on every device, as the JAX package runs it on its lax path
    (the fused kernel has no shortcut)."""

    def __init__(self, channels: int, groups: int = 8,
                 use_modulation: bool = True,
                 modulation_features: Optional[int] = None, dtype=None,
                 param_dtype=torch.float32, device=None,
                 in_channels: Optional[int] = None):
        super().__init__()
        c = channels
        ci = c if in_channels is None else in_channels
        self.groups, self.use_modulation, self.dtype = groups, use_modulation, dtype
        self.has_shortcut = ci != c
        p = dict(dtype=param_dtype, device=device)
        self.gn1_scale, self.gn1_bias = new_param(ci, **p), new_param(ci, **p)
        self.conv1_kernel, self.conv1_bias = new_param(3, ci, c, **p), new_param(c, **p)
        self.gn2_scale, self.gn2_bias = new_param(c, **p), new_param(c, **p)
        self.conv2_kernel, self.conv2_bias = new_param(3, c, c, **p), new_param(c, **p)
        if self.has_shortcut:
            self.shortcut_kernel = new_param(ci, c, **p)
            self.shortcut_bias = new_param(c, **p)
        if use_modulation:
            self.mod_gn_scale, self.mod_gn_bias = new_param(c, **p), new_param(c, **p)
            self.mod_dense = Dense(modulation_features, 2 * c, zero_init=True,
                                   dtype=dtype, param_dtype=param_dtype,
                                   device=device)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        for name, t in self.named_parameters(recurse=False):
            if name.endswith("_kernel"):
                lecun_normal_(t, math.prod(t.shape[:-1]), generator)
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
        if self.has_shortcut:
            return self._changing_width(x, cast, mods, modb, mgs, mgb)
        return resnet_kernel.fused_resnet_item(
            x, cast(self.gn1_scale), cast(self.gn1_bias),
            cast(self.conv1_kernel), cast(self.conv1_bias),
            cast(self.gn2_scale), cast(self.gn2_bias),
            cast(self.conv2_kernel), cast(self.conv2_bias),
            mods, modb, mgs, mgb, groups=self.groups, eps=1e-5,
            use_modulation=self.use_modulation)

    def _changing_width(self, x, cast, mods, modb, mgs, mgb) -> Tensor:
        """The JAX lax path of a width-changing item
        (audio_diffusion_tpu/ops/unet.py:154-174, 322-326)."""
        h = group_norm(x, self.groups, cast(self.gn1_scale),
                       cast(self.gn1_bias))
        h = conv3(F.silu(h), cast(self.conv1_kernel), cast(self.conv1_bias))
        h = group_norm(h, self.groups, cast(self.gn2_scale),
                       cast(self.gn2_bias))
        h = conv3(F.silu(h), cast(self.conv2_kernel), cast(self.conv2_bias))
        y = x @ cast(self.shortcut_kernel) + cast(self.shortcut_bias) + h
        if self.use_modulation:
            hm = group_norm(y, self.groups, mgs, mgb)
            y = y + hm * (1.0 + mods[:, None, :]) + modb[:, None, :]
        return y


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


class InjectChannelsItem(nn.Module):
    """Context injection: x + Dense(cat([x, ctx])), the context
    [B, context_channels, L_d] taken channels-last at this depth's length."""

    def __init__(self, channels: int, context_channels: int, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.Dense_0 = Dense(channels + context_channels, channels,
                             dtype=dtype, param_dtype=param_dtype,
                             device=device)

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        ctx = context.transpose(1, 2).to(x.dtype)
        if ctx.shape[1] != x.shape[1]:
            raise ValueError(f"context length {ctx.shape[1]} != feature "
                             f"length {x.shape[1]} at this depth")
        return x + self.Dense_0(torch.cat([x, ctx], dim=-1))


class ItemStack(nn.Module):
    """One level's repeated item sequence:
    ([Resnet+Mod][Inject if context][Attn]·a[CrossAttn]·c) × items. Module
    names follow flax's per-class counters. With ``in_channels`` other than
    ``channels``, the first resnet item changes the width."""

    def __init__(self, channels: int, items: int, attentions: int,
                 use_modulation: bool, resnet_groups: int,
                 attention_heads: int, attention_features: int,
                 modulation_features: Optional[int],
                 cross_attentions: int = 0, context_channels: int = 0,
                 embedding_features: Optional[int] = None, dtype=None,
                 param_dtype=torch.float32, device=None,
                 in_channels: Optional[int] = None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        if in_channels == channels:
            in_channels = None
        if in_channels is not None and items < 1:
            raise ValueError("a channel change in the first item requires "
                             "items >= 1")
        self.layout = []
        for it in range(items):
            resnet = f"ResnetModItem_{it}"
            self.add_module(resnet, ResnetModItem(
                channels, resnet_groups, use_modulation, modulation_features,
                **common, in_channels=in_channels if it == 0 else None))
            inject = f"InjectChannelsItem_{it}" if context_channels else None
            if inject:
                self.add_module(inject, InjectChannelsItem(
                    channels, context_channels, **common))
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
            self.layout.append((resnet, inject, attns, crosses))

    def forward(self, x: Tensor, features: Optional[Tensor],
                embedding: Optional[Tensor] = None,
                context: Optional[Tensor] = None) -> Tensor:
        for resnet, inject, attns, crosses in self.layout:
            x = getattr(self, resnet)(x, features)
            if inject:
                if context is None:
                    raise ValueError(
                        "this depth was built with context_channels > 0; "
                        "pass channels=[...] with a tensor at this depth")
                x = getattr(self, inject)(x, context)
            for name in attns:
                x = getattr(self, name)(x)
            if crosses and embedding is None:
                raise ValueError("cross attention requires embedding= (or "
                                 "text= at the model layer)")
            for name in crosses:
                x = getattr(self, name)(x, embedding)
        return x


class XUNet(nn.Module):
    """The U-Net, written iteratively. Per level i:
      down:  Downsample(factor_i, -> channels_i); down-items
      inner: next level (the innermost level has no skip)
      up:    SkipMerge(inner, skip, features); up-items; Upsample(factor_i)
    then GN -> SiLU -> conv3 to ``out_channels``. I/O is [B, C, T].
    Cross-attention items attend to ``embedding=`` [B, N,
    embedding_features]; a level with ``context_channels`` > 0 injects
    ``channels=[...]``'s tensor at that depth. ``channel_change`` says
    where the down path changes width: ``"resample"``, in Downsample's
    projection; ``"first_item"``, in each level's first resnet item (from
    level 1 on; Downsample keeps the source width)."""

    def __init__(self, in_channels: int, out_channels: int,
                 channels: Sequence[int], factors: Sequence[int],
                 items: Sequence[int], attentions: Sequence[int],
                 cross_attentions: Optional[Sequence[int]] = None,
                 context_channels: Optional[Sequence[int]] = None,
                 embedding_features: Optional[int] = None,
                 attention_heads: int = 8, attention_features: int = 64,
                 resnet_groups: int = 8, use_modulation: bool = True,
                 modulation_features: Optional[int] = None,
                 use_remat: bool = False, remat_policy: Optional[str] = None,
                 channel_change: str = "resample",
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        _check_remat_policy(remat_policy)
        if channel_change not in ("resample", "first_item"):
            raise ValueError(f"channel_change must be 'resample' or "
                             f"'first_item', got {channel_change!r}")
        self.use_remat = use_remat
        self.remat_policy = remat_policy
        cross_attentions = cross_attentions or [0] * len(channels)
        context_channels = context_channels or [0] * len(channels)
        if any(cross_attentions) and embedding_features is None:
            raise ValueError("cross_attentions requires embedding_features "
                             "(the width of embedding=)")
        self.num_levels = len(channels)
        self.factors = tuple(factors)
        self.resnet_groups = resnet_groups
        self.use_modulation = use_modulation
        self.dtype = dtype
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)

        def stack(i: int, in_c: Optional[int] = None) -> ItemStack:
            return ItemStack(channels[i], items[i], attentions[i],
                             use_modulation, resnet_groups, attention_heads,
                             attention_features, modulation_features,
                             cross_attentions[i], context_channels[i],
                             embedding_features, **common, in_channels=in_c)

        prev_c = in_channels
        for i in range(self.num_levels):
            # Level 0 always changes width in the projection: the raw input
            # channels (stereo: 2) cannot be group-normed.
            level_cc = channel_change == "first_item" and i > 0
            self.add_module(f"down_{i}", Downsample(
                prev_c, prev_c if level_cc else channels[i], factors[i],
                **common))
            self.add_module(f"items_down_{i}",
                            stack(i, prev_c if level_cc else None))
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

    def _stack(self, name: str, h: Tensor, *args) -> Tensor:
        return run_stack(getattr(self, name), self.use_remat,
                         self.remat_policy, h, *args)

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
                **unused_kwargs):
        """``channels`` is padded with ``None`` to the number of levels, so
        ``[None] * k + [latent]`` injects at depth k. ``return_hidden=True``
        also returns the encoder state ``(bottleneck, skips)`` (opaque, in
        the port's channels-last layout), taken before the up path pops the
        skips; ``hidden=state`` skips the down path and decodes that state
        with the current ``features`` (encoder reuse across sampling
        steps)."""
        _check_unused_kwargs(unused_kwargs)
        total_factor = math.prod(self.factors)
        if x.shape[-1] % total_factor:
            raise ValueError(
                f"input length {x.shape[-1]} must be divisible by the product "
                f"of the downsampling factors ({total_factor})")
        contexts = list(channels or [])
        contexts += [None] * (self.num_levels - len(contexts))

        if hidden is not None:
            h, skips = hidden[0], list(hidden[1])
        else:
            h = _cast(x.transpose(1, 2), self.dtype)  # [B, T, C]
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
                skip = getattr(self, f"skip_{i}")
                h = skip(h, skips.pop(), features)
            h = self._stack(f"items_up_{i}", h, features, embedding,
                            contexts[i])
            h = getattr(self, f"up_{i}")(h)

        cast = lambda t: _cast(t, self.dtype)  # noqa: E731
        h = group_norm(h, self.resnet_groups, cast(self.out_gn_scale),
                       cast(self.out_gn_bias))
        h = conv3(F.silu(h), cast(self.out_kernel), cast(self.out_bias))
        out = h.transpose(1, 2).to(x.dtype)
        return (out, enc) if return_hidden else out


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


def _double_batch(tree, b: int):
    """Each tensor in ``tree`` (nested lists, tuples and dicts) whose leading
    dim is ``b``, concatenated with itself; everything else as it is (a
    ``hidden`` state from a doubled pass has batch 2b and passes through)."""
    if isinstance(tree, Tensor):
        return torch.cat([tree, tree]) if tree.ndim and tree.shape[0] == b \
            else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_double_batch(t, b) for t in tree)
    if isinstance(tree, dict):
        return {k: _double_batch(v, b) for k, v in tree.items()}
    return tree


class ClassifierFreeGuidanceWrapper(nn.Module):
    """Classifier-free guidance: a learned fixed (null) embedding
    ``fixed_embedding`` [max_length, features] (init normal(0.02)), used
    when no ``embedding`` is given; train-time embedding dropout (one
    Bernoulli(``embedding_mask_proba``) per batch row, drawn from
    ``generator``); and, for ``embedding_scale`` != 1, one batch-doubled
    pass over [cond; fixed] combined as out_fixed + s·(out − out_fixed)."""

    def __init__(self, inner: nn.Module, embedding_max_length: int,
                 embedding_features: int, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.inner = inner
        self.fixed_embedding = new_param(embedding_max_length,
                                         embedding_features,
                                         dtype=param_dtype, device=device)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        self.fixed_embedding.normal_(0.0, 0.02, generator=generator)

    @staticmethod
    def draw_mask(batch: int, proba: float, generator: torch.Generator,
                  device) -> Tensor:
        """[B, 1, 1] booleans, True with probability ``proba``."""
        return torch.rand((batch, 1, 1), generator=generator,
                          device=device) < proba

    def forward(self, x: Tensor, sigmas: Optional[Tensor] = None, *,
                embedding: Optional[Tensor] = None,
                embedding_mask_proba: float = 0.0,
                embedding_scale: float = 1.0,
                generator: Optional[torch.Generator] = None, **kwargs):
        b = x.shape[0]
        fixed = self.fixed_embedding
        fixed_b = fixed[None].expand((b,) + fixed.shape).to(
            embedding.dtype if embedding is not None else fixed.dtype)
        if embedding is None:
            return self.inner(x, sigmas, embedding=fixed_b, **kwargs)

        if embedding_mask_proba > 0.0:
            if generator is None:
                raise ValueError(
                    "embedding_mask_proba > 0 draws its mask from "
                    "generator=, and none was given")
            mask = self.draw_mask(b, embedding_mask_proba, generator,
                                  x.device)
            embedding = torch.where(mask, fixed_b, embedding)

        if embedding_scale == 1.0:
            return self.inner(x, sigmas, embedding=embedding, **kwargs)

        # Guided: one batch-doubled pass [conditioned; fixed].
        res = self.inner(torch.cat([x, x]), _double_batch(sigmas, b),
                         embedding=torch.cat([embedding, fixed_b]),
                         **_double_batch(kwargs, b))
        # With return_hidden the state is the doubled pass's (batch 2b).
        with_hidden = kwargs.get("return_hidden", False)
        out2, enc = res if with_hidden else (res, None)
        out, out_fixed = out2[:b], out2[b:]
        out = out_fixed + embedding_scale * (out - out_fixed)
        return (out, enc) if with_hidden else out


class AppendChannelsWrapper(nn.Module):
    """Concatenates ``append_channels`` [B, C', T], cast to x's dtype, to
    the net input on the channel axis before the inner net (the
    upsampler's and the vocoder's conditioning)."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x: Tensor, sigmas: Optional[Tensor] = None, *,
                append_channels: Tensor, **kwargs):
        h = torch.cat([x, append_channels.to(x.dtype)], dim=1)
        return self.inner(h, sigmas, **kwargs)
