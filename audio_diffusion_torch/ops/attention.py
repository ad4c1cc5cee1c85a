"""Self- and cross-attention items of the U-Net (counterpart of
audio_diffusion_tpu/ops/attention.py), channels-last [B, L, C].

The JAX package calls ``jax.nn.dot_product_attention`` (XLA, not a Pallas
kernel), so attention here is plain PyTorch in the same form: f32 logits,
scale 1/√head_features, f32 softmax, probabilities rounded to the value
type, then the product with the values. ``scaled_dot_product_attention`` is
not used, so the rounding points match the JAX package's. Cross-attention
takes its keys and values from a context [B, N, context_features] (the
text embedding), with no key-padding mask, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .layers import Dense, LayerNorm

__all__ = ["Attention", "FeedForward", "AttentionItem", "CrossAttentionItem"]


def _dot_product_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """q, k, v [B, H, S, D] -> [B, H, S, D]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


class Attention(nn.Module):
    """Multi-head attention over the length axis. Self-attention (no
    ``context_features``) projects with one fused ``to_qkv``; cross-attention
    takes ``to_q`` from x and ``to_k``/``to_v`` from a context whose width
    ``context_features`` may differ from x's."""

    def __init__(self, features: int, heads: int, head_features: int,
                 out_features: int, context_features: Optional[int] = None,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        inner = heads * head_features
        self.heads, self.head_features = heads, head_features
        self.cross = context_features is not None
        common = dict(bias=False, dtype=dtype, param_dtype=param_dtype,
                      device=device)
        if self.cross:
            self.to_q = Dense(features, inner, **common)
            self.to_k = Dense(context_features, inner, **common)
            self.to_v = Dense(context_features, inner, **common)
        else:
            self.to_qkv = Dense(features, 3 * inner, **common)
        self.to_out = Dense(inner, out_features, **common)

    def forward(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        if (context is not None) != self.cross:
            raise ValueError(
                "a cross-attention takes context=, a self-attention none "
                f"(this one was built with cross={self.cross})")
        if context is None:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)

        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, self.heads, self.head_features).transpose(1, 2)

        out = _dot_product_attention(split(q), split(k), split(v))
        b, s, _ = x.shape
        out = out.transpose(1, 2).reshape(b, s, self.heads * self.head_features)
        return self.to_out(out)


class FeedForward(nn.Module):
    """Dense -> GELU (tanh form) -> Dense, ratio ``multiplier``."""

    def __init__(self, features: int, multiplier: int = 4, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.Dense_0 = Dense(features, features * multiplier, **common)
        self.Dense_1 = Dense(features * multiplier, features, **common)

    def forward(self, x: Tensor) -> Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class AttentionItem(nn.Module):
    """Pre-LN self-attention + pre-LN feed-forward, both residual."""

    def __init__(self, features: int, heads: int, head_features: int,
                 context_features: Optional[int] = None, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.LayerNorm_0 = LayerNorm(features, **common)
        self.Attention_0 = Attention(features, heads, head_features, features,
                                     context_features, **common)
        self.LayerNorm_1 = LayerNorm(features, **common)
        self.FeedForward_0 = FeedForward(features, **common)

    def forward(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        h = self.LayerNorm_0(x)
        if context is not None:
            context = context.to(h.dtype)
        x = x + self.Attention_0(h, context)
        return x + self.FeedForward_0(self.LayerNorm_1(x))


class CrossAttentionItem(AttentionItem):
    """Pre-LN cross-attention to ``embedding`` [B, N, context_features]
    (cast to the normalized activation's dtype) + pre-LN feed-forward, both
    residual."""

    def __init__(self, features: int, context_features: int, heads: int,
                 head_features: int, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__(features, heads, head_features, context_features,
                         dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x: Tensor, embedding: Tensor) -> Tensor:
        return super().forward(x, embedding)
