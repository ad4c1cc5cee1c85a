"""Self- and cross-attention items of the U-Net (counterpart of
audio_diffusion_tpu/ops/attention.py), channels-last [B, L, C].

The JAX package calls ``jax.nn.dot_product_attention`` (XLA, not a Pallas
kernel), so attention here keeps its form: f32 logits of the bf16 products,
scale 1/√head_features, f32 softmax, probabilities rounded to the value
type, then the product with the values. ``scaled_dot_product_attention`` is
not used, so the rounding points match the JAX package's. Cross-attention
takes its keys and values from a context [B, N, context_features] (the
text embedding), with no key-padding mask, as in the JAX package.

Two routes, chosen from what the inputs show (``ops/kernels/attention.py``).
Without a gradient (sampling and serving run under ``inference_mode``, a
teacher under ``no_grad``) the LayerNorms and the attention core take the
fast path: on the card, one ``F.layer_norm`` launch per LayerNorm and one
launch of the core's kernel, which reads q, k and v through their strides
from the projections' outputs. The core's kernel takes bf16 and head widths
that are multiples of 16 up to 128; other widths and float32 run the core's
plain form, and a LayerNorm whose parameters are not in its input's dtype
runs its plain form. With a gradient (training) both run the plain form
under autograd. On a CPU tensor the fast path is the plain form too, so the
CPU results are the same bits either way.

Under a length shard (``parallel.comm.length_shard``) an attention item
gathers its input's whole sequence, runs unchanged on every rank and keeps
its rows: the products keep the unsharded shapes, so a library that picks
its algorithm by shape computes the same bits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..parallel import comm
from .kernels import attention as attention_kernels
from .layers import Dense, LayerNorm

__all__ = ["Attention", "FeedForward", "AttentionItem", "CrossAttentionItem"]


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
        core = attention_kernels.attention_core_route(q, k, v, self.heads)
        return self.to_out(core(q, k, v, self.heads))


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
    """Pre-LN self-attention + pre-LN feed-forward, both residual. Without
    a gradient, on the card, its LayerNorms and attention core are three
    kernel launches (the module docstring says when each route applies)."""

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
        shard = comm.current_length_shard()
        if shard is not None:
            length = x.shape[1]
            whole = comm.all_gather_rows(x, shard.group, dim=1)
            with comm.length_shard(None):
                out = self.forward(whole, context)
            return out[:, shard.rank * length:(shard.rank + 1) * length]
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
