"""The T5 encoder stack in plain PyTorch: what transformers'
``FlaxT5EncoderModel`` computes for a ReLU (non-gated) T5 config, with no
dropout. The JAX package's ``RandomT5TextEncoder`` builds that model; the
port's (``ops.text``) runs this stack.

Per block: pre-RMS-norm self-attention plus the residual, then pre-RMS-norm
``wi`` → ReLU → ``wo`` plus the residual; a final RMS norm after the
blocks. The logits are not scaled by 1/√d. The relative-position bias
(bidirectional buckets) is held by block 0 and reused by every block, with
the padding mask added to it as the dtype's minimum. Parameter names follow
the Flax tree (``convert.t5_params_from_flax``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn

__all__ = ["T5RMSNorm", "T5EncoderStack", "relative_position_bucket"]

# The config of the JAX package's encoder: a byte vocabulary (256 bytes
# after 3 special ids), and T5's relative-position buckets and norm eps.
VOCAB_SIZE = 259
NUM_BUCKETS = 32
MAX_DISTANCE = 128
EPS = 1e-6


def relative_position_bucket(relative_position: Tensor) -> Tensor:
    """Bidirectional bucket of each key − query offset: half the
    ``NUM_BUCKETS`` per sign, exact below half of those, log-spaced up to
    ``MAX_DISTANCE``."""
    half = NUM_BUCKETS // 2
    buckets = (relative_position > 0).to(torch.int32) * half
    n = relative_position.abs()
    max_exact = half // 2
    is_small = n < max_exact
    large = max_exact + (torch.log(n.float() / max_exact)
                         / math.log(MAX_DISTANCE / max_exact)
                         * (half - max_exact))
    large = torch.clamp(large, max=half - 1)
    return buckets + torch.where(is_small, n.float(), large).to(torch.int32)


class T5RMSNorm(nn.Module):
    """x / sqrt(mean(x²) + EPS) · weight: no mean, no bias, the variance in
    f32."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: Tensor) -> Tensor:
        variance = x.float().pow(2).mean(dim=-1, keepdim=True)
        return self.weight * (x / torch.sqrt(variance + EPS))


def _linear(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device)


class _SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_kv: int,
                 has_bias: bool, device=None):
        super().__init__()
        inner = num_heads * d_kv
        self.num_heads, self.d_kv = num_heads, d_kv
        self.q, self.k = _linear(d_model, inner, device), _linear(d_model, inner, device)
        self.v, self.o = _linear(d_model, inner, device), _linear(inner, d_model, device)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(NUM_BUCKETS, num_heads,
                                                        device=device)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        b, n, _ = x.shape
        heads = lambda t: t.reshape(b, n, self.num_heads, self.d_kv).transpose(1, 2)  # noqa: E731
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        weights = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        out = (weights @ v).transpose(1, 2).reshape(b, n, -1)
        return self.o(out)


class _Layer0(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, has_bias, device):
        super().__init__()
        self.SelfAttention = _SelfAttention(d_model, num_heads, d_kv,
                                            has_bias, device)
        self.layer_norm = T5RMSNorm(d_model, device)


class _DenseReluDense(nn.Module):
    def __init__(self, d_model, d_ff, device):
        super().__init__()
        self.wi, self.wo = _linear(d_model, d_ff, device), _linear(d_ff, d_model, device)

    def forward(self, x: Tensor) -> Tensor:
        return self.wo(F.relu(self.wi(x)))


class _Layer1(nn.Module):
    def __init__(self, d_model, d_ff, device):
        super().__init__()
        self.DenseReluDense = _DenseReluDense(d_model, d_ff, device)
        self.layer_norm = T5RMSNorm(d_model, device)


class _Block(nn.Module):
    def __init__(self, d_model, d_ff, num_heads, d_kv, has_bias, device):
        super().__init__()
        self.layer = nn.ModuleList([
            _Layer0(d_model, num_heads, d_kv, has_bias, device),
            _Layer1(d_model, d_ff, device)])

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Encoder(nn.Module):
    def __init__(self, d_model, d_ff, num_layers, num_heads, d_kv, device):
        super().__init__()
        self.block = nn.ModuleList([
            _Block(d_model, d_ff, num_heads, d_kv, i == 0, device)
            for i in range(num_layers)])
        self.final_layer_norm = T5RMSNorm(d_model, device)


class T5EncoderStack(nn.Module):
    """``input_ids`` [B, N] (0 is padding) and ``attention_mask`` [B, N]
    -> hidden states [B, N, d_model], float32. Each head is
    ``d_model // num_heads`` wide."""

    def __init__(self, d_model: int = 768, d_ff: int = 1536,
                 num_layers: int = 2, num_heads: int = 4, device=None):
        super().__init__()
        self.d_model, self.d_ff, self.num_heads = d_model, d_ff, num_heads
        self.d_kv = d_model // num_heads
        self.shared = nn.Embedding(VOCAB_SIZE, d_model, device=device)
        self.encoder = _Encoder(d_model, d_ff, num_layers, num_heads,
                                self.d_kv, device)

    def init_params(self, generator: torch.Generator) -> None:
        """Fill every weight as Flax T5's initializers do (factor 1): the
        embedding N(0, 1); q N(0, (inner·d_kv)^-½); k, v, o and the
        relative-position bias N(0, inner^-½); wi N(0, d_model^-½); wo
        N(0, d_ff^-½); the norms ones. Drawn on the generator's device in
        the order of ``named_parameters``, then copied in place."""
        inner = self.num_heads * self.d_kv
        std = {"shared": 1.0, "q": (inner * self.d_kv) ** -0.5,
               "k": inner ** -0.5, "v": inner ** -0.5, "o": inner ** -0.5,
               "relative_attention_bias": inner ** -0.5,
               "wi": self.d_model ** -0.5, "wo": self.d_ff ** -0.5}
        with torch.no_grad():
            for name, p in self.named_parameters():
                *path, _ = name.split(".")
                if path[-1] in ("layer_norm", "final_layer_norm"):
                    p.fill_(1.0)
                    continue
                draw = torch.randn(p.shape, generator=generator,
                                   device=generator.device) * std[path[-1]]
                p.copy_(draw)

    def position_bias(self, length: int, device) -> Tensor:
        """[1, heads, N, N] from block 0's relative-position embedding."""
        pos = torch.arange(length, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None])
        table = self.encoder.block[0].layer[0].SelfAttention
        return table.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        x = self.shared(input_ids)
        mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min)
        bias = self.position_bias(input_ids.shape[1], x.device) + mask
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
