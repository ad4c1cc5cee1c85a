"""Plain PyTorch reference of the 1-D U-Net that the benchmark's
configurations name: the archinetai audio-diffusion-pytorch README's
``UNetV0`` (time conditioning, optional classifier-free guidance around
the net, nine levels of downsampling, resnet items with modulation,
self-attention and cross-attention items).

Everything here is float32 and written from the published description:
channels-last activations [B, L, C], GroupNorm with a centred variance,
k=3 convolutions as one product over the three taps, LayerNorm before
each attention and feed-forward, tanh GELU. It imports nothing of the
program under test. Parameters are a flat dict keyed by the names that
:func:`param_spec` lists, which are the program's ``state_dict`` names,
so one set of weights made by the benchmark loads into both.

``Precision`` says how every matrix product is computed. ``FLOAT32`` is
the reference. ``FP8`` rounds both operands of every product (and, under
autograd, the gradient that flows into it) to float8 with a per-tensor
scale: the benchmark's control, the step below the bfloat16 that the
configurations state.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

__all__ = ["param_spec", "Precision", "FLOAT32", "FP8", "net_forward",
           "denoise"]

Params = Dict[str, Tensor]


def _levels(cfg: dict) -> int:
    return len(cfg["channels"])


def _heads(cfg: dict) -> Tuple[int, int]:
    return cfg.get("attention_heads", 8), cfg.get("attention_features", 64)


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every parameter of the net as (name, shape, kind, fan_in). ``kind``
    says how the benchmark draws it: ``kernel`` (normal, std
    1/sqrt(fan_in)), ``gate`` (a zero-initialized modulation or skip
    projection: normal, std 0.02), ``scale`` (1 + normal·0.02), ``bias``
    (normal·0.02), ``freqs`` (normal·16, the Fourier features) and
    ``embed`` (the learned null embedding, normal·0.02)."""
    n = _levels(cfg)
    ch, fac, items = cfg["channels"], cfg["factors"], cfg["items"]
    attn = cfg.get("attentions", [0] * n)
    cross = cfg.get("cross_attentions", [0] * n)
    feats = cfg.get("modulation_features", 1024)
    heads, hf = _heads(cfg)
    inner = heads * hf
    emb = cfg.get("embedding_features")
    out_c = cfg.get("out_channels", cfg["in_channels"])
    spec: List[Tuple[str, Tuple[int, ...], str, int]] = []

    def add(name, shape, kind, fan_in=1):
        spec.append((name, tuple(shape), kind, fan_in))

    def dense(name, fin, fout, bias=True, kind="kernel"):
        add(f"{name}.weight", (fout, fin), kind, fin)
        if bias:
            add(f"{name}.bias", (fout,), "bias")

    def norm(name, c, scale="scale", bias="bias"):
        add(f"{name}.{scale}", (c,), "scale")
        add(f"{name}.{bias}", (c,), "bias")

    def attention_item(name, c, context):
        norm(f"{name}.LayerNorm_0", c)
        if context is None:
            dense(f"{name}.Attention_0.to_qkv", c, 3 * inner, bias=False)
        else:
            dense(f"{name}.Attention_0.to_q", c, inner, bias=False)
            dense(f"{name}.Attention_0.to_k", context, inner, bias=False)
            dense(f"{name}.Attention_0.to_v", context, inner, bias=False)
        dense(f"{name}.Attention_0.to_out", inner, c, bias=False)
        norm(f"{name}.LayerNorm_1", c)
        dense(f"{name}.FeedForward_0.Dense_0", c, 4 * c)
        dense(f"{name}.FeedForward_0.Dense_1", 4 * c, c)

    def stack(name, i):
        c = ch[i]
        for it in range(items[i]):
            r = f"{name}.ResnetModItem_{it}"
            add(f"{r}.gn1_scale", (c,), "scale")
            add(f"{r}.gn1_bias", (c,), "bias")
            add(f"{r}.conv1_kernel", (3, c, c), "kernel", 3 * c)
            add(f"{r}.conv1_bias", (c,), "bias")
            add(f"{r}.gn2_scale", (c,), "scale")
            add(f"{r}.gn2_bias", (c,), "bias")
            add(f"{r}.conv2_kernel", (3, c, c), "kernel", 3 * c)
            add(f"{r}.conv2_bias", (c,), "bias")
            add(f"{r}.mod_gn_scale", (c,), "scale")
            add(f"{r}.mod_gn_bias", (c,), "bias")
            dense(f"{r}.mod_dense", feats, 2 * c, kind="gate")
            for a in range(attn[i]):
                attention_item(f"{name}.AttentionItem_{it * attn[i] + a}", c,
                               None)
            for a in range(cross[i]):
                attention_item(
                    f"{name}.CrossAttentionItem_{it * cross[i] + a}", c, emb)

    add("sigma_embedding.freqs", (128,), "freqs")
    dense("sigma_embedding.Dense_0", 257, feats)
    dense("sigma_embedding.Dense_1", feats, feats)
    pre = "inner."
    if cfg.get("use_embedding_cfg"):
        add("inner.fixed_embedding", (cfg["embedding_max_length"], emb),
            "embed")
        pre = "inner.inner."
    prev = cfg["in_channels"]
    for i in range(n):
        add(f"{pre}down_{i}.kernel", (fac[i] * prev, ch[i]), "kernel",
            fac[i] * prev)
        add(f"{pre}down_{i}.bias", (ch[i],), "bias")
        stack(f"{pre}items_down_{i}", i)
        prev = ch[i]
    for i in range(n):
        if i < n - 1:
            dense(f"{pre}skip_{i}.Dense_0", feats, ch[i], kind="gate")
        stack(f"{pre}items_up_{i}", i)
        up_c = ch[i - 1] if i > 0 else ch[0]
        add(f"{pre}up_{i}.kernel", (ch[i], fac[i] * up_c), "kernel", ch[i])
        add(f"{pre}up_{i}.bias", (fac[i] * up_c,), "bias")
    add(f"{pre}out_gn_scale", (ch[0],), "scale")
    add(f"{pre}out_gn_bias", (ch[0],), "bias")
    add(f"{pre}out_kernel", (3, ch[0], out_c), "kernel", 3 * ch[0])
    add(f"{pre}out_bias", (out_c,), "bias")
    return spec


# --------------------------------------------------------------- precision
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _fp8(t: Tensor, dtype, top: float) -> Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to ``top``, returned in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (t.float() * scale).to(dtype).float() / scale


class _FP8Matmul(torch.autograd.Function):
    """a @ b with both operands in e4m3; the incoming gradient in e5m2, the
    operands as the forward rounded them (as fp8 training recipes do)."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _fp8(a, torch.float8_e4m3fn, _E4M3_MAX)
        qb = _fp8(b, torch.float8_e4m3fn, _E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2, _E5M2_MAX)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # Broadcast batch axes back to each operand's shape.
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class Precision:
    """How the reference computes a matrix product."""

    def __init__(self, name: str):
        self.name = name

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.name == "fp8":
            return _FP8Matmul.apply(a, b)
        return torch.matmul(a, b)


FLOAT32 = Precision("float32")
FP8 = Precision("fp8")


# ------------------------------------------------------------------ layers
def _dense(p: Params, name: str, x: Tensor, pr: Precision) -> Tensor:
    y = pr.mm(x, p[f"{name}.weight"].t())
    bias = p.get(f"{name}.bias")
    return y + bias if bias is not None else y


def group_norm(x: Tensor, groups: int, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    b, l, c = x.shape
    xg = x.reshape(b, l, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, l, c)
    return xn * scale + bias


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-6) -> Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def conv3(x: Tensor, kernel: Tensor, bias: Tensor, pr: Precision) -> Tensor:
    """k=3, padding 1: output position l reads l-1, l and l+1."""
    length = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1))
    taps = torch.cat([xp[:, t:t + length] for t in range(3)], dim=-1)
    return pr.mm(taps, kernel.reshape(-1, kernel.shape[-1])) + bias


def resnet_item(p: Params, name: str, x: Tensor, feats: Tensor, groups: int,
                pr: Precision) -> Tensor:
    """(GroupNorm, SiLU, conv) twice plus the identity, then the
    modulation x + GroupNorm(x)·(1 + scale) + shift, (scale, shift) from
    the features."""
    h = group_norm(x, groups, p[f"{name}.gn1_scale"], p[f"{name}.gn1_bias"])
    h = conv3(F.silu(h), p[f"{name}.conv1_kernel"], p[f"{name}.conv1_bias"],
              pr)
    h = group_norm(h, groups, p[f"{name}.gn2_scale"], p[f"{name}.gn2_bias"])
    h = conv3(F.silu(h), p[f"{name}.conv2_kernel"], p[f"{name}.conv2_bias"],
              pr)
    y = x + h
    mod = _dense(p, f"{name}.mod_dense", F.silu(feats), pr)
    scale, shift = mod.chunk(2, dim=-1)
    hm = group_norm(y, groups, p[f"{name}.mod_gn_scale"],
                    p[f"{name}.mod_gn_bias"])
    return y + hm * (1.0 + scale[:, None]) + shift[:, None]


def attention_item(p: Params, name: str, x: Tensor, context: Optional[Tensor],
                   heads: int, head_features: int, pr: Precision) -> Tensor:
    """Pre-LayerNorm attention (self, or to ``context``) and pre-LayerNorm
    feed-forward, each residual."""
    h = layer_norm(x, p[f"{name}.LayerNorm_0.scale"],
                   p[f"{name}.LayerNorm_0.bias"])
    a = f"{name}.Attention_0"
    if context is None:
        q, k, v = _dense(p, f"{a}.to_qkv", h, pr).chunk(3, dim=-1)
    else:
        q = _dense(p, f"{a}.to_q", h, pr)
        k = _dense(p, f"{a}.to_k", context, pr)
        v = _dense(p, f"{a}.to_v", context, pr)

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads,
                         head_features).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    logits = pr.mm(q, k.transpose(-1, -2)) / math.sqrt(head_features)
    out = pr.mm(torch.softmax(logits, dim=-1), v)
    b, s = x.shape[:2]
    out = out.transpose(1, 2).reshape(b, s, heads * head_features)
    x = x + _dense(p, f"{a}.to_out", out, pr)
    h = layer_norm(x, p[f"{name}.LayerNorm_1.scale"],
                   p[f"{name}.LayerNorm_1.bias"])
    ff = f"{name}.FeedForward_0"
    h = F.gelu(_dense(p, f"{ff}.Dense_0", h, pr), approximate="tanh")
    return x + _dense(p, f"{ff}.Dense_1", h, pr)


def _stack(p: Params, name: str, x: Tensor, feats: Tensor,
           embedding: Optional[Tensor], i: int, cfg: dict,
           pr: Precision) -> Tensor:
    n = _levels(cfg)
    attn = cfg.get("attentions", [0] * n)[i]
    cross = cfg.get("cross_attentions", [0] * n)[i]
    heads, hf = _heads(cfg)
    groups = cfg.get("resnet_groups", 8)
    for it in range(cfg["items"][i]):
        x = resnet_item(p, f"{name}.ResnetModItem_{it}", x, feats, groups, pr)
        for a in range(attn):
            x = attention_item(p, f"{name}.AttentionItem_{it * attn + a}", x,
                               None, heads, hf, pr)
        for a in range(cross):
            x = attention_item(
                p, f"{name}.CrossAttentionItem_{it * cross + a}", x,
                embedding, heads, hf, pr)
    return x


def _unet(p: Params, pre: str, x: Tensor, feats: Tensor,
          embedding: Optional[Tensor], cfg: dict, pr: Precision) -> Tensor:
    """x [B, C, T] -> [B, out, T]."""
    n = _levels(cfg)
    ch, fac = cfg["channels"], cfg["factors"]
    h = x.transpose(1, 2)
    skips = []
    for i in range(n):
        b, length, c = h.shape
        h = h.reshape(b, length // fac[i], fac[i] * c)
        h = pr.mm(h, p[f"{pre}down_{i}.kernel"]) + p[f"{pre}down_{i}.bias"]
        h = _stack(p, f"{pre}items_down_{i}", h, feats, embedding, i, cfg, pr)
        if i < n - 1:
            skips.append(h)
    for i in reversed(range(n)):
        if i < n - 1:
            gate = _dense(p, f"{pre}skip_{i}.Dense_0", F.silu(feats), pr)
            h = h + skips.pop() * (1.0 + gate[:, None])
        h = _stack(p, f"{pre}items_up_{i}", h, feats, embedding, i, cfg, pr)
        up_c = ch[i - 1] if i > 0 else ch[0]
        h = pr.mm(h, p[f"{pre}up_{i}.kernel"]) + p[f"{pre}up_{i}.bias"]
        h = h.reshape(h.shape[0], h.shape[1] * fac[i], up_c)
    h = group_norm(h, cfg.get("resnet_groups", 8), p[f"{pre}out_gn_scale"],
                   p[f"{pre}out_gn_bias"])
    h = conv3(F.silu(h), p[f"{pre}out_kernel"], p[f"{pre}out_bias"], pr)
    return h.transpose(1, 2)


def sigma_features(p: Params, sigmas: Tensor, pr: Precision) -> Tensor:
    """σ [B] -> modulation features: Fourier features [sin, cos, σ] of
    learned frequencies, Dense, GELU, Dense."""
    angles = sigmas[:, None] * p["sigma_embedding.freqs"][None] * (2 * math.pi)
    emb = torch.cat([torch.sin(angles), torch.cos(angles), sigmas[:, None]],
                    dim=-1)
    h = F.gelu(_dense(p, "sigma_embedding.Dense_0", emb, pr),
               approximate="tanh")
    return _dense(p, "sigma_embedding.Dense_1", h, pr)


def net_forward(p: Params, cfg: dict, x: Tensor, sigmas: Tensor,
                embedding: Optional[Tensor] = None,
                embedding_scale: float = 1.0,
                pr: Precision = FLOAT32) -> Tensor:
    """The net's v for x [B, C, T] at σ [B]. With classifier-free guidance
    (``use_embedding_cfg``) a missing embedding is the learned null
    embedding, and ``embedding_scale`` != 1 mixes the conditioned and the
    null pass: null + scale·(conditioned − null)."""
    feats = sigma_features(p, sigmas.float(), pr)
    if not cfg.get("use_embedding_cfg"):
        return _unet(p, "inner.", x, feats, embedding, cfg, pr)
    null = p["inner.fixed_embedding"][None].expand(
        (x.shape[0],) + tuple(p["inner.fixed_embedding"].shape))
    if embedding is None:
        return _unet(p, "inner.inner.", x, feats, null, cfg, pr)
    if embedding_scale == 1.0:
        return _unet(p, "inner.inner.", x, feats, embedding, cfg, pr)
    both = _unet(p, "inner.inner.", torch.cat([x, x]),
                 torch.cat([feats, feats]), torch.cat([embedding, null]),
                 cfg, pr)
    cond, uncond = both.chunk(2)
    return uncond + embedding_scale * (cond - uncond)


def alpha_beta(sigmas: Tensor) -> Tuple[Tensor, Tensor]:
    angle = sigmas * (math.pi / 2)
    return torch.cos(angle), torch.sin(angle)


def denoise(p: Params, cfg: dict, noise: Tensor, num_steps: int,
            embedding: Optional[Tensor] = None, embedding_scale: float = 1.0,
            pr: Precision = FLOAT32) -> Tensor:
    """The deterministic v-sampler from ``noise`` [B, C, T] over σ from 1
    to 0 in ``num_steps`` equal steps: per step the net's v gives the
    denoised estimate α·x − β·v and the noise estimate β·x + α·v, which
    the next σ's α and β mix again."""
    sig = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32,
                         device=noise.device)
    alpha, beta = alpha_beta(sig)
    x = noise.float()
    for i in range(num_steps):
        v = net_forward(p, cfg, x, sig[i].expand(x.shape[0]), embedding,
                        embedding_scale, pr)
        x_pred = alpha[i] * x - beta[i] * v
        n_pred = beta[i] * x + alpha[i] * v
        x = alpha[i + 1] * x_pred + beta[i + 1] * n_pred
    return x
