"""The pieces of ``flax.linen`` that the JAX package builds on, with flax's
numerics: ``Dense`` (lecun-normal kernel, zero bias, compute dtype),
``LayerNorm`` (eps 1e-6, f32 one-pass moments) and the initializers."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .kernels import attention as attention_kernels

__all__ = ["Dense", "LayerNorm", "GroupNorm", "lecun_normal_", "new_param",
           "init_module"]

# Standard deviation of a standard normal truncated to [-2, 2] (flax's
# variance_scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> Tensor:
    """flax ``lecun_normal``: truncated normal in ±2σ, σ = √(1/fan_in)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def new_param(*shape: int, dtype=torch.float32, device=None) -> nn.Parameter:
    """An uninitialized parameter; ``init_params`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def init_module(module: nn.Module,
                generator: Optional[torch.Generator]) -> None:
    """(Re)initialize every parameter of ``module`` in place: each submodule
    with an ``init_params`` fills its own parameters from ``generator``."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_params"):
                m.init_params(generator)


class Dense(nn.Linear):
    """flax ``nn.Dense`` as an ``nn.Linear`` (weight [out, in]). With
    ``dtype`` set, input and parameters are cast to it for the product."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.zero_init = zero_init
        self.compute_dtype = dtype

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        if self.zero_init:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
            b = b.to(self.compute_dtype) if b is not None else None
        return F.linear(x, w, b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: f32 moments
    E[x²] − E[x]² (clamped at 0), y = (x − mean)·(rsqrt(var + eps)·scale)
    + bias, returned in ``dtype`` (or the promoted input/param type)."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = new_param(features, dtype=param_dtype, device=device)
        self.bias = new_param(features, dtype=param_dtype, device=device)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        """``kernels.attention.layer_norm_route`` picks the route: without a
        gradient (grad mode off, or nothing here requires one) the fast
        path (one ``F.layer_norm`` launch on a CUDA tensor) where input,
        parameters and output share a dtype; otherwise, and under autograd,
        the plain form. On a CPU tensor both are the plain form."""
        out_dtype = self.dtype or torch.promote_types(x.dtype, self.scale.dtype)
        norm = attention_kernels.layer_norm_route(x, self.scale, self.bias,
                                                  out_dtype)
        return norm(x, self.scale, self.bias, self.eps, out_dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on channels-last [B, ..., C]: f32 one-pass
    moments E[x²] − E[x]² per (batch, group) (clamped at 0), eps 1e-6,
    y = (x − mean)·(rsqrt(var + eps)·scale) + bias in f32, returned in
    ``dtype`` (or the promoted input/param type). torch's GroupNorm differs
    in both: eps 1e-5 and a centred variance."""

    def __init__(self, features: int, num_groups: int, eps: float = 1e-6,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.scale = new_param(features, dtype=param_dtype, device=device)
        self.bias = new_param(features, dtype=param_dtype, device=device)

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xf = x.float().reshape(b, -1, c)
        xg = xf.reshape(b, -1, g, c // g)
        mean = xg.mean(dim=(1, 3))
        var = torch.clamp(xg.square().mean(dim=(1, 3)) - mean * mean, min=0.0)
        mean = mean.repeat_interleave(c // g, 1)[:, None]
        var = var.repeat_interleave(c // g, 1)[:, None]
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale.float()) \
            + self.bias.float()
        out_dtype = self.dtype or torch.promote_types(x.dtype, self.scale.dtype)
        return y.to(out_dtype).reshape(x.shape)
