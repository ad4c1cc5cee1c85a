"""Fused resnet(+modulation) item: the wrapper of its CUDA kernel and its
plain PyTorch version.

Counterpart of ``audio_diffusion_tpu/ops/kernels/resnet.py`` (the Pallas
``fused_resnet_item``) at fold 1, channels-last ``[B, L, C]``: no lane
folding, so no lane→group matrices. The kernel source is
``audio_diffusion_torch/csrc/resnet_item.cu``; its header says what bounds it
on an H100 and how the design answers that.

A CPU tensor takes :func:`resnet_item_reference`, whose gradient is
autograd's; a CUDA tensor takes the kernels or raises. Where autograd needs a
gradient, the forward keeps its input, conv 1's output, the item before its
modulation and the three GroupNorm statistics, and the backward is the
hand-written chain of ``audio_diffusion_torch/csrc/resnet_item_bwd.cu``
(counterpart of the Pallas kernel's custom VJP).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from .build import load_library

__all__ = ["fused_resnet_item", "resnet_item_reference", "conv_occupancy"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Elements each CTA of the statistics pass sums (sets its L tile).
_STATS_ELEMS_PER_CTA = 8192
# The weight gradient sums B·L positions in slabs of 32-position chunks, each
# slab writing an f32 [3, C, C] partial: about this many CTAs, within this
# many bytes of partials.
_WGRAD_CHUNK = 32
_WGRAD_TILE = 64
_WGRAD_CTAS = 512
_WGRAD_PARTIAL_BYTES = 16 * 2**20


def _group_stats(h: Tensor, groups: int, eps: float):
    """Per-channel (mean, rstd) [B, 1, C] of f32 ``h`` [B, L, C]: one-pass
    moments E[h²] − E[h]², the variance clamped at 0 (ops/unet.py:86-97 of
    the JAX package)."""
    b, l, c = h.shape
    hg = h.reshape(b, l, groups, c // groups)
    mean = hg.mean(dim=(1, 3))
    meansq = hg.square().mean(dim=(1, 3))
    rstd = torch.rsqrt(torch.clamp(meansq - mean * mean, min=0.0) + eps)
    per = c // groups
    return (mean.repeat_interleave(per, 1)[:, None],
            rstd.repeat_interleave(per, 1)[:, None])


def _conv3(h: Tensor, k: Tensor) -> Tensor:
    """k=3, padding-1 conv of [B, L, Cin] with [3, Cin, Cout] in f32; tap t
    reads position l − 1 + t (cross-correlation)."""
    length = h.shape[1]
    hp = F.pad(h.float(), (0, 0, 1, 1))
    k = k.float()
    return (hp[:, 0:length] @ k[0] + hp[:, 1:length + 1] @ k[1]
            + hp[:, 2:length + 2] @ k[2])


def resnet_item_reference(x: Tensor, gn1s: Tensor, gn1b: Tensor, k1: Tensor,
                          c1b: Tensor, gn2s: Tensor, gn2b: Tensor, k2: Tensor,
                          c2b: Tensor, mods: Optional[Tensor] = None,
                          modb: Optional[Tensor] = None,
                          mgs: Optional[Tensor] = None,
                          mgb: Optional[Tensor] = None, *, groups: int = 8,
                          eps: float = 1e-5,
                          use_modulation: bool = True) -> Tensor:
    """Plain version of the kernel, with the Pallas body's rounding points
    (resnet.py:94-116 of the JAX package): the activated conv inputs, conv 1's
    output and the item's output are rounded to ``x.dtype``; everything else
    is f32. x [B, L, C]; k [3, C, C]; vectors [C]; mods/modb [B, C]."""
    dtype = x.dtype

    def gn_silu(h, s, b):
        mean, rstd = _group_stats(h, groups, eps)
        n = (h - mean) * rstd * s.float() + b.float()
        return (n * torch.sigmoid(n)).to(dtype)

    xf = x.float()
    h = (_conv3(gn_silu(xf, gn1s, gn1b), k1) + c1b.float()).to(dtype)
    h = _conv3(gn_silu(h.float(), gn2s, gn2b), k2) + c2b.float()
    y = (xf + h).to(dtype)
    if use_modulation:
        yf = y.float()
        mean, rstd = _group_stats(yf, groups, eps)
        hm = (yf - mean) * rstd * mgs.float() + mgb.float()
        y = (yf + hm * (1.0 + mods.float()[:, None])
             + modb.float()[:, None]).to(dtype)
    return y


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("resnet_item").resnet_item_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    fn = load_library("resnet_item_bwd").resnet_item_backward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 34
                   + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def conv_occupancy(dtype: torch.dtype, channels: int, length: int,
                   batch: int = 1) -> dict:
    """The conv kernel's grid at one item shape against what the card holds
    at once: CTAs launched, resident CTAs per SM, and the share of one full
    wave they fill (needs a CUDA device)."""
    fn = load_library("resnet_item").resnet_conv_grid
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    ctas, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(_DTYPE_CODES[dtype], batch, length, channels, ctypes.byref(ctas),
             ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"conv_occupancy: CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(ctas=ctas.value, blocks_per_sm=blocks.value, sms=sms,
                wave_fill=min(1.0, ctas.value / (sms * blocks.value)))


def wgrad_slabs(batch: int, length: int, channels: int):
    """(chunks per slab, slabs) of the weight-gradient kernel at one item
    shape: enough slabs for about ``_WGRAD_CTAS`` CTAs, as long as their f32
    partials stay within ``_WGRAD_PARTIAL_BYTES``."""
    chunks = batch * -(-length // _WGRAD_CHUNK)
    tiles = (-(-channels // _WGRAD_TILE)) ** 2
    fit = _WGRAD_PARTIAL_BYTES // (12 * channels * channels)
    slabs = max(1, min(chunks, -(-_WGRAD_CTAS // tiles), fit))
    per_slab = -(-chunks // slabs)
    return per_slab, -(-chunks // per_slab)


def _ptr(t: Optional[Tensor]):
    return t.data_ptr() if t is not None else None


def _stats_tiles(length: int, channels: int):
    """(rows per tile, tiles) of the two-stage reductions over L."""
    rows_per_tile = max(1, _STATS_ELEMS_PER_CTA // channels)
    return rows_per_tile, -(-length // rows_per_tile)


def _launch_forward(x, params, groups, eps, use_modulation, keep):
    """Launch the forward chain. ``keep`` asks for what the backward reads:
    returns (out, h, y, stats), with y the item before its modulation (out
    itself when nothing is kept or there is no modulation)."""
    b, length, c = x.shape
    rows_per_tile, n_tiles = _stats_tiles(length, c)
    h = torch.empty_like(x)
    y = torch.empty_like(x)
    out = torch.empty_like(x) if keep and use_modulation else y
    partial = torch.empty((b, n_tiles, groups, 2), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((3, b, groups, 2), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            _DTYPE_CODES[x.dtype], _ptr(x), *(_ptr(t) for t in params),
            _ptr(h), _ptr(y), _ptr(out), _ptr(partial), _ptr(stats),
            b, length, c, groups, rows_per_tile, eps, int(use_modulation),
            stream)
    if err:
        raise RuntimeError(f"fused_resnet_item: CUDA error {err} at launch")
    fused_resnet_item.launches += 1
    return out, h, y, stats


class _FusedResnetItem(torch.autograd.Function):
    """The item on a CUDA tensor with its hand-written backward. Inputs were
    checked by :func:`fused_resnet_item`."""

    @staticmethod
    def forward(ctx, groups, eps, use_modulation, x, *params):
        out, h, y, stats = _launch_forward(x, params, groups, eps,
                                           use_modulation, keep=True)
        ctx.save_for_backward(x, h, y, stats, *params)
        ctx.item = (groups, eps, use_modulation)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        groups, eps, use_modulation = ctx.item
        x, h, y, stats, *params = ctx.saved_tensors
        (gn1s, gn1b, k1, _, gn2s, gn2b, k2, _, mods, _, mgs, mgb) = params
        g = g.contiguous()
        if g.dtype != x.dtype or g.device != x.device or g.data_ptr() % 16:
            raise ValueError(
                f"fused_resnet_item backward: gradient is {g.dtype} on "
                f"{g.device} (16-byte aligned: {g.data_ptr() % 16 == 0}), "
                f"x is {x.dtype} on {x.device}")
        b, length, c = x.shape
        rows_per_tile, n_tiles = _stats_tiles(length, c)
        per_slab, slabs = wgrad_slabs(b, length, c)
        grads = [torch.empty_like(t) if t is not None else None
                 for t in (x, *params)]
        dy = torch.empty_like(x) if use_modulation else None
        dh = torch.empty_like(x)
        f32 = dict(dtype=torch.float32, device=x.device)
        dn = torch.empty(x.shape, **f32)
        red_partial = torch.empty((b, n_tiles, c, 3), **f32)
        col = torch.empty((b, c, 3), **f32)
        means = torch.empty((b, groups, 2), **f32)
        wpartial = torch.empty((slabs, 3, c, c), **f32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _backward_kernel()(
                _DTYPE_CODES[x.dtype], _ptr(g), _ptr(x), _ptr(h), _ptr(y),
                _ptr(stats), _ptr(gn1s), _ptr(gn1b), _ptr(k1), _ptr(gn2s),
                _ptr(gn2b), _ptr(k2), _ptr(mods), _ptr(mgs), _ptr(mgb),
                *(_ptr(t) for t in grads), _ptr(dy), _ptr(dh), _ptr(dn),
                _ptr(red_partial), _ptr(col), _ptr(means), _ptr(wpartial),
                b, length, c, groups, rows_per_tile, per_slab, slabs, eps,
                int(use_modulation), stream)
        if err:
            raise RuntimeError(
                f"fused_resnet_item backward: CUDA error {err} at launch")
        fused_resnet_item.backward_launches += 1
        return (None, None, None, *grads)


def fused_resnet_item(x: Tensor, gn1s: Tensor, gn1b: Tensor, k1: Tensor,
                      c1b: Tensor, gn2s: Tensor, gn2b: Tensor, k2: Tensor,
                      c2b: Tensor, mods: Optional[Tensor] = None,
                      modb: Optional[Tensor] = None,
                      mgs: Optional[Tensor] = None,
                      mgb: Optional[Tensor] = None, *, groups: int = 8,
                      eps: float = 1e-5, use_modulation: bool = True) -> Tensor:
    """One resnet(+modulation) item. x [B, L, C] float32 or bfloat16; k1/k2
    [3, C, C] (tap, in, out); GN scales/biases and conv biases [C];
    mods/modb [B, C] (the modulation's scale and shift); every tensor in
    x's dtype. Differentiable in all 13 tensors (not in ``groups``, ``eps``,
    ``use_modulation``): on the CPU through the plain version, on a CUDA
    tensor through the backward kernels. ``fused_resnet_item.launches``
    counts forward launches and ``.backward_launches`` backward ones, one
    per item."""
    if x.device.type == "cpu":
        return resnet_item_reference(
            x, gn1s, gn1b, k1, c1b, gn2s, gn2b, k2, c2b, mods, modb, mgs, mgb,
            groups=groups, eps=eps, use_modulation=use_modulation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resnet_item: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_resnet_item: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"fused_resnet_item: x must be [B, L, C], got "
                         f"{tuple(x.shape)}")
    b, length, c = x.shape
    if c % groups or c % 8:
        raise ValueError(f"fused_resnet_item: {c} channels must be a multiple "
                         f"of 8 and of {groups} groups")
    shapes = {"gn1s": (c,), "gn1b": (c,), "k1": (3, c, c), "c1b": (c,),
              "gn2s": (c,), "gn2b": (c,), "k2": (3, c, c), "c2b": (c,)}
    if use_modulation:
        shapes.update(mods=(b, c), modb=(b, c), mgs=(c,), mgb=(c,))
    args = dict(gn1s=gn1s, gn1b=gn1b, k1=k1, c1b=c1b, gn2s=gn2s, gn2b=gn2b,
                k2=k2, c2b=c2b, mods=mods, modb=modb, mgs=mgs, mgb=mgb)
    for name, shape in shapes.items():
        t = args[name]
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"fused_resnet_item: {name} must have shape "
                             f"{shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
    needs_grad = False
    for name, t in [("x", x)] + [(n, args[n]) for n in shapes]:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"fused_resnet_item: {name} is {t.dtype} on "
                             f"{t.device}, x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_resnet_item: {name} is not contiguous")
        if name in ("x", "k1", "k2") and t.data_ptr() % 16:
            raise ValueError(f"fused_resnet_item: {name} is not 16-byte "
                             "aligned (the kernel copies 16-byte vectors)")
        needs_grad = needs_grad or t.requires_grad
    params = tuple(args[n] if n in shapes else None for n in args)
    if needs_grad and torch.is_grad_enabled():
        return _FusedResnetItem.apply(groups, eps, use_modulation, x, *params)
    return _launch_forward(x, params, groups, eps, use_modulation,
                           keep=False)[0]


fused_resnet_item.launches = 0
fused_resnet_item.backward_launches = 0
