"""Fused resnet(+modulation) item: the wrapper of its CUDA kernel and its
plain PyTorch version.

Counterpart of ``audio_diffusion_tpu/ops/kernels/resnet.py`` (the Pallas
``fused_resnet_item``) at fold 1, channels-last ``[B, L, C]``: no lane
folding, so no lane→group matrices. The kernel source is
``audio_diffusion_torch/csrc/resnet_item.cu``, whose bf16 convolutions are
``csrc/conv3_sm90.cuh``; their headers say what bounds them on an H100 and
how the design answers that. :func:`conv_plan` picks that conv's tile and
split-K per item shape.

A CPU tensor takes :func:`resnet_item_reference`, whose gradient is
autograd's; a CUDA tensor takes the kernels or raises. Where autograd needs a
gradient, the forward keeps its input, conv 1's output, the item before its
modulation and the three GroupNorm statistics, and the backward is the
hand-written chain of ``audio_diffusion_torch/csrc/resnet_item_bwd.cu``
(counterpart of the Pallas kernel's custom VJP). In bf16 its data gradients
run the forward's conv (``conv3_sm90.cuh``, :func:`conv_plan`) and its weight
gradients ``csrc/wgrad_sm90.cuh`` (:func:`wgrad_plan`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from .build import load_library

__all__ = ["fused_resnet_item", "resnet_item_reference", "conv_plan",
           "conv_occupancy", "wgrad_plan", "backward_occupancy"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Elements each CTA of the statistics pass sums (sets its L tile).
_STATS_ELEMS_PER_CTA = 8192
# The weight gradient sums B·L positions in slabs of position chunks, each
# slab writing an f32 [3, C, C] partial, all of them within this many bytes.
# bf16 (csrc/wgrad_sm90.cuh), for C up to each key: the tile's output
# channels per CTA (8 and 32: the narrow mma.sync kernel, whole C; 64 and
# 128: wgmma, by 64 input channels), positions per chunk (on an H100, 128
# positions for the 128 tile were up to 17% faster than 64, and never more
# than 1% slower; PERF.md) and the CTAs an H100 holds per SM with a full
# ring, as the CUDA occupancy API reports them (on the card the plan asks
# the API: _wgrad_resident). f32 (csrc/resnet_item_bwd.cu): one 64 x 64
# tile over 32-position chunks, about _WGRAD_F32_CTAS CTAs.
_WGRAD_TILES = ((8, 8, 256, 5), (32, 32, 64, 2), (64, 64, 64, 2),
                (None, 128, 128, 1))
_WGRAD_PARTIAL_BYTES = 16 * 2**20
_WGRAD_F32_CTAS = 512
# The bf16 forward conv (csrc/conv3_sm90.cuh): output channels per CTA for
# C up to each key, the most and the fewest 64-row sub-tiles per CTA, and
# the K chunk of that tile; an H100's SMs; the cap on split-K's f32
# partials.
_CONV_TILES = ((8, 8, 2, 16), (32, 4, 1, 32), (64, 2, 1, 32),
               (128, 2, 2, 32))
_SMS = 132
_CONV_WORKSPACE_BYTES = 16 * 2**20


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
                   + [ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    fn = load_library("resnet_item_bwd").resnet_item_backward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 30
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _occupancy(fn, *plan: int):
    """(dynamic shared memory, resident CTAs per SM) of one kernel's plan on
    the current device, from a library's occupancy entry (no launch)."""
    fn.argtypes = ([ctypes.c_int] * len(plan)
                   + [ctypes.POINTER(ctypes.c_int)] * 2)
    fn.restype = ctypes.c_int
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(*plan, ctypes.byref(smem), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return smem.value, blocks.value


def _with_fill(plan: dict, sms: int, smem: int, blocks: int) -> dict:
    """``plan`` with its occupancy and the share of one full wave its grid
    fills (above 1: more than one wave)."""
    return dict(plan, smem_bytes=smem, blocks_per_sm=blocks, sms=sms,
                wave_fill=plan["ctas"] / (sms * blocks))


def backward_occupancy(channels: int, length: int, batch: int = 1) -> dict:
    """The plans of the bf16 backward's two convolutions at one item shape
    (:func:`conv_plan` for the data gradient, :func:`wgrad_plan` for the
    weight gradient, as the backward takes them), each with its dynamic
    shared memory, resident CTAs per SM and the share of one full wave it
    fills (needs a CUDA device)."""
    dev = torch.cuda.current_device()
    sms = _sm_count(dev)
    dplan = conv_plan(batch, length, channels, sms)
    wplan = wgrad_plan(batch, length, channels, sms,
                       _wgrad_resident(dev, channels))
    lib = load_library("resnet_item_bwd")
    return dict(
        data_gradient=_with_fill(dplan, sms, *_occupancy(
            lib.resnet_dgrad_occupancy, dplan["bn"], dplan["mt"],
            dplan["bk"], dplan["cps"])),
        weight_gradient=_with_fill(wplan, sms, *_occupancy(
            lib.resnet_wgrad_occupancy, wplan["tile"], wplan["chunk"],
            wplan["cps"])))


def conv_occupancy(channels: int, length: int, batch: int = 1) -> dict:
    """:func:`conv_plan` of the bf16 forward conv at one item shape against
    what the card holds at once: the plan, its dynamic shared memory,
    resident CTAs per SM, and the share of one full wave they fill (needs a
    CUDA device)."""
    sms = _sm_count(torch.cuda.current_device())
    plan = conv_plan(batch, length, channels, sms)
    return _with_fill(plan, sms, *_occupancy(
        load_library("resnet_item").resnet_conv_plan_occupancy, plan["bn"],
        plan["mt"], plan["bk"], plan["cps"]))


@functools.lru_cache(maxsize=None)
def _wgrad_resident(device_index: int, channels: int) -> int:
    """CTAs per SM that one device holds of the bf16 weight gradient's tile
    for ``channels`` with a full ring of chunks, from the CUDA occupancy
    API."""
    _, tile, chunk, _ = _wgrad_tile(channels)
    with torch.cuda.device(device_index):
        # Any chunks per slab from the ring's depth up give the full ring.
        return _occupancy(load_library("resnet_item_bwd")
                          .resnet_wgrad_occupancy, tile, chunk, 2**30)[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def conv_plan(batch: int, length: int, channels: int, sms: int = _SMS) -> dict:
    """Tile and split-K of the bf16 conv at one item shape: the forward's
    two convs and the backward's two data gradients, whose shapes are the
    same (M = L rows, N = C, K = 3·C).

    ``bn`` output channels (a multiple of 8 up to 128, the narrowest of
    8, 32, 64, 128 that covers C) by ``64 * mt`` rows per CTA, K chunks of
    ``bk`` input channels (16 at C = 8, half of it zero, else 32). Where
    its row tiles would not give every SM a CTA, ``mt`` drops to its tile's
    fewest (2 at C = 8, 1 at C = 32 and 64); the 128-channel tile is always
    128 rows tall, so that fewer row tiles read each weight (on an H100
    that took 2–9% off an item at levels 3–8 against 64 rows; PERF.md).
    If the grid still fills less than a wave of ``sms`` CTAs, K's
    ``chunks`` are split: each of ``splits`` CTAs per output tile takes
    ``cps`` consecutive chunks (all three taps of each; the last split may
    take fewer). The split count is :func:`_split`'s for ``resident`` CTAs
    on each SM, with f32 partials (``workspace_bytes``) within
    ``_CONV_WORKSPACE_BYTES``. At the flagship's levels these are the
    splits whose grid comes nearest one wave, which on an H100 at batch 1
    were the fastest, or within 2% of it, at every level from 3 to 8
    (``conv_plan_sweep.py``; PERF.md)."""
    bn, mt, mt_min, bk = next((t for t in _CONV_TILES if channels <= t[0]),
                              _CONV_TILES[-1])
    ch_tiles = -(-channels // bn)
    if batch * -(-length // (64 * mt)) * ch_tiles < sms:
        mt = mt_min
    tiles = batch * -(-length // (64 * mt)) * ch_tiles
    chunks = -(-channels // bk)
    partial = 4 * batch * length * channels
    # CTAs an SM holds at once: the kernel's launch bounds give the
    # 128 x 128 tile the registers of one CTA per SM, the others two.
    resident = 1 if bn * mt > 128 else 2
    splits, cps = 1, chunks
    if tiles < sms:
        splits, cps = _split(tiles, chunks, partial, _CONV_WORKSPACE_BYTES,
                             resident * sms)
    return dict(bn=bn, mt=mt, bk=bk, chunks=chunks, splits=splits, cps=cps,
                ctas=tiles * splits, resident=resident,
                workspace_bytes=partial * splits if splits > 1 else 0)


def _split(tiles: int, chunks: int, part_bytes: int, cap: int,
           wave: int):
    """(parts, chunks per part): ``chunks`` consecutive chunks of a sum
    shared among ``parts`` CTAs for each of ``tiles`` output tiles, each
    part taking ``cps`` of them (the last may take fewer). The split is the
    one that takes the fewest chunk-times, a CTA's chunks times the waves of
    ``wave`` resident CTAs its grid needs, with the fewer parts on a tie, as
    long as the parts' partials of ``part_bytes`` each stay within ``cap``
    (a single part writes no partial)."""
    best = None
    for want in range(1, chunks + 1):
        cps = -(-chunks // want)
        parts = -(-chunks // cps)
        if parts > 1 and parts * part_bytes > cap:
            break
        key = (-(-tiles * parts // wave) * cps, parts)
        if best is None or key < best[0]:
            best = key, parts, cps
    return best[1], best[2]


def _wgrad_tile(channels: int):
    """The _WGRAD_TILES row of the bf16 weight gradient at ``channels``."""
    return next(t for t in _WGRAD_TILES if t[0] is None or channels <= t[0])


@functools.lru_cache(maxsize=None)
def wgrad_plan(batch: int, length: int, channels: int, sms: int = _SMS,
               resident: Optional[int] = None, bf16: bool = True) -> dict:
    """Tile and slabs of the weight gradient at one item shape.

    dK [3, C, C] is a product over the ``batch * ceil(length / chunk)``
    position ``chunks``; each of ``slabs`` CTAs per output tile takes
    ``cps`` consecutive chunks (the last slab may take fewer) and writes an
    f32 partial [3, C, C] (``partial_bytes`` in all), summed in slab order
    afterwards. bf16: ``tile`` is the CTA's output channels (8 or 32: the
    narrow kernel's exact 3C x C tile for C up to 32; 64 or 128: the wgmma
    kernel, by 64 input channels), ``ctas`` = output tiles x slabs, and the
    slab count is :func:`_split`'s for ``resident`` CTAs on each of ``sms``
    SMs (an H100's from _WGRAD_TILES unless given) within
    ``_WGRAD_PARTIAL_BYTES``; one slab writes dK itself and needs no
    partial (``partial_bytes`` 0). f32 (``bf16=False``, tile 0): 64 x 64
    tiles over 32-position chunks, about ``_WGRAD_F32_CTAS`` CTAs within the
    same cap, partials always."""
    slab_bytes = 12 * channels * channels
    if bf16:
        _, tile, chunk, own = _wgrad_tile(channels)
        resident = resident or own
        tiles = 1 if tile <= 32 else -(-channels // 64) * -(-channels // tile)
        chunks = batch * -(-length // chunk)
        slabs, cps = _split(tiles, chunks, slab_bytes, _WGRAD_PARTIAL_BYTES,
                            resident * sms)
    else:
        tile, chunk, resident = 0, 32, None
        tiles = (-(-channels // 64)) ** 2
        chunks = batch * -(-length // chunk)
        want = max(1, min(chunks, -(-_WGRAD_F32_CTAS // tiles),
                          _WGRAD_PARTIAL_BYTES // slab_bytes))
        cps = -(-chunks // want)
        slabs = -(-chunks // cps)
    return dict(tile=tile, chunk=chunk, chunks=chunks, cps=cps, slabs=slabs,
                ctas=tiles * slabs, resident=resident,
                partial_bytes=(slab_bytes * slabs
                               if slabs > 1 or not bf16 else 0))


def _ptr(t: Optional[Tensor]):
    return t.data_ptr() if t is not None else None


def _backward_scratch(batch: int, length: int, channels: int, groups: int,
                      bf16: bool, sms: int = _SMS,
                      resident: Optional[int] = None):
    """The backward's plans and its one f32 scratch buffer: (the weight
    gradient's plan, the bf16 data gradient's plan or None, offsets in
    floats of dn, the GroupNorm backward's partials, column sums and group
    means, the slab partials and the split-K partials, each on a 256-byte
    boundary, and the buffer's size in floats). ``sms`` and ``resident``
    are the device's, as :func:`wgrad_plan` takes them."""
    _, n_tiles = _stats_tiles(length, channels)
    wplan = wgrad_plan(batch, length, channels, sms, resident, bf16)
    dplan = conv_plan(batch, length, channels, sms) if bf16 else None
    sizes = dict(dn=batch * length * channels,
                 red_partial=batch * n_tiles * channels * 3,
                 col=batch * channels * 3, means=batch * groups * 2,
                 wpartial=wplan["partial_bytes"] // 4,
                 dgrad_ws=dplan["workspace_bytes"] // 4 if dplan else 0)
    offsets, total = {}, 0
    for name, n in sizes.items():
        offsets[name] = total
        total += -(-n // 64) * 64
    return wplan, dplan, offsets, total


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
    plan, ws = (0, 0, 0, 1, 1), None
    if x.dtype == torch.bfloat16:
        p = conv_plan(b, length, c, _sm_count(x.device.index))
        plan = (p["bn"], p["mt"], p["bk"], p["splits"], p["cps"])
        if p["workspace_bytes"]:
            ws = torch.empty(p["workspace_bytes"] // 4, dtype=torch.float32,
                             device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            _DTYPE_CODES[x.dtype], _ptr(x), *(_ptr(t) for t in params),
            _ptr(h), _ptr(y), _ptr(out), _ptr(partial), _ptr(stats),
            b, length, c, groups, rows_per_tile, eps, int(use_modulation),
            *plan, _ptr(ws), stream)
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
        rows_per_tile, _ = _stats_tiles(length, c)
        bf16, dev = x.dtype == torch.bfloat16, x.device.index
        wplan, dplan, offsets, size = _backward_scratch(
            b, length, c, groups, bf16, _sm_count(dev),
            _wgrad_resident(dev, c) if bf16 else None)
        grads = [torch.empty_like(t) if t is not None else None
                 for t in (x, *params)]
        dy = torch.empty_like(x) if use_modulation else None
        dh = torch.empty_like(x)
        scratch = torch.empty(size, dtype=torch.float32, device=x.device)
        dgrad = ((dplan["bn"], dplan["mt"], dplan["bk"], dplan["splits"],
                  dplan["cps"]) if dplan else (0, 0, 0, 1, 1))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _backward_kernel()(
                _DTYPE_CODES[x.dtype], _ptr(g), _ptr(x), _ptr(h), _ptr(y),
                _ptr(stats), _ptr(gn1s), _ptr(gn1b), _ptr(k1), _ptr(gn2s),
                _ptr(gn2b), _ptr(k2), _ptr(mods), _ptr(mgs), _ptr(mgb),
                *(_ptr(t) for t in grads), _ptr(dy), _ptr(dh), _ptr(scratch),
                *offsets.values(), b, length, c, groups, rows_per_tile,
                wplan["tile"], wplan["chunk"], wplan["cps"], wplan["slabs"],
                *dgrad, eps, int(use_modulation), stream)
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
