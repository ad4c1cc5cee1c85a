"""The attention items' LayerNorm and attention core without a gradient:
the core's CUDA kernel (``audio_diffusion_torch/csrc/attention.cu``), the
library's LayerNorm, and their plain PyTorch versions.

The JAX package wrote no Pallas kernel here: its attention items leave
flax's LayerNorm and ``jax.nn.dot_product_attention`` to XLA
(``audio_diffusion_tpu/ops/attention.py``). Run eagerly, their plain forms
are about 36 launches per attention item, and on an H100 the host's time to
make them sets the pace of a sampling step at batch 1. Here they are three:
one ``F.layer_norm`` per LayerNorm (one launch, as fast on the card as a
hand-written kernel was and half its host time, ``PERF.md``) and one launch
of the core's kernel, which never writes the f32 logits. The source's header
says what bounds the core and how its design answers that.

:func:`layer_norm` is flax's ``nn.LayerNorm`` over the last axis and
:func:`attention_core` the attention between the projections: split into
heads, f32 logits of bf16 products, scale, f32 softmax, probabilities
rounded once to the value type, their product with the values, heads merged
(``F.scaled_dot_product_attention`` rounds elsewhere, so it is not used).
Each runs its plain version (:func:`layer_norm_reference`,
:func:`attention_core_reference`) on a CPU tensor; on a CUDA tensor it
launches or raises. Neither takes a gradient. The layers ask
:func:`layer_norm_route` and :func:`attention_core_route` which to run: the
fast one when no gradient is needed (:func:`needs_grad`) and it takes the
inputs (:func:`layer_norm_takes`, :func:`attention_core_takes`), else the
plain version, under autograd if need be.
``layer_norm.launches`` and ``attention_core.launches`` count the launches.
A trace (``torch.export``) records the core's call on a CUDA tensor as the
registered operator ``torch.ops.audio_diffusion_torch.attention_core``, one
node, as it records the fused resnet item, and the LayerNorm as ATen's.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import Tensor

from .build import launch_on, load_library

__all__ = ["layer_norm", "layer_norm_reference", "layer_norm_takes",
           "layer_norm_route", "attention_core", "attention_core_reference",
           "attention_core_takes", "attention_core_route", "needs_grad"]

_LN_DTYPES = (torch.float32, torch.bfloat16)


def needs_grad(*tensors: Tensor) -> bool:
    """Whether autograd would record an op on ``tensors``: grad mode is on
    and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ------------------------------------------------------------------ LayerNorm

def layer_norm_reference(x: Tensor, scale: Tensor, bias: Tensor, eps: float,
                         out_dtype: torch.dtype) -> Tensor:
    """flax ``nn.LayerNorm`` over the last axis in plain PyTorch: f32
    moments E[x²] − E[x]² (clamped at 0), y = (x − mean)·(rsqrt(var + eps)
    ·scale) + bias in f32, returned in ``out_dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(out_dtype)


def layer_norm_takes(x: Tensor, scale: Tensor, bias: Tensor,
                     out_dtype: torch.dtype) -> bool:
    """Whether ``F.layer_norm`` takes this LayerNorm: input, output and
    both parameters of one dtype, float32 or bfloat16 (on the card the
    library reads its parameters in the input's dtype and returns it)."""
    return (x.dtype in _LN_DTYPES
            and x.dtype == scale.dtype == bias.dtype == out_dtype)


def layer_norm_route(x: Tensor, scale: Tensor, bias: Tensor,
                     out_dtype: torch.dtype):
    """The LayerNorm to run on these inputs: :func:`layer_norm` when no
    gradient is needed and :func:`layer_norm_takes` them, else
    :func:`layer_norm_reference`."""
    if not needs_grad(x, scale, bias) and layer_norm_takes(x, scale, bias,
                                                           out_dtype):
        return layer_norm
    return layer_norm_reference


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float,
               out_dtype: torch.dtype) -> Tensor:
    """LayerNorm over the last axis of x [..., C] with scale and bias [C],
    without a gradient: on a CUDA tensor one launch of ``F.layer_norm``
    (what :func:`layer_norm_takes` accepts, or it raises), on a CPU tensor
    the plain version. The library sums the moments by Welford's method and
    scales after normalising, in f32 too, so an output may round to the
    neighbouring value of the output type."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no library call for device {x.device}")
    if not layer_norm_takes(x, scale, bias, out_dtype):
        raise ValueError(
            f"layer_norm: no library call for x {x.dtype}, parameters "
            f"{scale.dtype}/{bias.dtype}, output {out_dtype}")
    layer_norm.launches += 1
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


layer_norm.launches = 0


# ------------------------------------------------------------ attention core

def attention_core_reference(q: Tensor, k: Tensor, v: Tensor,
                             heads: int) -> Tensor:
    """The attention core in plain PyTorch, in the JAX package's form: q
    [B, S, H·D], k and v [B, N, H·D] -> [B, S, H·D]; f32 logits, scale
    1/√D, f32 softmax, probabilities rounded to v's dtype, then the product
    with the values (``scaled_dot_product_attention`` is not used, so the
    rounding points match the JAX package's)."""
    def split(t):
        b, s, _ = t.shape
        return t.reshape(b, s, heads, -1).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scale = qh.shape[-1] ** -0.5
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    out = torch.matmul(probs, vh)
    b, s, _ = q.shape
    return out.transpose(1, 2).reshape(b, s, -1)


def attention_core_takes(q: Tensor, k: Tensor, v: Tensor, heads: int) -> bool:
    """Whether the kernel takes this attention: q, k and v in bfloat16 and a
    head width that is a multiple of 16, at most 128."""
    d = q.shape[-1] // heads
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and d % 16 == 0 and 16 <= d <= 128)


def attention_core_route(q: Tensor, k: Tensor, v: Tensor, heads: int):
    """The attention core to run on these inputs: :func:`attention_core`
    when no gradient is needed and :func:`attention_core_takes` them, else
    :func:`attention_core_reference`."""
    if not needs_grad(q, k, v) and attention_core_takes(q, k, v, heads):
        return attention_core
    return attention_core_reference


def _core_geometry(q: Tensor, k: Tensor, v: Tensor, heads: int):
    """(B, S, N, D) of a kernel call, or a ValueError: q [B, S, H·D], k and v
    [B, N, H·D], each read through its strides, which (but the unit stride
    of the last axis) must be multiples of 8 elements (16 bytes)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention_core: q, k and v must be [B, L, H·D]")
    b, s, inner = q.shape
    n = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != inner
            or inner % heads or n < 1):
        raise ValueError(
            f"attention_core: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
            f"{tuple(v.shape)} do not split into {heads} heads over the same "
            "keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        if st[2] != 1 or st[1] % 8 or st[0] % 8:
            raise ValueError(
                f"attention_core: {name} (strides {t.stride()}) is not read "
                "as 16-byte rows")
    return b, s, n, inner // heads


@functools.lru_cache(maxsize=None)
def _core_kernel():
    fn = load_library("attention").attention_core_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_core(q: Tensor, k: Tensor, v: Tensor, heads: int) -> Tensor:
    b, s, n, d = _core_geometry(q, k, v, heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"attention_core: {name} is not 16-byte aligned "
                             "(the kernel reads 16-byte vectors)")
    out = torch.empty((b, s, heads * d), dtype=q.dtype, device=q.device)
    err = launch_on(
        q.device, _core_kernel(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, n, heads, d, *q.stride()[:2], *k.stride()[:2],
        *v.stride()[:2], d ** -0.5)
    if err:
        raise RuntimeError(f"attention_core: CUDA error {err} at launch")
    attention_core.launches += 1
    return out


def attention_core(q: Tensor, k: Tensor, v: Tensor, heads: int) -> Tensor:
    """The attention core of q [B, S, H·D] over k and v [B, N, H·D] ->
    [B, S, H·D], without a gradient: the kernel on CUDA tensors (what
    :func:`attention_core_takes` accepts, read through their strides, so
    the chunks of a packed projection need no copy; else it raises), the
    plain version on CPU tensors. Against the plain version on the card the
    kernel sums the logits and the output in another order, and a
    probability may round to the neighbouring bf16 value."""
    if q.device.type == "cpu":
        return attention_core_reference(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention_core: no kernel for device {q.device}")
    if not attention_core_takes(q, k, v, heads):
        raise ValueError(
            f"attention_core: no kernel for {q.dtype}/{k.dtype}/{v.dtype} "
            f"with head width {q.shape[-1] // heads}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention_core: q, k and v on different devices")
    if torch.compiler.is_compiling():
        _core_geometry(q, k, v, heads)
        return _core_op(q, k, v, heads)
    return _launch_core(q, k, v, heads)


attention_core.launches = 0


@torch.library.custom_op("audio_diffusion_torch::attention_core",
                         mutates_args=())
def _core_op(q: Tensor, k: Tensor, v: Tensor, heads: int) -> Tensor:
    """:func:`attention_core`'s kernel as an operator (inputs as it checks
    them)."""
    if q.device.type != "cuda":
        raise ValueError(f"attention_core: no kernel for device {q.device}")
    return _launch_core(q, k, v, heads)


@_core_op.register_fake
def _core_op_fake(q, k, v, heads):
    return q.new_empty(q.shape)
