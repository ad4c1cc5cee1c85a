"""Int8/int4 weight-only quantization for inference (counterpart of
audio_diffusion_tpu/ops/quant.py).

``quantize_params(model.params)`` returns a NEW parameter dict in which
every float tensor with ``ndim >= 2`` and at least ``min_size`` elements is
a :class:`QTensor`: int8 values and float32 per-output-channel scales
(symmetric, [-127, 127]; zero leaves quantize to exact zeros). The master
parameters are never modified; the quantized dict rides the explicit
``params=`` override::

    qparams = quantize_params(model.params)
    audio = model.sample(noise, num_steps=50, params=qparams)
    service = GenerationService(model, params=qparams)

The samplers dequantize the dict to the net's compute dtype inside each
step (:func:`dequantize_step_params`), as the JAX samplers do. JAX mixes a
zero derived from the loop carry into the scales so that XLA cannot hoist
the dequantization out of its scan; an eager Python loop has nothing to
hoist, so the port dequantizes each step as it is and the values are the
same.

Layout. The JAX rule quantizes per output channel, the LAST axis of the
JAX leaf, and ``bits=4`` packs two signed nibbles ([-7, 7]) per byte along
the flattened INPUT axes. The port keeps a flax Dense kernel [in, out] as an
``nn.Linear`` weight [out, in] (``convert.py``), so for a leaf named
``...weight`` :func:`quantize_params` applies the JAX rule to its
transposition and stores ``q`` and ``qscale`` transposed back
(``channel_axis=0``: the scales are [out, 1], int4 pairs lie along the
last axis). Every other leaf keeps the JAX layout (``channel_axis=-1``).
So ``quantize_params(params_from_jax(tree))`` equals
``params_from_jax(jax_quantize_params(tree))`` bit for bit, and
dequantization gives contiguous tensors in the port's layout.

int4 is an at-rest format: :func:`unpack_int4_leaves` turns its leaves into
the int8 form once, at load, with the same values and scales.
"""
from __future__ import annotations

from math import prod
from typing import Dict, Optional

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

__all__ = [
    "QTensor",
    "quantize_params",
    "dequantize_params",
    "has_qtensors",
    "dequantize_step_params",
    "unpack_int4_leaves",
]


class QTensor:
    """A quantized weight: int8 ``q`` and float32 per-output-channel
    ``qscale``. ``orig_dtype`` (a name such as ``"float32"``) is the dtype
    a dequantization without one restores. ``bits`` is 8 or 4 (two signed
    nibbles per byte); a 4-bit leaf records its unpacked shape in
    ``orig_shape``. ``channel_axis`` is the axis of the output channels in
    the port's layout: -1 (the JAX layout) or 0 (an ``nn.Linear`` weight
    [out, in]). A registered pytree node, so an exported program takes a
    parameter dict that holds QTensors."""

    __slots__ = ("q", "qscale", "orig_dtype", "bits", "orig_shape",
                 "channel_axis")

    def __init__(self, q, qscale, orig_dtype: str = "float32", bits: int = 8,
                 orig_shape=None, channel_axis: int = -1):
        if bits == 4 and orig_shape is None:
            raise ValueError(
                "QTensor(bits=4) requires orig_shape: int4 storage is packed "
                "(two rows per byte) and the pre-packing shape cannot be "
                "recovered from the packed array alone")
        if channel_axis not in (0, -1):
            raise ValueError(f"channel_axis must be 0 or -1, got "
                             f"{channel_axis}")
        self.q = q
        self.qscale = qscale
        self.orig_dtype = orig_dtype
        self.bits = bits
        self.orig_shape = tuple(orig_shape) if orig_shape is not None else None
        self.channel_axis = channel_axis

    @property
    def shape(self):
        """The LOGICAL weight shape, the dequantized tensor's. For int4 it
        is about twice the storage; count bytes from :attr:`packed_shape`."""
        return (self.orig_shape if self.orig_shape is not None
                else tuple(self.q.shape))

    @property
    def packed_shape(self):
        """The shape of the int8 storage ``q``."""
        return tuple(self.q.shape)

    def __repr__(self):
        return (f"QTensor(shape={tuple(self.shape)}, int{self.bits}, "
                f"{self.orig_dtype})")


def _flatten(qt: QTensor):
    return [qt.q, qt.qscale], [qt.orig_dtype, qt.bits, qt.orig_shape,
                               qt.channel_axis]


def _flatten_with_keys(qt: QTensor):
    # Index keys: an exported program's guards name each child by its key
    # path, and attribute keys where one name is a prefix of the other
    # ("q", "qscale") break that code.
    children, context = _flatten(qt)
    return [(pytree.SequenceKey(i), c) for i, c in enumerate(children)], context


def _unflatten(children, context) -> QTensor:
    return QTensor(*children, *context)


def _to_dumpable(context) -> str:
    import json

    dtype, bits, shape, axis = context
    return json.dumps([dtype, bits, None if shape is None else list(shape),
                       axis])


def _from_dumpable(text: str):
    import json

    return json.loads(text)


pytree.register_pytree_node(
    QTensor, _flatten, _unflatten, flatten_with_keys_fn=_flatten_with_keys,
    serialized_type_name="audio_diffusion_torch.ops.quant.QTensor",
    to_dumpable_context=_to_dumpable, from_dumpable_context=_from_dumpable)


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def _is_dense(name: str) -> bool:
    """An ``nn.Linear`` weight [out, in] (a flax Dense kernel transposed)."""
    return name.rsplit(".", 1)[-1] == "weight"


def _quantize_jax_layout(w: Tensor, bits: int):
    """The JAX rule on a leaf in the JAX layout: (q, scale, packed?)."""
    qmax = 127 if bits == 8 else 7
    wf = w.to(torch.float32)
    amax = torch.amax(wf.abs(), dim=tuple(range(w.dim() - 1)), keepdim=True)
    # A tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds otherwise than the CPU and JAX do.
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    if bits == 8:
        return q, scale
    n = w.shape[-1]
    q2 = q.reshape(-1, n)
    if q2.shape[0] % 2:
        q2 = torch.cat([q2, q2.new_zeros(1, n)], dim=0)
    low, high = q2[0::2], q2[1::2]
    packed = torch.bitwise_or(torch.bitwise_left_shift(high, 4),
                              torch.bitwise_and(low, 0x0F))
    return packed.to(torch.int8), scale


def quantize_leaf(w: Tensor, bits: int = 8, channel_axis: int = -1
                  ) -> QTensor:
    """Symmetric per-output-channel int8 or int4 quantization of ``w``,
    whose output channels lie on ``channel_axis`` (-1, or 0 for an
    ``nn.Linear`` weight [out, in]). ``bits=4`` packs value pairs along the
    flattened input axes: byte ``b`` holds input row ``2i`` in its low
    nibble and ``2i + 1`` in its high one; an odd count is padded with a
    zero row that dequantization drops."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    dtype = str(w.dtype).split(".")[-1]
    wj = w.t() if channel_axis == 0 else w
    q, scale = _quantize_jax_layout(wj, bits)
    if channel_axis == 0:
        q, scale = q.t().contiguous(), scale.t().contiguous()
    return QTensor(q, scale, dtype, bits,
                   tuple(w.shape) if bits == 4 else None, channel_axis)


def _unpack_int4(qt: QTensor) -> Tensor:
    """Packed int8 -> int8 nibble values of ``qt.orig_shape``."""
    p, shape = qt.q, qt.orig_shape
    if qt.channel_axis == 0:
        p, shape = p.t(), shape[::-1]
    # Arithmetic shifts of int8: the low nibble sign-extends.
    low = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    high = torch.bitwise_right_shift(p, 4)
    n = p.shape[-1]
    rows = torch.stack([low, high], dim=1).reshape(-1, n)
    out = rows[:prod(shape[:-1])].reshape(shape)
    return out.t().contiguous() if qt.channel_axis == 0 else out


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def dequantize_leaf(qt: QTensor, dtype=None) -> Tensor:
    """The (approximate) weight in ``dtype`` (default: the original), as a
    new contiguous tensor in the port's layout. Computed at that width:
    int8 values and float32 scales are cast to ``dtype`` and multiplied
    there, as the JAX package does, not in float32 and rounded after."""
    dt = _torch_dtype(dtype if dtype is not None else qt.orig_dtype)
    q = qt.q if qt.bits == 8 else _unpack_int4(qt)
    return q.to(dt) * qt.qscale.to(dt)


def quantize_params(params: Dict[str, Tensor], min_size: int = 65536,
                    bits: int = 8) -> Dict:
    """A NEW dict in which every float tensor with ndim >= 2 and at least
    ``min_size`` elements is a :class:`QTensor` (conv kernels, attention
    and feed-forward projections, modulation and skip gates, resampling
    kernels); biases, norm scales and embeddings stay exact. ``bits=4``
    stores two values per byte."""
    out = {}
    with torch.no_grad():
        for name, w in params.items():
            if (isinstance(w, Tensor) and w.dim() >= 2
                    and w.numel() >= min_size and w.is_floating_point()):
                out[name] = quantize_leaf(
                    w.detach(), bits, 0 if _is_dense(name) else -1)
            else:
                out[name] = w
    return out


def dequantize_params(params: Dict, dtype=None) -> Dict[str, Tensor]:
    """Inverse of :func:`quantize_params` (lossy): QTensor values become
    tensors of ``dtype`` (default: each one's original dtype); everything
    else passes through."""
    return {name: dequantize_leaf(v, dtype) if _is_q(v) else v
            for name, v in params.items()}


def unpack_int4_leaves(params: Dict) -> Dict:
    """Every int4 QTensor in its int8 form, with the same values and scales
    (lossless; done once, at load). int4 is the format at rest and in
    transit; the samplers stream the int8 form."""
    return {name: (QTensor(_unpack_int4(v), v.qscale, v.orig_dtype,
                           channel_axis=v.channel_axis)
                   if _is_q(v) and v.bits == 4 else v)
            for name, v in params.items()}


def has_qtensors(params: Dict) -> bool:
    """Whether the dict holds any QTensor."""
    return any(_is_q(v) for v in params.values())


def dequantize_step_params(params: Dict, dtype) -> Dict:
    """The dict a sampling step runs on: dequantized to ``dtype`` (the
    net's compute dtype; None keeps each original dtype) when it holds
    QTensors, else ``params`` itself, untouched. The JAX version's
    ``anchor`` (a zero from the carry against XLA's loop-invariant
    hoisting) has no use in an eager loop and is not taken."""
    if not has_qtensors(params):
        return params
    return dequantize_params(params, dtype)


def storage_bytes(params: Dict) -> int:
    """Bytes the dict holds at rest: a QTensor's int8 storage and scales,
    every other tensor as it is."""
    total = 0
    for v in params.values():
        for t in ((v.q, v.qscale) if _is_q(v) else (v,)):
            total += t.numel() * t.element_size()
    return total
