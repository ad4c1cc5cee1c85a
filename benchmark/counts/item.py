"""The fused resnet item's least time on the chip, forward and backward,
from its shape [batch, length, channels] and dtype.

The item is (GroupNorm, SiLU, k=3 conv) twice plus the identity, then the
modulation x + GroupNorm(x)·(1 + scale) + shift. Its two convolutions are
12·C²·L·B operations forward; the backward's two data gradients and two
weight gradients 24·C²·L·B. The bound is the larger of operations over the
peak rate and bytes over HBM bandwidth. In bfloat16 on the nine-level
net (C, L from (8, 2^18) down to (1024, 2^7)) the forward at batch 1 is
bound by bytes at levels 0-2 (few channels, long rows) and 7-8 (the
kernels' 12·C² bytes outweigh short rows) and by operations at levels
3-6; at batch 2 level 7 turns to operations, at batch 8 levels 3-8. The
backward follows the same split, except level 3 at batch 1 (bytes).
"""
from __future__ import annotations

from typing import Tuple

from .peaks import ELEMENT_BYTES, FLOPS, HBM_BYTES_PER_S


def forward(batch: int, length: int, channels: int,
            dtype: str = "bfloat16") -> Tuple[float, int, int]:
    """(bound in seconds, bytes, operations) of one item forward with
    modulation."""
    b, l, c = batch, length, channels
    nbytes = (2 * b * l * c + 6 * c * c + 8 * c + 2 * b * c) \
        * ELEMENT_BYTES[dtype]
    flops = 12 * c * c * l * b
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype]), nbytes, flops


def backward(batch: int, length: int, channels: int,
             dtype: str = "bfloat16") -> Tuple[float, int, int]:
    """(bound in seconds, bytes, operations) of one item backward with
    modulation: the forward keeps h, y and the statistics, so no
    convolution runs again."""
    b, l, c = batch, length, channels
    nbytes = (5 * b * l * c + 12 * c * c + 22 * c) * ELEMENT_BYTES[dtype]
    flops = 24 * c * c * l * b
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype]), nbytes, flops
