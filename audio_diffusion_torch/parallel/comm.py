"""The collectives of the multi-GPU paths, and the two shard contexts that
the net and the losses read.

One process runs per rank. Three collectives carry everything the sharded
paths exchange:

- :func:`all_gather_rows`: every rank's tensor, concatenated along one axis
  in rank order;
- :func:`all_reduce_sum`: the sum over ranks, taken as an all-gather and
  then a sum in rank order, so it is the same bits on every rank and from
  run to run (gradients, GroupNorm partials, losses, gradient norms);
- :func:`exchange_halo`: the neighbours' edge rows along one axis (the k=3
  convolutions of a length-sharded net).

Under NCCL they are NCCL calls on the card. Gloo runs only broadcast and
all-reduce on CUDA tensors, so under gloo (two ranks sharing one card, or
ranks on the CPU) a CUDA tensor is copied to the host, the gloo call runs
there, and the result is copied back. That copy is what the backend is, not
a fallback: nothing here changes backend or device when a call fails, it
raises. The compute stays on the card.

:func:`length_shard` says that the length axis of the net's activations is
split over a group (``parallel/inference.py``); :func:`data_shard` says that
a batch holds this rank's rows of a global batch, so that a loss draws the
global batch's σ and noise and keeps its rows (:func:`global_rows`). With
neither set, everything behaves as on one device.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

__all__ = ["Shard", "group_shard", "all_gather_rows", "all_reduce_sum",
           "exchange_halo", "pad_halo", "length_shard",
           "current_length_shard", "data_shard", "global_rows"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's place in a process group: ``rank`` of ``size``."""
    group: Any
    rank: int
    size: int


def group_shard(group) -> Shard:
    """This rank's place in ``group``."""
    return Shard(group, dist.get_rank(group), dist.get_world_size(group))


def all_gather_rows(x: Tensor, group, dim: int = 0) -> Tensor:
    """Every rank's ``x`` (all of one shape), concatenated along ``dim`` in
    rank order, on ``x``'s device. A one-rank group returns ``x``."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    x = x.detach().contiguous()
    if x.device.type == "cpu" or dist.get_backend(group) == "gloo":
        # Gloo gathers host tensors only: a CUDA tensor goes through the
        # host and back.
        host = x.cpu()
        parts = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim).to(x.device)
    out = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return torch.cat(out.unbind(0), dim)


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """The sum of every rank's ``x``, added in rank order (0 + 1 + ...), on
    every rank. A one-rank group returns ``x``."""
    if dist.get_world_size(group) == 1:
        return x
    parts = all_gather_rows(x[None], group)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def exchange_halo(x: Tensor, group, dim: int = 1
                  ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """(the previous rank's last row along ``dim``, the next rank's first
    row), each None where this rank is at that end of the group."""
    shard = group_shard(group)
    if shard.size == 1:
        return None, None
    n = x.shape[dim]
    edges = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)], dim)
    every = all_gather_rows(edges[None], group)
    left = (every[shard.rank - 1].narrow(dim, 1, 1)
            if shard.rank > 0 else None)
    right = (every[shard.rank + 1].narrow(dim, 0, 1)
             if shard.rank < shard.size - 1 else None)
    return left, right


def pad_halo(x: Tensor, left: Optional[Tensor], right: Optional[Tensor],
             dim: int = 1) -> Tuple[Tensor, int]:
    """``[left; x; right]`` along ``dim`` (a side only where it exists) and
    the offset of ``x``'s first row in it. A "SAME" k=3 convolution of the
    result, cut back to ``x``'s rows, is the convolution of the whole length
    at those rows: zero padding stays at the global ends."""
    parts = [t.to(x.dtype) for t in (left, x, right) if t is not None]
    return torch.cat(parts, dim).contiguous(), int(left is not None)


_LENGTH: contextvars.ContextVar = contextvars.ContextVar("length_shard",
                                                         default=None)
_DATA: contextvars.ContextVar = contextvars.ContextVar("data_shard",
                                                       default=None)


@contextlib.contextmanager
def length_shard(group):
    """Within the block, the net's length-mixing ops (GroupNorm statistics,
    k=3 convolutions, attention) treat their activations' length axis as
    this rank's contiguous part of a length split over ``group`` in rank
    order; ``group=None`` lifts an outer shard for the block."""
    token = _LENGTH.set(None if group is None else group_shard(group))
    try:
        yield
    finally:
        _LENGTH.reset(token)


def current_length_shard() -> Optional[Shard]:
    """The :func:`length_shard` in force over more than one rank, else
    None."""
    shard = _LENGTH.get()
    return shard if shard is not None and shard.size > 1 else None


@contextlib.contextmanager
def data_shard(rank: int, size: int):
    """Within the block, a batch of ``n`` rows is rows ``rank·n`` to
    ``(rank + 1)·n`` of a global batch of ``size·n`` (see
    :func:`global_rows`)."""
    token = _DATA.set(Shard(None, rank, size))
    try:
        yield
    finally:
        _DATA.reset(token)


def global_rows(n_local: int) -> Tuple[int, slice]:
    """(the global batch size, this rank's rows of it) for a batch of
    ``n_local`` rows. A batch-leading draw takes the global shape from the
    generator, which every rank holds in the same state, and keeps these
    rows, so a rank sees exactly its rows of the one-device draws."""
    shard = _DATA.get()
    if shard is None or shard.size == 1:
        return n_local, slice(None)
    start = shard.rank * n_local
    return n_local * shard.size, slice(start, start + n_local)
