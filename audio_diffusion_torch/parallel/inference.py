"""Sharded inference: sequence-parallel (length-sharded) sampling
(counterpart of audio_diffusion_tpu/parallel/inference.py).

Cuts batch-1 sampling latency across cards. The waveform's length axis is
split over one mesh axis, one contiguous part per rank in rank order, and
the model's own sampler runs on each part under ``comm.length_shard``: the
net's length-mixing ops exchange what they need (the fused item's
GroupNorm partials and conv halos, ``ops/kernels/resnet.py``; the plain
GroupNorm's sums and ``conv3``'s halos, ``ops/unet.py``; the attention
items' whole sequence, ``ops/attention.py``), where XLA inserted those
collectives for the JAX package. Per-position ops (the patch resampling,
the skips, the sampler's update) run on the part as they are. For the 1-D
U-Net (``UNetV0(dim=1)``).
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from . import comm
from .mesh import axis_rank, axis_size, check_mesh, mesh_device

__all__ = ["sample_length_sharded"]


def _total_factor(model) -> int:
    """The product of the net's downsampling factors (1 if it has none)."""
    return next((math.prod(m.factors) for m in model.net.module.modules()
                 if hasattr(m, "factors")), 1)


def sample_length_sharded(model, noise: Tensor, num_steps: int, mesh,
                          axis: str = "data", key=None, gather: bool = False,
                          **kwargs) -> Tensor:
    """Run ``model``'s sampler with the waveform length split over the mesh
    axis ``axis``.

    ``noise`` is the whole [B, C, T] noise, the same in every process; T
    must be divisible by the axis size times the product of the net's
    downsampling factors. Each rank samples its contiguous T / size
    positions; a ``channels=[...]`` context tensor is split along its
    length like the signal. Returns this rank's part of the sample
    [B, C, T / size] on its device, or with ``gather=True`` the whole
    sample on every rank. The sampler must be deterministic: the noise is
    the randomness."""
    check_mesh(mesh, "sample_length_sharded")
    if getattr(model.sampler, "needs_key", False):
        # Keyed samplers draw fresh noise inside the loop; there is no
        # per-request noise input to shard.
        raise NotImplementedError(
            f"{type(model.sampler).__name__} consumes RNG and takes no "
            "noise input; length-sharded sampling supports deterministic "
            "samplers (VSampler, DPMSampler)")
    assert key is None, (
        "deterministic samplers take no key; the noise IS the randomness")
    size, rank = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    noise = torch.as_tensor(noise)
    length = noise.shape[-1]
    need = size * _total_factor(model)
    if length % need:
        raise ValueError(
            f"length {length} is not divisible by {size} ranks x the "
            f"downsampling factors' product ({need // size})")
    part = length // size
    rows = slice(rank * part, (rank + 1) * part)
    channels = kwargs.get("channels")
    if channels is not None:
        # Each context [B, C', L_d] is cut like the signal at its depth.
        kwargs["channels"] = [
            None if t is None else t[..., rank * (t.shape[-1] // size):
                                     (rank + 1) * (t.shape[-1] // size)]
            for t in channels]
    local = noise[..., rows].to(mesh_device(mesh))
    with comm.length_shard(group):
        out = model.sample(local, num_steps=num_steps, **kwargs)
    if gather:
        return comm.all_gather_rows(out, group, dim=out.ndim - 1)
    return out
