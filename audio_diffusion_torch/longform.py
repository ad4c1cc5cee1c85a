"""Long-form generation past the training window (counterpart of
audio_diffusion_tpu/longform.py): the first window samples normally, and
every following window is RePaint-outpainted (``VInpainter``) from the
previous window's tail, so content stays continuous across seams::

    audio = generate_long(model, length=2**19, window=2**18,
                          overlap=2**16, num_steps=25)   # [b, c, length]
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from .diffusion import VInpainter, noise
from .utils import default

__all__ = ["generate_long", "make_inpainter"]


def make_inpainter(model) -> VInpainter:
    """An inpainter on the model's σ schedule, so inpainted windows denoise
    on the same trajectory family as its samples."""
    return VInpainter(net=model.net,
                      schedule=getattr(model.sampler, "schedule", None))


def generate_long(model, *, length: int, window: int, overlap: int,
                  num_steps: int = 50, num_resamples: int = 2,
                  generator: Optional[torch.Generator] = None,
                  batch_size: int = 1,
                  params: Optional[Dict[str, Tensor]] = None,
                  **cond) -> Tensor:
    """``[batch_size, channels, length]`` audio from overlap-outpainted
    windows of ``window`` samples, each keeping ``overlap`` samples of the
    previous one as its known region. ``num_resamples`` is RePaint's
    harmonization knob. ``params=`` overrides the live parameters; ``cond``
    (``text=`` is encoded once) reaches the net in every window. Noise is
    drawn from ``generator`` (default: the model's): the first window's,
    then each continuation window's, in the inpainter's order."""
    if not 0 < overlap < window:
        raise ValueError(f"overlap must be in (0, window), got overlap "
                         f"{overlap}, window {window}")
    if length < window:
        raise ValueError(f"length {length} shorter than window {window}: "
                         "call model.sample")
    generator = default(generator, model.generator)
    params = default(params, model.params)
    cond = model._process_cond(dict(cond))
    c = model.net.in_channels
    stride = window - overlap
    keys = {"generator": generator} if model.sampler.needs_key else {}
    with torch.inference_mode():
        first = model.sample(
            noise.normal(generator, (batch_size, c, window), torch.float32,
                         model.device),
            num_steps=num_steps, params=params, **keys, **cond)
        chunks = [first]
        produced = window
        inpainter = make_inpainter(model)
        # The known region: the leading `overlap` samples (the previous
        # window's tail).
        mask = torch.zeros((batch_size, c, window), dtype=torch.bool,
                           device=model.device)
        mask[..., :overlap] = True
        while produced < length:
            tail = chunks[-1][..., -overlap:]
            source = torch.cat([tail, tail.new_zeros(batch_size, c, stride)],
                               dim=-1)
            out = inpainter.sample(params, generator, source=source,
                                   mask=mask, num_steps=num_steps,
                                   num_resamples=num_resamples, **cond)
            chunks.append(out[..., overlap:])
            produced += stride
        return torch.cat(chunks, dim=-1)[..., :length]
