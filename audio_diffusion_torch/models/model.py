"""DiffusionModel: the composition root, net + diffusion + sampler
(counterpart of audio_diffusion_tpu/models/model.py).

Flat kwargs are routed by prefix (``diffusion_*`` -> diffusion, ``sampler_*``
-> sampler, the rest -> net), then ``loss = model(audio)`` and
``model.sample(noise, num_steps=...)``. The module lives on ``device``
(``None`` means the CUDA card; without one the constructor raises unless
``device="cpu"`` is passed) and is initialized from ``seed`` at construction.
``model.loss(params, generator, x)`` is the loss as a function of a
parameter dict, for ``parallel.make_train_step`` and custom loops.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import Tensor

from ..diffusion.samplers import VSampler
from ..diffusion.vdiffusion import VDiffusion, mse_loss
from ..utils import default, dequant_pcm16, groupby, resolve_device

__all__ = ["DiffusionModel"]


class DiffusionModel:
    def __init__(self, net_t: Callable, diffusion_t: Callable = VDiffusion,
                 sampler_t: Callable = VSampler, loss_fn: Callable = mse_loss,
                 dim: int = 1, seed: int = 0, device=None, **kwargs):
        diffusion_kwargs, kwargs = groupby("diffusion_", kwargs)
        sampler_kwargs, kwargs = groupby("sampler_", kwargs)
        self.device = resolve_device(device)
        self.net = net_t(dim=dim, device=self.device, **kwargs)
        self.diffusion = diffusion_t(net=self.net, loss_fn=loss_fn,
                                     **diffusion_kwargs)
        self.sampler = sampler_t(net=self.net, **sampler_kwargs)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.net.init(self.generator)

    @property
    def params(self) -> Dict[str, Tensor]:
        """The live parameters, keyed like ``self.net.module.state_dict()``."""
        return self.net.params()

    def initialize(self, x=None, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Tensor]:
        """Draw fresh parameters with the JAX package's initializers
        (lecun-normal kernels, zero-init modulation and skip gates,
        normal(16) ``freqs``). ``x`` is an optional example batch
        [B, in_channels, T], checked against the net."""
        channels = None if x is None else torch.as_tensor(x).shape[1]
        if channels is not None and channels != self.net.in_channels:
            raise ValueError(f"example batch has {channels} channels, the "
                             f"net takes {self.net.in_channels}")
        return self.net.init(default(generator, self.generator))

    def save(self, path) -> None:
        """Save the parameters as a ``state_dict`` (``torch.save``)."""
        torch.save(self.net.module.state_dict(), path)

    def load(self, path) -> Dict[str, Tensor]:
        """Restore parameters saved by :meth:`save` into the live module
        (strict: every name and shape must match)."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.net.module.load_state_dict(state, strict=True)
        return self.params

    def loss(self, params: Dict[str, Tensor], generator: torch.Generator,
             x: Tensor, **kwargs) -> Tensor:
        """The training loss as a function of a parameter dict (keyed like
        ``self.net.module.state_dict()``): differentiate it with
        ``torch.autograd.grad``. σ and the noise are drawn from
        ``generator``. An int16 (PCM16) batch is dequantized x / 32768 on
        the device, bit-exact against the float32 decode."""
        return self.diffusion.loss(params, generator, dequant_pcm16(x),
                                   **kwargs)

    def __call__(self, x, generator: Optional[torch.Generator] = None,
                 **kwargs) -> Tensor:
        """Training loss of a batch [B, C, T] (moved to the model's device)
        on the live parameters; ``loss.backward()`` fills their ``.grad``."""
        x = torch.as_tensor(x, device=self.device)
        return self.loss(self.params, default(generator, self.generator), x,
                         **kwargs)

    def sample(self, x_noisy, *args, params: Optional[Dict[str, Tensor]] = None,
               **kwargs) -> Tensor:
        """Draw samples from ``x_noisy`` [B, C, T] (moved to the model's
        device). ``params=`` overrides the live parameters for this call
        only, as a dict keyed like ``self.net.module.state_dict()``."""
        with torch.inference_mode():
            x_noisy = torch.as_tensor(x_noisy, device=self.device)
            return self.sampler.sample(default(params, self.params), x_noisy,
                                       *args, **kwargs)
