"""DiffusionModel: the composition root, net + diffusion + sampler
(counterpart of audio_diffusion_tpu/models/model.py).

Flat kwargs are routed by prefix (``diffusion_*`` -> diffusion, ``sampler_*``
-> sampler, the rest -> net), then ``loss = model(audio)`` and
``model.sample(noise, num_steps=...)``. The module lives on ``device``
(``None`` means the CUDA card; without one the constructor raises unless
``device="cpu"`` is passed) and is initialized from ``seed`` at construction.
``model.loss(params, generator, x)`` is the loss as a function of a
parameter dict, for ``parallel.make_train_step`` and custom loops.
``text=[...]`` is encoded on the host once per ``model(...)`` or
``model.sample(...)`` call into ``embedding=`` by the net's text encoder;
``loss`` takes a pre-encoded ``embedding=``.

A task model may own trainable modules beside the net (the autoencoder's
encoder, the vocoder's ``to_flat``): ``extras`` maps a prefix to each, and
their parameters ride in ``params`` as ``"<prefix>/<state_dict name>"``.
No net parameter name holds a "/", so the two never collide;
:meth:`DiffusionModel.split_params` parts them again.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from ..diffusion.samplers import VSampler
from ..diffusion.vdiffusion import VDiffusion, mse_loss
from ..ops.layers import init_module
from ..utils import default, dequant_pcm16, groupby, resolve_device

__all__ = ["DiffusionModel", "EncoderBase", "AdapterBase"]


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
        self.extras: Dict[str, nn.Module] = {}

    def _add_extra(self, prefix: str, module: nn.Module) -> nn.Module:
        """Own ``module`` as trainable extra ``prefix``: moved to the model's
        device and initialized from the model's generator."""
        module = module.to(self.device)
        init_module(module, self.generator)
        self.extras[prefix] = module
        return module

    def split_params(self, params: Dict[str, Tensor]
                     ) -> Tuple[Dict[str, Tensor], Dict[str, Dict[str, Tensor]]]:
        """(the net's parameters, each extra's by prefix, keyed like its
        ``state_dict``) from a dict keyed like :attr:`params`."""
        net = {k: v for k, v in params.items() if "/" not in k}
        extras: Dict[str, Dict[str, Tensor]] = {p: {} for p in self.extras}
        for name, t in params.items():
            if "/" in name:
                prefix, key = name.split("/", 1)
                if prefix not in extras:
                    raise ValueError(f"parameter {name!r}: this model has no "
                                     f"module {prefix!r}")
                extras[prefix][key] = t
        return net, extras

    def _extra_state(self, state_dict_of) -> Dict[str, Tensor]:
        return {f"{prefix}/{k}": v for prefix, m in self.extras.items()
                for k, v in state_dict_of(m).items()}

    def _process_cond(self, kwargs: Dict) -> Dict:
        """``text=`` -> ``embedding=`` (on the model's device), through the
        net's text encoder."""
        if "text" in kwargs:
            text = kwargs.pop("text")
            encoder = self.net.text_encoder
            if encoder is None:
                raise ValueError(
                    "text= requires a net built with use_text_conditioning="
                    "True and a text_encoder (or pass embedding= directly)")
            if "embedding" in kwargs:
                raise ValueError("pass either text= or embedding=, not both")
            embedding = torch.as_tensor(encoder(list(text)),
                                        device=self.device)
            # float32, as the JAX package's jnp.asarray with x64 off (an
            # encoder's numpy float32 output times an integer mask is
            # float64).
            if embedding.dtype == torch.float64:
                embedding = embedding.float()
            kwargs["embedding"] = embedding
        return kwargs

    @property
    def params(self) -> Dict[str, Tensor]:
        """The live parameters, keyed like ``self.net.module.state_dict()``,
        and each extra module's as ``"<prefix>/<name>"``."""
        return {**self.net.params(),
                **self._extra_state(lambda m: dict(m.named_parameters()))}

    def _example(self, x: Tensor) -> Tensor:
        """An example data batch as the net takes it (a task model may
        fold or adapt it)."""
        return x

    def initialize(self, x=None, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Tensor]:
        """Draw fresh parameters with the JAX package's initializers
        (lecun-normal kernels, zero-init modulation and skip gates,
        normal(16) ``freqs``), the extra modules' too. ``x`` is an
        optional example batch [B, C, T] of the data, checked by the
        diffusion method against the net's input layout."""
        generator = default(generator, self.generator)
        self.diffusion.init_net_params(
            generator, None if x is None else self._example(torch.as_tensor(x)))
        for module in self.extras.values():
            init_module(module, generator)
        return self.params

    def save(self, path) -> None:
        """Save the parameters as one ``state_dict`` (``torch.save``): the
        net's, and each extra module's under its prefix."""
        torch.save({**self.net.module.state_dict(),
                    **self._extra_state(lambda m: m.state_dict())}, path)

    def load(self, path) -> Dict[str, Tensor]:
        """Restore parameters saved by :meth:`save` into the live modules
        (strict: every name and shape must match)."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        net, extras = self.split_params(state)
        self.net.module.load_state_dict(net, strict=True)
        for prefix, module in self.extras.items():
            module.load_state_dict(extras[prefix], strict=True)
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
                         **self._process_cond(kwargs))

    def sample(self, *args, generator: Optional[torch.Generator] = None,
               params: Optional[Dict[str, Tensor]] = None,
               **kwargs) -> Tensor:
        """Draw samples: ``model.sample(x_noisy, num_steps=...)``, or, for a
        sampler that makes its own start (``ARVSampler``),
        ``model.sample(num_items=..., ...)``. Positional arrays are moved to
        the model's device. A sampler that draws noise (``needs_key``) takes
        ``generator`` (default: the model's) after the parameters; a
        deterministic one raises if given one. ``params=`` overrides the
        live parameters for this call only, as a dict keyed like
        ``self.net.module.state_dict()``."""
        if generator is not None and not getattr(self.sampler, "needs_key",
                                                 False):
            raise ValueError(f"{type(self.sampler).__name__} is "
                             "deterministic and takes no generator")
        return self._sample(default(params, self.params),
                            default(generator, self.generator), *args,
                            **kwargs)

    def _sample(self, params: Dict[str, Tensor], generator: torch.Generator,
                *args, **kwargs) -> Tensor:
        """The sampler on the net's part of ``params``, in inference mode,
        with ``generator`` ahead of ``args`` where it draws noise."""
        lead = ((generator,) if getattr(self.sampler, "needs_key", False)
                else ())
        with torch.inference_mode():
            args = tuple(torch.as_tensor(a, device=self.device)
                         if isinstance(a, (Tensor, np.ndarray)) else a
                         for a in args)
            return self.sampler.sample(self.split_params(params)[0], *lead,
                                       *args, **self._process_cond(kwargs))


class EncoderBase(nn.Module, ABC):
    """An encoder for :class:`DiffusionAE`: ``forward(x, with_info=False)``
    maps audio [B, C, T] to a latent [B, out_channels, T /
    downsample_factor] (with ``with_info``, a pair (latent, info dict)).
    Its parameters train jointly with the net."""

    out_channels: int
    downsample_factor: int

    @abstractmethod
    def forward(self, x: Tensor, with_info: bool = False):
        ...


class AdapterBase(ABC):
    """A fixed transform pair applied around the diffusion space of a
    :class:`DiffusionAE`: the net learns ``encode(x)`` and a decoded sample
    goes through ``decode``. It has no trainable parameters."""

    @abstractmethod
    def encode(self, x: Tensor) -> Tensor:
        ...

    @abstractmethod
    def decode(self, x: Tensor) -> Tensor:
        ...
