"""The Net bundle: the contract between the diffusion engine and the network
(counterpart of audio_diffusion_tpu/ops/net.py)::

    net.apply(params_or_module, x, sigmas=None, **cond) -> Tensor

``params_or_module`` is either an ``nn.Module`` (called as it is) or a dict
of parameter tensors keyed like ``net.module.state_dict()``, which is applied
with ``torch.func.functional_call`` without touching the module's own
parameters. ``cond`` may hold ``generator=``, the random stream of
stochastic conditioning (CFG's embedding dropout), which the loss passes as
the JAX loss passes a key.
"""
from __future__ import annotations

import copy
import itertools
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import Tensor, nn
from torch.func import functional_call

from .layers import init_module

__all__ = ["Net", "cast_inference_params"]

# Parameters that stay float32 under a bf16 compute dtype: SigmaEmbedding's
# fourier `freqs` feed large angles to sin/cos. Every other float32
# parameter is cast, CFG's `fixed_embedding` included.
_KEEP_F32 = ("freqs",)


def cast_inference_params(params: Dict[str, Tensor], dtype) -> Dict[str, Tensor]:
    """Cast float32 parameters to the compute dtype once, before a sampling
    loop; ``freqs`` stay float32, and quantized leaves (``ops/quant.py``'s
    ``QTensor``) pass through: the samplers dequantize them to the compute
    dtype inside each step, and casting their scales here would add a bf16
    rounding to the int8 error. No-op when dtype is None or float32."""
    if dtype is None or dtype == torch.float32:
        return params
    return {name: (t.to(dtype) if isinstance(t, Tensor)
                   and t.dtype == torch.float32
                   and name.rsplit(".", 1)[-1] not in _KEEP_F32 else t)
            for name, t in params.items()}


_SHELLS: "weakref.WeakKeyDictionary[nn.Module, Dict[int, nn.Module]]" = (
    weakref.WeakKeyDictionary())
_SHELLS_LOCK = threading.Lock()


def thread_module(module: nn.Module) -> nn.Module:
    """``module`` on the main thread; on any other thread a copy of its
    structure made for that thread, whose parameters and buffers are meta
    tensors: ``functional_call`` fills them for the length of a call, so the
    copy holds no memory and the module itself is never swapped."""
    if threading.current_thread() is threading.main_thread():
        return module
    with _SHELLS_LOCK:
        shells = _SHELLS.setdefault(module, {})
        shell = shells.get(threading.get_ident())
        if shell is None:
            memo = {id(t): nn.Parameter(t.detach().to("meta"),
                                        requires_grad=t.requires_grad)
                    for t in itertools.chain(module.parameters(),
                                             module.buffers())}
            shell = shells[threading.get_ident()] = copy.deepcopy(module,
                                                                  memo)
    return shell


class _Run(nn.Module):
    """Calls ``fn(module)`` as its forward, so ``functional_call`` can hold
    a parameter dict in place around any code that uses the module."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, fn: Callable[[nn.Module], Any]) -> Any:
        return fn(self.module)


class Net:
    """An ``nn.Module`` + the standardized (x, sigmas, **cond) call."""

    def __init__(self, module: nn.Module, in_channels: int, out_channels: int,
                 uses_sigma: bool = True, compute_dtype: Any = None):
        self.module = module
        self.in_channels = in_channels
        self.out_channels = out_channels
        # The net's compute dtype; samplers pre-cast f32 params to it.
        self.compute_dtype = compute_dtype
        self.uses_sigma = uses_sigma
        # Host-side text encoder, set by UNetV0 with use_text_conditioning;
        # the model layer turns text= into embedding= with it.
        self.text_encoder = None

    def params(self) -> Dict[str, Tensor]:
        """The module's live parameters, by state_dict name."""
        return dict(self.module.named_parameters())

    def init(self, generator: torch.Generator) -> Dict[str, Tensor]:
        """(Re)initialize every parameter in place with the JAX package's
        initializers, drawing from ``generator``; returns the parameters."""
        init_module(self.module, generator)
        return self.params()

    def apply(self, params_or_module: Union[nn.Module, Dict[str, Tensor]],
              x: Tensor, sigmas: Optional[Tensor] = None, **cond) -> Tensor:
        return self.run(params_or_module,
                        lambda module: module(x, sigmas, **cond))

    def run(self, params_or_module: Union[nn.Module, Dict[str, Tensor]],
            fn: Callable[[nn.Module], Any]) -> Any:
        """``fn(module)`` with ``params_or_module``'s parameters in place for
        the whole call: a sampling loop swaps a parameter dict in once, not
        once per step (the swap walks every parameter of the net)."""
        if isinstance(params_or_module, nn.Module):
            return fn(params_or_module)
        params = {"module." + k: v for k, v in params_or_module.items()}
        return functional_call(_Run(thread_module(self.module)), params,
                               (fn,), strict=True)

    def __call__(self, params, x: Tensor, sigmas: Optional[Tensor] = None,
                 **cond) -> Tensor:
        return self.apply(params, x, sigmas, **cond)
