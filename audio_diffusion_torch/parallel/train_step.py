"""The one-device training step: loss, gradients and optimizer update
(counterpart of audio_diffusion_tpu/parallel/train_step.py).

The JAX step is one jitted program over a donated state; here it is eager
PyTorch that updates the state in place (the counterpart of the donation)
and returns its metrics as device tensors, without waiting for the device.
The multi-device parts (mesh, ZeRO-1) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import Tensor

from ..utils import dequant_pcm16

__all__ = ["TrainState", "make_train_step"]


@dataclass
class TrainState:
    step: Tensor                      # int32 scalar on the parameters' device
    params: Dict[str, Tensor]         # leaf tensors, updated in place
    optimizer: torch.optim.Optimizer  # over params.values(); holds the moments
    generator: torch.Generator        # the loss draws σ and noise from it
    # Exponential moving average of params; None when disabled.
    ema: Optional[Dict[str, Tensor]] = None


def _split_leading(t: Tensor, parts: int) -> Tensor:
    if t.shape[0] % parts:
        raise ValueError(f"batch {t.shape[0]} not divisible by "
                         f"accum_steps={parts}")
    return t.reshape((parts, t.shape[0] // parts) + t.shape[1:])


def make_train_step(
    loss_fn: Callable[..., Tensor],
    optimizer_t: Callable[..., torch.optim.Optimizer],
    mesh: Any = None,
    ema_decay: Optional[float] = None,
    accum_steps: int = 1,
    zero1: bool = False,
    steps_per_call: int = 1,
) -> Tuple[Callable, Callable]:
    """Build (init_state, train_step).

    ``loss_fn(params, generator, batch, **cond) -> scalar``, for example
    ``DiffusionModel.loss``. ``optimizer_t`` makes the optimizer from the list
    of parameters, for example ``functools.partial(torch.optim.Adam,
    lr=1e-4)``.

    ``accum_steps > 1`` splits the batch's leading axis (and that of every
    tensor among the conditioning kwargs) into microbatches run one after
    the other; their float32 gradients are summed and scaled by
    1/accum_steps, and one optimizer step follows. The loss is the mean of
    the microbatches' losses.

    ``steps_per_call > 1`` takes K stacked batches [K, batch, ...] and runs K
    full steps; the conditioning is shared by all K, and each metric comes
    back stacked [K].

    Returns:
      init_state(params, generator) -> TrainState. ``params`` are leaf
        tensors that require gradients (``model.params``).
      train_step(state, batch, **cond) -> (state, metrics): ``state`` is
        updated in place and returned; ``metrics`` holds ``loss``,
        ``grad_norm`` (the global L2 norm of the gradients) and ``step`` as
        device tensors.
    """
    if mesh is not None or zero1:
        raise NotImplementedError(
            "make_train_step mesh=/zero1= (multi-GPU) is not ported yet "
            "(ROADMAP Queue 1, item 4)")

    def init_state(params: Dict[str, Tensor],
                   generator: torch.Generator) -> TrainState:
        leaves = list(params.values())
        ema = None
        if ema_decay is not None:
            ema = {k: v.detach().clone() for k, v in params.items()}
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            params=params, optimizer=optimizer_t(leaves),
            generator=generator, ema=ema)

    def value_and_grad(state: TrainState, batch, cond):
        leaves = list(state.params.values())
        loss = loss_fn(state.params, state.generator, batch, **cond)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]

    def grad_fn(state: TrainState, batch, cond):
        """(loss, grads), microbatched when accum_steps > 1."""
        if accum_steps == 1:
            return value_and_grad(state, batch, cond)
        mb_batch = _split_leading(batch, accum_steps)
        mb_cond = {k: _split_leading(v, accum_steps)
                   if isinstance(v, Tensor) else v for k, v in cond.items()}
        loss_sum, grads_sum = None, None
        for i in range(accum_steps):
            cond_i = {k: v[i] if isinstance(v, Tensor) else v
                      for k, v in mb_cond.items()}
            loss, grads = value_and_grad(state, mb_batch[i], cond_i)
            grads = [g.float() for g in grads]
            if grads_sum is None:
                loss_sum, grads_sum = loss.float(), grads
            else:
                loss_sum = loss_sum + loss
                torch._foreach_add_(grads_sum, grads)
        inv = 1.0 / accum_steps
        torch._foreach_mul_(grads_sum, inv)
        return loss_sum * inv, grads_sum

    def single_step(state: TrainState, batch, cond):
        batch = dequant_pcm16(batch)
        loss, grads = grad_fn(state, batch, cond)
        # Before the update: an optimizer may clip the gradients in place.
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        leaves = list(state.params.values())
        for p, g in zip(leaves, grads):
            p.grad = g.to(p.dtype)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if state.ema is not None:
            with torch.no_grad():
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [p.detach() for p in leaves],
                                    alpha=1.0 - ema_decay)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "step": state.step.clone()}

    def train_step(state: TrainState, batch, **cond):
        if steps_per_call == 1:
            return state, single_step(state, batch, cond)
        if batch.shape[0] != steps_per_call:
            raise ValueError(
                f"steps_per_call={steps_per_call} takes {steps_per_call} "
                f"stacked batches, got a leading axis of {batch.shape[0]}")
        metrics = [single_step(state, b, cond) for b in batch]
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    return init_state, train_step
