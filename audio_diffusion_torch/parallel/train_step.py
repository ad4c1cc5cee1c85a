"""The training step: loss, gradients and optimizer update, on one device or
over a mesh (counterpart of audio_diffusion_tpu/parallel/train_step.py).

The JAX step is one jitted program over a donated state; here it is eager
PyTorch that updates the state in place (the counterpart of the donation)
and returns its metrics as device tensors, without waiting for the device.

Over a ``("data", "model")`` mesh (``parallel/mesh.py``) one process runs
per rank:

- **data**: each rank takes its rows of the global batch (``shard_batch``),
  draws the global batch's σ and noise and keeps its rows
  (``comm.data_shard``), and computes its rows' loss and gradients; the
  gradients and the loss are summed over the data group in rank order and
  scaled by 1/data, so ``loss``, ``grad_norm`` and ``step`` are the same on
  every rank and the update is the one-device update of the global batch,
  up to the order of the sums.
- **ZeRO-1** (``zero1=True``, data > 1, model = 1): each rank keeps Adam's
  moments only for its slice of each leaf, along the leaf's first axis
  divisible by data (a leaf with none keeps them whole), updates that slice
  of the parameters and all-gathers them.
- **model** (> 1): each leaf that ``param_sharding_rules`` shards keeps its
  master slice, its moments and its EMA as this rank's shard of the output-
  feature axis; after each update the shards are all-gathered into the
  working parameters that the forward reads, and the reduced gradient is
  cut back to the shard before the update. The compute is not partitioned:
  every rank of a model group runs the whole net on the same rows, so the
  math is the one-device math and each rank holds 1/model of the wide
  leaves' optimizer state. The JAX package leaves the partition of the
  compute to XLA, which is no contract of it.

The sharded optimizer runs over slice leaves. An optimizer that reads
across its leaves must take that value from the step: :class:`ClipAdamW`
clips by the step's global norm of the full, reduced gradients
(``grad_norm``), as optax's chain does on the global array.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import Tensor

from ..utils import dequant_pcm16
from . import comm
from .mesh import axis_rank, axis_size, check_mesh, param_sharding_rules

__all__ = ["TrainState", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class Slice:
    """This rank's part of a parameter leaf: ``index`` of ``size`` equal
    parts along ``axis``, gathered over ``group``. ``master`` is the part
    the optimizer updates."""
    master: Tensor
    axis: int
    index: int
    size: int
    group: Any

    def cut(self, full: Tensor) -> Tensor:
        w = full.shape[self.axis] // self.size
        return full.narrow(self.axis, self.index * w, w).contiguous()


@dataclasses.dataclass
class TrainState:
    step: Tensor                      # int32 scalar on the parameters' device
    params: Dict[str, Tensor]         # leaf tensors, updated in place
    optimizer: torch.optim.Optimizer  # holds the moments
    generator: torch.Generator        # the loss draws σ and noise from it
    # Exponential moving average of params; None when disabled. Over the
    # model axis, a sharded leaf's EMA is this rank's shard.
    ema: Optional[Dict[str, Tensor]] = None
    # ZeRO-1 and the model axis: the sharded leaves' slices, by name.
    shards: Dict[str, Slice] = dataclasses.field(default_factory=dict)
    # The model axis: whether a shard's EMA is a shard too.
    ema_sharded: bool = False

    def optimizer_leaf(self, name: str) -> Tensor:
        """The tensor the optimizer updates for parameter ``name``."""
        sl = self.shards.get(name)
        return sl.master if sl is not None else self.params[name]


def gather_slices(parts: List[Tensor], slices: List[Slice]) -> List[Tensor]:
    """The whole leaves of ``parts`` (each ``slices[i]``'s part of a leaf),
    through one all-gather per group and dtype."""
    out: List[Optional[Tensor]] = [None] * len(parts)
    keys: Dict[Any, List[int]] = {}
    for i, (p, sl) in enumerate(zip(parts, slices)):
        keys.setdefault((id(sl.group), p.dtype), []).append(i)
    for idx in keys.values():
        group = slices[idx[0]].group
        flat = torch.cat([parts[i].reshape(-1) for i in idx])
        every = comm.all_gather_rows(flat[None], group)
        off = 0
        for i in idx:
            sl, n = slices[i], parts[i].numel()
            piece = every[:, off:off + n].reshape(
                (sl.size,) + tuple(parts[i].shape))
            out[i] = torch.cat(piece.unbind(0), sl.axis)
            off += n
    return out


def _split_leading(t: Tensor, parts: int) -> Tensor:
    if t.shape[0] % parts:
        raise ValueError(f"batch {t.shape[0]} not divisible by "
                         f"accum_steps={parts}")
    return t.reshape((parts, t.shape[0] // parts) + t.shape[1:])


def _zero1_axis(shape, data_size: int) -> Optional[int]:
    """The first axis divisible by ``data_size`` (and at least that long),
    as ``_zero1_spec`` picks it; None: the leaf is not sliced."""
    for ax, n in enumerate(shape):
        if n % data_size == 0 and n >= data_size:
            return ax
    return None


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

    ``mesh`` (a ``DeviceMesh`` from ``create_mesh``): the batch and every
    tensor among the conditioning kwargs are this rank's rows of the global
    batch (``shard_batch``, ``global_batch``, ``DeviceCorpus(mesh=)``), and
    the parameters are the same on every rank (made from one seed). See the
    module docstring for what each axis does. ``zero1`` is a no-op without
    a mesh, on data = 1 and with a model axis, as in the JAX package.

    ``accum_steps > 1`` splits the batch's leading axis (and that of every
    tensor among the conditioning kwargs) into microbatches run one after
    the other; their float32 gradients are summed and scaled by
    1/accum_steps, and one optimizer step follows. The loss is the mean of
    the microbatches' losses. Over a mesh, microbatch i is the global
    microbatch i split over data, as the JAX scan over the global batch
    runs it: the step all-gathers the global batch over the data group and
    each rank takes its rows of each microbatch.

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
    check_mesh(mesh, "make_train_step")
    data_size = axis_size(mesh, "data")
    model_size = axis_size(mesh, "model")
    data_rank = axis_rank(mesh, "data")
    data_group = mesh.get_group("data") if mesh is not None else None
    use_zero1 = zero1 and data_size > 1 and model_size == 1

    def slices_of(params: Dict[str, Tensor]) -> Dict[str, Slice]:
        out = {}
        if model_size > 1:
            group, index = mesh.get_group("model"), axis_rank(mesh, "model")
            for name, spec in param_sharding_rules(params, mesh).items():
                if spec:
                    out[name] = (spec.index("model"), index, model_size,
                                 group)
        elif use_zero1:
            for name, p in params.items():
                ax = _zero1_axis(p.shape, data_size)
                if ax is not None:
                    out[name] = (ax, data_rank, data_size, data_group)
        shards = {}
        for name, (ax, index, size, group) in out.items():
            p = params[name].detach()
            w = p.shape[ax] // size
            shards[name] = Slice(p.narrow(ax, index * w, w).clone(), ax,
                                 index, size, group)
        return shards

    def init_state(params: Dict[str, Tensor],
                   generator: torch.Generator) -> TrainState:
        shards = slices_of(params)
        leaves = [shards[k].master if k in shards else v
                  for k, v in params.items()]
        ema = None
        if ema_decay is not None:
            ema = {k: (shards[k].master.clone() if k in shards
                       and model_size > 1 else v.detach().clone())
                   for k, v in params.items()}
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            params=params, optimizer=optimizer_t(leaves),
            generator=generator, ema=ema, shards=shards,
            ema_sharded=model_size > 1)

    def value_and_grad(state: TrainState, batch, cond):
        leaves = list(state.params.values())
        with comm.data_shard(data_rank, data_size):
            loss = loss_fn(state.params, state.generator, batch, **cond)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]

    def microbatches(batch, cond):
        """Each microbatch's (batch, cond) of this rank."""
        if data_size > 1:
            # Global microbatch i, split over data.
            batch = comm.all_gather_rows(batch, data_group)
            cond = {k: comm.all_gather_rows(v, data_group)
                    if isinstance(v, Tensor) else v for k, v in cond.items()}
        mb_batch = _split_leading(batch, accum_steps)
        mb_cond = {k: _split_leading(v, accum_steps)
                   if isinstance(v, Tensor) else v for k, v in cond.items()}
        for i in range(accum_steps):
            b = mb_batch[i]
            c = {k: v[i] if isinstance(v, Tensor) else v
                 for k, v in mb_cond.items()}
            if data_size > 1:
                n = b.shape[0] // data_size
                if b.shape[0] % data_size:
                    raise ValueError(
                        f"a global microbatch of {b.shape[0]} rows does not "
                        f"split over data={data_size} ranks")
                rows = slice(data_rank * n, (data_rank + 1) * n)
                b = b[rows]
                c = {k: v[rows] if isinstance(v, Tensor) else v
                     for k, v in c.items()}
            yield b, c

    def grad_fn(state: TrainState, batch, cond):
        """(loss, grads) of this rank's rows, microbatched when
        accum_steps > 1."""
        if accum_steps == 1:
            return value_and_grad(state, batch, cond)
        loss_sum, grads_sum = None, None
        for mb, cond_i in microbatches(batch, cond):
            loss, grads = value_and_grad(state, mb, cond_i)
            grads = [g.float() for g in grads]
            if grads_sum is None:
                loss_sum, grads_sum = loss.float(), grads
            else:
                loss_sum = loss_sum + loss
                torch._foreach_add_(grads_sum, grads)
        inv = 1.0 / accum_steps
        torch._foreach_mul_(grads_sum, inv)
        return loss_sum * inv, grads_sum

    def data_mean(loss: Tensor, grads: List[Tensor]):
        """The loss and gradients summed over the data group in rank order
        and scaled by 1/data: one all-gather of every gradient."""
        if data_size == 1:
            return loss, grads
        flat = torch.cat([loss.float().reshape(1)]
                         + [g.float().reshape(-1) for g in grads])
        flat = comm.all_reduce_sum(flat, data_group) * (1.0 / data_size)
        out, off = [], 1
        for g in grads:
            out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
            off += g.numel()
        return flat[0].to(loss.dtype), out

    def single_step(state: TrainState, batch, cond):
        batch = dequant_pcm16(batch)
        loss, grads = data_mean(*grad_fn(state, batch, cond))
        # Before the update: an optimizer may clip the gradients in place.
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        names = list(state.params)
        for name, g in zip(names, grads):
            sl = state.shards.get(name)
            leaf = state.optimizer_leaf(name)
            leaf.grad = (sl.cut(g) if sl is not None else g).to(leaf.dtype)
        if state.shards and hasattr(state.optimizer, "grad_norm"):
            state.optimizer.grad_norm = grad_norm
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if state.shards:
            with torch.no_grad():
                sharded = list(state.shards)
                full = gather_slices([state.shards[k].master for k in sharded],
                                     [state.shards[k] for k in sharded])
                for name, t in zip(sharded, full):
                    state.params[name].copy_(t)
        if state.ema is not None:
            with torch.no_grad():
                ema = [state.ema[k] for k in names]
                src = [(state.shards[k].master if state.ema_sharded
                        and k in state.shards else state.params[k]).detach()
                       for k in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, src, alpha=1.0 - ema_decay)
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
