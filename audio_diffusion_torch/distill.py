"""Progressive distillation for v-diffusion (Salimans & Ho 2022;
counterpart of audio_diffusion_tpu/distill.py).

Each stage halves the number of sampling steps: a student learns to
reproduce, in ONE deterministic v-step, what the frozen teacher produces in
TWO, so an N-step sampler becomes N/2, then N/4, ... The teacher runs two
angular DDIM steps x_t -> z_mid -> z_end along σ_t -> σ_t − 1/2N ->
σ_t − 1/N, and the student's target is the (x0, ε) pair consistent with
both endpoints::

    x0       = (b_t·z_end − b_e·x_t) / (a_e·b_t − a_t·b_e)
    ε        = (x_t − a_t·x0) / b_t
    v_target = a_t·ε − b_t·x0

The denominator is sin(π/2N) at every t, and b_t is as small at t = 1;
both amplify the teacher's rounding, so σ and α/β stay float32 and the
divisions follow the JAX order exactly.

The teacher's passes run under ``torch.no_grad()``, apart from the
student's step, which is ``make_train_step``'s with a v-space loss. Every
fresh draw (t, σ, ε) goes through ``diffusion/noise.py``. The teacher is
the model's live parameters; the student trains a clone (the train step
updates its state in place), which is copied into ``model.params`` when a
stage ends: a stage that raises partway leaves the model as it was.

Over a mesh (``mesh=``) every batch is this rank's rows of the global batch;
the teacher's targets are computed on those rows with the global batch's
draws (each rank keeps its rows, ``parallel.comm.data_shard``), the student
trains with the mesh's train step, and over a model axis the teacher is
held as the shards ``param_sharding_rules`` names and gathered for each
pass.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import Tensor

from .diffusion import noise
from .diffusion.core import alpha_beta, pad_dims
from .diffusion.vdiffusion import mse_loss
from .ops.net import cast_inference_params
from .parallel import comm, make_train_step
from .parallel.mesh import (axis_rank, axis_size, check_mesh,
                            param_sharding_rules, shard_params)
from .parallel.train_step import Slice, gather_slices
from .utils import dequant_pcm16

__all__ = ["make_distill_loss", "make_teacher_targets",
           "make_guidance_targets", "ProgressiveDistiller"]


def _two_step_target(net, teacher_params, x_t: Tensor, sig_t: Tensor,
                     num_student_steps: int, **cond) -> Tensor:
    """The teacher's double DDIM step from ``x_t`` at ``sig_t`` and the v
    implied by its endpoint."""
    half = 1.0 / (2 * num_student_steps)  # one teacher step, in σ

    def ddim(z, s_from, s_to):
        v = net.apply(teacher_params, z, s_from, **cond)
        a0, b0 = alpha_beta(pad_dims(s_from, z.ndim - 1))
        a1, b1 = alpha_beta(pad_dims(s_to, z.ndim - 1))
        x0 = a0 * z - b0 * v
        e0 = b0 * z + a0 * v
        return a1 * x0 + b1 * e0

    z_mid = ddim(x_t, sig_t, sig_t - half)
    z_end = ddim(z_mid, sig_t - half, sig_t - 2 * half)

    a_t, b_t = alpha_beta(pad_dims(sig_t, x_t.ndim - 1))
    a_e, b_e = alpha_beta(pad_dims(sig_t - 2 * half, x_t.ndim - 1))
    denom = a_e * b_t - a_t * b_e  # = sin(θ_t − θ_e) > 0
    x0 = (b_t * z_end - b_e * x_t) / denom
    eps = (x_t - a_t * x0) / b_t   # b_t >= sin(π/2N) > 0 (t >= 1)
    return a_t * eps - b_t * x0


def _noised(generator, x: Tensor, sig_t: Tensor) -> Tensor:
    """x_t = α_t·x + β_t·ε, ε drawn through ``noise.normal`` (the global
    batch's rows on a data shard)."""
    a_t, b_t = alpha_beta(pad_dims(sig_t, x.ndim - 1))
    n, rows = comm.global_rows(x.shape[0])
    eps = noise.normal(generator, (n,) + tuple(x.shape[1:]), x.dtype,
                       x.device)[rows]
    return a_t * x + b_t * eps


def _on_data_shard(mesh, fn):
    """``fn`` run on the mesh's data shard; without a mesh, on whatever
    shard the caller set (a mesh train step's, for the fused loss)."""
    check_mesh(mesh, "teacher targets")
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with comm.data_shard(axis_rank(mesh, "data"),
                             axis_size(mesh, "data")):
            return fn(*args, **kwargs)

    return run


def make_teacher_targets(net, num_student_steps: int, mesh=None):
    """``targets(teacher_params, generator, x, **cond) -> (x_t, sig_t,
    v_target)``, under ``torch.no_grad()``. An int16 batch is dequantized
    first; t ~ U{1..N} is drawn through ``noise.randint``, then ε through
    ``noise.normal``; σ_t = t / N in float32. With a ``mesh``, x holds this
    rank's rows, and each draw takes the global batch's shape and keeps
    them."""

    @torch.no_grad()
    def targets(teacher_params, generator, x: Tensor, **cond):
        x = dequant_pcm16(x)
        n, rows = comm.global_rows(x.shape[0])
        t = noise.randint(generator, 1, num_student_steps + 1, (n,),
                          x.device)[rows]
        # A tensor divisor: CUDA computes a division by a Python scalar as
        # a product with its reciprocal.
        sig_t = t.to(torch.float32) / torch.tensor(
            num_student_steps, dtype=torch.float32, device=x.device)
        x_t = _noised(generator, x, sig_t)
        # The teacher's parameters are swapped into the net once for both
        # of its passes (as a sampler's loop does).
        v_target = net.run(teacher_params, lambda module: _two_step_target(
            net, module, x_t, sig_t, num_student_steps, **cond))
        return x_t, sig_t, v_target

    return _on_data_shard(mesh, targets)


def make_guidance_targets(net, embedding_scale: float, mesh=None):
    """``targets(teacher_params, generator, x, embedding=..., **cond) ->
    (x_t, sig_t, v_target)`` for guidance distillation, under
    ``torch.no_grad()``: ``v_target`` is the teacher's classifier-free
    guided v at ``embedding_scale`` (one batch-doubled pass). σ ~ U(0, 1)
    is drawn through ``noise.uniform``, then ε: guidance distillation
    changes what the net predicts, not the step grid. ``mesh`` as in
    :func:`make_teacher_targets`."""

    @torch.no_grad()
    def targets(teacher_params, generator, x: Tensor, *, embedding: Tensor,
                **cond):
        x = dequant_pcm16(x)
        n, rows = comm.global_rows(x.shape[0])
        sig_t = noise.uniform(generator, (n,), torch.float32,
                              x.device)[rows]
        x_t = _noised(generator, x, sig_t)
        v_target = net.apply(teacher_params, x_t, sig_t,
                             embedding=embedding,
                             embedding_scale=embedding_scale, **cond)
        return x_t, sig_t, v_target

    return _on_data_shard(mesh, targets)


def make_distill_loss(net, teacher_params, num_student_steps: int,
                      loss_fn: Optional[Callable] = None):
    """The fused distillation loss with the train-step signature,
    ``loss(params, generator, x, **cond)``: the teacher targets (drawn as
    :func:`make_teacher_targets` draws them), then the student's v on the
    same x_t and σ. The frozen teacher is held by closure."""
    loss_fn = loss_fn or mse_loss
    targets = make_teacher_targets(net, num_student_steps)

    def loss(params, generator, x: Tensor, **cond) -> Tensor:
        x_t, sig_t, v_target = targets(teacher_params, generator, x, **cond)
        return loss_fn(net.apply(params, x_t, sig_t, **cond), v_target)

    return loss


class ProgressiveDistiller:
    """Halve a trained model's sampling steps, stage by stage::

        distiller = ProgressiveDistiller(model, base_steps=64)
        distiller.stage(batches, num_train_steps=10_000)   # 64 -> 32
        distiller.stage(batches, num_train_steps=10_000)   # 32 -> 16
        model.sample(noise, num_steps=distiller.steps)

    Each stage freezes the current parameters as the teacher, starts a
    fresh optimizer (``optimizer(leaves)``, default Adam at
    ``learning_rate``) and trains a student, warm-started from the teacher,
    on the teacher's targets. ``model.params`` take the student's values
    when the stage ends. ``batches`` may yield tensors, numpy arrays, int16
    PCM, or ``(x, cond)`` tuples whose cond is merged over the stage's;
    with a ``mesh``, this rank's rows of each global batch.
    """

    def __init__(self, model, base_steps: int,
                 optimizer: Optional[Callable[..., torch.optim.Optimizer]]
                 = None,
                 learning_rate: float = 1e-4, mesh=None,
                 loss_fn: Optional[Callable] = None):
        check_mesh(mesh, "ProgressiveDistiller")
        if base_steps < 2 or base_steps % 2:
            raise ValueError("base_steps must be an even number of sampler "
                             f"steps, got {base_steps}")
        self.model = model
        self.steps = base_steps
        self.mesh = mesh
        self.optimizer = optimizer or functools.partial(torch.optim.Adam,
                                                        lr=learning_rate)
        self._loss_fn = loss_fn or mse_loss

    def _on_device(self, x):
        if isinstance(x, (Tensor, np.ndarray)):
            return torch.as_tensor(x, device=self.model.device)
        return x

    def _placed_teacher(self, teacher: Dict[str, Tensor]):
        """A function returning the teacher's whole tree: over a model axis
        the teacher is held as this rank's shards (``shard_params``) and
        gathered for each call, as the JAX teacher follows
        ``param_sharding_rules``."""
        if axis_size(self.mesh, "model") == 1:
            return lambda: teacher
        held = shard_params(teacher, self.mesh)
        specs = param_sharding_rules(teacher, self.mesh)
        size, index = axis_size(self.mesh, "model"), axis_rank(self.mesh,
                                                                "model")
        group = self.mesh.get_group("model")
        names = [k for k, spec in specs.items() if spec]
        slices = [Slice(held[k], specs[k].index("model"), index, size, group)
                  for k in names]

        def whole():
            full = gather_slices([held[k] for k in names], slices)
            return {**held, **dict(zip(names, full))}

        return whole

    def _run_stage(self, targets, batches, num_train_steps: int,
                   log_fn: Callable[[str], None], log_every: int, tag: str,
                   **cond) -> Dict:
        """Train a student on ``targets``: the teacher's pass, then the
        student's step on its outputs, for each batch."""
        model = self.model
        net, loss_fn = model.net, self._loss_fn
        # The teacher, cast once to the compute dtype as a sampler does.
        teacher = self._placed_teacher(cast_inference_params(
            {k: v.detach() for k, v in model.split_params(model.params)[0]
             .items()}, net.compute_dtype))

        def student_loss(params, generator, x_t, sigmas=None, v_target=None,
                         **cond):
            del generator  # the targets drew the randomness
            v_pred = net.apply(model.split_params(params)[0], x_t, sigmas,
                               **cond)
            return loss_fn(v_pred, v_target)

        init_state, train_step = make_train_step(student_loss,
                                                 self.optimizer,
                                                 mesh=self.mesh)
        student = {k: v.detach().clone().requires_grad_(True)
                   for k, v in model.params.items()}
        state = init_state(student, model.generator)
        cond = {k: self._on_device(v) for k, v in cond.items()}
        metrics: Dict = {}
        it = iter(batches)
        for i in range(num_train_steps):
            batch = next(it)
            step_cond = cond
            if isinstance(batch, tuple):
                batch, batch_cond = batch
                step_cond = {**cond, **{k: self._on_device(v)
                                        for k, v in batch_cond.items()}}
            x_t, sig_t, v_target = targets(teacher(), model.generator,
                                           self._on_device(batch),
                                           **step_cond)
            state, metrics = train_step(state, x_t, sigmas=sig_t,
                                        v_target=v_target, **step_cond)
            if (i + 1) % log_every == 0 or i == num_train_steps - 1:
                log_fn(f"distill {tag} step {i + 1}/{num_train_steps}: "
                       f"loss={float(metrics['loss']):.5f}")
        with torch.no_grad():
            for name, p in model.params.items():
                p.copy_(student[name])
        return metrics

    def stage(self, batches, num_train_steps: int,
              log_fn: Callable[[str], None] = print, log_every: int = 100,
              **cond) -> Dict:
        """One halving: train a student at steps // 2; returns the last
        metrics (device tensors)."""
        if self.steps % 2:
            raise ValueError(f"cannot halve an odd step count ({self.steps})")
        student_steps = self.steps // 2
        metrics = self._run_stage(
            make_teacher_targets(self.model.net, student_steps, self.mesh),
            batches,
            num_train_steps, log_fn, log_every,
            tag=f"{self.steps}->{student_steps}", **cond)
        self.steps = student_steps
        return metrics

    def guidance_stage(self, batches, embedding_scale: float,
                       num_train_steps: int,
                       log_fn: Callable[[str], None] = print,
                       log_every: int = 100, **cond) -> Dict:
        """Distill classifier-free guidance at ``embedding_scale`` into one
        conditional pass (Meng et al. 2023, one student per scale); the step
        count is unchanged. Run it before the halving stages, and pass them
        the same ``embedding``. ``batches`` must carry the conditioning:
        ``(x, {"embedding": ...})`` tuples, or a fixed ``embedding=``."""
        return self._run_stage(
            make_guidance_targets(self.model.net, embedding_scale, self.mesh),
            batches,
            num_train_steps, log_fn, log_every,
            tag=f"guidance(w={embedding_scale:g})", **cond)
