"""Training loop with checkpointing, metrics and profiler hooks
(counterpart of audio_diffusion_tpu/train/trainer.py).

- checkpoints of the whole train state (parameters, the optimizer's moments
  and count, the step, the generator's state, the EMA): saved
  asynchronously (copied to the host, then written by a background thread
  under a temporary name and renamed into place), resumed from the newest
  complete one;
- a metrics dict per step (loss, grad_norm), read on the host only at log
  time, with a host-side logger;
- a ``torch.profiler`` trace over a step window;
- optional NaN debugging: ``FloatingPointError`` at the first non-finite
  loss or gradient norm;
- a mesh (``parallel.create_mesh``): the data-parallel, ZeRO-1 or
  model-sharded step of ``make_train_step``, one checkpoint of the whole
  state written by rank 0 after the shards are gathered (the other ranks
  wait at a barrier), restored onto any mesh, and logs on rank 0.

The default optimizer is the JAX Trainer's ``optax.chain(
clip_by_global_norm(max_grad_norm), adamw(schedule, weight_decay))``:
:class:`ClipAdamW`, with the learning rate of update k taken from
:func:`lr_schedule` at k, as optax counts.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from ..parallel.mesh import check_mesh
from ..parallel.train_step import TrainState, gather_slices, make_train_step
from ..spans import span

__all__ = ["Trainer", "TrainerConfig", "ClipAdamW", "lr_schedule"]

CHECKPOINT_FILE = "state.pt"


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None
    # LR schedule: "constant" (with optional linear warmup) or "cosine"
    # (warmup + cosine decay to 0 over total_steps — required for cosine).
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    # EMA of params for sampling quality (None disables). The EMA is
    # checkpointed with the rest of the state; use `trainer.ema_params`.
    ema_decay: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    max_checkpoints: int = 3
    log_every: int = 50
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    debug_nans: bool = False
    # Gradient accumulation: each optimizer step runs accum_steps
    # microbatches (the batch's leading dim must be divisible by it).
    accum_steps: int = 1
    # Multi-step calls: each train-step call runs steps_per_call full
    # optimizer steps over that many stacked batches.
    steps_per_call: int = 1


def lr_schedule(cfg: TrainerConfig) -> Callable[[int], float]:
    """The learning rate of update ``k`` (counted from 0), as the JAX
    Trainer's optax schedule gives it: with warmup the first update has LR
    0; ``cosine`` is ``warmup_cosine_decay_schedule(0, lr, warmup,
    total_steps)`` (decay over total_steps − warmup, then 0); ``constant``
    with warmup is ``linear_schedule(0, lr, warmup)`` (lr after it)."""
    assert cfg.lr_schedule in ("constant", "cosine"), (
        f"unknown lr_schedule {cfg.lr_schedule!r} (constant|cosine)")
    lr, warmup = cfg.learning_rate, cfg.warmup_steps

    def warm(k: int) -> float:
        return lr * min(max(k, 0), warmup) / warmup

    if cfg.lr_schedule == "cosine":
        assert cfg.total_steps, (
            "lr_schedule='cosine' needs total_steps (the decay horizon)")
        decay = cfg.total_steps - warmup

        def cosine(k: int) -> float:
            if k < warmup:
                return warm(k)
            t = min(k - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return cosine
    if warmup:
        return warm
    return lambda k: lr


class ClipAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    weight_decay))`` as a torch optimizer, computed as optax computes it.

    - The learning rate of each update is ``schedule(k)``, k the updates
      made so far, read from the count Adam keeps on the host: a resumed
      optimizer needs no scheduler state, and setting it needs no device
      sync.
    - Clipping is optax's: ``(g / ‖g‖) · max_norm`` only where ``‖g‖ ≥
      max_norm``, with no epsilon (``clip_grad_norm_`` divides by ``‖g‖ +
      1e-6``). It scales ``p.grad`` in place, on the device.
    - Adam is optax's ``scale_by_adam``: the bias corrections ``1 − b^k``
      in float32 (``torch.optim.AdamW`` takes them in float64), and the
      decoupled weight decay is added to the update (default 0.0, optax's;
      not ``torch.optim.AdamW``'s 0.01).

    Per parameter the state holds ``exp_avg``, ``exp_avg_sq`` (beside the
    parameter) and ``step`` (a host tensor), as ``torch.optim.Adam`` names
    them.

    A sharded train step (ZeRO-1, the model axis) hands it slices of the
    parameters; it then sets ``grad_norm`` before each update, the global
    norm of the full gradients, which the clip uses in place of the norm of
    the slices.
    """

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = None,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(weight_decay=weight_decay))
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.betas = betas
        self.eps = eps
        self.grad_norm: Optional[Tensor] = None

    def updates(self) -> int:
        """Updates made so far (Adam's count, which stays on the host)."""
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state.get(p)
                if state:
                    return int(state["step"])
        return 0

    def _clip(self, grads) -> None:
        norm, self.grad_norm = self.grad_norm, None
        if norm is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        # g / 1 * 1 is g exactly; else (g / ‖g‖) · max_norm, as optax.
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one,
                                               one * self.max_grad_norm))

    @torch.no_grad()
    def step(self, closure=None):
        assert closure is None, "ClipAdamW takes no closure"
        count = self.updates() + 1
        f32 = np.float32
        lr = f32(self.schedule(count - 1))
        b1, b2 = self.betas
        # optax: 1 - b ** count in float32.
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        groups = [(g, [p for p in g["params"] if p.grad is not None])
                  for g in self.param_groups]
        if self.max_grad_norm is not None:
            self._clip([p.grad for _, ps in groups for p in ps])
        for group, params in groups:
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g² + b2 nu.
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd · p; p -= lr · u.
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, denom)
            del denom
            if group["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_mul_(upd, -float(lr))
            torch._foreach_add_(params, upd)
            for st in states:
                st["step"] += 1
        return None


def _to_host(tree):
    """A copy on the host of a nested dict of tensors: each device tensor
    copied into pinned memory without waiting, then one sync."""
    on_card = []

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if not torch.is_tensor(x):
            return x
        x = x.detach()
        if not x.is_cuda:
            return x.clone()
        on_card.append(x)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return host.copy_(x, non_blocking=True)

    out = copy(tree)
    if on_card:
        torch.cuda.synchronize()
    return out


def _load_into(live: Dict[str, Tensor], saved: Dict[str, Tensor],
               what: str) -> None:
    if set(live) != set(saved):
        raise ValueError(f"checkpoint {what}: names differ: "
                         f"{sorted(set(live) ^ set(saved))[:5]}")
    with torch.no_grad():
        for name, t in live.items():
            if tuple(saved[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint {what}: {name} has shape "
                    f"{tuple(saved[name].shape)}, the model {tuple(t.shape)}")
            t.copy_(saved[name])


class Trainer:
    """Owns the optimizer, train state, checkpointing and logging.

    Usage::

        model = DiffusionModel(...)
        trainer = Trainer(model, TrainerConfig(checkpoint_dir=...))
        trainer.fit(batch_iterator, num_steps=10_000)

    ``optimizer`` is a factory from the list of parameters to a
    ``torch.optim.Optimizer`` (as ``make_train_step`` takes it); by default
    :class:`ClipAdamW` with the config's schedule, clipping and weight
    decay. With a ``mesh`` every rank runs the same calls: ``fit`` takes
    this rank's rows of each global batch (``parallel.shard_batch``,
    ``global_batch``, ``DeviceCorpus(mesh=)``), and saving and restoring
    are collective.
    """

    def __init__(self, model, config: Optional[TrainerConfig] = None,
                 mesh=None, optimizer: Optional[Callable] = None,
                 log_fn: Callable[[str], None] = print):
        check_mesh(mesh, "Trainer")
        self.model = model
        self.config = config or TrainerConfig()
        self.mesh = mesh
        self.log_fn = log_fn
        cfg = self.config
        if optimizer is None:
            optimizer = functools.partial(
                ClipAdamW, schedule=lr_schedule(cfg),
                weight_decay=cfg.weight_decay,
                max_grad_norm=cfg.max_grad_norm)
        self.optimizer = optimizer
        self._init_state_fn, self.train_step = make_train_step(
            model.loss, optimizer, mesh=mesh, ema_decay=cfg.ema_decay,
            accum_steps=cfg.accum_steps, steps_per_call=cfg.steps_per_call)
        self._rank0 = mesh is None or dist.get_rank() == 0
        self._tail_step_cached = None  # single steps for the remainder
        self.state: Optional[TrainState] = None
        self._ckpt_dir = None
        if cfg.checkpoint_dir is not None:
            self._ckpt_dir = Path(cfg.checkpoint_dir).absolute()
            self._ckpt_dir.mkdir(parents=True, exist_ok=True)
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[Exception] = None

    # ------------------------------------------------------------ lifecycle
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """A fresh state over the model's live parameters. ``generator``
        (the loss's draws of σ and noise) defaults to one on the model's
        device seeded one past the model's seed."""
        params = self.model.params
        assert params, "the model has no parameters"
        if generator is None:
            generator = torch.Generator(device=self.model.device)
            generator.manual_seed(self.model.generator.initial_seed() + 1)
        self.state = self._init_state_fn(params, generator)
        return self.state

    # ---------------------------------------------------------- checkpoints
    def state_dict(self) -> Dict[str, Any]:
        """The train state as host tensors: ``step``, ``params``,
        ``optimizer`` (each parameter's optimizer state by name: Adam's
        ``exp_avg``, ``exp_avg_sq`` and ``step``), ``generator`` (its
        ``get_state()``) and ``ema`` (None when disabled)."""
        s = self.state
        assert s is not None, "no train state (init_state or fit first)"
        opt = s.optimizer.state
        optimizer = {n: dict(opt[s.optimizer_leaf(n)]) for n in s.params
                     if opt.get(s.optimizer_leaf(n))}
        ema = None if s.ema is None else dict(s.ema)
        # Sharded leaves: their moments (the state shaped like the slice)
        # and, over the model axis, their EMA, gathered whole.
        parts, slices, dest = [], [], []
        for name, sl in s.shards.items():
            for key, v in optimizer.get(name, {}).items():
                if torch.is_tensor(v) and v.shape == sl.master.shape:
                    parts.append(v)
                    slices.append(sl)
                    dest.append((optimizer[name], key))
            if ema is not None and s.ema_sharded:
                parts.append(ema[name])
                slices.append(sl)
                dest.append((ema, name))
        for (d, key), full in zip(dest, gather_slices(parts, slices)):
            d[key] = full
        host = _to_host({"step": s.step, "params": s.params, "ema": ema,
                         "optimizer": optimizer})
        host["step"] = int(host["step"])
        host["generator"] = s.generator.get_state()
        return host

    def load_state_dict(self, content: Dict[str, Any]) -> None:
        """Load a :meth:`state_dict` (or ``convert.train_state_from_jax``'s
        content) into the live state, strictly: every name and shape must
        match. A ``generator`` of None keeps the current one."""
        if self.state is None:
            self.init_state()
        s = self.state
        _load_into(s.params, content["params"], "params")
        opt = content["optimizer"]
        unknown = set(opt) - set(s.params)
        if unknown:
            raise ValueError(f"checkpoint optimizer: no parameter "
                             f"{sorted(unknown)[:5]}")
        s.optimizer.state.clear()
        for name, p in s.params.items():
            sl = s.shards.get(name)
            if sl is not None:
                with torch.no_grad():
                    sl.master.copy_(sl.cut(p))
            if name in opt:
                # Adam keeps its count on the host, the moments beside the
                # parameter; a sharded leaf takes its slice of them.
                def place(k, v):
                    if not torch.is_tensor(v):
                        return v
                    if k == "step":
                        return v.clone()
                    v = v.to(p.device, copy=True)
                    if sl is not None and v.shape == p.shape:
                        v = sl.cut(v)
                    return v
                s.optimizer.state[s.optimizer_leaf(name)] = {
                    k: place(k, v) for k, v in opt[name].items()}
        s.step.fill_(int(content["step"]))
        if content.get("generator") is not None:
            s.generator.set_state(content["generator"])
        if (s.ema is None) != (content.get("ema") is None):
            raise ValueError("checkpoint ema: the checkpoint and the "
                             "trainer disagree on whether EMA is on")
        if s.ema is not None:
            saved = content["ema"]
            if s.ema_sharded:
                saved = {k: (s.shards[k].cut(v) if k in s.shards else v)
                         for k, v in saved.items()}
            _load_into(s.ema, saved, "ema")

    def save_checkpoint(self, step: Optional[int] = None,
                        wait: bool = False) -> None:
        """Checkpoint the train state as ``<checkpoint_dir>/<step>/state.pt``.

        The state is copied to the host here; a background thread writes it
        under a temporary name in ``checkpoint_dir`` and renames it into
        place, then keeps the ``max_checkpoints`` newest. One save is in
        flight at a time; ``fit`` waits for the last on exit. ``wait=True``
        blocks until this save is durable. With a mesh the state is
        gathered from every rank, rank 0 writes it, and every rank returns
        once it is durable.
        """
        assert self._ckpt_dir is not None, "no checkpoint_dir configured"
        self.wait_for_save()
        content = self.state_dict()
        step = content["step"] if step is None else int(step)
        if self.mesh is not None:
            if self._rank0:
                self._write(step, content)
            dist.barrier()
            return

        def write():
            try:
                self._write(step, content)
            except Exception as e:  # surfaced by wait_for_save
                self._save_error = e

        self._save_thread = threading.Thread(target=write, daemon=True)
        self._save_thread.start()
        if wait:
            self.wait_for_save()

    def _write(self, step: int, content: Dict[str, Any]) -> None:
        root = self._ckpt_dir
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=root))
        try:
            with open(tmp / CHECKPOINT_FILE, "wb") as f:
                torch.save(content, f)
                f.flush()
                os.fsync(f.fileno())
            final = root / str(step)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp)
        for old in self.checkpoint_steps()[:-self.config.max_checkpoints]:
            shutil.rmtree(root / str(old))

    def wait_for_save(self) -> None:
        """Block until the save in flight (if any) is durable; re-raise its
        error."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError("checkpoint save failed") from err

    def checkpoint_steps(self) -> list:
        """Steps of the complete checkpoints, oldest first: directories
        named by digits alone that hold the whole file (a temporary entry
        or a directory without its file is a torn save and is ignored)."""
        if self._ckpt_dir is None or not self._ckpt_dir.exists():
            return []
        return sorted(int(p.name) for p in self._ckpt_dir.iterdir()
                      if p.name.isdigit() and (p / CHECKPOINT_FILE).is_file())

    def restore_latest(self) -> Optional[int]:
        """Restore the newest complete checkpoint; returns its step or
        None."""
        assert self._ckpt_dir is not None, "no checkpoint_dir configured"
        self.wait_for_save()  # flush any in-flight save
        steps = self.checkpoint_steps()
        if not steps:
            return None
        content = torch.load(self._ckpt_dir / str(steps[-1]) /
                             CHECKPOINT_FILE, map_location="cpu",
                             weights_only=True)
        self.load_state_dict(content)
        return steps[-1]

    @property
    def ema_params(self) -> Dict[str, Tensor]:
        """EMA parameters (the live parameters when EMA is disabled), whole:
        over the model axis the shards are gathered (a collective)."""
        s = self.state
        assert s is not None
        if s.ema is None:
            return s.params
        if not s.ema_sharded:
            return s.ema
        names = list(s.shards)
        full = gather_slices([s.ema[k] for k in names],
                             [s.shards[k] for k in names])
        return {**s.ema, **dict(zip(names, full))}

    # ----------------------------------------------------------------- fit
    def _tail_step(self, state, batch, **cond):
        """Single steps for the num_steps % steps_per_call tail."""
        if self._tail_step_cached is None:
            _, self._tail_step_cached = make_train_step(
                self.model.loss, self.optimizer, mesh=self.mesh,
                ema_decay=self.config.ema_decay,
                accum_steps=self.config.accum_steps)
        return self._tail_step_cached(state, batch, **cond)

    def _on_device(self, x):
        """A batch or conditioning array on the model's device: numpy
        through pinned memory without waiting; tensors moved if needed."""
        device = self.model.device
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if device.type == "cuda":
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)
        if isinstance(x, Tensor) and x.device != device:
            return x.to(device, non_blocking=True)
        return x

    def _next_batch(self, it, kk: int, k: int, cond: Dict):
        """The next call's batch on the device (``kk`` batches stacked
        when ``kk > 1``) and its conditioning."""
        if kk == 1 and k > 1:
            batch = next(it)
        elif k > 1:
            items = [next(it) for _ in range(kk)]
            if isinstance(items[0], tuple):
                raise ValueError(
                    "per-batch conditioning ((x, cond) batches) "
                    "requires steps_per_call=1 — the K-step call "
                    "passes one cond to every step")
            if isinstance(items[0], Tensor):
                # Device batches (data.DeviceCorpus): stack on the
                # device, not through the host.
                batch = torch.stack(items)
            else:
                batch = np.stack(items)
        else:
            batch = next(it)

        # Per-batch conditioning: iterators may yield
        # (x, {"embedding": ...}) tuples, merged over **cond.
        step_cond = cond
        if isinstance(batch, tuple):
            batch, batch_cond = batch
            step_cond = {**cond, **{n: self._on_device(v) for n, v
                                    in batch_cond.items()}}
        return self._on_device(batch), step_cond

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def fit(self, batches: Iterable, num_steps: int, **cond) -> Dict:
        """Run ``num_steps`` steps over ``batches``; returns the last
        metrics (device tensors)."""
        if self.state is None:
            self.init_state()
        cfg = self.config
        cond = {k: self._on_device(v) for k, v in cond.items()}
        metrics: Dict = {}
        t_last = time.perf_counter()
        it = iter(batches)
        # Host-side step counter: reading the device's state.step would
        # force a sync every iteration.
        step = int(self.state.step)
        step_last_log = step
        profiler, profile_from = None, None
        k = max(cfg.steps_per_call, 1)
        # Whole chunks of k steps, then the remainder as single steps.
        num_calls = num_steps // k
        tail = num_steps - num_calls * k
        try:
            for i in range(num_calls + tail):
                kk = k if i < num_calls else 1
                with span("train.data"):
                    batch, step_cond = self._next_batch(it, kk, k, cond)

                if (cfg.profile_dir is not None
                        and step == cfg.profile_start_step):
                    profiler, profile_from = self._profiler(), step
                    profiler.start()
                if kk == 1 and k > 1:
                    self.state, metrics = self._tail_step(
                        self.state, batch, **step_cond)
                else:
                    self.state, metrics = self.train_step(
                        self.state, batch, **step_cond)
                if cfg.debug_nans:
                    bad = ~(torch.isfinite(metrics["loss"])
                            & torch.isfinite(metrics["grad_norm"]))
                    if bool(bad.any()):
                        first = step + 1 + int(bad.reshape(-1).nonzero()[0])
                        raise FloatingPointError(
                            f"non-finite loss or gradient norm at step "
                            f"{first}")
                if kk > 1:
                    # Stacked [K] metrics: keep the last step's values.
                    metrics = {n: m[-1] for n, m in metrics.items()}
                step += kk
                if (profiler is not None and step >= cfg.profile_start_step
                        + cfg.profile_num_steps):
                    self._stop_profiler(profiler, profile_from, step)
                    profiler = None

                if self._rank0 and (step % cfg.log_every < kk
                                    or i == num_calls + tail - 1):
                    with span("train.wait"):
                        loss = float(metrics["loss"])
                        gnorm = float(metrics["grad_norm"])
                    now = time.perf_counter()
                    sps = (step - step_last_log) / max(now - t_last, 1e-9)
                    t_last, step_last_log = now, step
                    self.log_fn(
                        f"step {step}: loss={loss:.4f} "
                        f"grad_norm={gnorm:.3f} steps/s={sps:.2f}")

                if (self._ckpt_dir is not None
                        and step % cfg.checkpoint_every < kk):
                    self.save_checkpoint(step)
        finally:
            if profiler is not None:  # fit ended inside the profile window
                self._stop_profiler(profiler, profile_from, step)
            if self._ckpt_dir is not None:  # make async saves durable
                self.wait_for_save()
        return metrics

    def _stop_profiler(self, profiler, first: int, end: int) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        profiler.stop()
        out = Path(self.config.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(
            str(out / f"trace_steps_{first}_{end}.json"))
