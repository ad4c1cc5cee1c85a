"""Training through ``Trainer.fit`` over a ``DeviceCorpus``: the corpus is
PCM16 files synthesized from the seed into ``TMPDIR``; the trainer runs
global-norm clipping, Adam and an EMA of the parameters, one step per
``fit`` call (each ends on the trainer's own read of the loss).

Set-up builds the one trainer, drives it through its first
``check_steps`` steps on the window's own feed and keeps what the
reference compares: each step's loss, the first gradient as the
optimizer holds it (Adam's first moment over 1 − β1), and the norms of
the parameters' and the EMA's change after those steps. The window then
goes on with the same trainer and feed.

The window's own steps are checked too: at its first step boundary past
``LATE_CHECK_AT`` of its seconds it copies the state (parameters, Adam's
moments, the EMA, the loss generator's state) into buffers made at
set-up, and keeps the same readings of its next ``check_steps`` steps
but the first gradient. After the window the reference follows those
steps from the copied state: the ``late_`` numbers. (The first
gradient's worst leaf swings from 0.03 to 0.34 there while float8 reads
0.49 and up: no limit separates them, so it is not compared.)

Traffic keys: ``batch``, ``crop``, ``files``, ``file_frames``,
``sample_rate``, ``learning_rate``, ``max_grad_norm``, ``ema_decay``,
``check_steps``, ``limits``.

End-to-end: ``train_samples_per_s``, the samples of every step over the
window's wall time.
"""
from __future__ import annotations

import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd.profiler import record_function

from harness import core
from harness.trace import Ranges, Stretch
from reference.train import Crops, leaf_norms, train_reference, write_pcm16
from reference.unet import FLOAT32, FP8

# The traced stretch: these window steps.
STRETCH_FIRST, STRETCH_STEPS = 2, 2
# The share of the window's seconds after which its checked steps start.
LATE_CHECK_AT = 0.75
BETA1 = 0.9


class State:
    pass


def synth_corpus(run, root: Path) -> list:
    """``files`` stereo PCM16 files of ``file_frames`` frames: a few
    partials of random pitch under noise, from the seed."""
    t = run.traffic
    rs = run.rng(core.CORPUS)
    time_s = np.arange(t["file_frames"]) / t["sample_rate"]
    paths = []
    for i in range(t["files"]):
        audio = 0.02 * rs.standard_normal((2, t["file_frames"]))
        for f in rs.uniform(55.0, 2000.0, size=3):
            phase = rs.uniform(0, 2 * np.pi, size=(2, 1))
            audio += 0.15 * np.sin(2 * np.pi * f * time_s + phase)
        pcm = np.clip(np.round(audio * 32767), -32768, 32767).astype(np.int16)
        paths.append(root / f"take_{i:02d}.wav")
        write_pcm16(paths[-1], pcm, t["sample_rate"])
    return paths


def _fit_step(st):
    metrics = st.trainer.fit(st.feed, num_steps=1)
    return float(metrics["loss"])


class LateCheck:
    """The state before ``steps`` of the window's steps and what those
    steps do to it, kept on the device in flat float32 buffers that
    set-up makes, so the window allocates nothing for them."""

    KINDS = ("params", "mu", "nu", "ema")

    def __init__(self, state, steps: int):
        opt = state.optimizer
        self.names = list(state.params)
        params = [state.params[k] for k in self.names]

        def moment(p, key):
            # A parameter the step leaves without a moment keeps zeros.
            return opt.state[p][key] if key in opt.state.get(p, {}) \
                else torch.zeros_like(p)

        self.live = dict(
            params=params, mu=[moment(p, "exp_avg") for p in params],
            nu=[moment(p, "exp_avg_sq") for p in params],
            ema=[state.ema[k] for k in self.names])
        self.sizes = [p.numel() for p in params]
        self.shapes = [p.shape for p in params]
        total = sum(self.sizes)
        self.flat = {k: torch.empty(total, dtype=torch.float32,
                                    device=params[0].device)
                     for k in self.KINDS + ("scratch",)}
        self.bytes = sum(f.numel() * f.element_size()
                         for f in self.flat.values())
        self.state, self.steps = state, steps
        self.start = None
        self.losses, self.norms = [], {}

    @property
    def pending(self) -> bool:
        return self.start is not None and len(self.losses) < self.steps

    @torch.no_grad()
    def _gather(self, kind: str, into: str) -> torch.Tensor:
        flat = self.flat[into]
        torch.cat([t.detach().reshape(-1) for t in self.live[kind]],
                  out=flat)
        return flat

    def _leaf_norms(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.stack(torch._foreach_norm(list(flat.split(self.sizes))))

    @torch.no_grad()
    def take(self) -> None:
        """Copy the state before the next step."""
        for kind in self.KINDS:
            self._gather(kind, kind)
        self.generator = self.state.generator.get_state().clone()
        self.start = self.state.optimizer.updates()

    @torch.no_grad()
    def after_step(self, loss: float) -> None:
        if not self.pending:
            return
        self.losses.append(loss)
        if len(self.losses) == self.steps:
            for kind, name in (("params", "change"), ("ema", "ema_change")):
                d = self._gather(kind, "scratch").sub_(self.flat[kind])
                self.norms[name] = self._leaf_norms(d)

    def program(self) -> dict:
        """The program's readings, on the host."""
        out = dict(losses=list(self.losses))
        for name, norms in self.norms.items():
            out[name] = dict(zip(self.names, norms.double().cpu().tolist()))
        return out

    def start_state(self) -> dict:
        """The copied state as leaves: views of the buffers."""
        return {kind: dict(zip(self.names, (
            v.view(shape) for v, shape in zip(
                self.flat[kind].split(self.sizes), self.shapes))))
            for kind in self.KINDS}


def setup(run):
    from audio_diffusion_torch.data import DeviceCorpus
    from audio_diffusion_torch.ops.unet import ResnetModItem
    from audio_diffusion_torch.train import Trainer, TrainerConfig

    t = run.traffic
    st = State()
    st.root = Path(tempfile.mkdtemp(prefix="bench-corpus-"))
    st.files = synth_corpus(run, st.root)
    st.corpus_seed = core.subseed(run.seed, core.CORPUS) % 2**62
    st.loss_seed = core.subseed(run.seed, core.LOSS)
    corpus = DeviceCorpus(st.root, crop_frames=t["crop"],
                          batch_size=t["batch"], seed=st.corpus_seed,
                          device=run.device)
    st.feed = iter(corpus)
    weights = run.weights()
    st.model = core.build_model(run.config, weights, run.device)
    del weights
    st.trainer = Trainer(st.model, TrainerConfig(
        learning_rate=t["learning_rate"], max_grad_norm=t["max_grad_norm"],
        ema_decay=t["ema_decay"], log_every=2**62), log_fn=lambda s: None)
    st.trainer.init_state(
        torch.Generator(device=run.device).manual_seed(st.loss_seed))
    st.stretch = None
    if run.trace:
        st.items = []
        st.stretch = Stretch(Ranges(
            st.model.net.module, {ResnetModItem: "item"},
            lambda label, m, args, out: st.items.append(tuple(args[0].shape)),
            backward=True))

    # The first steps, which the reference follows.
    state = st.trainer.state
    st.losses = [_fit_step(st)]
    opt = state.optimizer
    # A parameter the step left without a moment has no gradient to read.
    st.first_grad = leaf_norms({
        k: opt.state[p]["exp_avg"] / (1.0 - BETA1) if "exp_avg" in
        opt.state.get(p, {}) else torch.zeros(()) for k, p in
        state.params.items()})
    for _ in range(t["check_steps"] - 1):
        st.losses.append(_fit_step(st))
    with torch.no_grad():
        p0 = run.weights()
        st.change = leaf_norms({k: state.params[k].detach() - p0[k]
                                for k in p0})
        st.ema_change = leaf_norms({k: state.ema[k] - p0[k] for k in p0})
        del p0
    st.late = LateCheck(state, t["check_steps"])
    run.counters["late_check_bytes"] = st.late.bytes
    return st


def window(run, st):
    t = run.traffic
    steps = 0
    stretch_s = 0.0
    late, late_at = st.late, LATE_CHECK_AT * run.seconds
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < run.seconds or steps < 1
           or late.pending or late.start is None):
        if (late.start is None and steps >= STRETCH_FIRST + STRETCH_STEPS
                and time.perf_counter() - t0 >= late_at):
            late.take()
        if st.stretch is not None and steps == STRETCH_FIRST:
            s0 = time.perf_counter()
            st.stretch.start()
            for _ in range(STRETCH_STEPS):
                with record_function("bench.train_step"):
                    _fit_step(st)
            st.stretch.stop()
            stretch_s = time.perf_counter() - s0
            steps += STRETCH_STEPS
            continue
        late.after_step(_fit_step(st))
        steps += 1
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    print(f"train: {steps} steps in {window_s:.3f} s", file=sys.stderr)
    run.attempted, run.failed = steps, 0
    run.e2e["train_samples_per_s"] = steps * t["batch"] / window_s
    run.counters.update(window_s=window_s, steps=steps,
                        item_batch=t["batch"])
    if st.stretch is not None and st.stretch.done:
        run.profile = st.stretch.trace()
        run.counters.update(stretch_s=stretch_s, stretch_steps=STRETCH_STEPS,
                            stretch_items=st.items)


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and its median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], median) for k in names}


def worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(leaf_gaps(got, want, keep).values())


def print_worst_leaves(program: dict, ref: dict, prefix: str) -> None:
    """The leaf behind each gap of norms, with the reference's norm over
    its median leaf's, to standard error."""
    for name in ("first_grad", "change", "ema_change"):
        if name not in program:
            continue
        gaps = leaf_gaps(program[name], ref[name])
        leaf = max(gaps, key=gaps.get)
        median = statistics.median(ref[name].values())
        print(f"train: {prefix}{name} worst leaf {leaf}: gap "
              f"{gaps[leaf]:.4g}, reference norm {ref[name][leaf]:.4g} "
              f"({ref[name][leaf] / median:.3g} of the median leaf's)",
              file=sys.stderr)


def readings(st, ref: dict, first_grad: dict) -> dict:
    """The numbers compared, of a run's values ``st`` against the
    reference's ``ref`` (the gradient's only where ``st`` holds it).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change: Adam moves them by rounding
    alone."""
    median = statistics.median(first_grad.values())
    moving = {k for k, v in first_grad.items() if v >= 1e-3 * median}
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(st["losses"], ref["losses"]))}
    if "first_grad" in st:
        out["grad_norm_gap"] = worst_leaf_gap(st["first_grad"], first_grad)
    out["change_gap"] = worst_leaf_gap(st["change"], ref["change"], moving)
    out["ema_change_gap"] = worst_leaf_gap(st["ema_change"],
                                           ref["ema_change"], moving)
    return out


def _batches(run, st, start: int) -> list:
    t = run.traffic
    crops = Crops(st.files, t["crop"], t["batch"], st.corpus_seed,
                  run.device)
    return [crops.batch_at(start + i) for i in range(t["check_steps"])]


def _reference(run, st, pr, batches=None):
    """The reference's first steps from the seed's weights."""
    t = run.traffic
    weights = run.weights()
    if batches is None:
        batches = _batches(run, st, 0)
    gen = torch.Generator(device=run.device).manual_seed(st.loss_seed)
    out = train_reference(weights, run.net, batches, gen, t["learning_rate"],
                          t["max_grad_norm"], t["ema_decay"], pr)
    del weights
    return out, batches


def _late_reference(run, st, pr, batches=None):
    """The reference's steps from the state the window copied."""
    t, late = run.traffic, st.late
    if batches is None:
        batches = _batches(run, st, late.start)
    gen = torch.Generator(device=run.device)
    gen.set_state(late.generator)
    s = late.start_state()
    out = train_reference(s["params"], run.net, batches, gen,
                          t["learning_rate"], t["max_grad_norm"],
                          t["ema_decay"], pr, moments=(s["mu"], s["nu"]),
                          ema=s["ema"], start=late.start)
    return out, batches


def _late(readings_: dict) -> dict:
    return {"late_" + k: v for k, v in readings_.items()}


def check(run, st, control=False):
    core.free(st.__dict__.pop("trainer"), st.__dict__.pop("model"),
              st.__dict__.pop("feed"))
    program = dict(losses=st.losses, first_grad=st.first_grad,
                   change=st.change, ema_change=st.ema_change)
    late_program = st.late.program()
    print(f"train: the window's steps {st.late.start + 1}-"
          f"{st.late.start + len(st.late.losses)} checked", file=sys.stderr)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref, batches = _reference(run, st, FLOAT32)
        got = readings(program, ref, ref["first_grad"])
        median = statistics.median(ref["first_grad"].values())
        still = sum(v < 1e-3 * median for v in ref["first_grad"].values())
        print(f"train: {still} of {len(ref['first_grad'])} leaves left out "
              "of the change (reference gradient under a thousandth of the "
              "median leaf's)", file=sys.stderr)
        late_ref, late_batches = _late_reference(run, st, FLOAT32)
        got.update(_late(readings(late_program, late_ref,
                                  late_ref["first_grad"])))
        print_worst_leaves(program, ref, "")
        print_worst_leaves(late_program, late_ref, "late ")
        for name, value in got.items():
            run.compare(name, value, run.traffic["limits"][name])
        if not control:
            return None
        out = {}
        for label, pr, cut in (("fp8", FP8, 1), ("half_batch", FLOAT32, 2)):
            low, _ = _reference(run, st, pr,
                                [b[:b.shape[0] // cut] for b in batches])
            late_low, _ = _late_reference(
                run, st, pr, [b[:b.shape[0] // cut] for b in late_batches])
            out[label] = {**readings(low, ref, ref["first_grad"]),
                          **_late(readings(late_low, late_ref,
                                           late_ref["first_grad"]))}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
        shutil.rmtree(st.root, ignore_errors=True)
        st.__dict__.pop("late", None)
