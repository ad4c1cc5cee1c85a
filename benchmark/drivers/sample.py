"""Closed-loop sampling: one client draws whole samples one after another
through ``DiffusionModel.sample`` (the deterministic v-sampler), each from
fresh noise made from the seed and, where the traffic asks for guidance,
with its own caption-like embedding; a sample ends with its audio copied
to the host.

Traffic keys: ``batch``, ``channels``, ``length``, ``num_steps``,
``check_samples`` (how many finished samples the reference recomputes),
``limits``; for guidance ``embedding_scale`` and ``embedding_rows`` (the
range of leading nonzero rows of each [max_length, features] embedding).

End-to-end: ``sample_ms_per_step``, the window's wall time over every
sampler step of the samples it finished.
"""
from __future__ import annotations

import sys
import time

import torch

from harness import core
from harness.trace import Ranges, Stretch
from reference.unet import FLOAT32, FP8, denoise

# The traced stretch: these steps of the window's second sample.
STRETCH_SAMPLE, STRETCH_FIRST, STRETCH_STEPS = 1, 10, 5


class State:
    pass


def _inputs(run, index: int, stream: int = core.INPUTS):
    """Noise [batch, channels, length] and the embedding (or None) of the
    window's sample ``index``, from the seed."""
    t = run.traffic
    gen = torch.Generator(device=run.device).manual_seed(
        core.subseed(run.seed, stream, index))
    noise = torch.randn((t["batch"], t["channels"], t["length"]),
                        generator=gen, dtype=torch.float32, device=run.device)
    if "embedding_scale" not in t:
        return noise, None
    net = run.net
    shape = (t["batch"], net["embedding_max_length"],
             net["embedding_features"])
    emb = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=run.device) * 0.2
    lo, hi = t["embedding_rows"]
    rows = torch.randint(lo, hi + 1, (t["batch"], 1, 1), generator=gen,
                         device=run.device)
    keep = torch.arange(shape[1], device=run.device)[None, :, None] < rows
    return noise, emb * keep


def _kwargs(run, emb):
    if emb is None:
        return {}
    return dict(embedding=emb, embedding_scale=run.traffic["embedding_scale"])


def setup(run):
    from audio_diffusion_torch.ops.attention import (AttentionItem,
                                                     CrossAttentionItem)
    from audio_diffusion_torch.ops.unet import ResnetModItem

    st = State()
    weights = run.weights()
    st.model = core.build_model(run.config, weights, run.device)
    del weights
    st.stretch = None
    if run.trace:
        st.items = []

        def seen(label, module, args, out):
            if label == "item":
                st.items.append(tuple(args[0].shape))

        st.stretch = Stretch(Ranges(
            st.model.net.module, {AttentionItem: "attention",
                                  CrossAttentionItem: "attention",
                                  ResnetModItem: "item"}, seen))
    noise, emb = _inputs(run, 0, core.WARMUP)
    st.model.sample(noise, num_steps=1, **_kwargs(run, emb)).cpu()
    return st


def _arm(run, st):
    """Start and stop the stretch from the net's own calls: call k of the
    window is step k % num_steps of sample k // num_steps."""
    steps = run.traffic["num_steps"]
    first = STRETCH_SAMPLE * steps + STRETCH_FIRST
    calls = [0]

    def hook(module, args):
        if calls[0] == first:
            st.stretch.start()
        elif calls[0] == first + STRETCH_STEPS:
            st.stretch.stop()
        calls[0] += 1

    return st.model.net.module.register_forward_pre_hook(hook)


def window(run, st):
    t = run.traffic
    handle = _arm(run, st) if st.stretch is not None else None
    st.outputs, ends = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds or len(st.outputs) < 1:
        noise, emb = _inputs(run, len(st.outputs))
        out = st.model.sample(noise, num_steps=t["num_steps"],
                              **_kwargs(run, emb))
        st.outputs.append(out.cpu())
        ends.append(time.perf_counter())
    window_s = ends[-1] - t0
    each = sorted(b - a for a, b in zip([t0] + ends, ends))
    print(f"sample: {len(each)} samples in {window_s:.3f} s; seconds per "
          f"sample min {each[0]:.4f}, median {each[len(each) // 2]:.4f}, "
          f"max {each[-1]:.4f}", file=sys.stderr)
    if handle is not None:
        handle.remove()
    n = len(st.outputs)
    steps = n * t["num_steps"]
    run.attempted, run.failed = n, 0
    run.e2e["sample_ms_per_step"] = window_s * 1e3 / steps
    run.counters.update(window_s=window_s, steps=steps,
                        item_batch=t["batch"] * (2 if "embedding_scale" in t
                                                 else 1))
    if st.stretch is not None and st.stretch.done:
        run.profile = st.stretch.trace()
        run.counters["stretch_s"] = st.stretch.cost_s
        run.counters["stretch_steps"] = STRETCH_STEPS
        run.counters["stretch_items"] = st.items


def _checked(run, st):
    """The finished samples the reference recomputes, drawn from the seed."""
    n = len(st.outputs)
    k = min(run.traffic["check_samples"], n)
    return sorted(run.rng(core.CHECK).choice(n, size=k, replace=False))


def _reference(run, weights, picks, pr):
    t = run.traffic
    noise, emb = zip(*(_inputs(run, int(i)) for i in picks))
    emb = None if emb[0] is None else torch.cat(emb)
    return denoise(weights, run.net, torch.cat(noise), t["num_steps"],
                   emb, t.get("embedding_scale", 1.0), pr)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def check(run, st, control=False):
    picks = _checked(run, st)
    outputs = [st.outputs[i] for i in picks]
    core.free(st.__dict__.pop("model"))
    weights = run.weights()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = _reference(run, weights, picks, FLOAT32).cpu()
            rows = ref.shape[0] // len(picks)
            worst = max(rel_l2(out, ref[i * rows:(i + 1) * rows])
                        for i, out in enumerate(outputs))
            run.compare("sample_rel_l2", worst,
                        run.traffic["limits"]["sample_rel_l2"])
            if not control:
                return None
            low = _reference(run, weights, picks, FP8).cpu()
            return {"sample_rel_l2": max(
                rel_l2(low[i * rows:(i + 1) * rows],
                       ref[i * rows:(i + 1) * rows])
                for i in range(len(picks)))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
