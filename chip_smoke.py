#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audio_diffusion_torch) on one NVIDIA
GPU: builds the CUDA kernels from this checkout (one ``nvcc`` per source,
side by side), holds each kernel against its plain PyTorch version at the
flagship's shapes, forward and backward, runs the flagship U-Net forward
with and without the kernels, then drives the two main paths with random
weights made from a seed: a 50-step ``VSampler`` sample of 2^18-sample
stereo at batch 1 in bf16, through ``DiffusionModel.sample``; and a few
Adam steps of the same net at batch 8 (bf16 compute, float32 master
parameters), through ``DiffusionModel.loss`` and ``make_train_step``.

    python3 chip_smoke.py

Each phase prints one JSON line; any failure exits non-zero. The last
lines are the card's name and power limit as ``nvidia-smi`` gives them, the
kernels summary and ``{"ok": true, "device": {...}}``. In the summary, the
forward row's ``launches`` counts the 50-step sample's and the backward
row's the timed train steps' (42 per step), and ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` are per pass of the net at batch 1: each
level's per-item bf16 device time times that level's items per pass (42 in
all); ``host_ms`` is the host's time to enqueue the same calls.
Without a CUDA device it exits with code 1 and prints no result.

Tolerances (kernel vs plain version, same inputs): float32 with TF32 off,
max-abs ≤ 2e-4·max(1, max|y|), sums taken in another order; bfloat16
max-abs ≤ 2^-5·max|y| (four ulps of the largest output: the kernel and the
plain version round at the same points, but a sum that lands on the other
side of a rounding boundary moves conv 1's output by one ulp, and the
modulation's GroupNorm can scale that by up to about two). The full-width
forward, kernel path vs plain path in bf16, must agree to a relative L2
error ≤ 5e-2 (about a hundred chained bf16 roundings).

Backward kernels vs autograd of the plain version (same inputs, one output
gradient): each of the 13 gradients relative to its own largest value,
float32 ≤ 1e-4 (measured 3e-6), bfloat16 ≤ 2e-2 (measured 0.012: the kernels
round the gradients passed between stages once, autograd wherever the
forward casts). Timed at batch 1; held again in bf16 at the train step's
batch of 8, with the output of the forward that keeps what the backward
needs (≤ 2^-5·max|y|). At level 0 (8 channels, 8 groups) the second GroupNorm
removes conv 1's bias: its gradient is zero in exact arithmetic and
rounding noise in both, and is compared on the scale of conv 2's bias
gradient. The small net's train step, card vs CPU in float32: loss and
grad_norm rel 1e-4, every gradient within 1e-3 of its largest value plus
1e-6·grad_norm.
"""
from __future__ import annotations

import cProfile
import functools
import json
import math
import pstats
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

KERNEL_SOURCE = "audio_diffusion_torch/csrc/resnet_item.cu"
REPLACES = "audio_diffusion_tpu/ops/kernels/resnet.py:172"
BACKWARD_SOURCE = "audio_diffusion_torch/csrc/resnet_item_bwd.cu"
BACKWARD_REPLACES = "audio_diffusion_tpu/ops/kernels/resnet.py:193-219"
GRAD_NAMES = ("x", "gn1s", "gn1b", "k1", "c1b", "gn2s", "gn2b", "k2", "c2b",
              "mods", "modb", "mgs", "mgb")
TRAIN_BATCH = 8
TRAIN_STEPS = 3
# (C, L) of the flagship's nine levels at 2^18 samples, and items per level.
LEVELS = [(8, 2**18), (32, 2**16), (64, 2**14), (128, 2**12), (256, 2**11),
          (512, 2**10), (512, 2**9), (1024, 2**8), (1024, 2**7)]
ITEMS = [1, 2, 2, 2, 2, 2, 2, 4, 4]
LENGTH = 2**18
NUM_STEPS = 50
GROUPS = 8
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPS = 20
SMALL_CFG = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
                 items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
                 attention_features=8, modulation_features=64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_ms(fn) -> float:
    """Host time of one call of ``fn`` in ms: what it takes to enqueue its
    work, not to run it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def cuda_ms(fn, flush, reps: int = REPS) -> float:
    """Median device time of ``fn`` in ms, L2 flushed before each run (the
    main path reads every item's weights once per pass, cold). Each run is
    enqueued behind a spin kernel that outlasts the host's enqueue, so the
    events time the device's work and not the gaps between launches that a
    slower host leaves."""
    import torch

    for _ in range(2):
        fn()
    khz = torch.cuda.get_device_properties(0).clock_rate
    cycles = int((1.5 * host_ms(fn) + 0.5) * khz)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        torch.cuda.synchronize()
        flush.zero_()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def item_inputs(c, length, dtype, gen, batch=1):
    import torch

    def f(*shape, scale=1.0, offset=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * scale + offset
        return t.to(dtype)

    w = 1.0 / math.sqrt(3 * c)
    return [f(batch, length, c), f(c, scale=.1, offset=1.), f(c, scale=.1),
            f(3, c, c, scale=w), f(c, scale=.1), f(c, scale=.1, offset=1.),
            f(c, scale=.1), f(3, c, c, scale=w), f(c, scale=.1),
            f(batch, c, scale=.2), f(batch, c, scale=.2),
            f(c, scale=.1, offset=1.),
            f(c, scale=.1)]


def gradient_errors(got, want, channels, tol, where):
    """Each of the 13 gradients against its plain counterpart, relative to
    the plain one's largest value; raises on a miss. Returns the largest
    relative and absolute errors."""
    worst_rel, worst_abs = 0.0, 0.0
    for i, name in enumerate(GRAD_NAMES):
        scale = want[i].float().abs().max().item()
        if name == "c1b" and channels == GROUPS:
            scale = want[8].float().abs().max().item()
        err = (got[i].float() - want[i].float()).abs().max().item()
        if got[i].shape != want[i].shape or not (err <= tol * scale):
            raise AssertionError(
                f"{where}: gradient of {name}, kernel vs plain max-abs "
                f"{err} > {tol} * {scale}")
        worst_rel = max(worst_rel, err / scale)
        worst_abs = max(worst_abs, err)
    return worst_rel, worst_abs


def item_at_train_batch(level, c, length, gen):
    """The item at the shape the train step gives it (batch TRAIN_BATCH,
    bf16), forward and backward through the kernels against the plain
    version under autograd: the output that the gradient-keeping forward
    writes, and all 13 gradients. Correctness only."""
    import torch
    from audio_diffusion_torch.ops.kernels.resnet import (
        fused_resnet_item, resnet_item_reference)

    dtype = torch.bfloat16
    args = item_inputs(c, length, dtype, gen, batch=TRAIN_BATCH)
    g = item_inputs(c, length, dtype, gen, batch=TRAIN_BATCH)[0]
    results = []
    for fn in (fused_resnet_item, resnet_item_reference):
        leaves = [t.clone().requires_grad_(True) for t in args]
        out = fn(*leaves, groups=GROUPS)
        results.append((out.detach(), torch.autograd.grad(out, leaves, g)))
    torch.cuda.synchronize()
    (out, got), (ref, want) = results
    err = (out.float() - ref.float()).abs().max().item()
    bound = 2.0 ** -5 * ref.float().abs().max().item()
    if not (err <= bound):
        raise AssertionError(f"level {level} batch {TRAIN_BATCH}: forward "
                             f"with gradients kept, max-abs {err} > {bound}")
    rel, worst = gradient_errors(got, want, c, 2e-2,
                                 f"level {level} batch {TRAIN_BATCH} bfloat16")
    emit(dict(phase="kernel_backward_vs_plain",
              kernel="fused_resnet_item.backward", level=level, channels=c,
              length=length, batch=TRAIN_BATCH, dtype="bfloat16",
              forward_max_abs_err=err, forward_tolerance=bound,
              max_rel_err=rel, tolerance=2e-2, max_abs_err=worst))


def library_item(x, gn1s, gn1b, k1, c1b, gn2s, gn2b, k2, c2b, mods, modb,
                 mgs, mgb):
    """The same item as cuDNN/PyTorch calls on [B, C, L] (yardstick only;
    the port never calls this). Kernels arrive as [Cout, Cin, 3]."""
    import torch.nn.functional as F

    h = F.conv1d(F.silu(F.group_norm(x, GROUPS, gn1s, gn1b, 1e-5)), k1, c1b,
                 padding=1)
    h = F.conv1d(F.silu(F.group_norm(h, GROUPS, gn2s, gn2b, 1e-5)), k2, c2b,
                 padding=1)
    y = x + h
    return (y + F.group_norm(y, GROUPS, mgs, mgb, 1e-5) * (1 + mods[:, :, None])
            + modb[:, :, None])


def phase_kernel_vs_plain(flush):
    """Kernel vs plain version at each level's item shape, bf16 and f32."""
    import torch
    from audio_diffusion_torch.ops.kernels.resnet import (
        conv_occupancy, fused_resnet_item, resnet_item_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for level, (c, length) in enumerate(LEVELS):
            args = item_inputs(c, length, dtype, gen)
            with torch.inference_mode():
                out = fused_resnet_item(*args, groups=GROUPS)
                ref = resnet_item_reference(*args, groups=GROUPS)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ymax = ref.float().abs().max().item()
                bound = (2e-4 * max(1.0, ymax) if dtype == torch.float32
                         else 2.0 ** -5 * ymax)
                if not (err <= bound):
                    raise AssertionError(
                        f"level {level} {dname}: kernel vs plain max-abs "
                        f"{err} > {bound}")
                lib_args = list(args)
                lib_args[0] = args[0].transpose(1, 2).contiguous()
                lib_args[3] = args[3].permute(2, 1, 0).contiguous()
                lib_args[7] = args[7].permute(2, 1, 0).contiguous()
                kernel_ms = cuda_ms(
                    lambda: fused_resnet_item(*args, groups=GROUPS), flush)
                kernel_host_ms = host_ms(
                    lambda: fused_resnet_item(*args, groups=GROUPS))
                plain_ms = cuda_ms(
                    lambda: resnet_item_reference(*args, groups=GROUPS), flush)
                library_ms = cuda_ms(lambda: library_item(*lib_args), flush)
            esize = args[0].element_size()
            nbytes = (2 * length * c + 2 * 3 * c * c + 8 * c + 2 * c) * esize
            flops = 12 * c * c * length
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flops_ms = flops / PEAK_FLOPS[dname] * 1e3
            row = dict(phase="kernel_vs_plain", kernel="fused_resnet_item",
                       level=level, channels=c, length=length, batch=1,
                       conv_grid=conv_occupancy(dtype, c, length),
                       dtype=dname, max_abs_err=err, tolerance=bound,
                       max_abs_out=ymax, kernel_ms=kernel_ms,
                       kernel_host_ms=kernel_host_ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                       bytes=nbytes, flops=flops,
                       items_per_forward=2 * ITEMS[level])
            emit(row)
            rows.append(row)
    return rows


def backward_of(fn, inputs, grad_out):
    """Run ``fn`` once on fresh leaves; returns a function that runs its
    backward from ``grad_out`` to all the leaves, again and again."""
    import torch

    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, grad_out,
                                       retain_graph=True)


def phase_kernel_backward_vs_plain(flush):
    """Backward kernels vs autograd of the plain version at each level's item
    shape, bf16 and f32, batch 1: all 13 gradients, and the time of one item
    backward beside the plain version's, the library yardstick's and the
    bound. Then each level at the train step's batch in bf16, forward and
    backward, correctness only; the returned rows are the batch-1 ones."""
    import torch
    from audio_diffusion_torch.ops.kernels.resnet import (
        fused_resnet_item, resnet_item_reference)

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for level, (c, length) in enumerate(LEVELS):
            args = item_inputs(c, length, dtype, gen)
            g = item_inputs(c, length, dtype, gen)[0]

            lib_args = list(args)
            lib_args[0] = args[0].transpose(1, 2).contiguous()
            lib_args[3] = args[3].permute(2, 1, 0).contiguous()
            lib_args[7] = args[7].permute(2, 1, 0).contiguous()
            kernel_bwd = backward_of(
                functools.partial(fused_resnet_item, groups=GROUPS), args, g)
            plain_bwd = backward_of(
                functools.partial(resnet_item_reference, groups=GROUPS), args,
                g)
            library_bwd = backward_of(library_item, lib_args,
                                      g.transpose(1, 2).contiguous())
            got, want = kernel_bwd(), plain_bwd()
            torch.cuda.synchronize()
            worst_rel, worst_abs = gradient_errors(
                got, want, c, tol, f"level {level} {dname}")
            kernel_ms = cuda_ms(kernel_bwd, flush)
            kernel_host_ms = host_ms(kernel_bwd)
            plain_ms = cuda_ms(plain_bwd, flush)
            library_ms = cuda_ms(library_bwd, flush)
            # The design keeps h, y and the statistics, so no conv is run
            # again: two data gradients and two weight gradients. Bytes:
            # g, x, h, y read and dx written, the two kernels read and their
            # gradients written, the vectors and their gradients.
            esize = args[0].element_size()
            nbytes = (5 * length * c + 12 * c * c + 22 * c) * esize
            flops = 24 * c * c * length
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flops_ms = flops / PEAK_FLOPS[dname] * 1e3
            row = dict(phase="kernel_backward_vs_plain",
                       kernel="fused_resnet_item.backward", level=level,
                       channels=c, length=length, batch=1, dtype=dname,
                       max_rel_err=worst_rel, tolerance=tol,
                       max_abs_err=worst_abs, kernel_ms=kernel_ms,
                       kernel_host_ms=kernel_host_ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                       bytes=nbytes, flops=flops,
                       items_per_forward=2 * ITEMS[level])
            emit(row)
            rows.append(row)
            del kernel_bwd, plain_bwd, library_bwd, got, want
    for level, (c, length) in enumerate(LEVELS):
        item_at_train_batch(level, c, length, gen)
    return rows


def build_flagship(torch, seed: int = 0):
    from audio_diffusion_torch import DiffusionModel, UNetV0, presets

    model = DiffusionModel(net_t=UNetV0, **presets.UNCONDITIONAL_48K,
                           dtype=torch.bfloat16, seed=seed)
    fill_zero_params(model)
    return model


def phase_forward(model, noise):
    """Full-width forward, kernel path vs plain path, bf16, σ = 0.5."""
    import torch
    from audio_diffusion_torch import cast_inference_params
    from audio_diffusion_torch.ops.kernels import resnet

    params = cast_inference_params(model.params, torch.bfloat16)
    sig = torch.full((1,), 0.5, device="cuda")
    with torch.inference_mode():
        def run():
            return model.net.apply(params, noise, sig)

        out = run()
        with mock.patch.object(resnet, "fused_resnet_item",
                               resnet.resnet_item_reference):
            ref = run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        kernel_ms = (time.perf_counter() - t0) * 1e3
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("full-width forward: bad shape or non-finite")
    diff = (out.float() - ref.float())
    rel = (diff.norm() / ref.float().norm()).item()
    row = dict(phase="forward", shape=list(out.shape), dtype="bfloat16",
               max_abs_err=diff.abs().max().item(), rel_l2_err=rel,
               max_abs_out=ref.float().abs().max().item(),
               kernel_path_ms=kernel_ms, plain_path_ms=plain_ms)
    emit(row)
    if not rel <= 5e-2:
        raise AssertionError(f"full-width forward: relative error {rel}")


def phase_small_reference():
    """A small net on the card (kernel path, f32) vs the same weights on the
    CPU (plain path): the port's own reference on a small input."""
    import torch
    from audio_diffusion_torch import DiffusionModel, UNetV0

    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **SMALL_CFG)
    gpu = DiffusionModel(net_t=UNetV0, **SMALL_CFG)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    noise = torch.randn(1, 2, 256, generator=torch.Generator().manual_seed(2))
    want = cpu.sample(noise, num_steps=10)
    got = gpu.sample(noise, num_steps=10).cpu()
    err = (got - want).abs().max().item()
    emit(dict(phase="small_reference", steps=10, dtype="float32",
              max_abs_err=err, tolerance=1e-3))
    if not err < 1e-3:
        raise AssertionError(f"small reference: max-abs {err}")


def fill_zero_params(model) -> None:
    """The flax initializers zero the modulation and skip gates and every
    bias; give those small random values so each path carries signal."""
    import torch

    with torch.no_grad():
        for p in model.params.values():
            if not p.any():
                p.normal_(0.0, 0.02, generator=model.generator)


def phase_train_small():
    """One Adam step of a small net in f32 on the card (kernels, forward and
    backward) vs the same weights, batch, σ and noise on the CPU (plain
    version under autograd)."""
    import torch
    from audio_diffusion_torch import DiffusionModel, UNetV0, make_train_step
    from audio_diffusion_torch.diffusion.vdiffusion import v_loss

    gen = torch.Generator().manual_seed(6)
    x, noise = (torch.randn(2, 2, 256, generator=gen) for _ in range(2))
    sigmas = torch.tensor([0.3, 0.8])
    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **SMALL_CFG)
    fill_zero_params(cpu)
    gpu = DiffusionModel(net_t=UNetV0, **SMALL_CFG)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    out = {}
    for model in (cpu, gpu):
        dev = model.device

        def loss_fn(params, generator, batch, model=model, dev=dev):
            return v_loss(model.net, params, batch, sigmas.to(dev),
                          noise.to(dev))

        grads = torch.autograd.grad(loss_fn(model.params, None, x.to(dev)),
                                    list(model.params.values()))
        init, step = make_train_step(
            loss_fn, functools.partial(torch.optim.Adam, lr=1e-4))
        _, metrics = step(init(model.params, torch.Generator(device=dev)),
                          x.to(dev))
        out[dev.type] = ({k: v.item() for k, v in metrics.items()},
                         [g.cpu() for g in grads])
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out["cuda"]
    norm = m_cpu["grad_norm"]
    worst = max(max(0.0, (a - b).abs().max().item() - 1e-6 * norm)
                / a.abs().max().item() for a, b in zip(g_cpu, g_gpu))
    emit(dict(phase="train_small", dtype="float32", cpu=m_cpu, card=m_gpu,
              max_grad_rel_err=worst, tolerance=1e-3))
    for key in ("loss", "grad_norm"):
        if not abs(m_gpu[key] - m_cpu[key]) <= 1e-4 * abs(m_cpu[key]):
            raise AssertionError(f"train_small: {key} {m_gpu[key]} on the "
                                 f"card, {m_cpu[key]} on the CPU")
    if not worst <= 1e-3:
        raise AssertionError(f"train_small: gradient rel err {worst}")


def phase_profile(name, run, **extra):
    """Device time by kernel over one call of ``run`` (torch.profiler), the
    device's busy share of the window's host time, and the host's Python
    functions by own time over a second call (cProfile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device events only, without the annotations that span them (an
    # optimizer's step is one): those would count their kernels twice.
    kernels = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    host = sorted(((f"{Path(f).name}:{line}({fn})", v[2])
                   for (f, line, fn), v in stats.items()),
                  key=lambda kv: -kv[1])[:12]
    emit(dict(phase=name, **extra, wall_ms=wall_us / 1e3,
              device_busy_ms=busy_us / 1e3,
              device_busy_share=busy_us / wall_us,
              top_kernels_ms={k[:80]: v / 1e3 for k, v in top},
              host_own_ms={k: v * 1e3 for k, v in host}))


def phase_train(model):
    """The training main path: Adam steps of the flagship at full width and
    depth, bf16 compute over float32 master parameters, 2^18-sample stereo,
    through ``DiffusionModel.loss`` and ``make_train_step``. Returns the item
    launches (forward, backward) counted over the timed steps."""
    import torch
    from audio_diffusion_torch import make_train_step
    from audio_diffusion_torch.ops.kernels import resnet

    item = resnet.fused_resnet_item
    items_per_pass = 2 * sum(ITEMS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = torch.randn(TRAIN_BATCH, 2, LENGTH, device="cuda",
                        generator=gen).clamp_(-1.0, 1.0)
    leaves = list(model.params.values())
    # Every parameter receives a gradient (this also warms the kernels up).
    grads = torch.autograd.grad(model.loss(model.params, gen, batch), leaves,
                                allow_unused=True)
    missing = [n for n, g in zip(model.params, grads)
               if g is None or not torch.isfinite(g).all() or not g.any()]
    if missing:
        raise AssertionError(f"train: no usable gradient for {missing[:5]} "
                             f"({len(missing)} parameters)")
    del grads
    before = [p.detach().clone() for p in leaves]
    init_state, train_step = make_train_step(
        model.loss, functools.partial(torch.optim.Adam, lr=1e-4))
    state = init_state(model.params, gen)
    state, _ = train_step(state, batch)  # warm-up: Adam allocates its moments
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    item.launches = item.backward_launches = 0
    step_ms, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.item() for k, v in m.items()})
    launches = (item.launches, item.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    median = sorted(step_ms)[len(step_ms) // 2]
    still = [n for (n, p), p0 in zip(model.params.items(), before)
             if torch.equal(p.detach(), p0)]
    emit(dict(phase="train", batch=TRAIN_BATCH, length=LENGTH,
              dtype="bfloat16", optimizer="Adam(lr=1e-4)", steps=TRAIN_STEPS,
              ms_per_step=median, ms_per_step_runs=step_ms,
              samples_per_s=TRAIN_BATCH / median * 1e3,
              metrics=metrics,
              forward_item_launches=launches[0],
              backward_item_launches=launches[1],
              expected_launches=items_per_pass * TRAIN_STEPS,
              parameters=len(leaves),
              parameter_elements=sum(p.numel() for p in leaves),
              peak_memory_bytes=peak))
    if launches != (items_per_pass * TRAIN_STEPS,) * 2:
        raise AssertionError(
            f"{launches} (forward, backward) item launches in {TRAIN_STEPS} "
            f"train steps, expected {items_per_pass} each per step")
    for m in metrics:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"train: non-finite metrics {m}")
    if metrics[-1]["step"] != TRAIN_STEPS + 1:
        raise AssertionError(f"train: step counter {metrics[-1]['step']}")
    if still:
        raise AssertionError(f"train: parameters that did not move: "
                             f"{still[:5]} ({len(still)})")
    del before
    phase_profile("train_profile", lambda: train_step(state, batch), steps=1,
                  batch=TRAIN_BATCH)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # Fails outside a checkout of the repo, before any result is printed.
    from audio_diffusion_torch.ops.kernels import resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, kind=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))

    # Build both sources unless already built, one nvcc each, side by side.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for future in [pool.submit(resnet._kernel),
                       pool.submit(resnet._backward_kernel)]:
            future.result()
    emit(dict(phase="build", sources=[KERNEL_SOURCE, BACKWARD_SOURCE],
              seconds=time.perf_counter() - t0))

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = phase_kernel_vs_plain(flush)
    bwd_rows = phase_kernel_backward_vs_plain(flush)
    del flush
    phase_small_reference()
    phase_train_small()

    model = build_flagship(torch)
    noise = torch.randn(1, 2, LENGTH, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    phase_forward(model, noise)

    # Warm-up, then the main path: counts set to 0 just before, read after.
    model.sample(noise, num_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resnet.fused_resnet_item.launches = 0
    t0 = time.perf_counter()
    out = model.sample(noise, num_steps=NUM_STEPS)
    torch.cuda.synchronize()
    step_ms = [(time.perf_counter() - t0) * 1e3 / NUM_STEPS]
    launches = resnet.fused_resnet_item.launches
    # Two more timed samples: host time per step varies between runs.
    for _ in range(2):
        t0 = time.perf_counter()
        model.sample(noise, num_steps=NUM_STEPS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / NUM_STEPS)
    items_per_forward = 2 * sum(ITEMS)
    emit(dict(phase="sample", steps=NUM_STEPS, length=LENGTH, batch=1,
              dtype="bfloat16", ms_per_step=sorted(step_ms)[1],
              ms_per_step_runs=step_ms, item_launches=launches,
              expected_launches=items_per_forward * NUM_STEPS,
              peak_memory_bytes=torch.cuda.max_memory_allocated(),
              out_shape=list(out.shape),
              out_std=out.float().std().item()))
    if launches != items_per_forward * NUM_STEPS:
        raise AssertionError(f"{launches} item launches on the main path, "
                             f"expected {items_per_forward * NUM_STEPS}")
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("sample: bad shape or non-finite values")
    phase_profile("profile", lambda: model.sample(noise, num_steps=2),
                  steps=2)

    # The training main path: counts set to 0 inside, just before its steps.
    train_launches = phase_train(model)

    # Per pass of the net at batch 1: each level's per-item bf16 time times
    # its items per pass.
    def summary(name, source, replaces, level_rows, **counts):
        bf16 = [r for r in level_rows if r["dtype"] == "bfloat16"]
        per_pass = lambda key: sum(  # noqa: E731
            r[key] * r["items_per_forward"] for r in bf16)
        bytes_ms = per_pass("bytes") / HBM_BYTES_PER_S * 1e3
        flops_ms = per_pass("flops") / PEAK_FLOPS["bfloat16"] * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **counts,
                "max_abs_err": max(r["max_abs_err"] for r in bf16),
                "max_rel_err": max(r.get("max_rel_err", r["max_abs_err"]
                                         / r.get("max_abs_out", 1.0))
                                   for r in bf16),
                "ms": per_pass("kernel_ms"),
                "host_ms": per_pass("kernel_host_ms"),
                "plain_ms": per_pass("plain_ms"),
                "bound_ms": max(bytes_ms, flops_ms),
                "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                "library_ms": per_pass("library_ms")}

    print(smi)
    emit({"kernels": [
        summary("fused_resnet_item", KERNEL_SOURCE, REPLACES, rows,
                launches=launches, train_launches=train_launches[0]),
        summary("fused_resnet_item.backward", BACKWARD_SOURCE,
                BACKWARD_REPLACES, bwd_rows, launches=train_launches[1],
                launches_per_train_step=train_launches[1] // TRAIN_STEPS)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
