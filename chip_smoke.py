#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audio_diffusion_torch) on one NVIDIA
GPU: builds the CUDA kernels from this checkout (one ``nvcc`` per source,
side by side), holds each kernel against its plain PyTorch version at the
flagship's shapes, forward and backward, runs the flagship U-Net forward
with and without the kernels, then drives the two main paths with random
weights made from a seed: a 50-step ``VSampler`` sample of 2^18-sample
stereo at batch 1 in bf16, through ``DiffusionModel.sample``; and a few
Adam steps of the same net at batch 8 (bf16 compute, float32 master
parameters), through ``DiffusionModel.loss`` and ``make_train_step``. Then
the text-conditional net (``presets.TEXT_CONDITIONAL_48K`` with the stub
text encoder: cross-attention at levels 3-8, classifier-free guidance): a
guided 50-step sample of one caption (``text=``, guidance 5, the item at
batch 2), the same with encoder reuse (k = 2), the cross-attention's device
time from a short profile, and Adam steps at batch 8 with ``embedding=``
from eight captions and embedding dropout 0.1. Before the flagship, a
small conditioned net (cross-attention, context injection, CFG) is held on
the card against the CPU, guided, with and without encoder reuse. Then the
other samplers on the flagship (a 25-step ``DPMSampler`` sample, a 50-step
``SDESampler(eta=0.3)`` sample and ``eta=0`` against the VSampler sample
bit for bit, ``generate_long`` of 2^19 samples in 2^18 windows with 2^16
of overlap: one sample and two RePaint windows, their seams bit-exact),
the T5 encoder stack (``RandomT5TextEncoder``) on the card against the
CPU and a guided 25-step DPM sample through it, and the README's
autoregressive model (``DiffusionAR``, one channel of 2^16 samples in 4
splits, the 9-level widths): ``ar.sample(num_items=1, num_chunks=16,
num_steps=64)`` and Adam steps at batch 8. Its items run the kernels'
no-modulation branch, held against the plain version at its nine level
shapes (L = 2^16 ... 2^5; bf16 and f32 forward, bf16 backward at batch 1
and 8, 9 gradients), and the other samplers and a small AR model are held
on the card against the CPU with host-made noise fed through the replaced
``diffusion.noise.normal``. Last, the task models at full width, each
freed before the next is built: ``DiffusionUpsampler(upsample_factor=16,
**presets.UPSAMPLER_16X)`` (``upsampler.sample`` of [1, 2, 2^14] to 2^18
samples, 50 steps, and Adam steps at batch 8), ``DiffusionVocoder(
**presets.VOCODER_48K)`` (``vocoder.sample`` of the stereo mel [1, 2, 80,
1024] that its ``to_spectrogram`` makes of 2^18 samples, the items at
batch 2; Adam steps at batch 8, the net at batch 16; its ``to_flat``
against cuDNN's transposed conv, default and deterministic) and
``DiffusionAE(
inject_depth=6, encoder=MelEncoder1d(...), **presets.AUTOENCODER_48K)``
with the JAX CLI's encoder (``ae.encode`` to a [1, 32, 512] latent
through 12 no-modulation items at C = 512, L = 1,024; ``ae.decode``, 50
steps; Adam steps at batch 8 that train the encoder too). Before them the
kernels are held against the plain version at those new shapes (the
encoder's item, forward at batch 1, backward at 1 and 8; the modulated
item at the nine levels at batch 16, forward and backward), and the DSP
front end and small task models on the card against the CPU. Then the
training path as a user drives it: a small net trained with the
``Trainer`` (warmup, cosine decay, clipping, EMA) on the card against the
CPU; the ``Trainer`` on the flagship at batch 8 over a corpus of 8 stereo
PCM16 files of 2^19 frames synthesized from a seed and held in a
``DeviceCorpus`` (crop 2^18), with a checkpoint at step 2 that a fresh
model and trainer resume from — the resumed run must give the straight
run's bits — and its ms per step with the corpus on the card and with the
host ``AudioDataset``; activation checkpointing (``use_remat``, full and
with ``"dots_with_no_batch_dims_saveable"``) bit-equal to the net without
it; and ``python -m audio_diffusion_torch`` ``train`` (2 steps, the corpus
on the card), ``sample`` (50 steps) and ``info --params`` as subprocesses.

    python3 chip_smoke.py

Each phase prints one JSON line; any failure exits non-zero. The last
lines are the card's name and power limit as ``nvidia-smi`` gives them, the
kernels summary and ``{"ok": true, "device": {...}}``. In the summary, the
forward row's ``launches`` counts the 50-step sample's and the backward
row's the timed train steps' (42 per step); ``guided_launches`` (2,100),
``reuse_launches`` (1,575 = 25 full passes of 42 + 25 decoder passes of 21)
and ``text_train_launches`` count the text-conditional paths', and the
``guided_batch_*`` keys are the per-pass sums at batch 2. ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` are per pass of the net at batch 1: each
level's per-item bf16 device time times that level's items per pass (42 in
all); ``host_ms`` is the host's time to enqueue the same calls. The
backward row's ``train_batch_ms``, ``train_batch_bound_ms`` and
``train_batch_library_ms`` are the same sums at the train step's batch of
8, and ``conv_sources`` names the headers of its two convolutions. The
``nomod_*`` keys are the per-pass sums of the no-modulation rows at the AR
levels (``nomod_train_batch_*`` at batch 8), and ``dpm_launches`` (1,050),
``sde_launches`` (2,100), ``longform_launches`` (5,250),
``t5_guided_dpm_launches`` (1,050 at batch 2), ``ar_sample_launches``
(13,440 = 42 x 320 passes) and ``ar_train_launches`` count those paths';
``upsampler_launches`` and ``vocoder_launches`` (2,100 each),
``ae_encode_launches`` (12), ``ae_decode_launches`` (2,100) and the
``*_train_launches`` of the three task models (42 per step; 54 for the
autoencoder) the task paths'. The ``encoder_nomod_*`` keys are the
encoder's per-pass sums (12 items at C = 512, L = 1,024; the backward's
``encoder_nomod_train_batch_*`` at batch 8) and the ``batch16_*`` keys
the flagship levels' per-pass sums at batch 16. ``trainer_launches``
counts the Trainer's 3 straight flagship steps (42 per step each way), and
``remat_launches`` the launches per step with ``use_remat`` (84 forward:
the forward kernel runs again in the backward's recompute; 42 backward).
``serve_launches`` counts the service's 3 batches of the 19 requests
(6,300 = 42 x 50 x 3), ``quant_launches`` the int8 sample's and
``artifact_launches`` the exported sampler's (2,100 each); the
``batch8_*`` keys are the per-pass sums at batch 8.
Without a CUDA device it exits with code 1 and prints no result.
The kernel-vs-plain rows run at batch 1 (bf16 and f32) and, in bf16, at the
guided pass's batch of 2 and the served batch of 8, with the same bars.
Serving's bars: quantized leaves on the card bit-equal to the CPU's and a
4-step quantized sample within 1e-3 of the CPU's (f32); the service's rows,
the artifact's sample and a seed in two batches bit for bit; the int8
sample's relative RMS error against bf16 under 0.5 (a sanity bar: its
value is reported).

Tolerances (kernel vs plain version, same inputs): float32 with TF32 off,
max-abs ≤ 2e-4·max(1, max|y|), sums taken in another order; bfloat16
max-abs ≤ 2^-5·max|y| (four ulps of the largest output: the kernel and the
plain version round at the same points, but a sum that lands on the other
side of a rounding boundary moves conv 1's output by one ulp, and the
modulation's GroupNorm can scale that by up to about two); a second bf16
call on the same inputs must give the same bits (split-K sums its partials
in a fixed order). The full-width
forward, kernel path vs plain path in bf16, must agree to a relative L2
error ≤ 5e-2 (about a hundred chained bf16 roundings).

Backward kernels vs autograd of the plain version (same inputs, one output
gradient): each of the 13 gradients relative to its own largest value,
float32 ≤ 1e-4 (measured 3e-6), bfloat16 ≤ 2e-2 (measured 0.012: the kernels
round the gradients passed between stages once, autograd wherever the
forward casts). Timed at batch 1; held again in bf16 at the train step's
batch of 8, with the output of the forward that keeps what the backward
needs (≤ 2^-5·max|y|), and timed there too. A second bf16 backward on
the same graph must give the same bits, at batch 1 and 8 (the weight
gradient's slabs and the data gradient's split-K partials are summed in a
fixed order). At level 0 (8 channels, 8 groups) the second GroupNorm
removes conv 1's bias: its gradient is zero in exact arithmetic and
rounding noise in both, and is compared on the scale of conv 2's bias
gradient. The small net's train step, card vs CPU in float32: loss and
grad_norm rel 1e-4, every gradient within 1e-3 of its largest value plus
1e-6·grad_norm.
"""
from __future__ import annotations

import cProfile
import functools
import gc
import json
import math
import pstats
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

KERNEL_SOURCE = "audio_diffusion_torch/csrc/resnet_item.cu"
CONV_SOURCE = "audio_diffusion_torch/csrc/conv3_sm90.cuh"
REPLACES = "audio_diffusion_tpu/ops/kernels/resnet.py:172"
BACKWARD_SOURCE = "audio_diffusion_torch/csrc/resnet_item_bwd.cu"
WGRAD_SOURCE = "audio_diffusion_torch/csrc/wgrad_sm90.cuh"
BACKWARD_REPLACES = "audio_diffusion_tpu/ops/kernels/resnet.py:193-219"
GRAD_NAMES = ("x", "gn1s", "gn1b", "k1", "c1b", "gn2s", "gn2b", "k2", "c2b",
              "mods", "modb", "mgs", "mgb")
TRAIN_BATCH = 8
TRAIN_STEPS = 3
# The serving service's device batch (GenerationService's default).
SERVE_BATCH = 8
# The guided pass runs [cond; fixed] as one batch of 2 for a batch-1 sample.
GUIDED_BATCH = 2
GUIDANCE = 5.0
CAPTIONS = ["a dog barking in the rain", "rain on a tin roof",
            "a crowd cheering in a stadium", "slow piano chords",
            "birdsong at dawn", "an old car engine starting",
            "waves breaking on a beach", "a church bell ringing"]
# (C, L) of the flagship's nine levels at 2^18 samples, and items per level.
LEVELS = [(8, 2**18), (32, 2**16), (64, 2**14), (128, 2**12), (256, 2**11),
          (512, 2**10), (512, 2**9), (1024, 2**8), (1024, 2**7)]
ITEMS = [1, 2, 2, 2, 2, 2, 2, 4, 4]
LENGTH = 2**18
NUM_STEPS = 50
# The README's autoregressive model: one channel of 2^16 samples in 4
# splits, the 9-level widths, so its levels run at L = 2^16 ... 2^5, and the
# items take the kernels' no-modulation branch.
AR_LENGTH, AR_SPLITS, AR_CHUNKS, AR_STEPS = 2**16, 4, 16, 64
AR_LEVELS = [(c, AR_LENGTH // (LENGTH // length)) for c, length in LEVELS]
# The fast sampler's steps, and long-form generation's geometry.
DPM_STEPS = 25
SDE_ETA = 0.3
LONG = dict(length=2**19, window=2**18, overlap=2**16, num_steps=DPM_STEPS,
            num_resamples=2)
T5_CAPTIONS = ["a dog barking in the rain", "",
               "a long caption of more than sixty-four bytes: rain, thunder "
               "and a distant train", "pluie fine sur le toit, très douce"]
# The task models: the x16 upsampler (2^14 -> 2^18 samples), the mel
# vocoder (80 mels, hop 256, so 1,024 frames of 2^18 samples; a train step
# on 8 stereo clips runs the net at batch 16) and the autoencoder with the
# JAX CLI's encoder defaults (12 items at C = 512 over the 1,024 mel frames,
# a x2 patch down to a [32, 512] latent, injected at depth 6).
UPSAMPLE_FACTOR = 16
TASK_BATCH = 2 * TRAIN_BATCH
ENCODER = dict(in_channels=2, channels=512, factors=[2], num_blocks=[12],
               out_channels=32, mel_channels=80)
ENCODER_LEVEL = (512, 1024)
ENCODER_ITEMS = 12
INJECT_DEPTH = 6
SMALL_TASK = dict(channels=[8, 32, 64], factors=[1, 4, 2], items=[1, 1, 1],
                  modulation_features=64)
SMALL_VOCODER = dict(mel_channels=16, mel_n_fft=128, mel_sample_rate=16000,
                     mel_normalize_log=True)
SMALL_ENCODER = dict(in_channels=2, channels=32, out_channels=4, factors=[2],
                     num_blocks=[1], mel_channels=16, mel_n_fft=64,
                     mel_sample_rate=16000)
SMALL_AE = dict(in_channels=2, inject_depth=2, channels=[8, 16, 32],
                factors=[1, 4, 8], items=[1, 1, 1], modulation_features=32)
SMALL_LT = dict(num_filters=4, window_length=8, stride=4)
GROUPS = 8
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPS = 20
FIXED_EMBEDDING = "inner.fixed_embedding"
SMALL_CFG = dict(in_channels=2, channels=[8, 32, 64], factors=[1, 4, 2],
                 items=[1, 2, 1], attentions=[0, 0, 1], attention_heads=4,
                 attention_features=8, modulation_features=64)
SMALL_COND = dict(cross_attentions=[0, 0, 1], context_channels=[0, 0, 5],
                  use_embedding_cfg=True, embedding_max_length=8,
                  embedding_features=32)
SMALL_AR = dict(channels=[8, 32, 64], factors=[1, 4, 2], items=[1, 2, 1],
                attentions=[0, 0, 1], attention_heads=4, attention_features=8)


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
    """Each of the 13 gradients (9 without modulation) against its plain
    counterpart, relative to the plain one's largest value; raises on a
    miss. Returns the largest relative and absolute errors."""
    worst_rel, worst_abs = 0.0, 0.0
    for i, name in enumerate(GRAD_NAMES[:len(want)]):
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


def backward_bound(c, length, batch, dname, use_modulation=True):
    """(bound_ms, bound_by, bytes, flops) of one item backward. The design
    keeps h, y and the statistics, so no conv is run again: two data
    gradients and two weight gradients. Bytes: g, x, h, y read and dx
    written, the two kernels read and their gradients written, the vectors
    and their gradients. Without modulation y is not read, and the
    modulation's vectors and gradients are not there."""
    esize = 2 if dname == "bfloat16" else 4
    nbytes = ((5 * batch * length * c + 12 * c * c + 22 * c) if use_modulation
              else (4 * batch * length * c + 12 * c * c + 10 * c)) * esize
    flops = 24 * c * c * length * batch
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[dname] * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes, flops)


def item_at_train_batch(level, c, length, gen, flush, use_modulation=True,
                        phase="kernel_backward_vs_plain", batch=TRAIN_BATCH,
                        items_per_forward=None, time_plain=False):
    """The item at the shape a train step gives it (``batch``, TRAIN_BATCH
    unless given; bf16), forward and backward through the kernels against
    the plain version under autograd: the output that the gradient-keeping
    forward writes, all 13 gradients (9 without modulation), a
    bit-identical second backward, the plans of the backward's two
    convolutions, and the backward's device time beside its bound and the
    library yardstick's (and the plain version's, with ``time_plain``)."""
    import torch
    from audio_diffusion_torch.ops.kernels.resnet import (
        backward_occupancy, fused_resnet_item, resnet_item_reference)

    dtype = torch.bfloat16
    n_args = 13 if use_modulation else 9
    args = item_inputs(c, length, dtype, gen, batch=batch)[:n_args]
    g = item_inputs(c, length, dtype, gen, batch=batch)[0]
    results = []
    for fn in (fused_resnet_item, resnet_item_reference):
        leaves = [t.clone().requires_grad_(True) for t in args]
        out = fn(*leaves, groups=GROUPS, use_modulation=use_modulation)
        backward = (lambda out=out, leaves=leaves: torch.autograd.grad(
            out, leaves, g, retain_graph=True))
        results.append((out.detach(), backward(), backward))
    kernel_bwd, plain_bwd = results[0][2], results[1][2]
    again = kernel_bwd()
    torch.cuda.synchronize()
    (out, got, _), (ref, want, _) = results
    err = (out.float() - ref.float()).abs().max().item()
    bound = 2.0 ** -5 * ref.float().abs().max().item()
    if not (err <= bound):
        raise AssertionError(f"level {level} batch {batch}: forward "
                             f"with gradients kept, max-abs {err} > {bound}")
    rel, worst = gradient_errors(got, want, c, 2e-2,
                                 f"level {level} batch {batch} bfloat16")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"level {level} batch {batch}: two bf16 "
                             "backwards on the same graph differ")
    del results, got, want, again
    kernel_ms = cuda_ms(kernel_bwd, flush)
    plain_ms = cuda_ms(plain_bwd, flush) if time_plain else None
    del plain_bwd
    lib_args = list(args)
    lib_args[0] = args[0].transpose(1, 2).contiguous()
    lib_args[3] = args[3].permute(2, 1, 0).contiguous()
    lib_args[7] = args[7].permute(2, 1, 0).contiguous()
    library_ms = cuda_ms(backward_of(library_item, lib_args,
                                     g.transpose(1, 2).contiguous()), flush)
    bound_ms, bound_by, nbytes, flops = backward_bound(
        c, length, batch, "bfloat16", use_modulation)
    row = dict(phase=phase,
               kernel="fused_resnet_item.backward", level=level, channels=c,
               length=length, batch=batch, dtype="bfloat16",
               plans=backward_occupancy(c, length, batch),
               bit_identical_rerun=True,
               forward_max_abs_err=err, forward_tolerance=bound,
               max_rel_err=rel, tolerance=2e-2, max_abs_err=worst,
               kernel_ms=kernel_ms, library_ms=library_ms,
               **({"plain_ms": plain_ms} if time_plain else {}),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, items_per_forward=(items_per_forward
                                              or 2 * ITEMS[level]))
    emit(row)
    return row


def library_item(x, gn1s, gn1b, k1, c1b, gn2s, gn2b, k2, c2b, mods=None,
                 modb=None, mgs=None, mgb=None):
    """The same item as cuDNN/PyTorch calls on [B, C, L] (yardstick only;
    the port never calls this). Kernels arrive as [Cout, Cin, 3]. Without
    the modulation's tensors the item ends at the residual."""
    import torch.nn.functional as F

    h = F.conv1d(F.silu(F.group_norm(x, GROUPS, gn1s, gn1b, 1e-5)), k1, c1b,
                 padding=1)
    h = F.conv1d(F.silu(F.group_norm(h, GROUPS, gn2s, gn2b, 1e-5)), k2, c2b,
                 padding=1)
    y = x + h
    if mods is None:
        return y
    return (y + F.group_norm(y, GROUPS, mgs, mgb, 1e-5) * (1 + mods[:, :, None])
            + modb[:, :, None])


def phase_kernel_vs_plain(flush):
    """Kernel vs plain version at each level's item shape, bf16 and f32 at
    batch 1, and bf16 again at the guided pass's batch of 2 ([cond; fixed]).
    A bf16 row also reports the conv's plan (tile, rows per CTA, splits,
    CTAs, resident CTAs per SM, wave fill) and checks that a second call
    gives the same bits. Returns the batch-1 rows and the batch-2 rows."""
    import torch

    rows = forward_rows(flush, "kernel_vs_plain", LEVELS,
                        ((torch.bfloat16, 1), (torch.float32, 1),
                         (torch.bfloat16, GUIDED_BATCH)), seed=0)
    return ([r for r in rows if r["batch"] == 1],
            [r for r in rows if r["batch"] == GUIDED_BATCH])


def phase_kernel_vs_plain_nomod(flush):
    """The same check of the forward kernel's no-modulation branch (the
    autoregressive model's items) at the AR levels' shapes, L = 2^16 ...
    2^5, bf16 and f32 at batch 1. Returns the rows."""
    import torch

    return forward_rows(flush, "kernel_vs_plain_nomod", AR_LEVELS,
                        ((torch.bfloat16, 1), (torch.float32, 1)), seed=5,
                        use_modulation=False)


def forward_rows(flush, phase, levels, runs, seed, use_modulation=True,
                 items=None):
    """Kernel vs plain version at each of ``levels`` (C, L) for each (dtype,
    batch) of ``runs``, with the times of the kernel, the plain version and
    the library yardstick beside the bound. A bf16 row also reports the
    conv's plan and checks that a second call gives the same bits.
    ``items`` are the items per pass at each level (the flagship's
    unless given)."""
    items = items or [2 * n for n in ITEMS]
    import torch
    from audio_diffusion_torch.ops.kernels.resnet import (
        conv_occupancy, fused_resnet_item, resnet_item_reference)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_args = 13 if use_modulation else 9
    kw = dict(groups=GROUPS, use_modulation=use_modulation)
    rows = []
    for dtype, batch in runs:
        dname = str(dtype).split(".")[-1]
        for level, (c, length) in enumerate(levels):
            args = item_inputs(c, length, dtype, gen, batch=batch)[:n_args]
            with torch.inference_mode():
                out = fused_resnet_item(*args, **kw)
                ref = resnet_item_reference(*args, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ymax = ref.float().abs().max().item()
                bound = (2e-4 * max(1.0, ymax) if dtype == torch.float32
                         else 2.0 ** -5 * ymax)
                if not (err <= bound):
                    raise AssertionError(
                        f"{phase} level {level} {dname} batch {batch}: "
                        f"kernel vs plain max-abs {err} > {bound}")
                extra = {}
                if dtype == torch.bfloat16:
                    again = fused_resnet_item(*args, **kw)
                    if not torch.equal(out, again):
                        raise AssertionError(
                            f"{phase} level {level} bf16 batch {batch}: two "
                            "calls on the same inputs differ")
                    extra = dict(conv_plan=conv_occupancy(c, length, batch),
                                 bit_identical_rerun=True)
                lib_args = list(args)
                lib_args[0] = args[0].transpose(1, 2).contiguous()
                lib_args[3] = args[3].permute(2, 1, 0).contiguous()
                lib_args[7] = args[7].permute(2, 1, 0).contiguous()
                kernel_ms = cuda_ms(
                    lambda: fused_resnet_item(*args, **kw), flush)
                kernel_host_ms = host_ms(
                    lambda: fused_resnet_item(*args, **kw))
                plain_ms = cuda_ms(
                    lambda: resnet_item_reference(*args, **kw), flush)
                library_ms = cuda_ms(lambda: library_item(*lib_args), flush)
            esize = args[0].element_size()
            nbytes = ((2 * batch * length * c + 2 * 3 * c * c + 8 * c
                       + 2 * batch * c) if use_modulation
                      else (2 * batch * length * c + 2 * 3 * c * c
                            + 6 * c)) * esize
            flops = 12 * c * c * length * batch
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flops_ms = flops / PEAK_FLOPS[dname] * 1e3
            row = dict(phase=phase, kernel="fused_resnet_item",
                       level=level, channels=c, length=length, batch=batch,
                       **extra, dtype=dname, max_abs_err=err, tolerance=bound,
                       max_abs_out=ymax, kernel_ms=kernel_ms,
                       kernel_host_ms=kernel_host_ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                       bytes=nbytes, flops=flops,
                       items_per_forward=items[level])
            if not use_modulation:
                row["use_modulation"] = False
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
    bound; a bf16 row also reports the plans of the backward's two
    convolutions and checks that a second backward gives the same bits. Then
    each level at the train step's batch in bf16, forward and backward, with
    its time and bound. Returns the batch-1 rows and the batch-8 rows."""
    import torch

    return backward_rows(flush, "kernel_backward_vs_plain", LEVELS,
                         (torch.bfloat16, torch.float32), seed=3)


def phase_kernel_backward_vs_plain_nomod(flush):
    """The same check of the backward kernels' no-modulation branch (9
    gradients; the autoregressive model's train step) at the AR levels'
    shapes, bf16 at batch 1 and at the train step's batch of 8. Returns the
    batch-1 rows and the batch-8 rows."""
    import torch

    return backward_rows(flush, "kernel_backward_vs_plain_nomod", AR_LEVELS,
                         (torch.bfloat16,), seed=7, use_modulation=False)


def backward_rows(flush, phase, levels, dtypes, seed, use_modulation=True,
                  items=None, time_plain=False):
    """Backward kernels vs autograd of the plain version at each of
    ``levels`` for each of ``dtypes`` at batch 1, then each level in bf16
    at the train step's batch (:func:`item_at_train_batch`, which times
    the plain version too with ``time_plain``). ``items`` are the items
    per pass at each level (the flagship's unless given)."""
    items = items or [2 * n for n in ITEMS]
    import torch
    from audio_diffusion_torch.ops.kernels.resnet import (
        backward_occupancy, fused_resnet_item, resnet_item_reference,
        wgrad_plan)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_args = 13 if use_modulation else 9
    kw = dict(groups=GROUPS, use_modulation=use_modulation)
    rows = []
    for dtype in dtypes:
        dname = str(dtype).split(".")[-1]
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for level, (c, length) in enumerate(levels):
            args = item_inputs(c, length, dtype, gen)[:n_args]
            g = item_inputs(c, length, dtype, gen)[0]

            lib_args = list(args)
            lib_args[0] = args[0].transpose(1, 2).contiguous()
            lib_args[3] = args[3].permute(2, 1, 0).contiguous()
            lib_args[7] = args[7].permute(2, 1, 0).contiguous()
            kernel_bwd = backward_of(
                functools.partial(fused_resnet_item, **kw), args, g)
            plain_bwd = backward_of(
                functools.partial(resnet_item_reference, **kw), args, g)
            library_bwd = backward_of(library_item, lib_args,
                                      g.transpose(1, 2).contiguous())
            got, want = kernel_bwd(), plain_bwd()
            torch.cuda.synchronize()
            worst_rel, worst_abs = gradient_errors(
                got, want, c, tol, f"{phase} level {level} {dname}")
            extra = {}
            if dtype == torch.bfloat16:
                again = kernel_bwd()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{phase} level {level} bf16: two "
                                         "backwards on the same graph differ")
                extra = dict(plans=backward_occupancy(c, length),
                             bit_identical_rerun=True)
                # The plan takes the card's residency from the occupancy
                # API; the CPU's default must be the same.
                resident = extra["plans"]["weight_gradient"]["resident"]
                if resident != wgrad_plan(1, length, c)["resident"]:
                    raise AssertionError(
                        f"level {level}: the card holds {resident} weight-"
                        "gradient CTAs per SM, wgrad_plan assumes "
                        f"{wgrad_plan(1, length, c)['resident']}")
                del again
            kernel_ms = cuda_ms(kernel_bwd, flush)
            kernel_host_ms = host_ms(kernel_bwd)
            plain_ms = cuda_ms(plain_bwd, flush)
            library_ms = cuda_ms(library_bwd, flush)
            bound_ms, bound_by, nbytes, flops = backward_bound(
                c, length, 1, dname, use_modulation)
            row = dict(phase=phase,
                       kernel="fused_resnet_item.backward", level=level,
                       channels=c, length=length, batch=1, dtype=dname,
                       **extra, max_rel_err=worst_rel, tolerance=tol,
                       max_abs_err=worst_abs, kernel_ms=kernel_ms,
                       kernel_host_ms=kernel_host_ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, flops=flops,
                       items_per_forward=items[level])
            if not use_modulation:
                row["gradients"] = len(got)
            emit(row)
            rows.append(row)
            del kernel_bwd, plain_bwd, library_bwd, got, want
    train_rows = [item_at_train_batch(level, c, length, gen, flush,
                                      use_modulation, phase,
                                      items_per_forward=items[level],
                                      time_plain=time_plain)
                  for level, (c, length) in enumerate(levels)]
    return rows, train_rows


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


def phase_cond_small_reference():
    """The small net with cross-attention, context injection and CFG on the
    card (kernel path, f32) vs the same weights on the CPU: a guided sample,
    and the same with encoder reuse (k = 2)."""
    import torch
    from audio_diffusion_torch import DiffusionModel, UNetV0

    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **SMALL_CFG,
                         **SMALL_COND)
    fill_zero_params(cpu)
    gpu = DiffusionModel(net_t=UNetV0, **SMALL_CFG, **SMALL_COND)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    gen = torch.Generator().manual_seed(7)
    noise = torch.randn(1, 2, 256, generator=gen)
    emb = torch.randn(1, 8, 32, generator=gen)
    ctx = torch.randn(1, 5, 32, generator=gen)
    errs = {}
    for reuse in (1, 2):
        kw = dict(num_steps=10, embedding_scale=3.0, encoder_reuse=reuse)
        want = cpu.sample(noise, embedding=emb, channels=[None, None, ctx],
                          **kw)
        got = gpu.sample(noise, embedding=emb.to(gpu.device),
                         channels=[None, None, ctx.to(gpu.device)],
                         **kw).cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"cond small reference k={reuse}: "
                                 "non-finite values")
        errs[f"encoder_reuse_{reuse}"] = (got - want).abs().max().item()
    emit(dict(phase="cond_small_reference", steps=10, dtype="float32",
              embedding_scale=3.0, max_abs_err=errs, tolerance=1e-3))
    if not max(errs.values()) < 1e-3:
        raise AssertionError(f"cond small reference: max-abs {errs}")


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


def sample_runs(model, noise, steps=None, **kw):
    """A 2-step warm-up, then three samples of ``steps`` steps (default
    ``NUM_STEPS``) through ``DiffusionModel.sample``: (the first's output,
    the item launches counted over the first alone, ms per step of each,
    peak device memory)."""
    import torch
    from audio_diffusion_torch.ops.kernels import resnet

    steps = steps or NUM_STEPS
    model.sample(noise, num_steps=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, step_ms = [], []
    for run in range(3):
        if run == 0:
            resnet.fused_resnet_item.launches = 0
        t0 = time.perf_counter()
        outs.append(model.sample(noise, num_steps=steps, **kw))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        if run == 0:
            launches = resnet.fused_resnet_item.launches
    return outs[0], launches, step_ms, torch.cuda.max_memory_allocated()


def host_noise(seed):
    """A stand-in for ``diffusion.noise.normal`` that draws on the host from
    one seeded CPU generator and moves the draw to the asked device, so a
    run on the card and one on the CPU see the same noise."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def normal(generator, shape, dtype, device):
        return torch.randn(tuple(shape), generator=gen).to(dtype=dtype,
                                                           device=device)
    return normal


def phase_sampler_small_reference():
    """The other samplers on a small net, card (kernel path, f32) vs the
    same weights on the CPU: DPM-Solver++ with and without encoder reuse,
    the SDE sampler, the RePaint inpainter, and a small autoregressive
    model's sample and loss (its items without modulation). Every draw is
    host-made noise fed through the replaced noise helper."""
    import torch
    from audio_diffusion_torch import (DiffusionAR, DiffusionModel,
                                       DPMSampler, SDESampler, UNetV0,
                                       VInpainter)
    from audio_diffusion_torch.diffusion import noise as noise_module
    from audio_diffusion_torch.diffusion.vdiffusion import arv_loss

    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **SMALL_CFG)
    fill_zero_params(cpu)
    gpu = DiffusionModel(net_t=UNetV0, **SMALL_CFG)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    ar_cpu = DiffusionAR(net_t=UNetV0, in_channels=1, length=256,
                         num_splits=4, device="cpu", seed=2, **SMALL_AR)
    fill_zero_params(ar_cpu)
    ar_gpu = DiffusionAR(net_t=UNetV0, in_channels=1, length=256,
                         num_splits=4, **SMALL_AR)
    ar_gpu.net.module.load_state_dict(ar_cpu.net.module.state_dict())
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(1, 2, 256, generator=gen)
    source = torch.randn(1, 2, 256, generator=gen)
    mask = torch.zeros(1, 2, 256, dtype=torch.bool)
    mask[..., :64] = True
    audio = torch.randn(2, 1, 256, generator=gen)
    sigmas = torch.rand(2, 1, 4, generator=gen)
    eps = torch.randn(2, 1, 256, generator=gen)

    def run(model, ar, name):
        dev = model.device
        params = model.params
        with torch.inference_mode():
            if name.startswith("dpm"):
                return DPMSampler(model.net).sample(
                    params, x.to(dev), 8,
                    encoder_reuse=2 if name.endswith("reuse_2") else 1)
            if name == "sde":
                return SDESampler(model.net, eta=0.5).sample(
                    params, model.generator, x.to(dev), 8)
            if name == "inpaint":
                return VInpainter(model.net).sample(
                    params, model.generator, source.to(dev), mask.to(dev), 4,
                    2)
            if name == "ar_sample":
                return ar.sample(num_items=1, num_chunks=6, num_steps=8)
        return arv_loss(ar.net, ar.params, audio.to(dev), sigmas.to(dev),
                        eps.to(dev)).detach()[None]

    errs = {}
    for name in ("dpm", "dpm_reuse_2", "sde", "inpaint", "ar_sample",
                 "ar_loss"):
        outs = []
        for model, ar in ((cpu, ar_cpu), (gpu, ar_gpu)):
            with mock.patch.object(noise_module, "normal", host_noise(9)):
                outs.append(run(model, ar, name).cpu())
        want, got = outs
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"sampler small reference {name}: shape "
                                 f"{tuple(got.shape)} or non-finite values")
        errs[name] = (got - want).abs().max().item()
    emit(dict(phase="sampler_small_reference", dtype="float32",
              dpm_steps=8, sde_eta=0.5, inpaint_resamples=2,
              max_abs_err=errs, tolerance=1e-3))
    if not max(errs.values()) < 1e-3:
        raise AssertionError(f"sampler small reference: max-abs {errs}")


def phase_sample_dpm(model, noise):
    """The flagship with ``DPMSampler``: a 25-step sample (the median of
    three runs). Returns the launches of the first run."""
    import torch
    from audio_diffusion_torch import DPMSampler

    model.sampler = DPMSampler(model.net)
    expected = 2 * sum(ITEMS) * DPM_STEPS
    out, launches, step_ms, peak = sample_runs(model, noise, steps=DPM_STEPS)
    emit(dict(phase="sample_dpm", steps=DPM_STEPS, length=LENGTH, batch=1,
              dtype="bfloat16", ms_per_step=sorted(step_ms)[1],
              ms_per_step_runs=step_ms, item_launches=launches,
              expected_launches=expected, peak_memory_bytes=peak,
              out_shape=list(out.shape), out_std=out.float().std().item()))
    if launches != expected:
        raise AssertionError(f"sample_dpm: {launches} item launches, "
                             f"expected {expected}")
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("sample_dpm: bad shape or non-finite values")
    return launches


def phase_sample_sde(model, noise, vsample):
    """The flagship with ``SDESampler(eta=0.3)``: 50-step samples (the
    median of three; fresh noise from the model's generator each step).
    Then ``eta=0`` from the ``sample`` phase's noise, which must give
    ``vsample``, that phase's VSampler output, bit for bit. Returns the
    launches of the first."""
    import torch
    from audio_diffusion_torch import SDESampler

    model.sampler = SDESampler(model.net, eta=SDE_ETA)
    out, launches, step_ms, peak = sample_runs(model, noise)
    model.sampler = SDESampler(model.net, eta=0.0)
    same = torch.equal(model.sample(noise, num_steps=NUM_STEPS), vsample)
    expected = 2 * sum(ITEMS) * NUM_STEPS
    rel = ((out.float() - vsample.float()).norm()
           / vsample.float().norm()).item()
    emit(dict(phase="sample_sde", steps=NUM_STEPS, eta=SDE_ETA, length=LENGTH,
              batch=1, dtype="bfloat16", ms_per_step=sorted(step_ms)[1],
              ms_per_step_runs=step_ms, item_launches=launches, expected_launches=expected,
              peak_memory_bytes=peak, out_shape=list(out.shape),
              out_std=out.float().std().item(),
              rel_l2_vs_vsampler=rel, eta0_equals_vsampler=same))
    if launches != expected:
        raise AssertionError(f"sample_sde: {launches} item launches, "
                             f"expected {expected}")
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("sample_sde: bad shape or non-finite values")
    if not same:
        raise AssertionError("sample_sde: eta=0 is not the VSampler sample")
    return launches


def phase_longform(model):
    """``generate_long`` on the flagship with the DPM sampler: one 25-step
    sample, then two RePaint continuation windows (25 steps, 2 resamples).
    Each window's known region must come out as the previous tail bit for
    bit (σ = 0 at the last step: α = 1, β = 0). Returns the launches."""
    import torch
    from audio_diffusion_torch import DPMSampler, VInpainter, generate_long
    from audio_diffusion_torch.ops.kernels import resnet

    model.sampler = DPMSampler(model.net)
    overlap, seams = LONG["overlap"], []
    inpaint = VInpainter.sample

    def spy(self, params, generator, source, mask, *args, **kwargs):
        out = inpaint(self, params, generator, source, mask, *args, **kwargs)
        seams.append(torch.equal(out[..., :overlap], source[..., :overlap]))
        return out

    gen = torch.Generator(device="cuda").manual_seed(11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resnet.fused_resnet_item.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(VInpainter, "sample", spy):
        audio = generate_long(model, generator=gen, **LONG)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = resnet.fused_resnet_item.launches
    windows = -(-(LONG["length"] - LONG["window"])
                // (LONG["window"] - overlap))
    expected = 2 * sum(ITEMS) * DPM_STEPS * (1 + windows
                                             * LONG["num_resamples"])
    emit(dict(phase="longform", **LONG, sampler="DPMSampler", batch=1,
              dtype="bfloat16", seconds=seconds,
              continuation_windows=len(seams), seams_bit_exact=seams,
              item_launches=launches, expected_launches=expected,
              peak_memory_bytes=torch.cuda.max_memory_allocated(),
              out_shape=list(audio.shape),
              out_std=audio.float().std().item()))
    if launches != expected:
        raise AssertionError(f"longform: {launches} item launches, expected "
                             f"{expected}")
    if (tuple(audio.shape) != (1, 2, LONG["length"])
            or not torch.isfinite(audio).all()):
        raise AssertionError("longform: bad shape or non-finite values")
    if len(seams) != windows or not all(seams):
        raise AssertionError(f"longform: seams {seams}, expected {windows} "
                             "bit-exact")
    return launches


def build_ar_model(torch, seed: int = 0):
    """The README's autoregressive model at the 9-level widths, with
    self-attention at levels 5-8 (8 heads x 64), bf16 compute."""
    from audio_diffusion_torch import DiffusionAR, UNetV0, presets

    model = DiffusionAR(net_t=UNetV0, in_channels=1, length=AR_LENGTH,
                        num_splits=AR_SPLITS, **presets._NET_9LEVEL,
                        attentions=presets.UNCONDITIONAL_48K["attentions"],
                        attention_heads=8, attention_features=64,
                        dtype=torch.bfloat16, seed=seed)
    fill_zero_params(model)
    return model


def phase_ar_sample(model):
    """``ar.sample(num_items=1, num_chunks=16, num_steps=64)``: the start
    window (64 passes) and 16 shifts of the σ ladder (16 passes each), 320
    passes of the net in all. Returns the launches."""
    import torch
    from audio_diffusion_torch.ops.kernels import resnet

    passes = AR_STEPS + AR_CHUNKS * AR_STEPS // AR_SPLITS
    model.sample(num_items=1, num_chunks=AR_SPLITS, num_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resnet.fused_resnet_item.launches = 0
    t0 = time.perf_counter()
    out = model.sample(num_items=1, num_chunks=AR_CHUNKS, num_steps=AR_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = resnet.fused_resnet_item.launches
    expected = 2 * sum(ITEMS) * passes
    shape = (1, 1, AR_CHUNKS * AR_LENGTH // AR_SPLITS)
    emit(dict(phase="ar_sample", num_chunks=AR_CHUNKS, num_steps=AR_STEPS,
              num_splits=AR_SPLITS, length=AR_LENGTH, batch=1,
              dtype="bfloat16", net_passes=passes, seconds=seconds,
              ms_per_pass=seconds * 1e3 / passes, item_launches=launches,
              expected_launches=expected,
              peak_memory_bytes=torch.cuda.max_memory_allocated(),
              out_shape=list(out.shape), out_dtype=str(out.dtype),
              out_std=out.float().std().item()))
    if launches != expected:
        raise AssertionError(f"ar_sample: {launches} item launches, "
                             f"expected {expected}")
    if tuple(out.shape) != shape or not torch.isfinite(out).all():
        raise AssertionError("ar_sample: bad shape or non-finite values")
    return launches


def phase_t5_text(model, noise):
    """The port's T5 encoder stack on the card against the same weights on
    the CPU (one seed gives both), f32, on captions that include an empty
    one and one longer than its 64 bytes, timed as the median of five
    encodes after the first (each with its copy back to the host); then
    the text-conditional flagship with that encoder and ``DPMSampler``:
    guided 25-step samples of one caption (the item at batch 2; the median
    of three), which must differ from the unguided one. Returns the first
    guided sample's launches."""
    import numpy as np
    import torch
    from audio_diffusion_torch import DPMSampler
    from audio_diffusion_torch.ops.text import RandomT5TextEncoder

    card = RandomT5TextEncoder()
    host = RandomT5TextEncoder(device="cpu")
    got = card(T5_CAPTIONS)
    encode_runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        card(T5_CAPTIONS)
        encode_runs.append((time.perf_counter() - t0) * 1e3)
    want = host(T5_CAPTIONS)
    pad = card._tokenize(T5_CAPTIONS) == 0
    ymax = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    padded_zero = bool((got[pad] == 0).all())

    model.net.text_encoder = card
    model.sampler = DPMSampler(model.net)
    out, launches, step_ms, peak = sample_runs(
        model, noise, steps=DPM_STEPS, text=T5_CAPTIONS[:1],
        embedding_scale=GUIDANCE)
    unguided = model.sample(noise, num_steps=DPM_STEPS, text=T5_CAPTIONS[:1])
    rel = ((out.float() - unguided.float()).norm()
           / unguided.float().norm()).item()
    expected = 2 * sum(ITEMS) * DPM_STEPS
    emit(dict(phase="t5_text", encoder=dict(
                  max_length=card.max_length, features=card.features,
                  layers=len(card.stack.encoder.block),
                  heads=card.stack.num_heads, captions=len(T5_CAPTIONS),
                  max_abs_err=err, tolerance=1e-4 * ymax, max_abs_out=ymax,
                  padded_rows_zero=padded_zero, dtype=str(got.dtype),
                  encode_ms=sorted(encode_runs)[2],
                  encode_ms_runs=encode_runs),
              steps=DPM_STEPS, sampler="DPMSampler", embedding_scale=GUIDANCE,
              length=LENGTH, batch=1, item_batch=GUIDED_BATCH,
              dtype="bfloat16", ms_per_step=sorted(step_ms)[1],
              ms_per_step_runs=step_ms, item_launches=launches,
              expected_launches=expected, peak_memory_bytes=peak,
              out_shape=list(out.shape), rel_l2_guided_vs_unguided=rel))
    if not (err <= 1e-4 * ymax) or not padded_zero:
        raise AssertionError(f"t5_text: encoder card vs CPU max-abs {err} "
                             f"(bar {1e-4 * ymax}), padded rows zero: "
                             f"{padded_zero}")
    if launches != expected:
        raise AssertionError(f"t5_text: {launches} item launches, expected "
                             f"{expected}")
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("t5_text: bad shape or non-finite values")
    if not rel > 1e-3:
        raise AssertionError(f"t5_text: the guided output is the unguided "
                             f"one (relative L2 {rel})")
    return launches


def build_text_model(torch, seed: int = 0):
    from audio_diffusion_torch import DiffusionModel, UNetV0, presets
    from audio_diffusion_torch.ops.text import StubTextEncoder

    model = DiffusionModel(net_t=UNetV0, **presets.TEXT_CONDITIONAL_48K,
                           text_encoder=StubTextEncoder(),
                           dtype=torch.bfloat16, seed=seed)
    fill_zero_params(model)
    return model


def phase_sample_text(model, noise):
    """The text-conditional main path: a guided 50-step sample of one
    caption (``text=``, the stub encoder, guidance 5) at batch 1, so the
    item runs at batch 2 once per step. Then the same call with encoder
    reuse (k = 2): per chunk of two steps one full pass and one decoder-only
    pass. Returns (guided launches, reuse launches)."""
    import torch

    per_pass = 2 * sum(ITEMS)
    text = dict(text=CAPTIONS[:1], embedding_scale=GUIDANCE)
    out, launches, step_ms, peak = sample_runs(model, noise, **text)
    unguided = model.sample(noise, num_steps=NUM_STEPS, text=CAPTIONS[:1])
    rel = ((out.float() - unguided.float()).norm()
           / unguided.float().norm()).item()
    emit(dict(phase="sample_text", steps=NUM_STEPS, length=LENGTH, batch=1,
              item_batch=GUIDED_BATCH, dtype="bfloat16",
              embedding_scale=GUIDANCE, captions=CAPTIONS[:1],
              ms_per_step=sorted(step_ms)[1], ms_per_step_runs=step_ms,
              item_launches=launches, expected_launches=per_pass * NUM_STEPS,
              peak_memory_bytes=peak, out_shape=list(out.shape),
              out_std=out.float().std().item(),
              rel_l2_guided_vs_unguided=rel))
    if launches != per_pass * NUM_STEPS:
        raise AssertionError(f"sample_text: {launches} item launches, "
                             f"expected {per_pass * NUM_STEPS}")
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("sample_text: bad shape or non-finite values")
    if not rel > 1e-3:
        raise AssertionError(f"sample_text: the guided output is the "
                             f"unguided one (relative L2 {rel})")

    fast, reuse_launches, step_ms, peak = sample_runs(
        model, noise, encoder_reuse=2, **text)
    expected = NUM_STEPS // 2 * (per_pass + per_pass // 2)
    rel = ((fast.float() - out.float()).norm() / out.float().norm()).item()
    emit(dict(phase="sample_reuse", steps=NUM_STEPS, encoder_reuse=2,
              length=LENGTH, batch=1, item_batch=GUIDED_BATCH,
              dtype="bfloat16", embedding_scale=GUIDANCE,
              ms_per_step=sorted(step_ms)[1], ms_per_step_runs=step_ms,
              item_launches=reuse_launches, expected_launches=expected,
              peak_memory_bytes=peak, out_shape=list(fast.shape),
              rel_l2_vs_exact=rel))
    if reuse_launches != expected:
        raise AssertionError(f"sample_reuse: {reuse_launches} item launches, "
                             f"expected {expected}")
    if fast.shape != noise.shape or not torch.isfinite(fast).all():
        raise AssertionError("sample_reuse: bad shape or non-finite values")
    return launches, reuse_launches


def phase_attention_profile(model, noise, steps: int = 2):
    """Device time of the cross-attention items (and of the self-attention
    items beside them) over ``steps`` guided net calls at batch 1, each item
    wrapped in a profiler range by forward hooks; the time of a range is its
    kernels' device time. A second, unprofiled run times each item between
    CUDA events recorded by the same hooks (its span on the stream, gaps
    the host leaves included)."""
    import torch
    from audio_diffusion_torch import cast_inference_params
    from audio_diffusion_torch.ops.attention import (AttentionItem,
                                                     CrossAttentionItem)
    from torch.profiler import ProfilerActivity, profile, record_function

    params = cast_inference_params(model.params, torch.bfloat16)
    emb = torch.as_tensor(model.net.text_encoder(CAPTIONS[:1]),
                          device=model.device)
    sig = torch.full((1,), 0.5, device=model.device)
    handles, counts = [], {"cross_attention": 0, "self_attention": 0}
    spans, timing = {k: [] for k in counts}, []
    for m in model.net.module.modules():
        if type(m) in (CrossAttentionItem, AttentionItem):
            name = ("cross_attention" if type(m) is CrossAttentionItem
                    else "self_attention")
            counts[name] += 1
            ranges = []

            def enter(mod, args, name=name, ranges=ranges):
                ranges.append(record_function(name).__enter__())
                if timing:
                    spans[name].append(torch.cuda.Event(enable_timing=True))
                    spans[name][-1].record()

            def leave(mod, args, out, name=name, ranges=ranges):
                ranges.pop().__exit__(None, None, None)
                if timing:
                    spans[name].append(torch.cuda.Event(enable_timing=True))
                    spans[name][-1].record()

            handles += [m.register_forward_pre_hook(enter),
                        m.register_forward_hook(leave)]

    def run():
        with torch.inference_mode():
            for _ in range(steps):
                model.net.apply(params, noise, sig, embedding=emb,
                                embedding_scale=GUIDANCE)

    try:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if model.device.type == "cuda":
            timing.append(True)
            run()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    span_ms = {k: sum(a.elapsed_time(b) for a, b in zip(v[::2], v[1::2]))
               / steps for k, v in spans.items()}
    # A range's host-side event sums the kernels its ops launched; the
    # device-side copy of the range spans first to last kernel, gaps and
    # all, and is left out.
    device_us = {k: 0.0 for k in counts}
    busy_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.name in device_us:
                device_us[e.name] += e.device_time_total
        elif not getattr(e, "is_user_annotation", False):
            busy_us += e.device_time_total
    emit(dict(phase="attention_profile", steps=steps, batch=1,
              item_batch=GUIDED_BATCH, dtype="bfloat16",
              items_per_pass=counts,
              device_ms_per_step={k: v / 1e3 / steps
                                  for k, v in device_us.items()},
              event_span_ms_per_step=span_ms,
              all_kernels_ms_per_step=busy_us / 1e3 / steps))
    if sum(device_us.values()) > busy_us:
        raise AssertionError(f"attention profile: the ranges' kernels "
                             f"({device_us}) exceed all kernels ({busy_us})")


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


def phase_train(model, phase="train", channels=2, length=LENGTH,
                items_per_pass=None, item_batch=TRAIN_BATCH, **cond):
    """A training main path: Adam steps of a model at full width and depth,
    bf16 compute over float32 master parameters, on a batch of ``channels``
    x ``length`` (2^18-sample stereo for the flagships), through
    ``DiffusionModel.loss`` and ``make_train_step``, with ``cond`` (the
    conditioning kwargs) on every step. Where the net has CFG, the
    embedding mask's draws are counted: ``fixed_embedding`` moves exactly
    when a row was masked in an Adam step. ``items_per_pass`` is the item
    launches each direction makes per step (the flagship's 42 unless
    given), and ``item_batch`` the batch the items run at. Returns the
    item launches (forward, backward) counted over the timed steps."""
    import torch
    from audio_diffusion_torch import make_train_step
    from audio_diffusion_torch.ops.kernels import resnet
    from audio_diffusion_torch.ops.unet import ClassifierFreeGuidanceWrapper

    item = resnet.fused_resnet_item
    items_per_pass = items_per_pass or 2 * sum(ITEMS)
    gen = torch.Generator(device=model.device).manual_seed(4)
    batch = torch.randn(TRAIN_BATCH, channels, length, device=model.device,
                        generator=gen).clamp_(-1.0, 1.0)
    leaves = list(model.params.values())
    masks = []
    draw = ClassifierFreeGuidanceWrapper.draw_mask

    def counted_draw(*args):
        masks.append(draw(*args))
        return masks[-1]

    spy = mock.patch.object(ClassifierFreeGuidanceWrapper, "draw_mask",
                            staticmethod(counted_draw))
    with spy:
        # Every parameter receives a gradient (this also warms the kernels
        # up); the fixed embedding only where a row was masked.
        grads = torch.autograd.grad(
            model.loss(model.params, gen, batch, **cond), leaves,
            allow_unused=True)
        masked_first = sum(int(m.sum()) for m in masks)
        missing = [n for n, g in zip(model.params, grads)
                   if g is None or not torch.isfinite(g).all()
                   or not (g.any() or (n == FIXED_EMBEDDING
                                       and not masked_first))]
        if missing:
            raise AssertionError(
                f"{phase}: no usable gradient for {missing[:5]} "
                f"({len(missing)} parameters)")
        del grads
        masks.clear()
        before = [p.detach().clone() for p in leaves]
        init_state, train_step = make_train_step(
            model.loss, functools.partial(torch.optim.Adam, lr=1e-4))
        state = init_state(model.params, gen)
        # Warm-up: Adam allocates its moments.
        state, _ = train_step(state, batch, **cond)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        item.launches = item.backward_launches = 0
        step_ms, metrics = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = train_step(state, batch, **cond)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: v.item() for k, v in m.items()})
        launches = (item.launches, item.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    median = sorted(step_ms)[len(step_ms) // 2]
    still = [n for (n, p), p0 in zip(model.params.items(), before)
             if torch.equal(p.detach(), p0)]
    masked = [int(m.sum()) for m in masks]
    may_stay = ([FIXED_EMBEDDING] if masks and not sum(masked) else [])
    extra = dict(embedding_mask_proba=cond.get("embedding_mask_proba"),
                 masked_rows_per_step=masked,
                 masked_rows_first_gradient=masked_first) if masks else {}
    emit(dict(phase=phase, batch=TRAIN_BATCH, item_batch=item_batch,
              channels=channels, length=length,
              dtype="bfloat16", optimizer="Adam(lr=1e-4)", steps=TRAIN_STEPS,
              ms_per_step=median, ms_per_step_runs=step_ms,
              samples_per_s=TRAIN_BATCH / median * 1e3,
              metrics=metrics,
              forward_item_launches=launches[0],
              backward_item_launches=launches[1],
              expected_launches=items_per_pass * TRAIN_STEPS,
              parameters=len(leaves),
              parameter_elements=sum(p.numel() for p in leaves),
              **extra, peak_memory_bytes=peak, peak_gb=peak / 1e9))
    if launches != (items_per_pass * TRAIN_STEPS,) * 2:
        raise AssertionError(
            f"{phase}: {launches} (forward, backward) item launches in "
            f"{TRAIN_STEPS} train steps, expected {items_per_pass} each per "
            "step")
    for m in metrics:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{phase}: non-finite metrics {m}")
    if metrics[-1]["step"] != TRAIN_STEPS + 1:
        raise AssertionError(f"{phase}: step counter {metrics[-1]['step']}")
    if still != may_stay:
        raise AssertionError(
            f"{phase}: parameters that did not move: {still[:5]} "
            f"({len(still)}; {sum(masked)} rows masked in the Adam steps)")
    del before
    phase_profile(f"{phase}_profile",
                  lambda: train_step(state, batch, **cond), steps=1,
                  batch=TRAIN_BATCH)
    return launches


def phase_kernel_vs_plain_tasks(flush):
    """The kernels at the task models' new shapes, held against the plain
    version with the bars above: the encoder's no-modulation item at (C =
    512, L = 1024), forward at batch 1 and backward at batch 1 and 8; and
    the modulated item at the nine flagship levels at batch 16 (the
    vocoder's train step), forward and backward, each with its plans, a
    bit-identical rerun, and its time beside the plain version's, the
    library's and the bound. Returns (encoder forward rows, batch-16
    forward rows, encoder backward rows at batch 1, at batch 8, batch-16
    backward rows)."""
    import torch

    bf16 = torch.bfloat16
    enc = forward_rows(flush, "kernel_vs_plain_tasks", [ENCODER_LEVEL],
                       ((bf16, 1),), seed=11, use_modulation=False,
                       items=[ENCODER_ITEMS])
    fwd16 = forward_rows(flush, "kernel_vs_plain_tasks", LEVELS,
                         ((bf16, TASK_BATCH),), seed=12)
    enc_bwd, enc_bwd8 = backward_rows(
        flush, "kernel_backward_vs_plain_tasks", [ENCODER_LEVEL], (bf16,),
        seed=13, use_modulation=False, items=[ENCODER_ITEMS],
        time_plain=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    bwd16 = [item_at_train_batch(level, c, length, gen, flush, True,
                                 "kernel_backward_vs_plain_tasks",
                                 batch=TASK_BATCH, time_plain=True)
             for level, (c, length) in enumerate(LEVELS)]
    return enc, fwd16, enc_bwd, enc_bwd8, bwd16


def wsq_scale(n_fft, hop, win, frames, length):
    """min(1, Σ window²) at each sample of an inverse STFT: where it is
    small the inverse divides the FFTs' rounding by it, and a bar on the
    output is scaled by its inverse there."""
    import torch
    from audio_diffusion_torch.dsp.mel import _framing_window

    w2 = _framing_window(n_fft, win, "cpu") ** 2
    wsq = torch.zeros(max(length, (frames - 1) * hop + n_fft))
    for f in range(frames):
        wsq[f * hop:f * hop + n_fft] += w2
    return wsq[:length].clamp(1e-11, 1.0)


def phase_dsp_small_reference():
    """The DSP front end on the card (cuFFT) against the CPU (pocketfft),
    float32, on host-made signals: x16 resampling both ways, the STFT and
    its inverse, 8 Griffin-Lim iterations, ``MelSpectrogram`` with
    ``normalize`` and with ``normalize_log``, and the multi-resolution STFT
    loss and its gradient. Bar: max-abs ≤ 1e-4·max(1, max|y|), the sums
    in other orders; the inverse STFT's and Griffin-Lim's scaled by
    1 / min(1, Σ window²) at each sample."""
    import torch
    from audio_diffusion_torch import dsp, multi_resolution_stft_loss

    gen = torch.Generator().manual_seed(21)
    x = torch.randn(2, 2, 2**14, generator=gen)
    low = torch.randn(2, 2, 2**10, generator=gen)
    pred = torch.randn(2, 1, 2**14, generator=gen)
    n_fft, hop = 1024, 256
    spec = dsp.stft(x.flatten(0, 1), n_fft, hop)
    frames = spec.shape[-1]
    wsq = wsq_scale(n_fft, hop, n_fft, frames, 2**14)

    def loss_and_grad(p, t):
        p = p.clone().requires_grad_(True)
        loss = multi_resolution_stft_loss(p, t)
        return torch.cat([loss.detach()[None],
                          torch.autograd.grad(loss, [p])[0].flatten()])

    cases = {
        "upsample_16": (lambda a: dsp.upsample(a, UPSAMPLE_FACTOR), (low,),
                        None),
        "downsample_16": (lambda a: dsp.downsample(a, UPSAMPLE_FACTOR), (x,),
                          None),
        "stft": (lambda a: dsp.stft(a, n_fft, hop), (x.flatten(0, 1),), None),
        "istft": (lambda s: dsp.istft(s, n_fft, hop, length=2**14), (spec,),
                  wsq),
        "griffin_lim_8": (lambda m: dsp.griffin_lim(m, n_fft, hop, n_iter=8,
                                                    length=2**14),
                          (spec.abs(),), wsq),
        "mel_normalize": (dsp.MelSpectrogram(n_fft, hop, n_fft, 48000, 80,
                                             normalize=True), (x,), None),
        "mel_normalize_log": (dsp.MelSpectrogram(n_fft, hop, n_fft, 48000,
                                                 80, normalize_log=True),
                              (x,), None),
        "stft_loss_and_grad": (loss_and_grad, (pred, x[:, :1]), None),
    }
    errs, worst = {}, 0.0
    for name, (fn, args, scale) in cases.items():
        want = fn(*args)
        got = fn(*(a.cuda() for a in args)).cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"dsp small reference {name}: shape "
                                 f"{tuple(got.shape)} or non-finite values")
        diff = (got - want).abs()
        bar = 1e-4 * max(1.0, want.abs().max().item())
        ratio = (diff / (bar / scale if scale is not None else bar)).max()
        errs[name] = diff.max().item()
        worst = max(worst, ratio.item())
    emit(dict(phase="dsp_small_reference", dtype="float32", n_fft=n_fft,
              hop=hop, max_abs_err=errs, worst_share_of_bar=worst,
              tolerance="1e-4*max(1,max|y|), /min(1,sum window^2) for "
                        "istft and griffin_lim"))
    if not worst <= 1.0:
        raise AssertionError(f"dsp small reference: {errs} (worst {worst} "
                             "of the bar)")


def copy_params(dst, src) -> None:
    """Every parameter of task model ``src`` into ``dst`` (net and extras)."""
    dst.net.module.load_state_dict(src.net.module.state_dict())
    for prefix, module in dst.extras.items():
        module.load_state_dict(src.extras[prefix].state_dict())


def phase_task_small_reference():
    """Small task models on the card (kernel path, float32) against the same
    weights on the CPU: an upsampler (x4), a vocoder, an autoencoder and a
    net behind ``LTPlugin``; each one's loss at host-made σ and noise (the
    whole model path: reupsampling, folding, ``to_flat``, the encoder), a
    4-step sample from host-made noise fed through the replaced noise
    helper, and the autoencoder's latent."""
    import torch
    from audio_diffusion_torch import (DiffusionAE, DiffusionModel,
                                       DiffusionUpsampler, DiffusionVocoder,
                                       LTPlugin, MelEncoder1d, UNetV0)
    from audio_diffusion_torch.diffusion import noise as noise_module
    from audio_diffusion_torch.diffusion.vdiffusion import v_loss

    builders = {
        "upsampler": lambda dev: DiffusionUpsampler(
            net_t=UNetV0, in_channels=2, upsample_factor=4, device=dev,
            seed=1, **SMALL_TASK),
        "vocoder": lambda dev: DiffusionVocoder(
            net_t=UNetV0, device=dev, seed=1, **SMALL_VOCODER, **SMALL_TASK),
        "autoencoder": lambda dev: DiffusionAE(
            net_t=UNetV0, encoder=MelEncoder1d(device=dev, **SMALL_ENCODER),
            device=dev, seed=1, **SMALL_AE),
        "lt_plugin": lambda dev: DiffusionModel(
            net_t=LTPlugin(UNetV0, **SMALL_LT), in_channels=2, device=dev,
            seed=1, **SMALL_TASK),
    }
    gen = torch.Generator().manual_seed(22)
    audio = torch.randn(2, 2, 1024, generator=gen)
    errs = {}
    for name, build in builders.items():
        cpu = build("cpu")
        fill_zero_params(cpu)
        gpu = build("cuda")
        copy_params(gpu, cpu)
        net_batch = 4 if name == "vocoder" else 2
        sigmas = torch.rand(net_batch, generator=gen)
        eps = torch.randn(net_batch, 2 if name != "vocoder" else 1, 1024,
                          generator=gen)
        outs = {}
        for model in (cpu, gpu):
            dev = model.device

            def fixed(params, generator, x, model=model, dev=dev, **kw):
                return v_loss(model.net, params, x, sigmas.to(dev),
                              eps.to(dev), **kw)

            with mock.patch.object(model.diffusion, "loss", fixed):
                loss = model.loss(model.params, None, audio.to(dev))
            with mock.patch.object(noise_module, "normal", host_noise(23)):
                if name == "upsampler":
                    out = model.sample(audio[:1, :, ::4].to(dev), num_steps=4)
                elif name == "vocoder":
                    out = model.sample(model.to_spectrogram(audio[:1].to(
                        dev)), num_steps=4)
                elif name == "autoencoder":
                    latent = model.encode(audio.to(dev))
                    outs["latent", dev.type] = latent.cpu()
                    out = model.decode(latent[:1], num_steps=4)
                else:
                    out = model.sample(audio[:1].to(dev), num_steps=4)
            outs["loss", dev.type] = loss.detach().cpu()[None]
            outs["sample", dev.type] = out.cpu()
        for (what, where), got in outs.items():
            if where != "cuda":
                continue
            want = outs[what, "cpu"]
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"task small reference {name} {what}: "
                                     f"shape {tuple(got.shape)} or "
                                     "non-finite values")
            errs[f"{name}_{what}"] = (got - want).abs().max().item()
    emit(dict(phase="task_small_reference", dtype="float32", steps=4,
              max_abs_err=errs, tolerance=1e-3))
    if not max(errs.values()) < 1e-3:
        raise AssertionError(f"task small reference: max-abs {errs}")


def task_sample_runs(phase, sample, expected, shape, batch=1, **extra):
    """A task model's sampling main path: a 2-step warm-up, then three
    ``NUM_STEPS``-step runs of ``sample(num_steps, generator)``, each with a
    generator seeded alike (so the same noise): the item launches counted
    over the first, ms per step (the median of three), bit-identical
    reruns, samples per second and peak memory. Returns (launches, the
    first output)."""
    import torch
    from audio_diffusion_torch.ops.kernels import resnet

    def generator():
        return torch.Generator(device="cuda").manual_seed(31)

    sample(2, generator())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, step_ms = [], []
    for run in range(3):
        if run == 0:
            resnet.fused_resnet_item.launches = 0
        t0 = time.perf_counter()
        outs.append(sample(NUM_STEPS, generator()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / NUM_STEPS)
        if run == 0:
            launches = resnet.fused_resnet_item.launches
    peak = torch.cuda.max_memory_allocated()
    out = outs[0]
    same = all(torch.equal(out, o) for o in outs[1:])
    median = sorted(step_ms)[1]
    emit(dict(phase=phase, steps=NUM_STEPS, batch=batch, dtype="bfloat16",
              **extra, ms_per_step=median, ms_per_step_runs=step_ms,
              samples_per_s=batch / (median * NUM_STEPS / 1e3),
              item_launches=launches, expected_launches=expected,
              bit_identical_reruns=same, peak_memory_bytes=peak,
              peak_gb=peak / 1e9, out_shape=list(out.shape),
              out_dtype=str(out.dtype), out_std=out.float().std().item()))
    if launches != expected:
        raise AssertionError(f"{phase}: {launches} item launches, expected "
                             f"{expected}")
    if tuple(out.shape) != shape or not torch.isfinite(out).all():
        raise AssertionError(f"{phase}: shape {tuple(out.shape)} (expected "
                             f"{shape}) or non-finite values")
    if not same:
        raise AssertionError(f"{phase}: reruns with the same noise differ")
    return launches, out


def host_audio(seed, batch=1):
    """Stereo 2^18-sample audio in [-1, 1] made on the host, on the card."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 2, LENGTH, generator=gen).clamp_(-1.0,
                                                                1.0).cuda()


def phase_upsampler(torch):
    """``DiffusionUpsampler(upsample_factor=16, **presets.UPSAMPLER_16X)`` in
    bf16: a 50-step sample of [1, 2, 2^14] -> [1, 2, 2^18] (the net takes
    2 + 2 channels; 42 items per step at batch 1), then Adam steps at batch
    8. Returns (sample launches, train launches)."""
    from audio_diffusion_torch import DiffusionUpsampler, UNetV0, presets

    model = DiffusionUpsampler(net_t=UNetV0, upsample_factor=UPSAMPLE_FACTOR,
                               **presets.UPSAMPLER_16X, dtype=torch.bfloat16)
    fill_zero_params(model)
    low = host_audio(41)[..., ::UPSAMPLE_FACTOR].contiguous()
    launches, _ = task_sample_runs(
        "upsampler_sample",
        lambda steps, gen: model.sample(low, num_steps=steps, generator=gen),
        2 * sum(ITEMS) * NUM_STEPS, (1, 2, LENGTH), item_batch=1,
        in_shape=list(low.shape), upsample_factor=UPSAMPLE_FACTOR)
    phase_profile("upsampler_sample_profile",
                  lambda: model.sample(low, num_steps=2), steps=2)
    train = phase_train(model, "upsampler_train")
    return launches, train


def phase_vocoder(torch):
    """``DiffusionVocoder(**presets.VOCODER_48K)`` in bf16, ``to_flat`` in
    f32: a 50-step sample from the stereo mel [1, 2, 80, 1024] that the
    model's own ``to_spectrogram`` makes of host-made 2^18-sample audio (the
    channels fold into the batch: 42 items per step at batch 2), then Adam
    steps at batch 8 (the net and its items at batch 16), profiled. Returns
    (sample launches, train launches)."""
    from audio_diffusion_torch import DiffusionVocoder, UNetV0, presets

    model = DiffusionVocoder(net_t=UNetV0, **presets.VOCODER_48K,
                             dtype=torch.bfloat16)
    fill_zero_params(model)
    mel = model.to_spectrogram(host_audio(42))
    if tuple(mel.shape) != (1, 2, 80, 1024):
        raise AssertionError(f"vocoder: mel of shape {tuple(mel.shape)}")
    launches, _ = task_sample_runs(
        "vocoder_sample",
        lambda steps, gen: model.sample(mel, num_steps=steps, generator=gen),
        2 * sum(ITEMS) * NUM_STEPS, (1, 2, LENGTH), item_batch=2,
        mel_shape=list(mel.shape))
    phase_profile("vocoder_sample_profile",
                  lambda: model.sample(mel, num_steps=2), steps=2)
    train = phase_train(model, "vocoder_train", item_batch=TASK_BATCH)
    phase_to_flat(model, model.to_spectrogram(host_audio(44, TRAIN_BATCH)))
    return launches, train


def phase_to_flat(model, mel):
    """The vocoder's ``to_flat`` at the train step's shape (the stereo mel of
    8 clips, [16, 80, 1024] -> [16, 1, 2^18], float32): the port's
    transposed conv (one product and ``F.fold``) against cuDNN's
    ``F.conv_transpose1d`` with its default and with its deterministic
    algorithms: the outputs (max-abs ≤ 2e-4·max(1, max|y|)), the port's
    bits on a rerun, and the device time of a forward and of a forward
    with the kernel's gradient."""
    import torch
    import torch.nn.functional as F
    from audio_diffusion_torch.ops.conv import conv_transpose1d

    spec = mel.flatten(0, 1).float().contiguous()
    conv = model.to_flat
    kernel = conv.kernel.detach().clone()
    c = torch.backends.cudnn

    def cudnn(x, k, deterministic=False):
        with c.flags(enabled=True, benchmark=c.benchmark,
                     deterministic=deterministic, allow_tf32=False):
            return F.conv_transpose1d(x, k.permute(1, 2, 0),
                                      stride=conv.stride,
                                      padding=conv.padding)

    variants = {
        "port": lambda x, k: conv_transpose1d(x, k, conv.stride,
                                              conv.padding),
        "cudnn": cudnn,
        "cudnn_deterministic": functools.partial(cudnn, deterministic=True),
    }
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    g = torch.randn(spec.shape[0], 1, spec.shape[-1] * conv.stride,
                    device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(45))
    row, outs = {}, {}
    for name, fn in variants.items():
        with torch.no_grad():
            outs[name] = fn(spec, kernel)
        leaf = kernel.clone().requires_grad_(True)

        def fwd_bwd(fn=fn, leaf=leaf):
            return torch.autograd.grad(fn(spec, leaf), [leaf], g)

        with torch.no_grad():
            row[f"{name}_forward_ms"] = cuda_ms(lambda fn=fn: fn(spec, kernel),
                                                flush)
        row[f"{name}_forward_backward_ms"] = cuda_ms(fwd_bwd, flush)
    with torch.no_grad():
        again = variants["port"](spec, kernel)
    want = outs["cudnn"]
    bar = 2e-4 * max(1.0, want.abs().max().item())
    errs = {k: (v - want).abs().max().item() for k, v in outs.items()}
    same = torch.equal(again, outs["port"])
    emit(dict(phase="vocoder_to_flat", in_shape=list(spec.shape),
              out_shape=list(outs["port"].shape), dtype="float32", **row,
              max_abs_err_vs_cudnn=errs, tolerance=bar,
              port_bit_identical_rerun=same))
    if not max(errs.values()) <= bar or not same:
        raise AssertionError(f"vocoder_to_flat: {errs} (bar {bar}), port "
                             f"rerun bit-identical: {same}")


def phase_autoencoder(torch):
    """``DiffusionAE(inject_depth=6, encoder=MelEncoder1d(...),
    **presets.AUTOENCODER_48K)`` in bf16 (the encoder too): ``encode`` of
    [1, 2, 2^18] to a [1, 32, 512] latent (12 no-modulation items at C =
    512, L = 1,024; the median of three timed encodes, each bit-identical),
    a 50-step ``decode`` of it, and Adam steps at batch 8 that train the
    encoder jointly (42 + 12 items each way per step). Returns (encode
    launches, decode launches, train launches)."""
    from audio_diffusion_torch import (DiffusionAE, MelEncoder1d, UNetV0,
                                       presets)
    from audio_diffusion_torch.ops.kernels import resnet

    encoder = MelEncoder1d(**ENCODER, dtype=torch.bfloat16)
    model = DiffusionAE(net_t=UNetV0, inject_depth=INJECT_DEPTH,
                        encoder=encoder, **presets.AUTOENCODER_48K,
                        dtype=torch.bfloat16)
    fill_zero_params(model)
    audio = host_audio(43)
    model.encode(audio)
    torch.cuda.synchronize()
    latents, encode_ms = [], []
    for run in range(3):
        if run == 0:
            resnet.fused_resnet_item.launches = 0
        t0 = time.perf_counter()
        latents.append(model.encode(audio))
        torch.cuda.synchronize()
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        if run == 0:
            encode_launches = resnet.fused_resnet_item.launches
    latent = latents[0]
    same = all(torch.equal(latent, t) for t in latents[1:])
    shape = (1, ENCODER["out_channels"], LENGTH // encoder.downsample_factor)
    emit(dict(phase="ae_encode", batch=1, dtype="bfloat16",
              encode_ms=sorted(encode_ms)[1], encode_ms_runs=encode_ms,
              item_launches=encode_launches, expected_launches=ENCODER_ITEMS,
              bit_identical_reruns=same, latent_shape=list(latent.shape),
              latent_dtype=str(latent.dtype),
              latent_max_abs=latent.float().abs().max().item(),
              downsample_factor=encoder.downsample_factor))
    if encode_launches != ENCODER_ITEMS:
        raise AssertionError(f"ae_encode: {encode_launches} item launches, "
                             f"expected {ENCODER_ITEMS}")
    if (tuple(latent.shape) != shape or not torch.isfinite(latent).all()
            or latent.abs().max() > 1.0):
        raise AssertionError(f"ae_encode: latent {tuple(latent.shape)} "
                             "not finite, bounded and of the stated shape")
    if not same:
        raise AssertionError("ae_encode: two encodes of the same audio "
                             "differ")
    decode_launches, _ = task_sample_runs(
        "ae_decode",
        lambda steps, gen: model.decode(latent, num_steps=steps,
                                        generator=gen),
        2 * sum(ITEMS) * NUM_STEPS, (1, 2, LENGTH), item_batch=1,
        inject_depth=INJECT_DEPTH)
    phase_profile("ae_decode_profile",
                  lambda: model.decode(latent, num_steps=2), steps=2)
    train = phase_train(model, "ae_train",
                        items_per_pass=2 * sum(ITEMS) + ENCODER_ITEMS)
    return encode_launches, decode_launches, train


def phase_trainer_small_reference():
    """Three Trainer steps of a small net in f32 on the card (kernels,
    forward and backward) against the same weights on the CPU: warmup and
    cosine decay, clipping (every step's norm is above it), EMA, the same
    batches, σ and noise from numpy fed per step as (x, cond) batches.
    Parameters and EMA within 1e-4 (max-abs). The net's first level has two
    channels per group (16 channels, 8 groups), so no bias is removed by a
    GroupNorm and no gradient is rounding noise alone; at lr 2e-5 a sign
    flip of Adam's step in both of the two updates with a nonzero LR would
    still stay inside the bar."""
    import types

    import numpy as np
    import torch
    from audio_diffusion_torch import DiffusionModel, UNetV0
    from audio_diffusion_torch.diffusion.vdiffusion import v_loss
    from audio_diffusion_torch.train import Trainer, TrainerConfig

    cfg = dict(SMALL_CFG, channels=[16, 32, 64])
    rs = np.random.default_rng(8)
    batches = [(rs.uniform(-1, 1, (2, 2, 256)).astype(np.float32),
                dict(sigmas=rs.uniform(0.1, 0.9, 2).astype(np.float32),
                     noise=rs.standard_normal((2, 2, 256)).astype(
                         np.float32))) for _ in range(3)]
    tcfg = dict(learning_rate=2e-5, lr_schedule="cosine", warmup_steps=1,
                total_steps=4, max_grad_norm=0.5, ema_decay=0.9,
                log_every=1)
    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=2, **cfg)
    fill_zero_params(cpu)
    gpu = DiffusionModel(net_t=UNetV0, **cfg)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    out = []
    for model in (cpu, gpu):
        def loss_fn(params, generator, batch, sigmas, noise, model=model):
            return v_loss(model.net, params, batch, sigmas, noise)

        shim = types.SimpleNamespace(loss=loss_fn, params=model.params,
                                     device=model.device,
                                     generator=model.generator)
        logs = []
        trainer = Trainer(shim, TrainerConfig(**tcfg), log_fn=logs.append)
        trainer.fit(iter(batches), num_steps=3)
        out.append((
            logs, {n: p.detach().cpu() for n, p in model.params.items()},
            {n: e.cpu() for n, e in trainer.ema_params.items()}))
    (l_cpu, p_cpu, e_cpu), (l_gpu, p_gpu, e_gpu) = out
    err = max((p_cpu[n] - p_gpu[n]).abs().max().item() for n in p_cpu)
    ema_err = max((e_cpu[n] - e_gpu[n]).abs().max().item() for n in e_cpu)
    emit(dict(phase="trainer_small_reference", dtype="float32", steps=3,
              trainer=tcfg, cpu_logs=l_cpu, card_logs=l_gpu,
              max_param_abs_err=err, max_ema_abs_err=ema_err,
              tolerance=1e-4))
    if not (err <= 1e-4 and ema_err <= 1e-4):
        raise AssertionError(f"trainer_small_reference: parameters {err}, "
                             f"EMA {ema_err} from the CPU's")


def synth_corpus(root: Path, files: int = 8, frames: int = 2**19) -> Path:
    """``files`` stereo PCM16 WAVs of ``frames`` frames, from a numpy seed,
    written with the port's ``wav_write``."""
    import numpy as np
    from audio_diffusion_torch.data import wav_write

    rs = np.random.default_rng(17)
    wavs = root / "wavs"
    wavs.mkdir()
    t = np.arange(frames) / 48000.0
    for i in range(files):
        tone = 0.3 * np.sin(2 * np.pi * (110.0 * (i + 1)) * t)
        audio = tone + 0.05 * rs.standard_normal((2, frames))
        wav_write(wavs / f"take_{i}.wav", audio.astype(np.float32), 48000)
    return wavs


def trainer_state_equal(a, b):
    """The names of the tensors of two Trainer.state_dict()s that differ
    (parameters, EMA, Adam's moments and count)."""
    import torch

    bad = [f"params/{n}" for n in a["params"]
           if not torch.equal(a["params"][n], b["params"][n])]
    bad += [f"ema/{n}" for n in a["ema"]
            if not torch.equal(a["ema"][n], b["ema"][n])]
    bad += [f"optimizer/{n}/{k}" for n, st in a["optimizer"].items()
            for k, v in st.items() if not torch.equal(v, b["optimizer"][n][k])]
    if a["step"] != b["step"] or set(a["optimizer"]) != set(b["optimizer"]):
        bad.append("step or optimizer names")
    return bad


def phase_trainer_flagship(torch, root: Path):
    """The Trainer on the flagship (``presets.UNCONDITIONAL_48K``, bf16,
    batch 8): a synthesized corpus of 8 stereo PCM16 files of 2^19 frames
    in a ``DeviceCorpus`` (crop 2^18); warmup 2 and cosine over 8 steps,
    ``max_grad_norm`` 1.0, EMA 0.999, a checkpoint at step 2 (one kept).
    The resume gate: 3 straight steps on ``batch_at(0..2)`` against 2
    steps, the checkpoint, a fresh model and Trainer restored from it, and
    step 3 on ``batch_at(2)`` — the same bits in the parameters, the EMA
    and the moments. Then ms per step (median of 3 after a warm-up) with
    the ``DeviceCorpus`` and with the host ``AudioDataset`` on the same
    files, peak memory, the item launches (counts set to 0 just before the
    3 straight steps) and a profile of one step. Returns the launches
    (forward, backward) of the 3 straight steps."""
    from audio_diffusion_torch.data import AudioDataset, DeviceCorpus
    from audio_diffusion_torch.ops.kernels import resnet
    from audio_diffusion_torch.train import Trainer, TrainerConfig

    item = resnet.fused_resnet_item
    wavs = synth_corpus(root)
    dc = DeviceCorpus(wavs, crop_frames=LENGTH, batch_size=TRAIN_BATCH)
    ckpt = root / "ckpts"
    cfg = dict(learning_rate=1e-4, lr_schedule="cosine", warmup_steps=2,
               total_steps=8, max_grad_norm=1.0, ema_decay=0.999,
               checkpoint_every=2, max_checkpoints=1, log_every=1000)
    timings = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                timings[name] = time.perf_counter() - t0
        return wrapper

    def step_on(trainer, step):
        trainer.fit(iter([dc.batch_at(step)]), num_steps=1)

    # The interrupted run: 2 steps and the checkpoint, then the model freed.
    model = build_flagship(torch)
    trainer = Trainer(model, TrainerConfig(checkpoint_dir=str(ckpt), **cfg),
                      log_fn=lambda s: None)
    with mock.patch.object(Trainer, "state_dict",
                           timed("host_copy_s", Trainer.state_dict)), \
            mock.patch.object(Trainer, "_write",
                              timed("write_s", Trainer._write)):
        for step in range(2):
            step_on(trainer, step)
    saved = sorted(p.name for p in ckpt.iterdir())
    size = (ckpt / "2" / "state.pt").stat().st_size
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    model = build_flagship(torch)
    trainer = Trainer(model, TrainerConfig(checkpoint_dir=str(ckpt), **cfg),
                      log_fn=lambda s: None)
    t0 = time.perf_counter()
    restored = trainer.restore_latest()
    restore_s = time.perf_counter() - t0
    step_on(trainer, 2)
    resumed = trainer.state_dict()
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)

    # The straight run: the main path, counts set to 0 just before.
    model = build_flagship(torch)
    trainer = Trainer(model, TrainerConfig(**cfg), log_fn=lambda s: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    item.launches = item.backward_launches = 0
    for step in range(3):
        step_on(trainer, step)
    torch.cuda.synchronize()
    launches = (item.launches, item.backward_launches)
    straight = trainer.state_dict()
    differ = trainer_state_equal(straight, resumed)
    del resumed

    def ms_per_step(feed):
        step_on_feed = lambda: trainer.fit(feed, num_steps=1)  # noqa: E731
        step_on_feed()  # warm-up
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_on_feed()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return sorted(runs)[1], runs

    device_ms, device_runs = ms_per_step(iter(dc))
    host = AudioDataset(wavs, crop_frames=LENGTH, batch_size=TRAIN_BATCH)
    host_feed = iter(host)
    host_ms_, host_runs = ms_per_step(host_feed)
    host_feed.close()
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in trainer.fit(
        iter(dc), num_steps=1).items()}
    emit(dict(phase="trainer_flagship", batch=TRAIN_BATCH, length=LENGTH,
              dtype="bfloat16", trainer=cfg,
              corpus=dict(files=len(dc.files), frames=dc.frames[0],
                          dtype=str(dc.dtype), device_bytes=dc.device_bytes),
              checkpoint=dict(saved=saved, bytes=size, gb=size / 1e9,
                              host_copy_s=timings.get("host_copy_s"),
                              write_s=timings.get("write_s"),
                              restored_step=restored, restore_s=restore_s),
              resume_bit_exact=not differ, differing=differ[:5],
              forward_item_launches=launches[0],
              backward_item_launches=launches[1],
              expected_launches=2 * sum(ITEMS) * 3,
              ms_per_step_device_corpus=device_ms,
              ms_per_step_device_corpus_runs=device_runs,
              ms_per_step_host_dataset=host_ms_,
              ms_per_step_host_dataset_runs=host_runs,
              host_dataset_dtype=str(host.dtype),
              samples_per_s=TRAIN_BATCH / device_ms * 1e3,
              peak_memory_bytes=peak, peak_gb=peak / 1e9,
              metrics=metrics, step=straight["step"]))
    if restored != 2 or saved != ["2"]:
        raise AssertionError(f"trainer_flagship: checkpoints {saved}, "
                             f"restored step {restored}")
    if differ:
        raise AssertionError(f"trainer_flagship: the resumed run differs "
                             f"from the straight one in {len(differ)} "
                             f"tensors, first {differ[:5]}")
    if launches != (2 * sum(ITEMS) * 3,) * 2:
        raise AssertionError(f"trainer_flagship: {launches} item launches "
                             "in 3 steps, expected 42 each per step")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"trainer_flagship: metrics {metrics}")
    phase_profile("trainer_flagship_profile",
                  lambda: trainer.fit(iter(dc), num_steps=1), steps=1,
                  batch=TRAIN_BATCH)
    del model, trainer, straight
    return launches


def phase_remat_flagship(torch):
    """``use_remat=True`` on the flagship (bf16, batch 8), full recompute
    and with ``"dots_with_no_batch_dims_saveable"``: the loss and every
    gradient against the net without remat on the same parameters, batch
    and generator (bit-equal); then Adam steps as ``phase_train`` takes
    them (a warm-up, 3 timed): ms per step, peak memory and item launches
    per step (the forward kernel runs again in the backward: 84 forward,
    42 backward). Returns {variant: (forward, backward) launches per
    step}."""
    from audio_diffusion_torch import make_train_step
    from audio_diffusion_torch.ops.kernels import resnet

    item = resnet.fused_resnet_item
    batch = host_audio(45, TRAIN_BATCH)
    per_pass = 2 * sum(ITEMS)
    base = None
    rows, counts = [], {}
    for name, remat in [("none", {}), ("full", dict(use_remat=True)),
                        ("dots", dict(use_remat=True, remat_policy=(
                            "dots_with_no_batch_dims_saveable")))]:
        from audio_diffusion_torch import DiffusionModel, UNetV0, presets

        model = DiffusionModel(net_t=UNetV0, **presets.UNCONDITIONAL_48K,
                               dtype=torch.bfloat16, seed=0, **remat)
        fill_zero_params(model)
        leaves = list(model.params.values())
        gen = torch.Generator(device="cuda")
        loss = model.loss(model.params, gen.manual_seed(46), batch)
        grads = torch.autograd.grad(loss, leaves)
        if base is None:
            base = (loss.detach(), grads)
            equal, differ = True, []
        else:
            differ = [n for n, g, g0 in zip(model.params, grads, base[1])
                      if not torch.equal(g, g0)]
            equal = torch.equal(loss, base[0]) and not differ
        del grads
        init, step = make_train_step(
            model.loss, functools.partial(torch.optim.Adam, lr=1e-4))
        state = init(model.params, gen.manual_seed(47))
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        item.launches = item.backward_launches = 0
        runs = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        counts[name] = (item.launches // TRAIN_STEPS,
                        item.backward_launches // TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        rows.append(dict(remat=name, loss=loss.item(), bit_equal=equal,
                         differing=differ[:5], ms_per_step=sorted(runs)[1],
                         ms_per_step_runs=runs,
                         forward_launches_per_step=counts[name][0],
                         backward_launches_per_step=counts[name][1],
                         peak_memory_bytes=peak, peak_gb=peak / 1e9))
        del model, state, leaves, loss
        gc.collect()
        torch.cuda.empty_cache()
    emit(dict(phase="remat_flagship", batch=TRAIN_BATCH, length=LENGTH,
              dtype="bfloat16", rows=rows))
    for row in rows:
        want = (2 * per_pass if row["remat"] != "none" else per_pass,
                per_pass)
        got = (row["forward_launches_per_step"],
               row["backward_launches_per_step"])
        if got != want:
            raise AssertionError(f"remat_flagship {row['remat']}: {got} "
                                 f"item launches per step, expected {want}")
        if not row["bit_equal"]:
            raise AssertionError(f"remat_flagship {row['remat']}: loss or "
                                 f"gradients differ ({row['differing']})")
    return counts


def phase_cli_train_sample(root: Path):
    """``python -m audio_diffusion_torch`` as a user runs it, on the card:
    ``train`` (the flagship preset, 2 steps at batch 8, crop 2^18, the
    corpus on the device), ``sample`` (one 50-step sample of 2^18) and
    ``info --params``; each must exit 0, the WAV read back as finite stereo
    of 2^18 frames, ``info`` count 366.6 M parameters."""
    import numpy as np
    from audio_diffusion_torch.data import wav_probe, wav_read

    wavs = root / "wavs"
    if not wavs.exists():
        synth_corpus(root)
    run, smp = root / "run", root / "samples"
    repo = Path(__file__).resolve().parent
    commands = {
        "train": ["train", "--data", str(wavs), "--preset",
                  "UNCONDITIONAL_48K", "--steps", "2", "--batch",
                  str(TRAIN_BATCH), "--crop", str(LENGTH),
                  "--data-placement", "device", "--log-every", "1",
                  "--out", str(run)],
        "sample": ["sample", "--model", str(run / "model"), "--num", "1",
                   "--steps", str(NUM_STEPS), "--length", str(LENGTH),
                   "--out", str(smp)],
        "info": ["info", "--run", str(run), "--params"],
    }
    results = {}
    for name, argv in commands.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "audio_diffusion_torch", *argv],
            cwd=repo, capture_output=True, text=True, timeout=600)
        results[name] = dict(rc=proc.returncode,
                             seconds=time.perf_counter() - t0,
                             stdout=proc.stdout.strip().splitlines()[-6:],
                             stderr=proc.stderr.strip().splitlines()[-6:])
        if proc.returncode != 0:
            emit(dict(phase="cli_train_sample", **results))
            raise AssertionError(f"cli_train_sample: {name} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
    wav = smp / "sample_0.wav"
    audio = wav_read(wav)
    info = [ln for ln in results["info"]["stdout"]
            if ln.startswith("parameters:")]
    emit(dict(phase="cli_train_sample", **results,
              wav=dict(probe=list(wav_probe(wav)),
                       finite=bool(np.isfinite(audio).all()),
                       std=float(audio.std())),
              parameters_line=info))
    if wav_probe(wav)[:3] != (2, 48000, LENGTH) or not np.isfinite(
            audio).all():
        raise AssertionError(f"cli_train_sample: {wav} is "
                             f"{wav_probe(wav)}, finite "
                             f"{np.isfinite(audio).all()}")
    if not info or not info[0].startswith("parameters: 366.6 M"):
        raise AssertionError(f"cli_train_sample: info printed {info}")


def phase_kernel_vs_plain_batch8(flush):
    """The forward kernel at a served batch's shape: each flagship level's
    item at batch 8 in bf16, the inference branch (nothing kept), against
    the plain version with the batch-1 bars, a bit-identical rerun and the
    conv's plan. Returns the rows."""
    import torch

    return forward_rows(flush, "kernel_vs_plain_batch8", LEVELS,
                        ((torch.bfloat16, SERVE_BATCH),), seed=10)


def item_stand_in(route):
    """A stand-in for ``fused_resnet_item`` that skips its input checks and
    runs the item's inference forward through the registered operator (a
    trace's route) or the launcher called directly (eager code's), with the
    wrapper's counters: the two differ by the dispatcher alone."""
    import torch
    from audio_diffusion_torch.ops.kernels import resnet

    def item(x, *params, groups, eps, use_modulation):
        params = list(params) + [None] * (12 - len(params))
        if route == "operator":
            return torch.ops.audio_diffusion_torch.fused_resnet_item(
                x, *params, groups, eps, use_modulation)
        return resnet._launch_forward(x, params, groups, eps, use_modulation,
                                      keep=False)[0]

    item.launches = item.backward_launches = 0
    return item


def phase_operator_dispatch(model, noise):
    """What the registered operator's dispatch would add to eager code:
    the host's µs per item call through the launcher, through the operator
    and through ``fused_resnet_item`` itself (its input checks, then the
    launcher; 100 calls of the level-8 item at batch 1, in turns, four
    rounds, the first dropped), and ms per sampling step at batch 1 with
    every item through the launcher and through the operator (both
    without the checks), in turns (launcher, operator, operator, launcher,
    twice). The two routes must give the same bits. Returns the row."""
    import torch
    from audio_diffusion_torch.ops.kernels import resnet

    c, length = LEVELS[-1]
    args = item_inputs(c, length, torch.bfloat16,
                       torch.Generator(device="cuda").manual_seed(40))
    kw = dict(groups=GROUPS, eps=1e-5, use_modulation=True)
    stand_in = {r: item_stand_in(r) for r in ("launcher", "operator")}
    calls = {"launcher": lambda: stand_in["launcher"](*args, **kw),
             "operator": lambda: stand_in["operator"](*args, **kw),
             "wrapper": lambda: resnet.fused_resnet_item(*args, **kw)}
    call_us = {r: [] for r in calls}
    with torch.inference_mode():
        for route in tuple(calls) * 4:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                calls[route]()
            call_us[route].append((time.perf_counter() - t0) * 1e4)
            torch.cuda.synchronize()
    call_us = {k: sorted(v[1:])[1] for k, v in call_us.items()}
    steps = 20
    runs = {"launcher": [], "operator": []}
    outs = {}
    model.sample(noise, num_steps=2)
    for route in ("launcher", "operator", "operator", "launcher") * 2:
        with mock.patch.object(resnet, "fused_resnet_item", stand_in[route]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route] = model.sample(noise, num_steps=steps)
            torch.cuda.synchronize()
        runs[route].append((time.perf_counter() - t0) * 1e3 / steps)
    med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    spread = {k: max(v) - min(v) for k, v in runs.items()}
    row = dict(phase="operator_dispatch", steps=steps, batch=1,
               ms_per_step=med, ms_per_step_runs=runs, spread_ms=spread,
               operator_minus_launcher_ms=med["operator"] - med["launcher"],
               host_us_per_item_call=call_us,
               dispatch_ms_per_step=(call_us["operator"]
                                     - call_us["launcher"])
               * 2 * sum(ITEMS) / 1e3,
               routes_bit_equal=bool(torch.equal(outs["launcher"],
                                                 outs["operator"])))
    emit(row)
    if not row["routes_bit_equal"]:
        raise AssertionError("operator_dispatch: the operator and the "
                             "launcher give other bits")
    return row


def phase_quant_small_reference():
    """Quantized weights on the small net, card vs CPU (f32): int8 and int4
    (served through ``unpack_int4_leaves``) quantized on each device from
    the same weights: the int8 values, the scales and the dequantized
    leaves bit-equal; a 4-step quantized sample from host-made noise within
    the small reference's bar."""
    import torch
    from audio_diffusion_torch import (DiffusionModel, UNetV0,
                                       dequantize_params, quantize_params,
                                       unpack_int4_leaves)

    cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **SMALL_CFG)
    fill_zero_params(cpu)
    gpu = DiffusionModel(net_t=UNetV0, **SMALL_CFG)
    gpu.net.module.load_state_dict(cpu.net.module.state_dict())
    noise = torch.randn(1, 2, 256, generator=torch.Generator().manual_seed(3))
    errs, quantized = {}, 0
    for bits in (8, 4):
        q_cpu = unpack_int4_leaves(quantize_params(cpu.params, min_size=256,
                                                   bits=bits))
        q_gpu = unpack_int4_leaves(quantize_params(gpu.params, min_size=256,
                                                   bits=bits))
        d_cpu, d_gpu = dequantize_params(q_cpu), dequantize_params(q_gpu)
        for name, v in q_cpu.items():
            if hasattr(v, "qscale"):
                quantized += 1
                same = (torch.equal(q_gpu[name].q.cpu(), v.q)
                        and torch.equal(q_gpu[name].qscale.cpu(), v.qscale)
                        and torch.equal(d_gpu[name].cpu(), d_cpu[name]))
                if not same:
                    raise AssertionError(f"quant_small_reference int{bits} "
                                         f"{name}: card and CPU differ")
        want = cpu.sample(noise, num_steps=4, params=q_cpu)
        got = gpu.sample(noise, num_steps=4, params=q_gpu).cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"quant_small_reference int{bits}: "
                                 "non-finite values")
        errs[f"int{bits}"] = (got - want).abs().max().item()
    emit(dict(phase="quant_small_reference", steps=4, dtype="float32",
              quantized_leaves=quantized, leaves_bit_equal=True,
              max_abs_err=errs, tolerance=1e-3))
    if not max(errs.values()) < 1e-3:
        raise AssertionError(f"quant_small_reference: max-abs {errs}")


def phase_serve_flagship(model):
    """The batching service on the flagship (bf16): ``GenerationService(
    batch_size=8, num_steps=50, result_format="pcm16")``, 16 seed requests
    of 2^18 stereo, then 3 more (seed 3 again among them) that make a
    padded batch. Counts set to 0 just before the 19, read after: 42 x 50
    launches per batch. Requests and samples per second, ms per step at
    batch 8, latency per request, occupancy, padding, peak memory. Gates:
    seed 3 gives the same int16 bits in both batches; ``submit(noise)``
    rows equal ``model.sample`` of the same padded batch (10 steps); an
    ``update_params`` to a second parameter set while a batch is in flight
    fails no request, the batch in flight keeps the first set's bits and
    the next batch takes the second set. Returns the item launches of the
    19 requests."""
    import numpy as np
    import torch
    from audio_diffusion_torch import GenerationService
    from audio_diffusion_torch.ops.kernels import resnet
    from audio_diffusion_torch.serve import to_pcm16

    item = resnet.fused_resnet_item
    gen = torch.Generator(device="cuda").manual_seed(30)
    warm = torch.randn(SERVE_BATCH, 2, LENGTH, device="cuda", generator=gen)
    model.sample(warm, num_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = GenerationService(model, batch_size=SERVE_BATCH,
                            num_steps=NUM_STEPS, result_format="pcm16")
    try:
        done_at = {}

        def submit(seed, tag):
            fut = svc.submit_seed(seed, length=LENGTH)
            fut.add_done_callback(
                lambda f, tag=tag: done_at.setdefault(tag, time.perf_counter()))
            return fut

        seeds = list(range(16)) + [3, 100, 101]
        item.launches = 0
        t0 = time.perf_counter()
        futs = [submit(s, i) for i, s in enumerate(seeds[:16])]
        futs += [submit(s, 16 + i) for i, s in enumerate(seeds[16:])]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = item.launches
        stats = svc.stats
        peak = torch.cuda.max_memory_allocated()
        lat = sorted(done_at[i] - t0 for i in range(len(seeds)))
        batches = stats["batches"]
        if any(o.dtype != np.int16 or o.shape != (2, LENGTH) for o in outs):
            raise AssertionError("serve_flagship: a result is not int16 "
                                 f"[2, {LENGTH}]")
        same_seed = bool(np.array_equal(outs[3], outs[16]))

        # submit(noise): rows equal model.sample of the same padded batch.
        rs = np.random.default_rng(31)
        noises = [rs.standard_normal((2, LENGTH)).astype(np.float32)
                  for _ in range(3)]
        got = np.stack([f.result(timeout=600) for f in
                        [svc.submit(n, num_steps=10) for n in noises]])
        padded = torch.from_numpy(np.stack(noises + [noises[-1]] * 5))
        want = to_pcm16(model.sample(padded.cuda(), num_steps=10)[:3]).cpu()
        rows_equal = bool(np.array_equal(got, want.numpy()))

        # update_params while a batch is in flight.
        second = {k: (v.detach() * 0.999) for k, v in model.params.items()}
        old = [svc.submit_seed(s, length=LENGTH) for s in range(8)]
        time.sleep(0.5)  # the batch is running
        t1 = time.perf_counter()
        svc.update_params(second)
        swap_ms = (time.perf_counter() - t1) * 1e3
        new = [svc.submit_seed(s, length=LENGTH) for s in range(8)]
        old_out = [f.result(timeout=600) for f in old]
        new_out = [f.result(timeout=600) for f in new]
        kept_old = all(np.array_equal(a, b) for a, b in zip(old_out, outs))
        took_new = any(not np.array_equal(a, b)
                       for a, b in zip(new_out, outs))
        del second
    finally:
        svc.close()
    phase_profile("serve_profile", lambda: model.sample(warm, num_steps=2),
                  steps=2, batch=SERVE_BATCH)
    steps_run = batches * NUM_STEPS
    row = dict(phase="serve_flagship", batch_size=SERVE_BATCH,
               steps=NUM_STEPS, length=LENGTH, dtype="bfloat16",
               result_format="pcm16", seconds=wall, requests_per_s=len(seeds) / wall,
               samples_per_s=len(seeds) / wall,
               device_rows_per_s=batches * SERVE_BATCH / wall,
               ms_per_step_batch8=wall * 1e3 / steps_run,
               latency_s=dict(median=lat[len(lat) // 2], max=lat[-1],
                              min=lat[0]),
               **stats, peak_memory_bytes=peak, item_launches=launches,
               expected_launches=2 * sum(ITEMS) * NUM_STEPS * batches,
               same_seed_two_batches_bit_equal=same_seed,
               submit_rows_equal_model_sample=rows_equal,
               update_params_ms=swap_ms, in_flight_kept_old=kept_old,
               next_batch_took_new=took_new)
    emit(row)
    if batches != 3 or stats["padded_slots"] != 5:
        raise AssertionError(f"serve_flagship: {stats}, expected 3 batches "
                             "and 5 padded slots")
    if launches != row["expected_launches"]:
        raise AssertionError(f"serve_flagship: {launches} item launches, "
                             f"expected {row['expected_launches']}")
    for key in ("same_seed_two_batches_bit_equal",
                "submit_rows_equal_model_sample", "in_flight_kept_old",
                "next_batch_took_new"):
        if not row[key]:
            raise AssertionError(f"serve_flagship: {key} failed")
    return launches


def phase_quant_flagship(model, noise):
    """int8 weight-only quantization of the flagship (``quantize_params``,
    bf16 compute): a 50-step sample at batch 1 with the int8 dict and one
    without, in this call; ms per step of each, peak memory, the bytes at
    rest (f32 masters, int8, int4), the int8 sample's relative RMS error
    against the unquantized one, 2,100 launches per sample. Returns the
    int8 sample's launches."""
    import torch
    from audio_diffusion_torch import quantize_params
    from audio_diffusion_torch.ops.quant import storage_bytes

    q8 = quantize_params(model.params)
    q4 = quantize_params(model.params, bits=4)
    at_rest = dict(f32=storage_bytes(model.params), int8=storage_bytes(q8),
                   int4=storage_bytes(q4),
                   quantized_leaves=sum(hasattr(v, "qscale")
                                        for v in q8.values()),
                   leaves=len(q8))
    del q4
    ref, ref_launches, ref_ms, ref_peak = sample_runs(model, noise)
    out, launches, q_ms, q_peak = sample_runs(model, noise, params=q8)
    rel_rms = ((out.float() - ref.float()).norm()
               / ref.float().norm()).item()
    row = dict(phase="quant_flagship", bits=8, steps=NUM_STEPS, batch=1,
               dtype="bfloat16", ms_per_step=dict(
                   bf16=sorted(ref_ms)[1], int8=sorted(q_ms)[1]),
               ms_per_step_runs=dict(bf16=ref_ms, int8=q_ms),
               peak_memory_bytes=dict(bf16=ref_peak, int8=q_peak),
               bytes_at_rest=at_rest, rel_rms_err=rel_rms,
               item_launches=dict(bf16=ref_launches, int8=launches),
               finite=bool(torch.isfinite(out).all()))
    emit(row)
    want = 2 * sum(ITEMS) * NUM_STEPS
    if launches != want or ref_launches != want:
        raise AssertionError(f"quant_flagship: launches {launches}, "
                             f"{ref_launches}, expected {want}")
    if not row["finite"] or not rel_rms < 0.5:
        raise AssertionError(f"quant_flagship: rel RMS {rel_rms}")
    return launches


def phase_export_flagship(model, noise, root: Path):
    """``export_sampler`` of the flagship at [1, 2, 2^18], 50 steps: the
    seconds to export and to load, the artifact's bytes; the artifact's
    sample against ``model.sample`` bit for bit, ms per step of each,
    2,100 launches (counts set to 0 just before the artifact's sample);
    an ``ArtifactSampler`` behind a ``GenerationService`` giving the same
    int16 bits. Returns the artifact's launches."""
    import numpy as np
    import torch
    from audio_diffusion_torch import (ArtifactSampler, GenerationService,
                                       export_sampler)
    from audio_diffusion_torch.ops.kernels import resnet
    from audio_diffusion_torch.serve import to_pcm16

    item = resnet.fused_resnet_item
    art = root / "artifact"
    t0 = time.perf_counter()
    manifest = export_sampler(model, art, length=LENGTH, batch_size=1,
                              num_steps=NUM_STEPS, sample_rate=48000)
    export_s = time.perf_counter() - t0
    nbytes = {p.name: p.stat().st_size for p in art.iterdir()}
    program = torch.export.load(art / "step.pt2")
    op_nodes = sum("fused_resnet_item" in str(n.target)
                   for n in program.graph.nodes)
    del program
    t0 = time.perf_counter()
    sampler = ArtifactSampler(art, model.params)
    load_s = time.perf_counter() - t0
    want, _, live_ms, _ = sample_runs(model, noise)
    times = []
    sampler.sample(noise)  # warm-up
    for run in range(3):
        if run == 0:
            item.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sampler.sample(noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / NUM_STEPS)
        if run == 0:
            launches = item.launches
    bit_equal = bool(torch.equal(got, want))
    with GenerationService(sampler, num_steps=NUM_STEPS, batch_size=1,
                           result_format="pcm16") as svc:
        served = svc.submit(noise[0].cpu()).result(timeout=600)
    served_equal = bool(np.array_equal(served,
                                       to_pcm16(want[0]).cpu().numpy()))
    row = dict(phase="export_flagship", shape=manifest["noise_shape"],
               steps=NUM_STEPS, dtype="bfloat16", export_s=export_s,
               load_s=load_s, artifact_bytes=nbytes,
               graph_nodes=manifest["graph_nodes"],
               pruned_nodes=manifest["pruned_nodes"],
               operator_nodes=op_nodes,
               ms_per_step=dict(live=sorted(live_ms)[1],
                                artifact=sorted(times)[1]),
               ms_per_step_runs=dict(live=live_ms, artifact=times),
               bit_equal=bit_equal, item_launches=launches,
               served_bit_equal=served_equal)
    emit(row)
    if op_nodes != 2 * sum(ITEMS):
        raise AssertionError(f"export_flagship: {op_nodes} operator nodes")
    if launches != 2 * sum(ITEMS) * NUM_STEPS:
        raise AssertionError(f"export_flagship: {launches} launches")
    if not (bit_equal and served_equal):
        raise AssertionError("export_flagship: the artifact's sample "
                             "differs from model.sample")
    return launches


def wav_pcm(body: bytes):
    """(channels, rate, int16 frames) of a PCM16 WAV body."""
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        if w.getsampwidth() != 2:
            raise AssertionError("not a PCM16 WAV")
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        return w.getnchannels(), w.getframerate(), pcm.reshape(
            -1, w.getnchannels()).T


def serve_process(argv, requests, timeout=900):
    """``python -m audio_diffusion_torch serve`` in a subprocess on a free
    port: waits for its address, POSTs ``requests`` (JSON bodies) to
    /generate concurrently, reads /stats, stops it with SIGTERM. Returns
    (seconds to start, to the first response and per request, the bodies,
    /stats, the exit code, the last lines of its output)."""
    import signal
    import urllib.request

    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "audio_diffusion_torch", "serve", *argv,
         "--port", "0"], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        for _ in range(20):  # the address line, after any warnings
            line = proc.stdout.readline()
            if "http://" in line or not line:
                break
        if "http://" not in line:
            raise AssertionError(f"serve did not start: {line!r} "
                                 f"{proc.stderr.read()[-2000:]}")
        start_s = time.perf_counter() - t0
        base = line.strip().rsplit(" ", 1)[-1]

        def post(body):
            req = urllib.request.Request(
                base + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read(), time.perf_counter() - t

        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(requests)) as pool:
            results = list(pool.map(post, requests))
        first_s = min(s for _, s in results)
        with urllib.request.urlopen(base + "/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        wall_s = time.perf_counter() - t1
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        out = proc.stdout.read().strip().splitlines()[-3:]
        return dict(start_s=start_s, first_response_s=first_s,
                    request_s=[s for _, s in results],
                    wall_s=wall_s), [b for b, _ in results], stats, rc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_cli_serve(root: Path):
    """``serve`` and ``export`` as a user runs them, on the run that
    ``phase_cli_train_sample`` trained: ``serve --model`` with 4 concurrent
    ``POST /generate`` of 2^18 frames (one padded batch of 8), each a PCM16
    stereo WAV of 2^18 frames, /stats showing one batch; SIGTERM drains
    and exits 0. Then ``export`` and ``serve --artifact`` with one
    request."""
    import numpy as np

    run = root / "run"
    repo = Path(__file__).resolve().parent
    times, bodies, stats, rc, out = serve_process(
        ["--model", str(run / "model")],
        [{"seed": k, "length": LENGTH} for k in range(4)])
    shapes = [wav_pcm(b)[:2] + (wav_pcm(b)[2].shape,) for b in bodies]
    ok = all(s == (2, 48000, (2, LENGTH)) for s in shapes)
    distinct = len({bytes(b) for b in bodies}) == 4
    row = dict(phase="cli_serve", serve=dict(**times, stats=stats, rc=rc,
                                             wavs_ok=ok, distinct=distinct,
                                             last_lines=out))
    if not (ok and distinct and rc == 0 and stats["requests"] == 4
            and stats["batches"] == 1):
        emit(row)
        raise AssertionError(f"cli_serve: serve {shapes}, rc {rc}, {stats}")
    art = root / "cli_artifact"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "audio_diffusion_torch", "export", "--model",
         str(run / "model"), "--out", str(art), "--length", str(LENGTH),
         "--steps", str(NUM_STEPS)], cwd=repo, capture_output=True,
        text=True, timeout=900)
    row["export"] = dict(rc=proc.returncode,
                         seconds=time.perf_counter() - t0,
                         stdout=proc.stdout.strip().splitlines()[-2:])
    if proc.returncode != 0:
        emit(row)
        raise AssertionError(f"cli_serve: export exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    times, bodies, stats, rc, out = serve_process(
        ["--model", str(run / "model"), "--artifact", str(art)],
        [{"seed": 7}])
    channels, rate, pcm = wav_pcm(bodies[0])
    ok = (channels, rate, pcm.shape) == (2, 48000, (2, LENGTH))
    row["serve_artifact"] = dict(**times, stats=stats, rc=rc, wav_ok=ok,
                                 nonzero=bool(np.abs(pcm).max() > 0),
                                 last_lines=out)
    emit(row)
    if not (ok and rc == 0 and stats["requests"] == 1):
        raise AssertionError(f"cli_serve: serve --artifact {channels}, "
                             f"{rate}, {pcm.shape}, rc {rc}, {stats}")


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
    emit(dict(phase="build", sources=[KERNEL_SOURCE, CONV_SOURCE,
                                      BACKWARD_SOURCE, WGRAD_SOURCE],
              seconds=time.perf_counter() - t0))

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows, guided_rows = phase_kernel_vs_plain(flush)
    nomod_rows = phase_kernel_vs_plain_nomod(flush)
    bwd_rows, bwd_train_rows = phase_kernel_backward_vs_plain(flush)
    nomod_bwd_rows, nomod_bwd_train_rows = (
        phase_kernel_backward_vs_plain_nomod(flush))
    (enc_rows, batch16_rows, enc_bwd_rows, enc_bwd_train_rows,
     batch16_bwd_rows) = phase_kernel_vs_plain_tasks(flush)
    batch8_rows = phase_kernel_vs_plain_batch8(flush)
    del flush
    phase_small_reference()
    phase_train_small()
    phase_trainer_small_reference()
    phase_cond_small_reference()
    phase_sampler_small_reference()
    phase_dsp_small_reference()
    phase_task_small_reference()
    phase_quant_small_reference()

    model = build_flagship(torch)
    noise = torch.randn(1, 2, LENGTH, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    phase_forward(model, noise)

    # Warm-up, then the main path: counts set to 0 just before, read after;
    # two more timed samples, since host time per step varies between runs.
    out, launches, step_ms, peak = sample_runs(model, noise)
    items_per_forward = 2 * sum(ITEMS)
    emit(dict(phase="sample", steps=NUM_STEPS, length=LENGTH, batch=1,
              dtype="bfloat16", ms_per_step=sorted(step_ms)[1],
              ms_per_step_runs=step_ms, item_launches=launches,
              expected_launches=items_per_forward * NUM_STEPS,
              peak_memory_bytes=peak,
              out_shape=list(out.shape),
              out_std=out.float().std().item()))
    if launches != items_per_forward * NUM_STEPS:
        raise AssertionError(f"{launches} item launches on the main path, "
                             f"expected {items_per_forward * NUM_STEPS}")
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("sample: bad shape or non-finite values")
    phase_profile("profile", lambda: model.sample(noise, num_steps=2),
                  steps=2)
    phase_operator_dispatch(model, noise)

    # Serving on the same net, each path with its own counts: the batching
    # service at batch 8, int8 weights, the exported sampler.
    serve_launches = phase_serve_flagship(model)
    gc.collect()
    torch.cuda.empty_cache()
    quant_launches = phase_quant_flagship(model, noise)
    gc.collect()
    torch.cuda.empty_cache()
    art_root = Path(tempfile.mkdtemp(prefix="chip_smoke_art_"))
    try:
        artifact_launches = phase_export_flagship(model, noise, art_root)
    finally:
        shutil.rmtree(art_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # The other samplers on the same net, each with its own counts: DPM,
    # SDE (eta = 0 against the VSampler sample above), long-form.
    dpm_launches = phase_sample_dpm(model, noise)
    sde_launches = phase_sample_sde(model, noise, out)
    long_launches = phase_longform(model)
    del out

    # The training main path: counts set to 0 inside, just before its steps.
    train_launches = phase_train(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # The text-conditional paths (guided sample, with and without encoder
    # reuse; training with embedding dropout), each with its own counts;
    # then the T5 encoder stack and a guided DPM sample through it.
    model = build_text_model(torch)
    text_launches = phase_sample_text(model, noise)
    phase_attention_profile(model, noise)
    embedding = torch.as_tensor(model.net.text_encoder(CAPTIONS),
                                device=model.device)
    text_train_launches = phase_train(model, "train_text",
                                      embedding=embedding,
                                      embedding_mask_proba=0.1)
    t5_launches = phase_t5_text(model, noise)
    del model, embedding
    gc.collect()
    torch.cuda.empty_cache()

    # The autoregressive model: its sample and its train step, whose items
    # run the no-modulation branch.
    model = build_ar_model(torch)
    ar_launches = phase_ar_sample(model)
    phase_profile("ar_sample_profile",
                  lambda: model.sample(num_items=1, num_chunks=AR_SPLITS + 1,
                                       num_steps=AR_SPLITS), passes=9)
    ar_train_launches = phase_train(model, "ar_train", channels=1,
                                    length=AR_LENGTH)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # The task models, each freed before the next is built: the upsampler,
    # the vocoder (its train step runs the items at batch 16) and the
    # autoencoder (its encoder's items without modulation).
    up_launches, up_train_launches = phase_upsampler(torch)
    gc.collect()
    torch.cuda.empty_cache()
    voc_launches, voc_train_launches = phase_vocoder(torch)
    gc.collect()
    torch.cuda.empty_cache()
    enc_launches, dec_launches, ae_train_launches = phase_autoencoder(torch)
    gc.collect()
    torch.cuda.empty_cache()

    # The Trainer and its data pipeline on the flagship (checkpoint and
    # resume, the corpus on the card and on the host), activation
    # checkpointing, and the command line as a user runs it; the corpus,
    # the checkpoint and the run live in a temporary directory.
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        trainer_launches = phase_trainer_flagship(torch, root)
        gc.collect()
        torch.cuda.empty_cache()
        remat_launches = phase_remat_flagship(torch)
        phase_cli_train_sample(root)
        phase_cli_serve(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

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

    def train_sums(train_rows, prefix):
        keys = ("kernel_ms", "library_ms", "bound_ms") + (
            ("plain_ms",) if all("plain_ms" in r for r in train_rows) else ())
        return {f"{prefix}_{key}": sum(r[key] * r["items_per_forward"]
                                       for r in train_rows)
                for key in keys}

    guided = summary("", "", "", guided_rows)
    nomod = summary("", "", "", nomod_rows)
    nomod_bwd = summary("", "", "", nomod_bwd_rows)
    encoder_fwd = summary("", "", "", enc_rows)
    encoder_bwd = summary("", "", "", enc_bwd_rows)
    batch16_fwd = summary("", "", "", batch16_rows)
    batch8_fwd = summary("", "", "", batch8_rows)
    task_launches = dict(upsampler_launches=up_launches,
                         vocoder_launches=voc_launches,
                         ae_encode_launches=enc_launches,
                         ae_decode_launches=dec_launches)
    per_pass_keys = ("ms", "plain_ms", "bound_ms", "library_ms",
                     "max_abs_err")
    print(smi)
    emit({"kernels": [
        summary("fused_resnet_item", KERNEL_SOURCE, REPLACES, rows,
                launches=launches, train_launches=train_launches[0],
                guided_launches=text_launches[0],
                reuse_launches=text_launches[1],
                text_train_launches=text_train_launches[0],
                dpm_launches=dpm_launches, sde_launches=sde_launches,
                longform_launches=long_launches,
                t5_guided_dpm_launches=t5_launches,
                ar_sample_launches=ar_launches,
                ar_train_launches=ar_train_launches[0],
                **task_launches,
                upsampler_train_launches=up_train_launches[0],
                vocoder_train_launches=voc_train_launches[0],
                ae_train_launches=ae_train_launches[0],
                trainer_launches=trainer_launches[0],
                remat_launches={k: v[0] for k, v in remat_launches.items()},
                conv_source=CONV_SOURCE,
                **{f"guided_batch_{k}": guided[k] for k in per_pass_keys},
                **{f"nomod_{k}": nomod[k] for k in per_pass_keys},
                **{f"encoder_nomod_{k}": encoder_fwd[k]
                   for k in per_pass_keys},
                **{f"batch16_{k}": batch16_fwd[k] for k in per_pass_keys},
                serve_launches=serve_launches, quant_launches=quant_launches,
                artifact_launches=artifact_launches,
                **{f"batch8_{k}": batch8_fwd[k]
                   for k in per_pass_keys + ("host_ms", "bound_by")}),
        summary("fused_resnet_item.backward", BACKWARD_SOURCE,
                BACKWARD_REPLACES, bwd_rows, launches=train_launches[1],
                launches_per_train_step=train_launches[1] // TRAIN_STEPS,
                text_train_launches=text_train_launches[1],
                ar_train_launches=ar_train_launches[1],
                conv_sources=[CONV_SOURCE, WGRAD_SOURCE],
                train_batch_ms=sum(r["kernel_ms"] * r["items_per_forward"]
                                   for r in bwd_train_rows),
                train_batch_library_ms=sum(
                    r["library_ms"] * r["items_per_forward"]
                    for r in bwd_train_rows),
                train_batch_bound_ms=sum(
                    r["bound_ms"] * r["items_per_forward"]
                    for r in bwd_train_rows),
                **{f"nomod_{k}": nomod_bwd[k] for k in per_pass_keys},
                **train_sums(nomod_bwd_train_rows, "nomod_train_batch"),
                upsampler_train_launches=up_train_launches[1],
                vocoder_train_launches=voc_train_launches[1],
                ae_train_launches=ae_train_launches[1],
                trainer_launches=trainer_launches[1],
                remat_launches={k: v[1] for k, v in remat_launches.items()},
                **{f"encoder_nomod_{k}": encoder_bwd[k]
                   for k in per_pass_keys},
                **train_sums(enc_bwd_train_rows, "encoder_nomod_train_batch"),
                **train_sums(batch16_bwd_rows, "batch16"),
                batch16_max_rel_err=max(r["max_rel_err"]
                                        for r in batch16_bwd_rows))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
