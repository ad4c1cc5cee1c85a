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
batch 2), the same with encoder reuse (k = 2), the attention kernels'
launches, and Adam steps at batch 8 with ``embedding=``
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
The attention items' fast routes (``attention_kernels_vs_plain``): the
core's kernel and the LayerNorm's library call (``F.layer_norm``, through
the port's wrapper) against their plain versions at every shape a README
pass runs them at (self-attention at S = N = 1,024 ... 128, cross-attention
at S = 4,096 ... 128 over 64 keys; the uncond pass at batch 1 and 8, the
guided text pass at 2), timed beside the plain version and the library's
call (``F.scaled_dot_product_attention``, which the port does not run: it
rounds elsewhere than the JAX package; and the bare ``F.layer_norm``).
Their rows in the summary, ``attention_core`` (route ``cuda``) and
``layer_norm`` (route ``library``), take the forward row's keys per uncond
pass at batch 1, with ``guided_*`` and ``batch8_*`` for the other two
passes, ``library_host_ms`` and ``max_rel_l2_err``; ``launches`` counts the
flagship's 50-step sample (1,200 cores and 2,400 LayerNorms: 24 attention
items per pass) and ``guided_launches`` the guided text sample's (2,800
and 5,600: 56 items).
Distillation and evaluation: ``artifact_reuse_launches`` counts the
``encoder_reuse=2`` artifact's sample (1,575), ``distill_launches_per_step``
a halving step of ``ProgressiveDistiller`` on the flagship at batch 8
(126 forward: two no-grad teacher passes and the student's; 42 backward),
``distilled_sample_launches`` the 4-step sample after it (168), and
``guidance_distill_launches_per_step`` a guidance step on the
text-conditional flagship (84 forward: the teacher's guided pass at item
batch 16 and the student's at 8; 42 backward). Before them the targets
and a 3-step stage of a small net are held on the card against the CPU
(host-made draws through the replaced ``diffusion.noise`` hooks); the
``CorpusEmbedder`` trains at its defaults on a synthesized corpus and
embeds on the card against the CPU; the CLI's ``distill``, ``sample``
and ``eval`` run as subprocesses.
The 2-D and 3-D nets and ``channel_change="first_item"``: the CPU tests'
small nets on the card against the CPU (``nd_small_reference``: forward,
VSampler and SDE samples with host-made draws, the v-loss's gradients,
the 2-D net's int8 leaves bit-equal); ``dim2_full``, the DDPM LSUN-256
U-Net's widths on 256 x 256 RGB images, and ``dim3_full``, a 3-D net on
16-frame 64 x 64 clips: a 50-step sample at batch 1 (a rerun bit for bit,
no fused-item launch: the item is a 1-D kernel) and Adam steps at batch 8
and 4; ``first_item_flagship``, the flagship whose down path changes width
in each level's first item: 1,800 launches per 50-step sample and 36 + 36
per train step (``first_item_launches``, ``first_item_train_launches``:
the six width-changing items take the plain path by geometry), the six
items' device time per pass beside the fused items'.
Multi-GPU: ``create_mesh()`` under NCCL at world size 1 in this process
(``nccl_world1``: the small net's mesh step bit-equal to the plain step);
then two ranks, child processes of this script that share the card over
gloo (each collective staged through the host; over NCCL too where there
are two cards), after the small references: the staged, length-sharded
item at the nine level shapes, bf16 and f32, against its plain version
and bit for bit against the unsharded kernel (``kernel_sharded_vs_plain``,
with each level's plan, the staged item's time per rank and the halo
copies' device time), and the small net's DP, ZeRO-1 and model-axis steps
and a 4-step length-sharded sample against one rank
(``multi_rank_small_reference``); at the end, the 50-step flagship sample
with the length split over the ranks against the main path's sample
(``length_sharded_flagship``: 2,100 launches per rank, collectives, ms
per step and peak per rank, the first module that diverges from the
whole pass) and the flagship's DP step at global batch 8
(``dp_flagship``: 42 + 42 launches per rank per step, the first loss
against the one-process step's, ZeRO-1's moments, a rerun bit for bit).
The kernels line's ``length_sharded_launches_per_rank`` and
``dp_train_launches_per_rank`` count those. No time taken over gloo on
one card is a multi-GPU speed.
Without a CUDA device it exits with code 1 and prints no result.
The kernel-vs-plain rows run at batch 1 (bf16 and f32) and, in bf16, at the
guided pass's batch of 2 and the served batch of 8, with the same bars.
Serving's bars: quantized leaves on the card bit-equal to the CPU's and a
4-step quantized sample within 1e-3 of the CPU's (f32); the service's rows,
the artifact's sample and a seed in two batches bit for bit; the int8
sample's relative RMS error against bf16 under 0.5 (a sanity bar: its
value is reported).
Distillation's bars: the small net's targets within 1e-3 of the CPU's
(f32); after a 3-step stage the last loss rel 1e-4 and every parameter
within 2·lr per step (Adam's step is about lr·sign(g)); the flagship's
stage moves every parameter (the guidance stage all but the fixed
embedding, which only the teacher's guided pass reads), and a stage
whose feed fails at step 2 leaves ``model.params`` bit-equal. The
embedder's ``embed`` on the card within 1e-4 of the CPU's, unit norm.

Tolerances (kernel vs plain version, same inputs): float32 with TF32 off,
max-abs ≤ 2e-4·max(1, max|y|), sums taken in another order; bfloat16
max-abs ≤ 2^-5·max|y| (four ulps of the largest output: the kernel and the
plain version round at the same points, but a sum that lands on the other
side of a rounding boundary moves conv 1's output by one ulp, and the
modulation's GroupNorm can scale that by up to about two); a second bf16
call on the same inputs must give the same bits (split-K sums its partials
in a fixed order). The attention core in bf16: relative L2 ≤ 2^-10 and
max-abs ≤ 2^-5·max|y| (its sums run in another order, so a probability or
an output may round to the neighbouring bf16 value; logits rounded to bf16
read 4.4e-3 and more); the LayerNorm max-abs ≤ 2^-7·max|y| (one ulp); a
rerun gives the same bits. The full-width
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
import os
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
# The attention core's kernel and the LayerNorm's library call. No Pallas
# kernel: XLA runs both in the JAX package.
ATTENTION_SOURCE = "audio_diffusion_torch/csrc/attention.cu"
LN_SOURCE = "torch.nn.functional.layer_norm"
CORE_REPLACES = "audio_diffusion_tpu/ops/attention.py:31-34 (XLA ops)"
LN_REPLACES = "flax nn.LayerNorm in audio_diffusion_tpu/ops/attention.py (XLA ops)"
# The README nets' attention: 8 heads of 64. The bars against the plain
# versions (tests/test_torch_cuda.py gives their reasons): the core's
# relative L2 error and largest error over the largest output, the
# LayerNorm's largest.
ATTN_HEADS, ATTN_FEATURES = 8, 64
ATTN_REL_L2, ATTN_MAX_ABS, LN_MAX_ABS = 2.0 ** -10, 2.0 ** -5, 2.0 ** -7
# The summary's per-pass keys of a kernel's row.
PER_PASS_KEYS = ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
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
# Distillation: the flagship's halving stage from 8 to 4 steps (its
# targets at N = 4), the guided net's stage at the sample's guidance scale;
# the corpus embedder at its defaults on 16 stereo files of 4 s.
DISTILL_BASE_STEPS = 8
EMBED_FILES, EMBED_SECONDS, EMBED_STEPS = 16, 4, 20
# ms per train step by phase_train's phase name, for the distill phases.
TRAIN_MS = {}
# The 2-D/3-D nets and channel_change="first_item". Small: the CPU tests'
# nets (tests/test_torch_unet2d.py, test_torch_first_item.py). Full width:
# the DDPM LSUN-256 U-Net's widths (Ho et al. 2020, 256 x 256 RGB, GroupNorm
# 32, attention at 16 x 16 and 8 x 8) and a 3-D net on the 16-frame 64 x 64
# clips of Video Diffusion Models (Ho et al. 2022; the 16 frames bound the
# product of the factors); the README flagship with first_item, whose six
# width-changing items (levels 1-5 and 7) take the plain path.
SMALL_ND = dict(in_channels=3, channels=[8, 16, 32], factors=[1, 2, 2],
                items=[1, 2, 1], attentions=[0, 0, 1],
                cross_attentions=[0, 0, 1], context_channels=[0, 8, 0],
                attention_heads=2, attention_features=8, resnet_groups=4,
                modulation_features=16, embedding_features=12)
SMALL_ND_SPATIAL = {2: (16, 16), 3: (8, 16, 16)}
SMALL_FIRST_ITEM = dict(in_channels=2, channels=[8, 16, 32],
                        factors=[1, 2, 2], items=[1, 2, 1],
                        modulation_features=32, lane_fold=False,
                        channel_change="first_item")
DIM2_FULL = dict(in_channels=3, channels=[128, 128, 256, 256, 512, 512],
                 factors=[1, 2, 2, 2, 2, 2], items=[2] * 6,
                 attentions=[0, 0, 0, 0, 1, 1], attention_heads=8,
                 attention_features=64, resnet_groups=32,
                 modulation_features=512)
DIM2_SHAPE, DIM2_TRAIN_BATCH = (3, 256, 256), 8
DIM3_FULL = dict(in_channels=3, channels=[64, 128, 256, 512],
                 factors=[1, 2, 2, 2], items=[2] * 4, attentions=[0, 0, 0, 1],
                 attention_heads=8, attention_features=64, resnet_groups=32,
                 modulation_features=256)
DIM3_SHAPE, DIM3_TRAIN_BATCH = (3, 16, 64, 64), 4
FIRST_ITEM_SHORTCUTS = 6


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


def attention_shapes(cross: bool):
    """The attention items of one pass of the README nets: (kind, C, S, N,
    items per pass), self-attention at the levels of ``attentions``, and
    with ``cross`` the text net's cross-attention over the embedding's keys
    at the levels of ``cross_attentions``; each level's items down and up."""
    from audio_diffusion_torch import presets

    cfg = presets.TEXT_CONDITIONAL_48K
    shapes = [("self", c, length, length, 2 * n)
              for (c, length), n, a in zip(LEVELS, ITEMS, cfg["attentions"])
              if a]
    if cross:
        shapes += [("cross", c, length, cfg["embedding_max_length"], 2 * n)
                   for (c, length), n, a in zip(LEVELS, ITEMS,
                                                cfg["cross_attentions"])
                   if a]
    return shapes


def attention_item_rows(flush, shape, batch, gen):
    """The attention core and the LayerNorm of one attention item's shape at
    ``batch``, bf16, inputs as the sampling path gives them (q, k and v
    chunks of the packed projection for self-attention, the embedding's
    keys for cross-attention; LayerNorm parameters cast to bf16): each fast
    route (the core's kernel, the LayerNorm's ``F.layer_norm`` through the
    port's wrapper) against its plain version (errors, a rerun's bits) and
    timed beside it and beside the library's call (``F.scaled_dot_product_
    attention``, timed only; the bare ``F.layer_norm``). Returns (core row,
    LayerNorm row)."""
    import torch
    import torch.nn.functional as F
    from audio_diffusion_torch.ops.kernels.attention import (
        attention_core, attention_core_reference, layer_norm,
        layer_norm_reference)

    kind, c, s, n, items = shape
    h, d = ATTN_HEADS, ATTN_FEATURES
    bf16 = torch.bfloat16

    def f(*shape, scale=1.0, offset=0.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                + offset).to(bf16)

    if kind == "self":
        q, k, v = f(batch, s, 3 * h * d).chunk(3, dim=-1)
    else:
        q, k, v = f(batch, s, h * d), f(batch, n, h * d), f(batch, n, h * d)
    x = f(batch, s, c, scale=3.0, offset=0.5)
    scale, bias = f(c, scale=0.2, offset=1.0), f(c, scale=0.2)
    qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2) for t in (q, k, v))
    calls = {
        "attention_core": (lambda: attention_core(q, k, v, h),
                           lambda: attention_core_reference(q, k, v, h),
                           lambda: F.scaled_dot_product_attention(qh, kh, vh)),
        "layer_norm": (lambda: layer_norm(x, scale, bias, 1e-6, bf16),
                       lambda: layer_norm_reference(x, scale, bias, 1e-6,
                                                    bf16),
                       lambda: F.layer_norm(x, (c,), scale, bias, 1e-6))}
    core_flops = 4 * batch * h * s * n * d
    sizes = {"attention_core": (2 * (2 * batch * s + 2 * batch * n) * h * d,
                                core_flops, items),
             "layer_norm": (2 * (2 * batch * s * c + 2 * c), 0, 2 * items)}
    rows = []
    for name, (kernel, plain, library) in calls.items():
        with torch.inference_mode():
            got, again, want = kernel(), kernel(), plain()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {kind} S={s} batch {batch}: two "
                                     "calls on the same inputs differ")
            diff, want = got.float() - want.float(), want.float()
            err, ymax = diff.abs().max().item(), want.abs().max().item()
            rel = (diff.norm() / want.norm()).item()
            times = {key: cuda_ms(fn, flush) for key, fn in
                     (("kernel_ms", kernel), ("plain_ms", plain),
                      ("library_ms", library))}
            hosts = {key: sorted(host_ms(fn) for _ in range(5))[2]
                     for key, fn in (("kernel_host_ms", kernel),
                                     ("library_host_ms", library))}
        nbytes, flops, per_pass = sizes[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        row = dict(phase="attention_kernels_vs_plain", kernel=name, kind=kind,
                   channels=c, length=s, keys=n, batch=batch, dtype="bfloat16",
                   max_abs_err=err, max_abs_out=ymax, max_rel_err=err / ymax,
                   rel_l2_err=rel, bit_identical_rerun=True, **times, **hosts,
                   bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   bytes=nbytes, flops=flops, items_per_forward=per_pass)
        emit(row)
        if name == "attention_core":
            ok = rel <= ATTN_REL_L2 and err <= ATTN_MAX_ABS * ymax
        else:
            ok = err <= LN_MAX_ABS * ymax
        if not ok:
            raise AssertionError(f"{name} {kind} S={s} batch {batch}: max abs "
                                 f"{err} of {ymax}, relative L2 {rel}")
        rows.append(row)
    return rows


def phase_attention_kernels_vs_plain(flush):
    """The attention items' kernels against their plain versions at every
    shape a README pass runs them at: the uncond pass at batch 1 and at the
    service's 8, the guided text pass (self- and cross-attention) at batch
    2. Returns {pass name: (core rows, LayerNorm rows)}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    passes = {}
    for name, cross, batch in (("uncond", False, 1),
                               ("guided", True, GUIDED_BATCH),
                               ("batch8", False, SERVE_BATCH)):
        pairs = [attention_item_rows(flush, shape, batch, gen)
                 for shape in attention_shapes(cross)]
        passes[name] = tuple(list(rows) for rows in zip(*pairs))
    return passes


def attention_launches(phase, model, noise, cross, **kw):
    """The attention kernels' launches over one ``NUM_STEPS`` sample,
    counters set to 0 just before: one core and two LayerNorms per attention
    item and pass, or an AssertionError. Returns (cores, LayerNorms)."""
    from audio_diffusion_torch.ops.kernels.attention import (attention_core,
                                                             layer_norm)

    items = sum(shape[-1] for shape in attention_shapes(cross))
    attention_core.launches = layer_norm.launches = 0
    model.sample(noise, num_steps=NUM_STEPS, **kw)
    got = (attention_core.launches, layer_norm.launches)
    expected = (items * NUM_STEPS, 2 * items * NUM_STEPS)
    emit(dict(phase=f"{phase}_attention_launches", steps=NUM_STEPS,
              attention_items_per_pass=items, launches=list(got),
              expected_launches=list(expected)))
    if got != expected:
        raise AssertionError(f"{phase}: (cores, LayerNorms) launched {got}, "
                             f"expected {expected}")
    return got


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
    TRAIN_MS[phase] = median
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
    of 2^18 frames, ``info`` count 366.6 M parameters. ``train`` runs on
    ``create_mesh()`` and ``Trainer(mesh=)`` as the JAX CLI does: alone,
    one rank over NCCL."""
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
        if name == "train":
            results["mesh"] = [ln for ln in proc.stdout.splitlines()
                               if ln.startswith("mesh:")]
            if results["mesh"] != ["mesh: data=1 x model=1 over nccl"]:
                raise AssertionError(f"cli_train_sample: train's mesh "
                                     f"{results['mesh']}")
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
    return launches, phase_export_reuse_flagship(model, noise, root)


def phase_export_reuse_flagship(model, noise, root: Path):
    """``export_sampler(..., encoder_reuse=2)`` of the flagship at [1, 2,
    2^18], 50 steps: the full step (which returns the encoder state) and
    the reuse step exported; the artifact's sample against
    ``model.sample(noise, num_steps=50, encoder_reuse=2)`` bit for bit,
    with 1,575 launches (25 full passes of 42, 25 decoder passes of 21;
    counts set to 0 just before the artifact's sample). Returns them."""
    import torch
    from audio_diffusion_torch import ArtifactSampler, export_sampler
    from audio_diffusion_torch.ops.kernels import resnet

    item = resnet.fused_resnet_item
    art = root / "artifact_reuse"
    t0 = time.perf_counter()
    manifest = export_sampler(model, art, length=LENGTH, batch_size=1,
                              num_steps=NUM_STEPS, sample_rate=48000,
                              encoder_reuse=2)
    export_s = time.perf_counter() - t0
    nbytes = {p.name: p.stat().st_size for p in art.iterdir()}
    sampler = ArtifactSampler(art, model.params)
    want = model.sample(noise, num_steps=NUM_STEPS, encoder_reuse=2)
    sampler.sample(noise)  # warm-up
    torch.cuda.synchronize()
    item.launches = 0
    t0 = time.perf_counter()
    got = sampler.sample(noise)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / NUM_STEPS
    launches = item.launches
    bit_equal = bool(torch.equal(got, want))
    expected = NUM_STEPS // 2 * (2 * sum(ITEMS) + sum(ITEMS))
    emit(dict(phase="export_reuse_flagship", shape=manifest["noise_shape"],
              steps=NUM_STEPS, encoder_reuse=manifest["encoder_reuse"],
              export_s=export_s, artifact_bytes=nbytes,
              graph_nodes=manifest["graph_nodes"],
              pruned_nodes=manifest["pruned_nodes"], ms_per_step=ms,
              bit_equal=bit_equal, item_launches=launches,
              expected_launches=expected))
    if launches != expected or not bit_equal:
        raise AssertionError(f"export_reuse_flagship: {launches} launches, "
                             f"bit-equal {bit_equal}")
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


def host_draws(seed):
    """Stand-ins for the three draw hooks of ``diffusion.noise`` (normal,
    randint, uniform) that draw on the host from one seeded CPU generator
    and move the draw to the asked device, so a run on the card and one on
    the CPU see the same draws. A context manager."""
    import contextlib

    import torch
    from audio_diffusion_torch.diffusion import noise as noise_module

    gen = torch.Generator().manual_seed(seed)
    hooks = dict(
        normal=lambda g, shape, dtype, device: torch.randn(
            tuple(shape), generator=gen).to(dtype=dtype, device=device),
        randint=lambda g, low, high, shape, device: torch.randint(
            low, high, tuple(shape), generator=gen).to(device),
        uniform=lambda g, shape, dtype, device: torch.rand(
            tuple(shape), generator=gen).to(dtype=dtype, device=device))
    stack = contextlib.ExitStack()
    for name, fn in hooks.items():
        stack.enter_context(mock.patch.object(noise_module, name, fn))
    return stack


def phase_distill_small_reference():
    """Distillation on the small net, card (kernel path, f32) vs the same
    weights on the CPU, every draw host-made through the replaced noise
    hooks: the N = 4 teacher targets, the guidance targets of the small net
    with cross-attention and CFG (scale 3), within the small reference's
    bar; then a 3-step ``stage`` (Adam, lr 1e-4) on each device: the last
    loss rel 1e-4 and every parameter within 2·lr per step (Adam's step is
    about lr·sign(g), and a gradient of rounding noise may take either
    sign)."""
    import torch
    from audio_diffusion_torch import (DiffusionModel, ProgressiveDistiller,
                                       UNetV0)
    from audio_diffusion_torch.distill import (make_guidance_targets,
                                               make_teacher_targets)

    guided = dict(SMALL_CFG, cross_attentions=[0, 0, 1],
                  use_embedding_cfg=True, embedding_max_length=8,
                  embedding_features=32)
    pairs = {}
    for name, cfg in (("teacher", SMALL_CFG), ("guidance", guided)):
        cpu = DiffusionModel(net_t=UNetV0, device="cpu", seed=1, **cfg)
        fill_zero_params(cpu)
        gpu = DiffusionModel(net_t=UNetV0, **cfg)
        gpu.net.module.load_state_dict(cpu.net.module.state_dict())
        pairs[name] = (cpu, gpu)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 2, 256, generator=gen).clamp_(-1.0, 1.0)
    emb = torch.randn(2, 8, 32, generator=gen)

    def targets(model, kind):
        dev = model.device
        with host_draws(12):
            if kind == "teacher":
                out = make_teacher_targets(model.net, 4)(
                    model.params, None, x.to(dev))
            else:
                out = make_guidance_targets(model.net, 3.0)(
                    model.params, None, x.to(dev), embedding=emb.to(dev))
        return [t.cpu() for t in out]

    errs = {}
    for kind, (cpu, gpu) in pairs.items():
        want, got = targets(cpu, kind), targets(gpu, kind)
        for name, w, g in zip(("x_t", "sigma", "v_target"), want, got):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"distill small reference {kind} "
                                     f"{name}: shape or non-finite values")
            errs[f"{kind}_{name}"] = (g - w).abs().max().item()
    losses, params = [], []
    for model in pairs["teacher"]:
        dev = model.device
        with host_draws(13):
            m = ProgressiveDistiller(model, base_steps=8).stage(
                (x.to(dev) for _ in range(TRAIN_STEPS)), TRAIN_STEPS,
                log_fn=lambda s: None)
        losses.append(float(m["loss"]))
        params.append({k: v.detach().cpu() for k, v in model.params.items()})
    lr = 1e-4
    diffs = [(params[1][k] - v).abs() for k, v in params[0].items()]
    stage_err = max(d.max().item() for d in diffs)
    beyond = sum(int((d > 1e-6).sum()) for d in diffs)
    emit(dict(phase="distill_small_reference", dtype="float32",
              student_steps=4, guidance_scale=3.0, max_abs_err=errs,
              tolerance=1e-3, stage_steps=TRAIN_STEPS, stage_loss=losses,
              stage_param_max_abs_err=stage_err,
              stage_param_elements_beyond_1e6=beyond,
              stage_param_elements=sum(d.numel() for d in diffs),
              stage_tolerance=2 * lr * TRAIN_STEPS))
    if not max(errs.values()) < 1e-3:
        raise AssertionError(f"distill small reference: max-abs {errs}")
    if not (abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
            and stage_err <= 2 * lr * TRAIN_STEPS + 1e-6):
        raise AssertionError(f"distill small reference: stage losses "
                             f"{losses}, parameters max-abs {stage_err}")


def distill_steps(model, run_stage, batch, cond_batch=None):
    """Run ``run_stage(batches)`` (a 3-step stage of a
    ``ProgressiveDistiller`` on ``model``) over a feed of ``batch`` (paired
    with ``cond_batch`` where given) that marks each step's start: (the
    stage's metrics, ms per step, (forward, backward) item launches per
    step, peak device memory, the parameters that did not move). The
    counts are set to 0 just before the stage."""
    import torch
    from audio_diffusion_torch.ops.kernels import resnet

    item = resnet.fused_resnet_item
    before = {k: v.detach().clone() for k, v in model.params.items()}
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), item.launches,
                      item.backward_launches))

    def feed():
        while True:
            mark()
            yield batch if cond_batch is None else (batch, cond_batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    item.launches = item.backward_launches = 0
    metrics = run_stage(feed())
    mark()
    peak = torch.cuda.max_memory_allocated()
    ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    launches = [(b[1] - a[1], b[2] - a[2]) for a, b in zip(marks, marks[1:])]
    still = [k for k, v in model.params.items() if torch.equal(v, before[k])]
    return metrics, ms, launches, peak, still


def phase_distill_flagship(model, noise):
    """Progressive distillation of the flagship (bf16, batch 8, 2^18
    stereo): ``ProgressiveDistiller(model, base_steps=8)`` and one 3-step
    ``stage`` (8 -> 4). Each step runs the teacher's two no-grad passes and
    the student's step: exactly 126 forward and 42 backward item launches
    per step; ms per step beside ``phase_train``'s from this run, the peak;
    every parameter moved; a profile of the teacher's targets (its two
    passes). Then a sample at the distilled 4 steps (168
    launches, finite), and the abort gate: a feed that raises at step 2
    leaves ``model.params`` bit-equal. Returns (forward, backward launches
    per step, the sample's launches)."""
    import torch
    from audio_diffusion_torch import (ProgressiveDistiller,
                                       cast_inference_params)
    from audio_diffusion_torch.distill import make_teacher_targets
    from audio_diffusion_torch.ops.kernels import resnet

    item = resnet.fused_resnet_item
    per_pass = 2 * sum(ITEMS)
    gen = torch.Generator(device=model.device).manual_seed(5)
    batch = torch.randn(TRAIN_BATCH, 2, LENGTH, device=model.device,
                        generator=gen).clamp_(-1.0, 1.0)
    distiller = ProgressiveDistiller(model, base_steps=DISTILL_BASE_STEPS)
    logs = []
    metrics, ms, launches, peak, still = distill_steps(
        model, lambda feed: distiller.stage(feed, TRAIN_STEPS,
                                            log_fn=logs.append,
                                            log_every=1), batch)
    # Where a halving step's extra time goes: the teacher's two passes.
    teacher = cast_inference_params(
        {k: v.detach() for k, v in model.params.items()},
        model.net.compute_dtype)
    targets = make_teacher_targets(model.net, distiller.steps)
    phase_profile("distill_targets_profile",
                  lambda: targets(teacher, model.generator, batch),
                  batch=TRAIN_BATCH, passes=2)
    del teacher
    item.launches = 0
    t0 = time.perf_counter()
    out = model.sample(noise, num_steps=distiller.steps)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) * 1e3 / distiller.steps
    sample_launches = item.launches
    finite = bool(torch.isfinite(out).all())
    del out
    # The abort gate: a feed that fails at the second step.
    snapshot = {k: v.detach().clone() for k, v in model.params.items()}

    def failing():
        yield batch
        raise RuntimeError("the batch source failed at step 2")

    try:
        ProgressiveDistiller(model, base_steps=DISTILL_BASE_STEPS).stage(
            failing(), TRAIN_STEPS, log_fn=lambda s: None)
        aborted = False
    except RuntimeError as exc:
        aborted = "step 2" in str(exc)
    intact = all(torch.equal(v, snapshot[k])
                 for k, v in model.params.items())
    del snapshot
    expected = (per_pass * 3, per_pass)
    emit(dict(phase="distill_flagship", batch=TRAIN_BATCH, length=LENGTH,
              dtype="bfloat16", base_steps=DISTILL_BASE_STEPS,
              student_steps=distiller.steps, stage_steps=TRAIN_STEPS,
              optimizer="Adam(lr=1e-4)",
              ms_per_step=sorted(ms)[len(ms) // 2], ms_per_step_runs=ms,
              train_ms_per_step=TRAIN_MS.get("train"),
              loss=float(metrics["loss"]), logs=logs,
              item_launches_per_step=launches,
              expected_launches_per_step=expected,
              peak_memory_bytes=peak, peak_gb=peak / 1e9,
              parameters_not_moved=still, sample_steps=distiller.steps,
              sample_ms_per_step=sample_ms,
              sample_item_launches=sample_launches, sample_finite=finite,
              abort_raised=aborted, abort_params_bit_equal=intact))
    if any(tuple(n) != expected for n in launches) or len(launches) != \
            TRAIN_STEPS:
        raise AssertionError(f"distill_flagship: launches per step "
                             f"{launches}, expected {expected}")
    if still or not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"distill_flagship: {len(still)} parameters "
                             f"did not move ({still[:5]}) or a non-finite "
                             "loss")
    if sample_launches != per_pass * distiller.steps or not finite:
        raise AssertionError(f"distill_flagship: the {distiller.steps}-step "
                             f"sample made {sample_launches} launches, "
                             f"finite {finite}")
    if not (aborted and intact):
        raise AssertionError(f"distill_flagship: abort raised {aborted}, "
                             f"params intact {intact}")
    return launches[0] + (sample_launches,)


def phase_guidance_distill_flagship(model, embedding):
    """Guidance distillation of the text-conditional flagship (bf16, batch
    8): a 3-step ``guidance_stage`` at the guided sample's scale, with
    ``(x, {"embedding": ...})`` batches. Each step runs the teacher's
    guided pass (the items at batch 16) and the student's step: exactly 84
    forward (42 at batch 16, 42 at batch 8) and 42 backward launches per
    step; every parameter moved but the fixed embedding, which only the
    teacher's guided pass reads. Returns (forward, backward) launches per
    step."""
    import torch
    from audio_diffusion_torch import ProgressiveDistiller

    per_pass = 2 * sum(ITEMS)
    gen = torch.Generator(device=model.device).manual_seed(6)
    batch = torch.randn(TRAIN_BATCH, 2, LENGTH, device=model.device,
                        generator=gen).clamp_(-1.0, 1.0)
    distiller = ProgressiveDistiller(model, base_steps=DISTILL_BASE_STEPS)
    logs = []
    metrics, ms, launches, peak, still = distill_steps(
        model, lambda feed: distiller.guidance_stage(
            feed, GUIDANCE, TRAIN_STEPS, log_fn=logs.append, log_every=1),
        batch, {"embedding": embedding})
    expected = (2 * per_pass, per_pass)
    emit(dict(phase="guidance_distill_flagship", batch=TRAIN_BATCH,
              teacher_item_batch=2 * TRAIN_BATCH, length=LENGTH,
              dtype="bfloat16", guidance_scale=GUIDANCE,
              stage_steps=TRAIN_STEPS, optimizer="Adam(lr=1e-4)",
              ms_per_step=sorted(ms)[len(ms) // 2], ms_per_step_runs=ms,
              train_text_ms_per_step=TRAIN_MS.get("train_text"),
              loss=float(metrics["loss"]), logs=logs,
              item_launches_per_step=launches,
              expected_launches_per_step=expected,
              peak_memory_bytes=peak, peak_gb=peak / 1e9,
              parameters_not_moved=still))
    if any(tuple(n) != expected for n in launches) or len(launches) != \
            TRAIN_STEPS:
        raise AssertionError(f"guidance_distill_flagship: launches per step "
                             f"{launches}, expected {expected}")
    if still != [FIXED_EMBEDDING] or not math.isfinite(
            float(metrics["loss"])):
        raise AssertionError(f"guidance_distill_flagship: parameters that "
                             f"did not move: {still[:5]}, or a non-finite "
                             "loss")
    return launches[0]


def phase_embed_flagship(torch):
    """``CorpusEmbedder`` at its defaults (48 kHz, crop 48,000, 64 mels,
    widths (96, 128, 192), batch 32) on 16 stereo files of 4 s synthesized
    from a seed, the corpus on the card: ms per ``train`` step over 20
    steps (after a 2-step warm-up), the peak; then ``embed`` of 8 files' 2 s
    on the card against the CPU with the same parameters: max-abs ≤ 1e-4
    (float32, TF32 off), unit norm."""
    import numpy as np
    from audio_diffusion_torch import CorpusEmbedder

    rs = np.random.default_rng(23)
    rate = 48000
    frames = EMBED_SECONDS * rate
    t = np.arange(frames) / rate
    corpus = np.stack([
        0.3 * np.sin(2 * np.pi * 80.0 * (i + 1) * t) * np.array([[1.0],
                                                                  [0.8]])
        + 0.05 * rs.standard_normal((2, frames))
        for i in range(EMBED_FILES)]).astype(np.float32)
    emb = CorpusEmbedder()
    emb.train(corpus, steps=2)  # warm-up: cuDNN's plans, AdamW's state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = emb.train(corpus,
                       generator=torch.Generator(emb.device).manual_seed(1),
                       steps=EMBED_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / EMBED_STEPS
    peak = torch.cuda.max_memory_allocated()
    probe = corpus[:8, :, :2 * rate]
    got = emb.embed(params, probe)
    t0 = time.perf_counter()
    want = CorpusEmbedder(device="cpu").embed(
        {k: v.cpu() for k, v in params.items()}, probe)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    norm_err = float(np.abs(np.linalg.norm(got, axis=-1) - 1.0).max())
    emit(dict(phase="embed_flagship", files=EMBED_FILES,
              seconds_per_file=EMBED_SECONDS, sample_rate=rate,
              crop=emb.crop, widths=list(emb.widths), features=emb.features,
              batch=32, steps=EMBED_STEPS, ms_per_step=step_ms,
              peak_memory_bytes=peak, peak_gb=peak / 1e9,
              parameters=sum(v.numel() for v in params.values()),
              embed_shape=list(got.shape), max_abs_err=err,
              unit_norm_err=norm_err, tolerance=1e-4,
              cpu_embed_seconds=cpu_s))
    if not (got.shape == (len(probe), emb.features) and err <= 1e-4
            and norm_err <= 1e-5):
        raise AssertionError(f"embed_flagship: shape {got.shape}, max-abs "
                             f"{err}, unit norm error {norm_err}")


def phase_cli_distill_eval(root: Path):
    """``distill``, ``sample`` and ``eval`` as a user runs them, on the run
    that ``phase_cli_train_sample`` trained: ``distill --base-steps 4
    --target-steps 2 --stage-steps 2``, then two 2-step samples from
    ``run/model_distilled2`` (finite stereo of 2^18 frames), then ``eval``
    of those against the corpus, whose JSON must hold finite values. Each
    must exit 0."""
    import numpy as np
    from audio_diffusion_torch.data import wav_probe, wav_read

    run, wavs, smp = root / "run", root / "wavs", root / "samples_distilled"
    repo = Path(__file__).resolve().parent
    commands = {
        "distill": ["distill", "--model", str(run / "model"), "--data",
                    str(wavs), "--base-steps", "4", "--target-steps", "2",
                    "--stage-steps", "2", "--crop", str(LENGTH),
                    "--log-every", "1"],
        "sample": ["sample", "--model", str(run / "model_distilled2"),
                   "--num", "2", "--steps", "2", "--length", str(LENGTH),
                   "--out", str(smp)],
        "eval": ["eval", "--ref", str(wavs), "--samples", str(smp)],
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
            emit(dict(phase="cli_distill_eval", **results))
            raise AssertionError(f"cli_distill_eval: {name} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
    summary = json.loads(results["eval"]["stdout"][-1])
    wav_ok = all(wav_probe(smp / f"sample_{i}.wav")[:3] == (2, 48000, LENGTH)
                 and np.isfinite(wav_read(smp / f"sample_{i}.wav")).all()
                 for i in range(2))
    finite = all(isinstance(v, (int, float)) and math.isfinite(v)
                 for v in summary.values())
    emit(dict(phase="cli_distill_eval", **results, eval_summary=summary,
              wavs_ok=wav_ok, eval_finite=finite))
    if not (wav_ok and finite and summary["num_samples"] == 2):
        raise AssertionError(f"cli_distill_eval: wavs ok {wav_ok}, eval "
                             f"{summary}")


def moved(cond, device):
    """The conditioning kwargs on ``device`` (a ``channels=`` list keeps its
    Nones)."""
    return {k: ([None if t is None else t.to(device) for t in v]
                if isinstance(v, list) else v.to(device))
            for k, v in cond.items()}


def phase_nd_small_reference():
    """The CPU tests' 2-D, 3-D and ``first_item`` nets on the card (f32,
    TF32 off: cuDNN's convs, and the kernels on ``first_item``'s
    constant-width items) against the same weights on the CPU: the forward,
    a 4-step VSampler sample of host-made noise, a 4-step SDE sample whose
    draws come from the host through the replaced ``noise`` hooks, the
    v-loss and its gradients at host-made σ and noise, and the 2-D net's
    int8 leaves bit-equal. The bars of small_reference and train_small."""
    import torch
    from audio_diffusion_torch import (DiffusionModel, SDESampler, UNetV0,
                                       quantize_params)
    from audio_diffusion_torch.diffusion.vdiffusion import v_loss
    from audio_diffusion_torch.ops.kernels import resnet

    rows, failures = {}, []
    for name, dim, cfg in (("dim2", 2, SMALL_ND), ("dim3", 3, SMALL_ND),
                           ("first_item", 1, SMALL_FIRST_ITEM)):
        spatial = SMALL_ND_SPATIAL.get(dim, (128,))
        cpu = DiffusionModel(net_t=UNetV0, dim=dim, device="cpu", seed=1,
                             **cfg)
        fill_zero_params(cpu)
        gpu = DiffusionModel(net_t=UNetV0, dim=dim, **cfg)
        gpu.net.module.load_state_dict(cpu.net.module.state_dict())
        gen = torch.Generator().manual_seed(8)
        x, noise = (torch.randn(2, cfg["in_channels"], *spatial,
                                generator=gen) for _ in range(2))
        sigmas = torch.tensor([0.3, 0.8])
        cond = {} if dim == 1 else dict(
            embedding=torch.randn(2, 5, 12, generator=gen),
            channels=[None, torch.randn(2, 8, *(s // 2 for s in spatial),
                                        generator=gen)])
        outs = {}
        for model in (cpu, gpu):
            dev = model.device
            c = moved(cond, dev)
            with torch.inference_mode():
                fwd = model.net.apply(model.params, x.to(dev),
                                      sigmas.to(dev), **c)
                resnet.fused_resnet_item.launches = 0
                vs = model.sample(x.to(dev), num_steps=4, **c)
                launches = resnet.fused_resnet_item.launches
                with host_draws(9):
                    sde = SDESampler(model.net, eta=0.5).sample(
                        model.params, model.generator, x.to(dev), 4, **c)
            params = model.params
            loss = v_loss(model.net, params, x.to(dev), sigmas.to(dev),
                          noise.to(dev), **c)
            grads = torch.autograd.grad(loss, list(params.values()))
            outs[dev.type] = dict(
                forward=fwd.cpu(), sample=vs.cpu(), sde=sde.cpu(),
                loss=loss.item(), grads=[g.cpu() for g in grads],
                launches=launches)
        want, got = outs["cpu"], outs["cuda"]
        errs = {k: (got[k] - want[k]).abs().max().item()
                for k in ("forward", "sample", "sde")}
        norm = torch.linalg.vector_norm(torch.stack(
            [g.norm() for g in want["grads"]])).item()
        grad_err = max(max(0.0, (a - b).abs().max().item() - 1e-6 * norm)
                       / a.abs().max().item()
                       for a, b in zip(want["grads"], got["grads"]))
        row = dict(max_abs_err=errs, loss_cpu=want["loss"],
                   loss_card=got["loss"], max_grad_rel_err=grad_err,
                   sample_launches=got["launches"])
        if name == "dim2":
            q_cpu, q_gpu = (quantize_params(m.params, min_size=256)
                            for m in (cpu, gpu))
            leaves = [n for n, v in q_cpu.items() if hasattr(v, "qscale")]
            row["int8_leaves"] = len(leaves)
            for n in leaves:
                if not (torch.equal(q_gpu[n].q.cpu(), q_cpu[n].q) and
                        torch.equal(q_gpu[n].qscale.cpu(), q_cpu[n].qscale)):
                    raise AssertionError(f"nd_small_reference int8 {n}: "
                                         "card and CPU differ")
        rows[name] = row
        failures += [f"{name} {k}: max-abs {errs[k]}"
                     for k in ("forward", "sample", "sde")
                     if not (torch.isfinite(got[k]).all() and errs[k] < 1e-3)]
        if not abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"]):
            failures.append(f"{name}: loss {got['loss']} vs {want['loss']}")
        if not grad_err <= 1e-3:
            failures.append(f"{name}: gradient rel err {grad_err}")
        expected = 4 * 6 if name == "first_item" else 0
        if got["launches"] != expected:
            failures.append(f"{name}: {got['launches']} item launches in "
                            f"the 4-step sample, expected {expected}")
    emit(dict(phase="nd_small_reference", dtype="float32", steps=4,
              sde_eta=0.5, tolerance=1e-3, grad_tolerance=1e-3,
              int8_bit_equal=True, **rows))
    if failures:
        raise AssertionError(f"nd_small_reference: {failures}")


def nd_sample_and_train(model, phase, shape, train_batch, seed=0):
    """A 2-D/3-D main path at full width: a 50-step VSampler sample of
    ``shape`` at batch 1 (a 2-step warm-up, two timed runs that must give
    the same bits, a 2-step profile), then Adam steps at ``train_batch``
    (bf16 compute over f32 masters, through ``DiffusionModel.loss`` and
    ``make_train_step``): a warm-up step, three timed ones; every parameter
    must move. The fused item is a 1-D kernel: these paths launch it no
    time, as the JAX package runs no Pallas kernel at dim 2/3."""
    import torch
    from audio_diffusion_torch import make_train_step
    from audio_diffusion_torch.ops.kernels import resnet

    item = resnet.fused_resnet_item
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn(1, *shape, device="cuda", generator=gen)
    model.sample(noise, num_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    item.launches = 0
    outs, step_ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(model.sample(noise, num_steps=NUM_STEPS))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / NUM_STEPS)
    launches = item.launches
    sample_peak = torch.cuda.max_memory_allocated()
    if outs[0].shape != noise.shape or not torch.isfinite(outs[0]).all():
        raise AssertionError(f"{phase}: bad shape or non-finite sample")
    same = torch.equal(outs[0], outs[1])
    emit(dict(phase=f"{phase}_sample", steps=NUM_STEPS, batch=1,
              shape=list(noise.shape), dtype="bfloat16",
              ms_per_step=min(step_ms), ms_per_step_runs=step_ms,
              rerun_bit_equal=same, item_launches=launches,
              peak_memory_bytes=sample_peak, peak_gb=sample_peak / 1e9,
              out_std=outs[0].float().std().item()))
    if not same:
        raise AssertionError(f"{phase}: a rerun of the sample differs")
    if launches:
        raise AssertionError(f"{phase}: {launches} fused-item launches")
    del outs
    phase_profile(f"{phase}_sample_profile",
                  lambda: model.sample(noise, num_steps=2), steps=2)

    batch = torch.randn(train_batch, *shape, device="cuda",
                        generator=gen).clamp_(-1.0, 1.0)
    leaves = list(model.params.values())
    before = [p.detach().clone() for p in leaves]
    init_state, train_step = make_train_step(
        model.loss, functools.partial(torch.optim.Adam, lr=1e-4))
    state = init_state(model.params, gen)
    state, _ = train_step(state, batch)
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
    still = [n for (n, p), p0 in zip(model.params.items(), before)
             if torch.equal(p.detach(), p0)]
    median = sorted(step_ms)[len(step_ms) // 2]
    emit(dict(phase=f"{phase}_train", batch=train_batch,
              shape=list(batch.shape), dtype="bfloat16",
              optimizer="Adam(lr=1e-4)", steps=TRAIN_STEPS,
              ms_per_step=median, ms_per_step_runs=step_ms,
              samples_per_s=train_batch / median * 1e3, metrics=metrics,
              item_launches=launches, parameters=len(leaves),
              parameter_elements=sum(p.numel() for p in leaves),
              peak_memory_bytes=peak, peak_gb=peak / 1e9))
    for m in metrics:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{phase}: non-finite metrics {m}")
    if still:
        raise AssertionError(f"{phase}: parameters that did not move: "
                             f"{still[:5]} ({len(still)})")
    if any(launches):
        raise AssertionError(f"{phase}: {launches} fused-item launches")
    del before, state
    return median


def phase_nd_full(torch, dim):
    """``DiffusionModel(net_t=UNetV0, dim=2)`` at the DDPM LSUN-256 widths
    (256 x 256 RGB, Adam at batch 8), or ``dim=3`` on 16-frame 64 x 64
    clips (Adam at batch 4); bf16, random weights from a seed."""
    from audio_diffusion_torch import DiffusionModel, UNetV0

    cfg, shape, batch = ((DIM2_FULL, DIM2_SHAPE, DIM2_TRAIN_BATCH) if dim == 2
                         else (DIM3_FULL, DIM3_SHAPE, DIM3_TRAIN_BATCH))
    model = DiffusionModel(net_t=UNetV0, dim=dim, dtype=torch.bfloat16,
                           seed=dim, **cfg)
    fill_zero_params(model)
    nd_sample_and_train(model, f"dim{dim}_full", shape, batch, seed=dim)


def item_device_ms(model, noise, flush):
    """Device time of each resnet item of one bf16 pass at σ = 0.5 (L2
    flushed, median of REPS), split into the width-changing items (the
    plain path) and the fused ones: (shortcut ms, fused ms, rows)."""
    import torch
    from audio_diffusion_torch import cast_inference_params
    from audio_diffusion_torch.ops.unet import ResnetModItem

    params = cast_inference_params(model.params, torch.bfloat16)
    calls = []
    items = [(n, m) for n, m in model.net.module.named_modules()
             if isinstance(m, ResnetModItem)]
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: calls.append(
            (name, mod, args[0].detach(), args[1].detach())))
        for name, m in items]
    try:
        with torch.inference_mode():
            model.net.apply(params, noise, torch.full((1,), 0.5,
                                                      device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    rows = []
    with torch.inference_mode():
        for name, mod, x, features in calls:
            # The pass's own parameters: the bf16 cast swapped in.
            prefix = name + "."
            own = {k[len(prefix):]: v for k, v in params.items()
                   if k.startswith(prefix)}
            ms = cuda_ms(lambda: torch.func.functional_call(
                mod, own, (x, features)), flush)
            rows.append(dict(item=name, shortcut=mod.has_shortcut,
                             shape=list(x.shape), ms=ms))
    short = sum(r["ms"] for r in rows if r["shortcut"])
    fused = sum(r["ms"] for r in rows if not r["shortcut"])
    return short, fused, rows


def phase_first_item_flagship(torch, noise):
    """The README flagship with ``channel_change="first_item",
    lane_fold=False`` in bf16: a 50-step sample at batch 1 (1,800 forward
    launches: 36 of the 42 items per pass, the six width-changing ones on
    the plain path), a rerun bit for bit, the six items' device time per
    pass beside the fused items', and Adam steps at batch 8 (36 + 36
    launches per step, every parameter moved). Returns (sample launches,
    train launches)."""
    from audio_diffusion_torch import DiffusionModel, UNetV0, presets

    model = DiffusionModel(net_t=UNetV0, **presets.UNCONDITIONAL_48K,
                           dtype=torch.bfloat16, seed=3, lane_fold=False,
                           channel_change="first_item")
    fill_zero_params(model)
    shortcuts = [n for n in model.params if n.endswith("shortcut_kernel")]
    per_pass = 2 * sum(ITEMS) - FIRST_ITEM_SHORTCUTS
    out, launches, step_ms, peak = sample_runs(model, noise)
    again = model.sample(noise, num_steps=NUM_STEPS)
    same = torch.equal(out, again)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    short_ms, fused_ms, rows = item_device_ms(model, noise, flush)
    del flush
    emit(dict(phase="first_item_flagship_sample", steps=NUM_STEPS, batch=1,
              length=LENGTH, dtype="bfloat16",
              ms_per_step=sorted(step_ms)[1], ms_per_step_runs=step_ms,
              item_launches=launches, expected_launches=per_pass * NUM_STEPS,
              shortcut_items=len(shortcuts), rerun_bit_equal=same,
              shortcut_items_ms_per_pass=short_ms,
              fused_items_ms_per_pass=fused_ms,
              shortcut_item_ms={r["item"]: r["ms"] for r in rows
                                if r["shortcut"]},
              peak_memory_bytes=peak, out_std=out.float().std().item()))
    if len(shortcuts) != FIRST_ITEM_SHORTCUTS:
        raise AssertionError(f"first_item: {len(shortcuts)} shortcut items, "
                             f"expected {FIRST_ITEM_SHORTCUTS}")
    if launches != per_pass * NUM_STEPS:
        raise AssertionError(f"first_item: {launches} item launches in the "
                             f"sample, expected {per_pass * NUM_STEPS}")
    if out.shape != noise.shape or not torch.isfinite(out).all():
        raise AssertionError("first_item: bad shape or non-finite sample")
    if not same:
        raise AssertionError("first_item: a rerun of the sample differs")
    del out, again
    train = phase_train(model, "first_item_flagship_train",
                        items_per_pass=per_pass)
    del model
    return launches, train


# ------------------------------------------------------------- multi-GPU
# Two ranks, each a child process of this script (``chip_smoke.py --rank R
# PORT GROUP DIR BACKEND``); on one card they share it over gloo, whose
# collectives on CUDA tensors go through the host.
RANKS = 2
RANK_TIMEOUT = 900
# The CPU tests' small net (tests/test_torch_parallel.py; its 256-wide
# level gives the model axis leaves to shard), and a length at which every
# rank's shard is a multiple of its level's statistics tile.
SMALL_PARALLEL = dict(in_channels=2, channels=[8, 32, 256], factors=[1, 4, 2],
                      items=[1, 1, 1], attentions=[0, 0, 1], attention_heads=4,
                      attention_features=8, modulation_features=64,
                      resnet_groups=4)
SMALL_PARALLEL_LENGTH = 2**14
SMALL_PARALLEL_BATCH = 4
SMALL_PARALLEL_LR = 1e-4
DP_STEPS = 2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(group: str, root: Path, backend: str):
    """Run the rank phases ``group`` as RANKS child processes of this script
    (rendezvous on a free local port; rank r on card r % device_count),
    wait for every child within RANK_TIMEOUT, check every exit code, and
    return each rank's results. A rank that fails fails the run."""
    port = free_port()
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here))
    procs, logs = [], []
    for r in range(RANKS):
        logs.append(open(root / f"{group}_{backend}_rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
             str(port), group, str(root), backend], cwd=here, env=env,
            stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        for r, _ in bad:
            tail = (root / f"{group}_{backend}_rank{r}.log").read_text()
            print(f"--- {group} rank {r} ({backend}):\n{tail[-6000:]}",
                  file=sys.stderr)
        raise AssertionError(f"{group} ({backend}): ranks (rank, exit code) "
                             f"{bad} failed")
    return [json.loads((root / f"{group}_{backend}_rank{r}.json")
                       .read_text()) for r in range(RANKS)]


def rank_main(argv) -> int:
    """A rank's process: join the group, run its phases, save its results.
    Any exception fails the process, and so the run."""
    rank, port, group, root, backend = (int(argv[0]), argv[1], argv[2],
                                        Path(argv[3]), argv[4])
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       WORLD_SIZE=str(RANKS), RANK=str(rank),
                       LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist
    from audio_diffusion_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(backend=backend)
    out = RANK_GROUPS[group](torch, mesh, rank, root, backend)
    (root / f"{group}_{backend}_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def rank_kernel_sharded(torch, mesh, rank):
    """The staged, length-sharded item (two shards) at every flagship level
    shape, bf16 and f32: against the sharded plain version (the unsharded
    rows' bars) and against the unsharded kernel (statistics and output bit
    for bit), with each level's plan, the staged item's time per rank, the
    halo copies' device time and the unsharded kernel's."""
    from audio_diffusion_torch.ops.kernels import resnet
    from audio_diffusion_torch.parallel import comm

    shard = comm.group_shard(mesh.get_group("data"))
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for level, (c, length) in enumerate(LEVELS):
            args = item_inputs(c, length, dtype, gen)
            x, params = args[0], tuple(args[1:])
            part = length // RANKS
            local = x[:, rank * part:(rank + 1) * part].contiguous()
            with torch.inference_mode():
                got, stats = resnet._launch_sharded(local, params, GROUPS,
                                                    1e-5, True, shard,
                                                    keep_stats=True)
                ref = resnet.resnet_item_sharded_reference(
                    local, *params, shard=shard, groups=GROUPS)
                full, _, _, full_stats = resnet._launch_forward(
                    x, params, GROUPS, 1e-5, True, keep=True)
                want = full[:, rank * part:(rank + 1) * part]
                err = (got.float() - ref.float()).abs().max().item()
                ymax = ref.float().abs().max().item()
                bound = (2e-4 * max(1.0, ymax) if dtype == torch.float32
                         else 2.0 ** -5 * ymax)
                row = dict(level=level, channels=c, length=length,
                           shard_length=part, dtype=dname, max_abs_err=err,
                           tolerance=bound, max_abs_out=ymax,
                           output_bit_equal=torch.equal(got, want),
                           stats_bit_equal=torch.equal(stats, full_stats),
                           conv_plan=resnet.conv_plan(1, length, c),
                           # Wall time: the gathers go through the host.
                           staged_ms=sorted(host_ms(
                               lambda: resnet._launch_sharded(
                                   local, params, GROUPS, 1e-5, True, shard))
                               for _ in range(5))[2],
                           kernel_ms=cuda_ms(lambda: resnet.fused_resnet_item(
                               x, *params, groups=GROUPS), flush, reps=5),
                           halo_copies_ms=2 * cuda_ms(lambda: comm.pad_halo(
                               local, local[:, :1], local[:, -1:])[0][
                                   :, 1:part + 1].contiguous(), flush,
                               reps=5))
            rows.append(row)
            if not (err <= bound and row["output_bit_equal"]
                    and row["stats_bit_equal"]):
                raise AssertionError(f"kernel_sharded_vs_plain rank {rank}: "
                                     f"{row}")
    return rows


def recording_adam(seen: list, lr: float):
    """An Adam factory whose optimizer appends each step's gradients to
    ``seen`` (for the rounding mask of the parameters' bar)."""
    import torch

    class Recording(torch.optim.Adam):
        def step(self, closure=None):
            seen.append([p.grad.detach().clone() for g in self.param_groups
                         for p in g["params"]])
            return super().step(closure)

    return functools.partial(Recording, lr=lr)


def small_parallel_steps(torch, params0, x, mesh=None, **kw):
    """DP_STEPS Adam steps of the small net from ``params0`` on ``x`` (this
    rank's rows with a mesh): (losses, grad norms, parameters, state, the
    gradients each step saw)."""
    from audio_diffusion_torch import DiffusionModel, UNetV0, make_train_step

    model = DiffusionModel(net_t=UNetV0, **SMALL_PARALLEL)
    with torch.no_grad():
        for k, p in model.params.items():
            p.copy_(params0[k])
    seen = []
    init, step = make_train_step(
        model.loss, recording_adam(seen, SMALL_PARALLEL_LR), mesh=mesh, **kw)
    state = init(model.params, torch.Generator(device="cuda").manual_seed(7))
    losses, norms = [], []
    for _ in range(DP_STEPS):
        state, m = step(state, x)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return (losses, norms, {k: v.detach().clone()
                            for k, v in state.params.items()}, state, seen)


def params_within(got, want, grads, norms):
    """Max-abs over elements whose every step's gradient exceeds 1e-6 of
    the gradient norm (where Adam's step is beyond the rounding), the share
    of the others and their max-abs (Adam may turn a rounding difference
    there into up to lr per step). The small net's zero-initialized leaves,
    filled with normal(0.02) values, leave about 1% of the elements there
    on the card; the bar takes up to 5%."""
    import torch

    clear_err, other_err, masked, total = 0.0, 0.0, 0, 0
    for i, (name, w) in enumerate(want.items()):
        diff = (got[name] - w).abs()
        clear = torch.stack([g[i].abs() > 1e-6 * n
                             for g, n in zip(grads, norms)]).all(0)
        if clear.any():
            clear_err = max(clear_err, diff[clear].max().item())
        if (~clear).any():
            other_err = max(other_err, diff[~clear].max().item())
        masked += int((~clear).sum())
        total += w.numel()
    return clear_err, other_err, masked / total


def rank_small_reference(torch, mesh, rank, root, backend):
    """The small net's DP step, ZeRO-1 and model-axis step against one rank
    on the card, and a 4-step length-sharded sample against the unsharded
    one, to the CPU tests' bars."""
    from audio_diffusion_torch import (DiffusionModel, UNetV0,
                                       sample_length_sharded)
    from audio_diffusion_torch.parallel import create_mesh, shard_batch

    base = DiffusionModel(net_t=UNetV0, seed=1, **SMALL_PARALLEL)
    fill_zero_params(base)
    params0 = {k: v.detach().clone() for k, v in base.params.items()}
    x = torch.randn(SMALL_PARALLEL_BATCH, 2, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    one = small_parallel_steps(torch, params0, x)
    local = shard_batch(x, mesh)
    dp = small_parallel_steps(torch, params0, local, mesh)
    z = small_parallel_steps(torch, params0, local, mesh, zero1=True)
    mp = small_parallel_steps(torch, params0, x,
                              create_mesh(data=1, model=RANKS,
                                          backend=backend))
    clear_err, other_err, masked = params_within(dp[2], one[2], one[4],
                                                 one[1])
    zero1_moments = all(
        torch.equal(z[3].shards[k].cut(dp[3].optimizer.state[p][key])
                    if k in z[3].shards else dp[3].optimizer.state[p][key],
                    z[3].optimizer.state[z[3].optimizer_leaf(k)][key])
        for k, p in dp[3].params.items() for key in ("exp_avg",
                                                     "exp_avg_sq"))
    mp_err = max((mp[2][k] - w).abs().max().item() for k, w in one[2].items())
    model = DiffusionModel(net_t=UNetV0, **SMALL_PARALLEL)
    with torch.no_grad():
        for k, p in model.params.items():
            p.copy_(params0[k])
    noise = torch.randn(1, 2, SMALL_PARALLEL_LENGTH, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
    want = model.sample(noise, num_steps=4)
    got = sample_length_sharded(model, noise, 4, mesh, gather=True)
    out = dict(
        dp_losses=dp[0], one_losses=one[0], dp_grad_norms=dp[1],
        one_grad_norms=one[1],
        dp_loss_rel_err=max(abs(a - b) / abs(b)
                            for a, b in zip(dp[0], one[0])),
        dp_params_max_abs_err=clear_err, dp_params_other_max_abs_err=other_err,
        dp_params_masked_share=masked,
        zero1_params_bit_equal=all(torch.equal(z[2][k], v)
                                   for k, v in dp[2].items()),
        zero1_moments_bit_equal=zero1_moments,
        zero1_moment_share=sum(z[3].optimizer.state[z[3].optimizer_leaf(k)]
                               ["exp_avg"].numel() for k in z[2])
        / sum(v.numel() for v in z[2].values()),
        model_axis_params_max_abs_err=mp_err,
        model_axis_sharded_leaves=len(mp[3].shards),
        sample_max_abs_err=(got - want).abs().max().item(),
        sample_bit_equal=torch.equal(got, want),
        sample_length=SMALL_PARALLEL_LENGTH)
    ok = (out["dp_loss_rel_err"] <= 2e-5 and clear_err <= 1e-6
          and other_err <= 2 * SMALL_PARALLEL_LR * DP_STEPS and masked < 0.05
          and out["zero1_params_bit_equal"] and zero1_moments
          and mp_err <= 1e-6 and out["model_axis_sharded_leaves"] > 0
          and torch.allclose(got, want, atol=2e-4, rtol=2e-4))
    if not ok:
        raise AssertionError(f"multi_rank_small_reference rank {rank}: {out}")
    return out


def ranks_small(torch, mesh, rank, root, backend):
    return dict(kernel_sharded_vs_plain=rank_kernel_sharded(torch, mesh, rank),
                multi_rank_small_reference=rank_small_reference(
                    torch, mesh, rank, root, backend))


def flagship_noise(torch):
    """The main path's sample noise (the parent's ``noise``)."""
    return torch.randn(1, 2, LENGTH, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(1))


def dp_batch(torch):
    """The DP train step's global batch of 8 and its loss generator."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = torch.randn(TRAIN_BATCH, 2, LENGTH, device="cuda",
                        generator=gen).clamp_(-1.0, 1.0)
    return batch, torch.Generator(device="cuda").manual_seed(5)


def sample_trace(torch, model, noise, mesh=None, record_step=None):
    """A 50-step sample of ``noise`` (``sample_length_sharded`` over the
    mesh's data ranks if given: this rank's part) with the net's output at
    every step, and at step ``record_step`` every module's output in call
    order."""
    from audio_diffusion_torch import sample_length_sharded

    root = model.net.module
    calls, outs, mods = [0], [], []

    def mod_hook(name):
        def hook(m, i, o):
            if calls[0] - 1 == record_step and torch.is_tensor(o):
                mods.append((name, o.detach().clone()))
        return hook

    hooks = [root.register_forward_pre_hook(
                 lambda m, i: calls.__setitem__(0, calls[0] + 1)),
             root.register_forward_hook(
                 lambda m, i, o: outs.append(o.detach().clone()))]
    if record_step is not None:
        hooks += [m.register_forward_hook(mod_hook(n))
                  for n, m in root.named_modules() if n]
    try:
        sample = (sample_length_sharded(model, noise, NUM_STEPS, mesh)
                  if mesh is not None
                  else model.sample(noise, num_steps=NUM_STEPS))
    finally:
        for h in hooks:
            h.remove()
    return sample, outs, mods


def first_divergence(torch, model, noise, mesh, rank, sharded, sharded_v):
    """The sharded 50-step sample (``sharded``, with its net outputs
    ``sharded_v``) against the whole one in this process: whether they are
    bit-equal, and if not the first step whose net output differs on this
    rank's rows and, at that step, the first module whose output does (in
    call order; the net itself where only its own ops differ), with its
    max-abs error. Returns that and the whole sample on the host."""
    def rows(s, w):
        if s.shape == w.shape:
            return w
        axis = 1 if s.shape[1] * RANKS == w.shape[1] else s.ndim - 1
        n = s.shape[axis]
        return w.narrow(axis, rank * n, n)

    whole, whole_v, _ = sample_trace(torch, model, noise)
    out = dict(bit_equal=torch.equal(sharded, rows(sharded, whole)))
    step = next((k for k, (s, w) in enumerate(zip(sharded_v, whole_v))
                 if not torch.equal(s, rows(s, w))), None)
    out["first_step"] = step
    if step is not None:
        _, _, whole_m = sample_trace(torch, model, noise, record_step=step)
        _, _, sharded_m = sample_trace(torch, model, noise, mesh,
                                       record_step=step)
        for (name, w), (name_s, s) in zip(whole_m, sharded_m):
            if name != name_s:
                out["module"] = f"call order differs: {name} / {name_s}"
                break
            w = rows(s, w)
            if not torch.equal(s, w):
                out.update(module=name, shape=list(s.shape),
                           max_abs_err=(s.float() - w.float()).abs().max()
                           .item(), max_abs_out=w.float().abs().max().item())
                break
    return out, whole.cpu()


def rank_length_sharded(torch, model, mesh, rank, root):
    """The 50-step flagship sample with the length split over the ranks:
    launches, collectives and ms per step, peak; this rank's part saved for
    the parent; against the whole sample in this process, and the first
    step and module that diverge if any."""
    from audio_diffusion_torch import sample_length_sharded
    from audio_diffusion_torch.ops.kernels import resnet
    from audio_diffusion_torch.parallel import comm

    noise = flagship_noise(torch)
    calls = [0]
    gather = comm.all_gather_rows

    def counted(*args, **kwargs):
        calls[0] += 1
        return gather(*args, **kwargs)

    with mock.patch.object(comm, "all_gather_rows", counted):
        sample_length_sharded(model, noise, 2, mesh)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resnet.fused_resnet_item.launches = 0
        calls[0] = 0
        t0 = time.perf_counter()
        # The sharded sample, with the net's output kept at each step.
        out, out_v, _ = sample_trace(torch, model, noise, mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / NUM_STEPS
        launches, collectives = resnet.fused_resnet_item.launches, calls[0]
    peak = torch.cuda.max_memory_allocated()
    torch.save(out.cpu(), root / f"length_sharded_rank{rank}.pt")
    divergence, whole = first_divergence(torch, model, noise, mesh, rank,
                                         out, out_v)
    if rank == 0:
        torch.save(whole, root / "length_sharded_whole.pt")
    del out_v
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, expected_launches=2 * sum(ITEMS)
                * NUM_STEPS, collectives_per_step=collectives / NUM_STEPS,
                ms_per_step=ms, peak_memory_bytes=peak,
                out_shape=list(out.shape),
                finite=bool(torch.isfinite(out).all()),
                first_divergence=divergence)


def rank_dp_flagship(torch, model, mesh, rank):
    """The flagship's DP train step at global batch 8 (4 per rank): the
    losses, launches per step, ms per step and peak over DP_STEPS steps;
    one step again (bit for bit) and one with ZeRO-1 (the same bits, half
    the moments per rank); every parameter moved."""
    from audio_diffusion_torch import make_train_step
    from audio_diffusion_torch.ops.kernels import resnet
    from audio_diffusion_torch.parallel import shard_batch

    item = resnet.fused_resnet_item
    init = {k: v.detach().clone() for k, v in model.params.items()}
    first = {}
    batch, _ = dp_batch(torch)
    local = shard_batch(batch, mesh)
    del batch

    def run(zero1, steps, keep=False):
        with torch.no_grad():
            for k, p in model.params.items():
                p.copy_(init[k])
        init_fn, step = make_train_step(
            model.loss, functools.partial(torch.optim.Adam, lr=1e-4),
            mesh=mesh, zero1=zero1)
        state = init_fn(model.params, dp_batch(torch)[1])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, launches = [], [], []
        for i in range(steps):
            item.launches = item.backward_launches = 0
            t0 = time.perf_counter()
            state, m = step(state, local)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            launches.append([item.launches, item.backward_launches])
            if keep and i == 0:
                first.update({k: v.detach().clone()
                              for k, v in model.params.items()})
        moments = sum(v.numel() * v.element_size()
                      for st in state.optimizer.state.values()
                      for v in st.values() if torch.is_tensor(v) and v.ndim)
        res = dict(losses=losses, ms_per_step=ms, launches_per_step=launches,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   moment_bytes=moments)
        del state
        return res

    plain = run(False, DP_STEPS, keep=True)
    still = [k for k, v in first.items() if torch.equal(v, init[k])]
    again = run(False, 1)
    rerun_bit = all(torch.equal(p.detach(), first[k])
                    for k, p in model.params.items())
    zero = run(True, 1)
    zero1_bit = all(torch.equal(p.detach(), first[k])
                    for k, p in model.params.items())
    del init, first
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(batch=TRAIN_BATCH, rank_batch=TRAIN_BATCH // RANKS,
               plain=plain, rerun=again, zero1=zero, still=still[:5],
               rerun_bit_equal=rerun_bit, zero1_params_bit_equal=zero1_bit)
    expected = [[2 * sum(ITEMS)] * 2] * DP_STEPS
    if (still or not (rerun_bit and zero1_bit)
            or plain["launches_per_step"] != expected
            or again["losses"] != plain["losses"][:1]
            or 2 * zero["moment_bytes"] > plain["moment_bytes"] * 1.01):
        raise AssertionError(f"dp_flagship rank {rank}: {out}")
    return out


def ranks_flagship(torch, mesh, rank, root, backend):
    """Both flagship phases on one flagship (sampling leaves its weights
    as they were)."""
    model = build_flagship(torch)
    return dict(length_sharded_flagship=rank_length_sharded(
        torch, model, mesh, rank, root), dp_flagship=rank_dp_flagship(
        torch, model, mesh, rank))


RANK_GROUPS = {"small": ranks_small, "flagship": ranks_flagship}


def phase_multi_rank_small(root: Path, backend: str = "gloo"):
    """``kernel_sharded_vs_plain`` and ``multi_rank_small_reference`` on
    RANKS ranks (the ranks check their bars; this emits their rows)."""
    ranks = spawn_ranks("small", root, backend)
    label = ("2 ranks on one card over gloo, host-staged" if backend == "gloo"
             else f"{RANKS} ranks on {RANKS} cards over NCCL")
    for row in ranks[0]["kernel_sharded_vs_plain"]:
        emit(dict(phase="kernel_sharded_vs_plain", backend=backend,
                  times=label, **row))
    emit(dict(phase="kernel_sharded_vs_plain_ranks", backend=backend,
              rows_per_rank=[len(r["kernel_sharded_vs_plain"])
                             for r in ranks],
              all_bit_equal=all(row["output_bit_equal"]
                                and row["stats_bit_equal"]
                                for r in ranks
                                for row in r["kernel_sharded_vs_plain"])))
    for r, res in enumerate(ranks):
        emit(dict(phase="multi_rank_small_reference", backend=backend,
                  rank=r, **res["multi_rank_small_reference"]))
    return ranks


def phase_multi_rank_flagship(root: Path, unsharded, dp_reference_loss):
    """``length_sharded_flagship`` and ``dp_flagship`` on two ranks sharing
    the card over gloo: the sharded sample against the main path's
    unsharded one (bit for bit is the target; otherwise the first diverging
    module and a relative L2 error within the full-width forward's 5e-2),
    2,100 launches per rank; the DP step's first loss within 1e-5 of the
    one-process batch-8 step's, 42 + 42 launches per rank per step.
    Returns (launches per rank of the sample, of a DP step)."""
    import torch

    ranks = spawn_ranks("flagship", root, "gloo")
    label = "2 ranks on one card over gloo, host-staged"
    parts = [torch.load(root / f"length_sharded_rank{r}.pt")
             for r in range(RANKS)]
    got = torch.cat(parts, dim=-1).float()
    want = unsharded.float()
    bit = torch.equal(got, want)
    rel_l2 = ((got - want).norm() / want.norm()).item()
    ls = [r["length_sharded_flagship"] for r in ranks]
    # The ranks' own unsharded sample, against the one this process took.
    whole = torch.load(root / "length_sharded_whole.pt").float()
    emit(dict(phase="length_sharded_flagship", steps=NUM_STEPS,
              length=LENGTH, dtype="bfloat16", ranks=RANKS, times=label,
              bit_equal=bit,
              max_abs_err=(got - want).abs().max().item(),
              max_abs_out=want.abs().max().item(), rel_l2_err=rel_l2,
              ranks_whole_bit_equal_to_main_path=torch.equal(whole, want),
              ranks_whole_max_abs_err=(whole - want).abs().max().item(),
              per_rank=ls))
    launches = [r["launches"] for r in ls]
    if launches != [r["expected_launches"] for r in ls]:
        raise AssertionError(f"length_sharded_flagship: launches {launches}")
    divergences = [r["first_divergence"] for r in ls]
    found = all(d["bit_equal"] or d.get("module") for d in divergences)
    if not all(r["finite"] for r in ls) or not (
            bit or (rel_l2 <= 5e-2 and found)):
        raise AssertionError(
            f"length_sharded_flagship: bit-equal {bit}, rel L2 {rel_l2}, "
            f"first divergence {divergences}")
    dp = [r["dp_flagship"] for r in ranks]
    rel = abs(dp[0]["plain"]["losses"][0] - dp_reference_loss) / abs(
        dp_reference_loss)
    emit(dict(phase="dp_flagship", times=label, ranks=RANKS,
              reference_loss=dp_reference_loss, loss_rel_err=rel,
              moment_share_zero1=(dp[0]["zero1"]["moment_bytes"]
                                  / dp[0]["plain"]["moment_bytes"]),
              per_rank=dp))
    if rel > 1e-5 or dp[0]["plain"]["losses"] != dp[1]["plain"]["losses"]:
        raise AssertionError(f"dp_flagship: loss rel {rel}, losses "
                             f"{[d['plain']['losses'] for d in dp]}")
    return launches, [d["plain"]["launches_per_step"][-1] for d in dp]


def phase_nccl_world1():
    """``create_mesh()`` under NCCL at world size 1, with no launcher: the
    small net's mesh step bit-equal to the plain step."""
    import torch
    import torch.distributed as dist
    from audio_diffusion_torch import DiffusionModel, UNetV0
    from audio_diffusion_torch.parallel import create_mesh

    base = DiffusionModel(net_t=UNetV0, seed=1, **SMALL_PARALLEL)
    fill_zero_params(base)
    params0 = {k: v.detach().clone() for k, v in base.params.items()}
    x = torch.randn(SMALL_PARALLEL_BATCH, 2, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    plain = small_parallel_steps(torch, params0, x)
    mesh = create_mesh()
    try:
        backend = dist.get_backend()
        runs = {z: small_parallel_steps(torch, params0, x, mesh, zero1=z)
                for z in (False, True)}
    finally:
        dist.destroy_process_group()
    bit = {z: r[0] == plain[0] and all(torch.equal(r[2][k], v)
                                       for k, v in plain[2].items())
           for z, r in runs.items()}
    emit(dict(phase="nccl_world1", backend=backend, mesh=list(mesh.shape),
              bit_equal=bit[False], zero1_bit_equal=bit[True],
              losses=plain[0]))
    if backend != "nccl" or not all(bit.values()):
        raise AssertionError(f"nccl_world1: backend {backend}, bit {bit}")


def summary(name, source, replaces, level_rows, **counts):
    """A kernel's row of the summary: each shape's bf16 numbers times its
    items per pass, summed over ``level_rows`` (a pass of the net)."""
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


def attention_summary(name, route, source, replaces, index, rows_by_pass,
                      launches):
    """The summary's row of the attention core (``index`` 0) or the
    LayerNorm (1): per uncond pass at batch 1, ``guided_*`` per guided text
    pass at batch 2, ``batch8_*`` per uncond pass at batch 8; ``launches``
    (uncond sample, guided sample)."""
    keys = PER_PASS_KEYS + ("host_ms",)
    per_pass = {key: summary(name, source, replaces, rows[index])
                for key, rows in rows_by_pass.items()}
    return {**per_pass["uncond"], "route": route, "launches": launches[0],
            "guided_launches": launches[1],
            "library_host_ms": sum(r["library_host_ms"] * r["items_per_forward"]
                                   for r in rows_by_pass["uncond"][index]),
            "max_rel_l2_err": max(r["rel_l2_err"] for rows in
                                  rows_by_pass.values()
                                  for r in rows[index]),
            **{f"{key}_{k}": per_pass[key][k]
               for key in ("guided", "batch8")
               for k in keys}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    attention_rows = phase_attention_kernels_vs_plain(flush)
    del flush
    phase_small_reference()
    phase_train_small()
    phase_trainer_small_reference()
    phase_cond_small_reference()
    phase_sampler_small_reference()
    phase_dsp_small_reference()
    phase_task_small_reference()
    phase_quant_small_reference()
    phase_distill_small_reference()
    phase_nd_small_reference()

    # Multi-GPU, small: NCCL at world size 1 in this process; then two ranks
    # on the card over gloo (and over NCCL where there are two cards): the
    # sharded item at the flagship's levels and the small net's paths.
    phase_nccl_world1()
    ranks_root = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    small_ranks = phase_multi_rank_small(ranks_root)
    if torch.cuda.device_count() >= RANKS:
        phase_multi_rank_small(ranks_root, "nccl")

    model = build_flagship(torch)
    noise = flagship_noise(torch)
    phase_forward(model, noise)
    # The one-process loss that the DP step's first loss is held against,
    # on the untrained weights that the ranks build.
    batch, loss_gen = dp_batch(torch)
    with torch.no_grad():
        dp_reference_loss = model.loss(model.params, loss_gen, batch).item()
    del batch

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
    unsharded = out.cpu()
    attn_launches = attention_launches("sample", model, noise, cross=False)
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
        artifact_launches, artifact_reuse_launches = phase_export_flagship(
            model, noise, art_root)
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

    # The training main path: counts set to 0 inside, just before its steps;
    # then a halving stage of progressive distillation, with its own.
    train_launches = phase_train(model)
    gc.collect()
    torch.cuda.empty_cache()
    distill_launches = phase_distill_flagship(model, noise)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # The text-conditional paths (guided sample, with and without encoder
    # reuse; training with embedding dropout), each with its own counts;
    # then the T5 encoder stack and a guided DPM sample through it.
    model = build_text_model(torch)
    text_launches = phase_sample_text(model, noise)
    text_attn_launches = attention_launches(
        "sample_text", model, noise, cross=True, text=CAPTIONS[:1],
        embedding_scale=GUIDANCE)
    embedding = torch.as_tensor(model.net.text_encoder(CAPTIONS),
                                device=model.device)
    text_train_launches = phase_train(model, "train_text",
                                      embedding=embedding,
                                      embedding_mask_proba=0.1)
    gc.collect()
    torch.cuda.empty_cache()
    guidance_distill_launches = phase_guidance_distill_flagship(model,
                                                                embedding)
    t5_launches = phase_t5_text(model, noise)
    del model, embedding
    gc.collect()
    torch.cuda.empty_cache()

    # The 2-D and 3-D nets at full width (cuDNN convs: no fused item at dim
    # 2/3), then the flagship with channel_change="first_item", each with
    # its own counts.
    for dim in (2, 3):
        phase_nd_full(torch, dim)
        gc.collect()
        torch.cuda.empty_cache()
    first_item_launches, first_item_train = phase_first_item_flagship(
        torch, noise)
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
    phase_embed_flagship(torch)
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
        phase_cli_distill_eval(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # Multi-GPU at full width, two ranks sharing the card over gloo: the
    # length-sharded 50-step sample and the DP train step, each with its
    # own counts in each rank.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        ls_launches, dp_launches = phase_multi_rank_flagship(
            ranks_root, unsharded, dp_reference_loss)
    finally:
        shutil.rmtree(ranks_root, ignore_errors=True)
    staged = [r for r in small_ranks[0]["kernel_sharded_vs_plain"]
              if r["dtype"] == "bfloat16"]

    def train_sums(train_rows, prefix):
        keys = ("kernel_ms", "library_ms", "bound_ms") + (
            ("plain_ms",) if all("plain_ms" in r for r in train_rows) else ())
        return {f"{prefix}_{key}": sum(r[key] * r["items_per_forward"]
                                       for r in train_rows)
                for key in keys}

    emit(dict(phase="run", seconds=time.perf_counter() - t_start))
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
                **{f"guided_batch_{k}": guided[k] for k in PER_PASS_KEYS},
                **{f"nomod_{k}": nomod[k] for k in PER_PASS_KEYS},
                **{f"encoder_nomod_{k}": encoder_fwd[k]
                   for k in PER_PASS_KEYS},
                **{f"batch16_{k}": batch16_fwd[k] for k in PER_PASS_KEYS},
                serve_launches=serve_launches, quant_launches=quant_launches,
                artifact_launches=artifact_launches,
                artifact_reuse_launches=artifact_reuse_launches,
                distill_launches_per_step=distill_launches[0],
                distilled_sample_launches=distill_launches[2],
                guidance_distill_launches_per_step=(
                    guidance_distill_launches[0]),
                first_item_launches=first_item_launches,
                first_item_train_launches=first_item_train[0],
                length_sharded_launches_per_rank=ls_launches,
                dp_train_launches_per_rank=[d[0] for d in dp_launches],
                sharded_staged_ms_per_rank=sum(
                    r["staged_ms"] * 2 * ITEMS[r["level"]] for r in staged),
                sharded_halo_copies_ms=sum(
                    r["halo_copies_ms"] * 2 * ITEMS[r["level"]]
                    for r in staged),
                **{f"batch8_{k}": batch8_fwd[k]
                   for k in PER_PASS_KEYS + ("host_ms", "bound_by")}),
        summary("fused_resnet_item.backward", BACKWARD_SOURCE,
                BACKWARD_REPLACES, bwd_rows, launches=train_launches[1],
                launches_per_train_step=train_launches[1] // TRAIN_STEPS,
                text_train_launches=text_train_launches[1],
                ar_train_launches=ar_train_launches[1],
                distill_launches_per_step=distill_launches[1],
                guidance_distill_launches_per_step=(
                    guidance_distill_launches[1]),
                first_item_train_launches=first_item_train[1],
                dp_train_launches_per_rank=[d[1] for d in dp_launches],
                conv_sources=[CONV_SOURCE, WGRAD_SOURCE],
                train_batch_ms=sum(r["kernel_ms"] * r["items_per_forward"]
                                   for r in bwd_train_rows),
                train_batch_library_ms=sum(
                    r["library_ms"] * r["items_per_forward"]
                    for r in bwd_train_rows),
                train_batch_bound_ms=sum(
                    r["bound_ms"] * r["items_per_forward"]
                    for r in bwd_train_rows),
                **{f"nomod_{k}": nomod_bwd[k] for k in PER_PASS_KEYS},
                **train_sums(nomod_bwd_train_rows, "nomod_train_batch"),
                upsampler_train_launches=up_train_launches[1],
                vocoder_train_launches=voc_train_launches[1],
                ae_train_launches=ae_train_launches[1],
                trainer_launches=trainer_launches[1],
                remat_launches={k: v[1] for k, v in remat_launches.items()},
                **{f"encoder_nomod_{k}": encoder_bwd[k]
                   for k in PER_PASS_KEYS},
                **train_sums(enc_bwd_train_rows, "encoder_nomod_train_batch"),
                **train_sums(batch16_bwd_rows, "batch16"),
                batch16_max_rel_err=max(r["max_rel_err"]
                                        for r in batch16_bwd_rows)),
        attention_summary("attention_core", "cuda", ATTENTION_SOURCE,
                          CORE_REPLACES, 0, attention_rows,
                          (attn_launches[0], text_attn_launches[0])),
        attention_summary("layer_norm", "library", LN_SOURCE, LN_REPLACES, 1,
                          attention_rows,
                          (attn_launches[1], text_attn_launches[1]))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"]
             else main())
