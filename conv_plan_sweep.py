#!/usr/bin/env python3
"""Where one bf16 item's device time goes at each of the flagship's nine
level shapes on one NVIDIA GPU. The evidence behind ``conv_plan``'s choice
of split and ``wgrad_plan``'s choice of slabs.

    python3 conv_plan_sweep.py [--levels 5 6 7 8]
    python3 conv_plan_sweep.py --backward [--batches 1 8] [--variants]

Forward (the default, batch 1): the item under the bf16 conv's own plan
(``conv_plan``) and under other split counts at the levels that split K.
Each line is one JSON object: the level, the plan (tile ``bn`` x
``64 * mt`` rows, ``splits`` x ``cps`` K chunks, CTAs), the item's device
time as ``chip_smoke.py`` measures it (``cuda_ms``: L2 flushed, behind a
spin kernel, median of 20), its max-abs error against the plain version
(bound 2^-5·max|y|, as in ``chip_smoke.py``), and the device time by
kernel of one more call (``torch.profiler``, µs).

``--backward``: one bf16 item backward (all 13 gradients from one output
gradient, the forward run once beforehand) per level at each batch, with
the plans of its two convolutions (the data gradient's ``conv_plan`` and
the weight gradient's ``wgrad_plan``), its device time (``cuda_ms``), its
largest gradient error relative to autograd of the plain version (bound
2e-2, as in ``chip_smoke.py``) and the device µs by kernel of one more
call. ``--variants`` adds, at each shape, the weight gradient under a
quarter, half and twice its plan's slab count, under the slab count whose
grid comes nearest one wave, and where its plan has the 64 x 128 wgmma
tile, under the 64 x 64 one.

The first lines are the card's name and power limit. Without a CUDA device
it exits with code 1.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
from unittest import mock

import chip_smoke as smoke


def by_kernel(fn, flush) -> dict:
    """Device µs by kernel name over one call of ``fn``, L2 flushed. A
    profile that caught no device event is taken again (up to three
    times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    out = {}
    for _ in range(3):
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("void ", "").replace(
                    "(anonymous namespace)::", "").split("(")[0]
                out[name] = out.get(name, 0.0) + e.device_time_total
        if out:
            break
    return out


def wgrad_variant(plan, batch, length, channels, slabs=None, tile=None):
    """``plan`` of the weight gradient with another slab count or the 64 x
    64 wgmma tile (64-position chunks), in ``wgrad_plan``'s keys (not the
    occupancy that ``backward_occupancy`` adds)."""
    tile = tile or plan["tile"]
    chunk = 64 if tile == 64 else plan["chunk"]
    chunks = batch * -(-length // chunk)
    cps = -(-chunks // min(chunks, slabs or plan["slabs"]))
    n = -(-chunks // cps)
    tiles = 1 if tile <= 32 else -(-channels // 64) * -(-channels // tile)
    return dict(tile=tile, chunk=chunk, chunks=chunks, cps=cps, slabs=n,
                ctas=tiles * n, resident=plan["resident"],
                partial_bytes=12 * channels**2 * n if n > 1 else 0)


def wgrad_variants(plan, batch, length, channels, sms):
    """Other plans of the weight gradient at one shape: a quarter, half and
    twice the plan's slabs, the slab count whose grid comes nearest one
    wave of resident CTAs, and where the plan has the 64 x 128 wgmma tile,
    the 64 x 64 one."""
    chunks, tiles = plan["chunks"], plan["ctas"] // plan["slabs"]
    wave = plan["resident"] * sms
    nearest = min(range(1, chunks + 1), key=lambda n: (
        abs(tiles * -(-chunks // -(-chunks // n)) - wave), n))
    out = [wgrad_variant(plan, batch, length, channels, slabs=n)
           for n in (max(1, plan["slabs"] // 4), max(1, plan["slabs"] // 2),
                     2 * plan["slabs"], nearest)]
    if plan["tile"] == 128:
        out.append(wgrad_variant(plan, batch, length, channels, tile=64))
    seen = {(plan["tile"], plan["slabs"])}
    return [v for v in out if (v["tile"], v["slabs"]) not in seen
            and not seen.add((v["tile"], v["slabs"]))]


def sweep_backward(levels, batches, variants, sms, flush, gen) -> None:
    """One bf16 item backward per level and batch, under the plans and,
    with ``variants``, under other plans of the weight gradient."""
    import torch
    from audio_diffusion_torch.ops.kernels import resnet

    for batch in batches:
        for level in levels:
            c, length = smoke.LEVELS[level]
            args = smoke.item_inputs(c, length, torch.bfloat16, gen,
                                     batch=batch)
            g = smoke.item_inputs(c, length, torch.bfloat16, gen,
                                  batch=batch)[0]
            plans = resnet.backward_occupancy(c, length, batch)
            base = plans["weight_gradient"]
            others = (wgrad_variants(base, batch, length, c, sms)
                      if variants else [])
            want = smoke.backward_of(
                functools.partial(resnet.resnet_item_reference,
                                  groups=smoke.GROUPS), args, g)()
            for wplan in [None, *others]:
                patch = (mock.patch.object(resnet, "wgrad_plan",
                                           lambda *a, p=wplan: p)
                         if wplan else contextlib.nullcontext())
                with patch:
                    run = smoke.backward_of(
                        functools.partial(resnet.fused_resnet_item,
                                          groups=smoke.GROUPS), args, g)
                    got = run()
                    torch.cuda.synchronize()
                    rel, _ = smoke.gradient_errors(
                        got, want, c, 2e-2, f"level {level} batch {batch}")
                    row = dict(
                        direction="backward", level=level, channels=c,
                        length=length, batch=batch,
                        variant="plan" if wplan is None else "other",
                        dgrad_plan={k: v for k, v in plans[
                            "data_gradient"].items() if k in (
                                "bn", "mt", "splits", "cps", "ctas",
                                "wave_fill")},
                        wgrad_plan=wplan or base, ms=smoke.cuda_ms(run, flush),
                        max_rel_err=rel, tolerance=2e-2,
                        device_us=by_kernel(run, flush))
                print(json.dumps(row), flush=True)
                del run, got


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    from audio_diffusion_torch.ops.kernels import resnet

    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, nargs="*",
                    default=list(range(len(smoke.LEVELS))))
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[1, smoke.TRAIN_BATCH])
    ap.add_argument("--variants", action="store_true")
    opts = ap.parse_args()
    levels = opts.levels
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if opts.backward:
        sweep_backward(levels, opts.batches, opts.variants, sms, flush, gen)
        return 0
    own = resnet.conv_plan
    for level in levels:
        c, length = smoke.LEVELS[level]
        args = smoke.item_inputs(c, length, torch.bfloat16, gen)
        base = own(1, length, c, sms)
        # The plan, then at the split levels each power-of-two split.
        plans = [dict(base, variant="conv_plan")]
        if base["splits"] > 1:
            tiles = base["ctas"] // base["splits"]
            for splits in (1, 2, 4, 8, 16, 32):
                cps = -(-base["chunks"] // splits)
                n = -(-base["chunks"] // cps)
                if splits > base["chunks"] or n == base["splits"]:
                    continue
                plans.append(dict(base, variant="other", cps=cps, splits=n,
                                  ctas=tiles * n,
                                  workspace_bytes=(4 * length * c * n
                                                   if n > 1 else 0)))
        for plan in plans:
            with mock.patch.object(resnet, "conv_plan",
                                   lambda *a, plan=plan: plan), \
                    torch.inference_mode():
                def run():
                    return resnet.fused_resnet_item(*args,
                                                    groups=smoke.GROUPS)

                out = run()
                ref = resnet.resnet_item_reference(*args, groups=smoke.GROUPS)
                err = (out.float() - ref.float()).abs().max().item()
                bound = 2.0 ** -5 * ref.float().abs().max().item()
                row = dict(level=level, channels=c, length=length, batch=1,
                           plan={k: plan[k] for k in (
                               "variant", "bn", "mt", "splits", "cps",
                               "ctas")},
                           ms=smoke.cuda_ms(run, flush), max_abs_err=err,
                           tolerance=bound, device_us=by_kernel(run, flush))
            print(json.dumps(row), flush=True)
            if not err <= bound:
                raise AssertionError(f"level {level} {plan}: {err} > {bound}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
