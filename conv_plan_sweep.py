#!/usr/bin/env python3
"""Where one bf16 item's device time goes at each of the flagship's nine
level shapes (batch 1) on one NVIDIA GPU, under the bf16 conv's own plan
(``conv_plan``) and under other split counts at the levels that split K.
The evidence behind ``conv_plan``'s choice of split.

    python3 conv_plan_sweep.py [--levels 5 6 7 8]

Each line is one JSON object: the level, the plan (tile ``bn`` x
``64 * mt`` rows, ``splits`` x ``cps`` K chunks, CTAs), the item's device
time as ``chip_smoke.py`` measures it (``cuda_ms``: L2 flushed, behind a
spin kernel, median of 20), its max-abs error against the plain version
(bound 2^-5·max|y|, as in ``chip_smoke.py``), and the device time by
kernel of one more call (``torch.profiler``, µs). The first lines are the
card's name and power limit. Without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from unittest import mock

import chip_smoke as smoke


def by_kernel(fn, flush) -> dict:
    """Device µs by kernel name over one call of ``fn``, L2 flushed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.device_time_total
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    from audio_diffusion_torch.ops.kernels import resnet

    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, nargs="*",
                    default=list(range(len(smoke.LEVELS))))
    levels = ap.parse_args().levels
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
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
