#!/usr/bin/env python3
"""Run one cell of the benchmark of ``audio_diffusion_torch`` once:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port. The cell (a workload of
``BENCHMARK.json``) names its configuration and its traffic; the run makes
its weights and inputs from the seed on the card, warms the cell's shapes,
measures for ``--seconds`` seconds, compares what the window produced with
the plain reference under ``benchmark/reference/``, and prints one JSON line
as the last line of its output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a short profiled
stretch inside the window. Each number compared is printed beside its limit
as the last lines of standard error and under ``compared`` in that line.

It exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), or where a module of JAX or
of the JAX package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Build and kernel caches stay at fixed paths inside the checkout, so only
# a cell's first run there builds.
CACHE = ROOT / ".bench_cache"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return proc.stdout.strip().splitlines()[0] if proc.stdout else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # One process with few threads: idle intra-op threads that spin would
    # take cores from the host thread that dispatches to the card.
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(BENCH), str(ROOT)]

    import torch
    from harness import core

    cell = core.Cell.find(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = core.Run(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), T_START)
    out = core.execute(run, cell.driver())
    found = core.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=chips,
                  memory_peak_bytes=max(run.counters.get(k, 0) for k in (
                      "setup_peak_bytes", "window_peak_bytes")))
    if run.trace:
        if run.profile is None:
            print("the traced stretch did not run inside the window",
                  file=sys.stderr)
            return 4
        device.update(busy_s=run.profile.busy_s,
                      window_s=run.profile.wall_s)
    print(f"card: {card_line()}", file=sys.stderr)
    line = core.result_line(run, out, device)
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
