#!/usr/bin/env python3
"""The serving cell's knee: one set-up, then a window of open-loop Poisson
arrivals at each given rate through a fresh, warmed service, printing one
JSON line per rate (requests, completed per second of window, latency
median and p90, the median latency of each third of the arrivals: a
backlog that grows shows as thirds that rise)::

    python3 benchmark/sweep_serve.py --workload uncond-serve-poisson \\
        --seed 1 --seconds 30 --rates 2.5 3 3.5 4 4.5 5
"""
import time

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]

    import torch
    from harness import core

    cell = core.Cell.find(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    driver = cell.driver()
    run = core.Run(cell, args.seed, args.seconds, False, torch.device("cuda"),
                   time.perf_counter())
    state = driver.setup(run)
    for i, rate in enumerate(args.rates):
        if i:
            driver.start_service(run, state)
        run.traffic["rate_per_s"] = rate
        run.counters.clear()
        state.timed.calls.clear()
        driver.window(run, state)
        c = run.counters
        print(json.dumps(dict(
            rate_per_s=rate, requests=run.attempted, failed=run.failed,
            completed_per_s=(run.attempted - run.failed) / c["window_s"],
            window_s=c["window_s"], p90_s=run.e2e["serve_p90_s"],
            thirds_median_s=c["latency_thirds_median_s"],
            batches=c["batches"], stats=c["service_stats"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
