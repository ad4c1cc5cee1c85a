#!/usr/bin/env python3
"""Readings for the limits of ``correct``: for each seed, one cell's run
(set-up, a short window at the cell's own load, the check), printing the
program's compared numbers beside the control's (the plain reference in
float8 in the program's place, and for training a batch half left out) for
the first ``--control`` seeds, one JSON line per seed. Seeds share the process, so the set-up's imports and
builds are paid once::

    python3 benchmark/calibrate.py --workload NAME --seconds S --seeds 1 2 3 \
        [--control N]
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
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=None,
                        help="run the control for this many seeds (all)")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]

    import torch
    from harness import core

    cell = core.Cell.find(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    driver = cell.driver()
    controls = len(args.seeds) if args.control is None else args.control
    for i, seed in enumerate(args.seeds):
        run = core.Run(cell, seed, args.seconds, False, torch.device("cuda"),
                       time.perf_counter())
        state = driver.setup(run)
        driver.window(run, state)
        control = driver.check(run, state, control=i < controls)
        del state
        core.free()
        print(json.dumps(dict(
            workload=args.workload, seed=seed, attempted=run.attempted,
            e2e=run.e2e, program={c["name"]: c["value"]
                                  for c in run.compared},
            control=control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
