"""Tiny cells for the CPU tests: the nine-level net's structure cut to
three levels, at lengths a CPU runs in seconds, under the real cells'
drivers and limits."""
import copy
import json
import time

import torch

from harness import core

NET = dict(in_channels=2, channels=[8, 16, 32], factors=[1, 2, 2],
           items=[1, 1, 2], attentions=[0, 0, 1], attention_heads=2,
           attention_features=8, modulation_features=16, resnet_groups=4)
TEXT_NET = dict(NET, cross_attentions=[0, 1, 1], use_text_conditioning=True,
                use_embedding_cfg=True, embedding_max_length=4,
                embedding_features=12)
SIZES = dict(length=256, crop=256, file_frames=1024, files=3,
             num_steps=4, check_samples=2, check_requests=2, drain_s=20)


def cell(workload: str, dtype: str = "float32", **traffic_keys) -> core.Cell:
    """The workload of ``BENCHMARK.json`` with its traffic and limits, on
    the tiny net."""
    real = core.Cell.find(workload)
    traffic = copy.deepcopy(real.traffic)
    traffic.update({k: v for k, v in SIZES.items() if k in traffic})
    if traffic["driver"] == "train":
        traffic["batch"] = 4
    if traffic["driver"] == "serve":
        traffic.update(batch_size=3, rate_per_s=4.0)
    if "embedding_rows" in traffic:
        traffic["embedding_rows"] = [1, 3]
    traffic.update(traffic_keys)
    net = TEXT_NET if "use_text_conditioning" in real.config["net"] else NET
    config = dict(name="tiny", dtype=dtype, net=net,
                  text_encoder="StubTextEncoder")
    return core.Cell(workload, real.entry, config, traffic, real.end_to_end,
                     real.per_layer)


def run_cell(workload: str, seed: int = 20261017, seconds: float = 1.0,
             control: bool = False, before_window=None, **traffic_keys):
    """Set-up, window and check of a tiny cell on the CPU; (run, the
    control's readings or None). ``before_window`` is called between
    set-up and window."""
    c = cell(workload, **traffic_keys)
    run = core.Run(c, seed, seconds, False, torch.device("cpu"),
                   time.perf_counter())
    driver = c.driver()
    state = driver.setup(run)
    if before_window is not None:
        before_window()
    driver.window(run, state)
    readings = driver.check(run, state, control=control)
    return run, readings


def bench() -> dict:
    return json.loads((core.ROOT / "BENCHMARK.json").read_text())
