"""``BENCHMARK.json`` against the benchmark's contract, and the last line
of a run against the schema the driver reads."""
import json
import math
import re
import time

import pytest
import torch

from harness import core
from tiny import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) \
        == len(b["workloads"])
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"] + b["configs"] \
            + b["workloads"]:
        assert NAME.match(m["name"]), m["name"]
        if "unit" in m:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        cell = core.Cell.find(w["name"])
        assert [m for m in cell.end_to_end if m["name"] != "setup_s"]
        assert cell.per_layer


def _line(trace: bool) -> dict:
    run = core.Run(core.Cell.find("uncond-sample-b1"), 1, 1.0, trace,
                   torch.device("cpu"), time.perf_counter())
    run.compare("sample_rel_l2", 0.01, 0.03)
    out = dict(correct=run.correct, attempted=3, failed=0,
               metrics={"mfu.sample": {"value": 0.5, "unit": "%"}})
    device = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1,
                  memory_peak_bytes=123)
    if trace:
        out["breakdown"] = {"device_ops": [["k", 0.1]],
                            "idle_gaps": [["h", 0.2]]}
        device.update(busy_s=0.1, window_s=1.0)
    return core.result_line(run, out, device)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(trace):
    line = json.loads(json.dumps(_line(trace)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert ("breakdown" in line) == trace
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert line["compared"]["sample_rel_l2"] == {"value": 0.01,
                                                 "limit": 0.03}


def test_compared_past_its_limit_is_not_correct():
    run = core.Run(core.Cell.find("uncond-sample-b1"), 1, 1.0, False,
                   torch.device("cpu"), time.perf_counter())
    assert not run.correct  # nothing compared
    run.compare("a", 0.01, 0.03)
    run.compare("b", float("nan"), 0.03)
    assert not run.correct


def test_hold_host_pins_every_thread_and_releases():
    import gc
    import os
    import threading

    allowed = os.sched_getaffinity(0)
    seen = {}
    release = core.hold_host()
    try:
        worker = threading.Thread(
            target=lambda: seen.update(cpus=os.sched_getaffinity(0)))
        worker.start()
        worker.join()
        assert not gc.isenabled()
        held = os.sched_getaffinity(0)
        assert held <= allowed
        assert len(held) == min(core.HOLD_CORES, len(allowed))
        assert seen["cpus"] == held
    finally:
        release()
    assert gc.isenabled()
    assert os.sched_getaffinity(0) == allowed
