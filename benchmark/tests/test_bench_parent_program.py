"""Every per-layer reader works against a program that lacks what some of
them read: a traced run's host events with no range of the program's own,
and ``service_stats`` with only its four counters. There each reader
returns None or a number and never raises, and loading the readers imports
nothing of the program. With the program, each reader of its spans
(``sampler.step``, ``train.data``, ``train.wait``) and of the service's
batch timeline (``recent_batches``) reads a finite number."""
import math
import subprocess
import sys
import time

import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from harness import core
from harness.trace import Trace
from tiny import bench, cell, run_cell

SPAN_READERS = {"step_host_ms.sample": "uncond-sample-b1",
                "step_host_ms.train": "uncond-train-b8",
                "device_wait_ms.train": "uncond-train-b8"}
SERVE_READERS = ("serve.program_queue_wait_ms", "serve.dispatch_ms_per_step",
                 "serve.device_wait_ms")
PARENT_STATS = dict(requests=12, batches=4, padded_slots=4,
                    mean_occupancy=0.5)


def _cells():
    return [w["name"] for w in bench()["workloads"]]


def _readers(workload):
    return core.Cell.find(workload).readers()


def _finite_or_none(value):
    return value is None or math.isfinite(float(value))


def _plain_trace():
    """A CPU trace of plain torch ops inside a range of the benchmark's own,
    as the parent's program leaves one: no range of the program."""
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("bench.train_step"):
                (x @ x).sum().item()
    return Trace(list(prof.events()), 0.01)


def _parent_run(workload):
    run = core.Run(cell(workload), 7, 1.0, True, torch.device("cpu"),
                   time.perf_counter())
    run.profile = _plain_trace()
    run.counters.update(
        window_s=1.0, steps=20, stretch_s=0.1, stretch_steps=2,
        item_batch=1, stretch_items=[], window_peak_bytes=2**20,
        late_check_bytes=0, queue_waits_s=[0.5, 0.7],
        service_stats=dict(PARENT_STATS))
    return run


@pytest.mark.parametrize("workload", _cells())
def test_readers_on_the_parents_program(workload):
    run = _parent_run(workload)
    for name, reader in _readers(workload).items():
        value = reader.read(run)
        assert _finite_or_none(value), (name, value)
        if name in SPAN_READERS or name in SERVE_READERS:
            assert value is None, name
    run.profile = None
    run.counters["service_stats"] = {}
    for name, reader in _readers(workload).items():
        if name in SPAN_READERS or name in SERVE_READERS:
            assert reader.read(run) is None, name


def test_loading_the_readers_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(core.BENCH_DIR)!r}, {str(core.ROOT)!r}]\n"
        "import json\n"
        "from harness import core\n"
        "names = [w['name'] for w in json.loads((core.ROOT / "
        "'BENCHMARK.json').read_text())['workloads']]\n"
        "for n in names:\n"
        "    core.Cell.find(n).readers()\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'audio_diffusion_torch'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=core.ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_serve_readers_read_the_programs_timeline():
    run, _ = run_cell("uncond-serve-poisson")
    stats = run.counters["service_stats"]
    assert any(b["num_steps"] == 1 for b in stats["recent_batches"])
    readers = _readers("uncond-serve-poisson")
    for name in SERVE_READERS:
        value = readers[name].read(run)
        assert value is not None and math.isfinite(value) and value >= 0, \
            name


def test_span_readers_read_the_programs_spans():
    """A CPU trace of the tiny net's sampler and of one ``Trainer.fit``
    step inside the benchmark's ``bench.train_step`` range."""
    from audio_diffusion_torch.train import Trainer, TrainerConfig

    run = core.Run(cell("uncond-train-b8"), 7, 1.0, True,
                   torch.device("cpu"), time.perf_counter())
    model = core.build_model(run.config, run.weights(), run.device)
    trainer = Trainer(model, TrainerConfig(max_grad_norm=1.0,
                                           ema_decay=0.9, log_every=2**62),
                      log_fn=lambda s: None)
    batch = torch.randn(2, 2, 256, generator=torch.Generator().manual_seed(0))
    trainer.fit(iter([batch]), num_steps=1)
    noise = torch.randn(1, 2, 256, generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.sample(noise, num_steps=3)
        with record_function("bench.train_step"):
            trainer.fit(iter([batch]), num_steps=1)
    run.profile = Trace(list(prof.events()), 0.01)
    for name, workload in SPAN_READERS.items():
        value = _readers(workload)[name].read(run)
        assert value is not None and math.isfinite(value) and value > 0, \
            name
    optimizer = _readers("uncond-train-b8")["optimizer_device_ms.train"]
    assert optimizer.read(run) is not None
