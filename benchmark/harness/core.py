"""The run of one cell: find its configuration, traffic and metrics by name,
make the weights from the seed, build the program's model, hand the cell to
its driver, and print the result line.

A driver (``drivers/<name>.py``) has three functions:

- ``setup(run) -> state``: the model and everything the window needs,
  warmed at the cell's own shapes;
- ``window(run, state)``: the measured window; it sets ``run.e2e`` (the
  end-to-end metrics it measures), ``run.attempted``, ``run.failed`` and
  whatever the per-layer readers read in ``run.counters``;
- ``check(run, state, control=False)``: after the window, frees the
  program's state, runs the plain reference and adds each compared number
  with ``run.compare``. With ``control`` it also returns the control's
  readings (the reference in lower precision, or a planted fault, in the
  program's place), for the calibration of the limits.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_diffusion_tpu")


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` (whose name may hold dots) as
    ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files, found by name."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path = BENCH_DIR

    @classmethod
    def find(cls, name: str, bench_file: Path = ROOT / "BENCHMARK.json",
             bench_dir: Path = BENCH_DIR) -> "Cell":
        bench = read_json(bench_file)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in {bench_file.name}; "
                           f"known: {sorted(entries)}")
        entry = entries[name]
        files = {c["name"]: c["file"] for c in bench["configs"]}
        config = read_json(bench_file.parent / files[entry["config"]])
        traffic = read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
        e2e = [m for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if name in m.get("workloads", [name] if m["moves"]
                                      in moved else [])]
        return cls(name, entry, config, traffic, e2e, per_layer, bench_dir)

    def driver(self) -> ModuleType:
        name = self.traffic["driver"]
        return load_module(self.bench_dir / "drivers" / f"{name}.py",
                           f"bench_driver_{name}")

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_module(
            self.bench_dir / "metrics" / f"{m['name']}.py",
            "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed that is a pure function of ``seed`` and ``tags``."""
    state = np.random.SeedSequence(
        [abs(int(seed)), int(seed < 0), *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


# Tags of the streams drawn from one run seed.
WEIGHTS, INPUTS, CHECK, LOSS, CORPUS, ARRIVALS, WARMUP = range(7)

_KIND = {"kernel": (0.0, None), "gate": (0.0, 0.02), "scale": (1.0, 0.02),
         "bias": (0.0, 0.02), "freqs": (0.0, 16.0), "embed": (0.0, 0.02)}


def make_weights(spec, seed: int, device) -> Dict[str, Any]:
    """Every parameter of ``spec`` (the reference's ``param_spec``) as
    float32 on ``device``: one normal draw for all of them from a generator
    on the device, then each leaf's mean and spread by its kind."""
    import torch

    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out, off = {}, 0
    for name, shape, kind, fan_in in spec:
        n = math.prod(shape)
        mean, std = _KIND[kind]
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(std if std is not None else 1.0 / math.sqrt(fan_in))
        if mean:
            leaf.add_(mean)
        out[name] = leaf
        off += n
    return out


def build_model(config: dict, weights: Dict[str, Any], device):
    """The program's ``DiffusionModel`` at the configuration's sizes and
    dtype, with the benchmark's weights loaded (every name and shape must
    match). Where the file names a preset, the preset must hold the same
    sizes."""
    import torch
    from audio_diffusion_torch import DiffusionModel, UNetV0, presets
    from audio_diffusion_torch.ops import text

    net = dict(config["net"])
    if "preset" in config:
        preset = getattr(presets, config["preset"])
        differ = {k for k in set(preset) | set(net)
                  if k in preset and preset[k] != net.get(k)}
        if differ:
            raise ValueError(f"{config['name']}: the preset "
                             f"{config['preset']} differs in {sorted(differ)}")
    if net.get("use_text_conditioning"):
        net["text_encoder"] = getattr(text, config["text_encoder"])(
            net["embedding_max_length"], net["embedding_features"])
    model = DiffusionModel(net_t=UNetV0, dtype=getattr(torch, config["dtype"]),
                           device=device, **net)
    with torch.no_grad():
        model.net.module.load_state_dict(weights, strict=True)
    return model


@dataclasses.dataclass
class Run:
    """One run of one cell."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    compared: List[dict] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    profile: Any = None
    readers: Dict[str, ModuleType] = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def net(self) -> dict:
        return self.cell.config["net"]

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def rng(self, *tags: int) -> np.random.Generator:
        return np.random.default_rng(subseed(self.seed, *tags))

    def weights(self):
        from reference.unet import param_spec
        return make_weights(param_spec(self.net), self.seed, self.device)

    def compare(self, name: str, value: float, limit: float) -> None:
        """A number the run compares, with its limit: it passes when it is
        finite and not above the limit."""
        self.compared.append(dict(name=name, value=float(value),
                                  limit=float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.compared)


def free(*objs) -> None:
    """Drop the program's state and return its memory to the device."""
    import torch

    del objs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# The cores the window's threads are kept on: the dispatching thread and
# the one that runs the backward or the service's worker.
HOLD_CORES = 2


def hold_host():
    """Quiet the host for the window: no cyclic garbage collection, so no
    pass over the model's objects falls inside it, and every thread of the
    process kept on the last ``HOLD_CORES`` of the cores it may use, so
    the scheduler does not move the dispatching thread (windows in one
    process on the H100's host: the batch-1 sampler about 15% faster,
    training 20%).
    Returns a function that undoes both."""
    gc.collect()
    gc.disable()
    allowed = sorted(os.sched_getaffinity(0))
    pinned = set(allowed[-HOLD_CORES:])
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), pinned)
        except OSError:
            pass

    def release():
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), set(allowed))
            except OSError:
                pass
        gc.enable()

    return release


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def execute(run: Run, driver: ModuleType) -> dict:
    """Set-up, window and check of one run; returns the result line's
    object (without ``device``)."""
    import torch

    if run.trace:
        run.readers = run.cell.readers()
    state = driver.setup(run)
    setup_s = time.perf_counter() - run.t_start
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.counters["setup_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    release = hold_host()
    try:
        driver.window(run, state)
    finally:
        release()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.counters["window_peak_bytes"] = torch.cuda.max_memory_allocated()
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or the JAX package were loaded: "
                          f"{found}")
    driver.check(run, state)
    del state
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            value = run.readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in run.cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else run.e2e[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = dict(correct=run.correct, attempted=run.attempted,
               failed=run.failed, metrics=metrics)
    if run.trace and run.profile is not None:
        out["breakdown"] = run.profile.breakdown()
    return out


def result_line(run: Run, out: dict, device: dict) -> dict:
    """The last line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a traced run's ``breakdown``, and each
    compared number beside its limit under ``compared``, last."""
    line = dict(correct=out["correct"], attempted=out["attempted"],
                failed=out["failed"], metrics=out["metrics"], device=device)
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in run.compared}
    return line
