"""The traced run's tools: ranges around the net's modules, a profiled
stretch inside the window, and the reduction of its trace.

A range is entered by a forward pre-hook on a module and left by its
forward hook (or, for a backward, by full backward hooks); each end
launches a marker kernel, so a layer's time is the device time of the
kernels its module ran, whatever kernels implement it and whichever
library launched them. The profiler
records one short steady stretch (a few sampler steps, two train steps or
one served batch), which it holds in memory; no trace is written to disk.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["Ranges", "Stretch", "Trace"]


def _marker() -> None:
    """A tiny kernel of the benchmark's own on the current stream: the
    stream runs kernels in launch order, so the kernels between two markers
    are the ones the host launched between them, whichever library
    launched them and whether or not the profiler links them to a host
    op."""
    torch.cuda._sleep(0)


class Ranges:
    """Marked ranges named ``bench.<label>`` around every module of the
    given types, entered only while ``active``: a ``record_function`` (for
    the host's side of the trace) and a marker kernel at each end. With
    ``backward``, each module's backward is marked too, as
    ``<label>_bwd``, by full backward hooks. ``on_forward(label, module,
    inputs, output)`` sees every forward made while active."""

    def __init__(self, root: torch.nn.Module, labels: Dict[type, str],
                 on_forward: Optional[Callable] = None,
                 backward: bool = False):
        self.active = False
        self.on_forward = on_forward
        self.marks: List[Tuple[str, bool]] = []
        self._open: List = []
        for m in root.modules():
            label = labels.get(type(m))
            if label is None:
                continue
            m.register_forward_pre_hook(self._enter(label))
            m.register_forward_hook(self._leave(label))
            if backward:
                m.register_full_backward_pre_hook(
                    lambda mod, g, label=label: self._mark(f"{label}_bwd",
                                                           True))
                m.register_full_backward_hook(
                    lambda mod, gi, go, label=label: self._mark(
                        f"{label}_bwd", False))

    def _mark(self, label: str, enter: bool) -> None:
        if self.active:
            self.marks.append((label, enter))
            _marker()

    def _enter(self, label):
        def hook(module, inputs):
            if self.active:
                r = record_function(f"bench.{label}")
                r.__enter__()
                self._open.append(r)
                self._mark(label, True)
        return hook

    def _leave(self, label):
        def hook(module, inputs, output):
            if self.active and self._open:
                self._mark(label, False)
                self._open.pop().__exit__(None, None, None)
                if self.on_forward is not None:
                    self.on_forward(label, module, inputs, output)
        return hook


class Stretch:
    """One profiled stretch: ``start()`` and ``stop()`` each wait for the
    device, so the stretch holds exactly the work enqueued between them.
    ``wall_s`` is the stretch's own time, ``cost_s`` that and the
    profiler's start and stop."""

    def __init__(self, ranges: Optional[Ranges] = None):
        self.ranges = ranges
        self.prof = None
        self.wall_s = self.cost_s = 0.0
        self.marks: List[Tuple[str, bool]] = []

    def start(self) -> None:
        self._c0 = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        _marker()  # the probe: the trace's first kernel names the markers
        torch.cuda.synchronize()
        if self.ranges is not None:
            self.ranges.marks = []
            self.ranges.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        if self.ranges is not None:
            self.ranges.active = False
            self.marks = self.ranges.marks
        self.prof.stop()
        self.cost_s = time.perf_counter() - self._c0

    @property
    def done(self) -> bool:
        return self.cost_s > 0

    def trace(self) -> "Trace":
        return Trace(list(self.prof.events()), self.wall_s, self.marks)


def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The events of one stretch (times in µs) and what the readers take
    from them. The benchmark's marker kernels are left out of the device's
    work and bound the marked ranges."""

    def __init__(self, events, wall_s: float,
                 marks: Sequence[Tuple[str, bool]] = ()):
        self.wall_s = wall_s
        kernels = sorted((e for e in events
                          if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)),
                         key=lambda e: e.time_range.start)
        marker = kernels[0].name if kernels else None
        self.kernels = [e for e in kernels if e.name != marker]
        self.markers = [e for e in kernels if e.name == marker][1:]
        self.marks = list(marks)
        self.host = [e for e in events if e.device_type == DeviceType.CPU]
        self.busy = _union([(e.time_range.start, e.time_range.end)
                            for e in self.kernels])

    def marked_device_s(self, label: str) -> Optional[float]:
        """Device time of the kernels run between the markers of every
        range ``label``; None where the markers on the device do not match
        the ranges the host marked."""
        if len(self.markers) != len(self.marks):
            return None
        starts = [e.time_range.start for e in self.kernels]
        total, opened = 0.0, []
        for (name, enter), m in zip(self.marks, self.markers):
            if name != label:
                continue
            if enter:
                opened.append(m.time_range.end)
                continue
            lo = bisect.bisect_left(starts, opened.pop())
            hi = bisect.bisect_left(starts, m.time_range.start)
            total += sum(e.time_range.elapsed_us()
                         for e in self.kernels[lo:hi])
        return total / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        by_name: Dict[str, float] = defaultdict(float)
        for e in self.kernels:
            by_name[e.name] += e.time_range.elapsed_us()
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], us / 1e6] for name, us in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The gaps between device work, summed by what the host was doing
        in the middle of each: the innermost host op or range open there."""
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in self.host)
        starts = [s for s, _, _ in spans]
        by_label: Dict[str, float] = defaultdict(float)
        for (_, end), (nxt, _) in zip(self.busy, self.busy[1:]):
            mid = (end + nxt) / 2
            label, best = "host (no op recorded)", None
            i = bisect.bisect_right(starts, mid)
            for s, e, name in reversed(spans[max(0, i - 400):i]):
                if e >= mid and (best is None or e - s < best):
                    label, best = name, e - s
            by_label[label] += nxt - end
        ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], us / 1e6] for name, us in ranked]

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}
