"""What the readers of the program's own spans and of the service's batch
timeline share. They read the traced stretch's host events by name and the
``service_stats`` that ``drivers/serve.py`` copies into ``run.counters``, and
import nothing of the program: on a program that records no such span or
key, each returns None and the harness leaves its metric out."""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def host_ranges(run, *names: str) -> Dict[object, List[Tuple]]:
    """The complete host ranges of the given names in the traced stretch,
    as (start µs, end µs, name) sorted by start, by thread. A range still
    open when the profiler stopped is given the stop as its end, and no
    event of its thread ends later; so a range counts as complete where
    some event of its thread ends after it (one that ends last on its
    thread is left out with the cut ones)."""
    host = getattr(run.profile, "host", None) or []
    last_end: Dict[object, float] = defaultdict(lambda: float("-inf"))
    found = defaultdict(list)
    for e in host:
        end = e.time_range.end
        if end > last_end[e.thread]:
            last_end[e.thread] = end
        if e.name in names:
            found[e.thread].append((e.time_range.start, end, e.name))
    return {t: sorted(r for r in ranges if r[1] < last_end[t])
            for t, ranges in found.items()}


def mean_range_ms(run, name: str) -> Optional[float]:
    """The mean duration of the complete ranges ``name``, in ms."""
    spans = [e - s for ranges in host_ranges(run, name).values()
             for s, e, _ in ranges]
    return sum(spans) / len(spans) / 1e3 if spans else None


def served_batches(run) -> List[dict]:
    """The service's recent batches at the traffic's step count (which
    leaves out the one-step warm-up) that started with no profiler
    running; [] where the service keeps no such timeline. The service
    keeps only its last 64 batches, so a run of more leaves its first out
    (the serving cell runs about 25)."""
    stats = run.counters.get("service_stats")
    batches = stats.get("recent_batches") if isinstance(stats, dict) \
        else None
    steps = run.traffic.get("num_steps")
    if not steps:
        return []
    return [b for b in batches or []
            if isinstance(b, dict) and b.get("num_steps") == steps
            and not b.get("profiled", True)]


def median_ms(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.median(values) * 1e3 if values else None


__all__ = ["host_ranges", "mean_range_ms", "served_batches", "median_ms"]
