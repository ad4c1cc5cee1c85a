"""What several per-layer readers share. A reader returns None where its
run recorded nothing to read, and the harness then leaves the metric out."""
from __future__ import annotations

from typing import Optional

from counts import item, net, peaks


def idle_share(run) -> Optional[float]:
    """1 − (union of the kernels' intervals) / (the stretch's wall time)."""
    if run.profile is None or not run.profile.busy:
        return None
    return 1.0 - run.profile.busy_s / run.profile.wall_s


def steady_step_s(run) -> Optional[float]:
    """Seconds per step of the window, the traced stretch left out."""
    c = run.counters
    steps = c.get("steps", 0) - c.get("stretch_steps", 0)
    if steps <= 0:
        return None
    return (c["window_s"] - c.get("stretch_s", 0.0)) / steps


def mfu(run, flops_per_step: int) -> Optional[float]:
    """The step's model FLOPs over its time, in % of the bf16 dense peak."""
    step_s = steady_step_s(run)
    if step_s is None:
        return None
    return 100.0 * flops_per_step / step_s / peaks.BF16_FLOPS


def sample_flops(run) -> int:
    t = run.traffic
    return net.forward_flops(run.net, run.counters["item_batch"], t["length"])


def train_flops(run) -> int:
    t = run.traffic
    return net.train_flops(run.net, t["batch"], t["crop"])


def item_bound_s(run, which) -> float:
    """The summed least time of every item the stretch ran, by shape."""
    dtype = run.config["dtype"]
    return sum(which(b, l, c, dtype)[0]
               for b, l, c in run.counters.get("stretch_items", []))


def roofline(bound_s: float, device_s: float) -> Optional[float]:
    if bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s


__all__ = ["idle_share", "steady_step_s", "mfu", "sample_flops",
           "train_flops", "item_bound_s", "roofline", "item"]
