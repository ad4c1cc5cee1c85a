"""Open-loop serving: independent requests arrive at a fixed rate and go
through ``GenerationService.submit_seed`` (noise drawn on the card from
each request's seed, batches padded to a fixed size, replies as PCM16).

The arrivals are ``rate_per_s`` times the window's seconds requests whose
gaps are a Poisson process's: the exponential distribution's quantiles at
(k + 1/2) / n, scaled to fill the window, in an order drawn from the seed.
So every seed offers the same work and the same set of gaps, in another
order. A
request is timed from when it was due to when its future resolved; the
generator's own lateness is printed beside. A request that fails, or is
not done by the end of the drain, counts as later than all the others.

Traffic keys: ``rate_per_s``, ``batch_size``, ``max_wait_ms``,
``num_steps``, ``channels``, ``length``, ``result_format``,
``drain_s``, ``check_requests``, ``limits``.

End-to-end: ``serve_p90_s``.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from harness import core
from harness.trace import Stretch
from reference.serve import pcm16, seed_noise
from reference.unet import FLOAT32, FP8, denoise



class State:
    pass


class TimedModel:
    """The model as the service sees it, recording each call's start and
    end on the host clock."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.calls = []
        self.counting = False

    def sample(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.model.sample(*args, **kwargs)
        if self.counting:
            self.calls.append((t0, time.perf_counter()))
        return out


def arrivals(run):
    """(due seconds, request seeds), sorted by due time."""
    t = run.traffic
    n = round(t["rate_per_s"] * run.seconds)
    rs = run.rng(core.ARRIVALS)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rs.permutation(gaps) * (run.seconds / gaps.sum())
    due = np.cumsum(gaps) - gaps[0]
    seeds = rs.integers(0, 2**32, size=n)
    return due, seeds


def setup(run):
    st = State()
    weights = run.weights()
    st.model = core.build_model(run.config, weights, run.device)
    del weights
    st.timed = TimedModel(st.model)
    st.stretch = Stretch() if run.trace else None
    start_service(run, st)
    return st


def start_service(run, st) -> None:
    """A service around the timed model, warmed by one batch of one step
    through its own worker: its thread, the batch's shapes and the reply's
    conversion."""
    from audio_diffusion_torch.serve import GenerationService

    t = run.traffic
    st.service = GenerationService(
        st.timed, batch_size=t["batch_size"], max_wait_ms=t["max_wait_ms"],
        num_steps=t["num_steps"], result_format=t["result_format"])
    warm = [st.service.submit_seed(i, length=t["length"],
                                   channels=t["channels"], num_steps=1)
            for i in range(t["batch_size"])]
    for f in warm:
        f.result()


def window(run, st):
    t = run.traffic
    due, seeds = arrivals(run)
    n = len(due)
    done = [None] * n
    futures, late = [], []
    st.timed.counting = True
    t0 = time.perf_counter()
    for j in range(n):
        wait = t0 + due[j] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - t0 - due[j])
        fut = st.service.submit_seed(int(seeds[j]), length=t["length"],
                                     channels=t["channels"])
        fut.add_done_callback(
            lambda f, j=j: done.__setitem__(j, time.perf_counter()))
        futures.append(fut)
    # The traced run profiles the drain, from the last arrival until every
    # reply is in: at least one whole served batch, and no arrival that the
    # profiler's own work could delay.
    t_traced = math.inf
    if st.stretch is not None:
        t_traced = time.perf_counter()
        st.stretch.start()
    deadline = t0 + run.seconds + t["drain_s"]
    for f in futures:
        try:
            f.result(timeout=max(deadline - time.perf_counter(), 0.0))
        except Exception:  # late or failed: counted below, not raised
            pass
    end = time.perf_counter()
    st.timed.counting = False
    if st.stretch is not None:
        st.stretch.stop()
    stats = st.service.stats
    st.service.close()
    ok = [j for j, f in enumerate(futures)
          if f.done() and not f.cancelled() and f.exception() is None]
    st.replies = {j: futures[j].result() for j in ok}
    st.seeds = seeds
    latency = [done[j] - t0 - due[j] if j in st.replies else math.inf
               for j in range(n)]
    worst = end - t0 - float(due.min()) if n else 0.0
    ranked = sorted(min(x, worst + 1.0) for x in latency)
    p90 = ranked[max(math.ceil(0.9 * n) - 1, 0)]
    run.attempted, run.failed = n, n - len(ok)
    run.e2e["serve_p90_s"] = p90
    print(f"serve: {n} requests due at {t['rate_per_s']}/s over "
          f"{run.seconds} s; done {len(ok)}; latency median "
          f"{ranked[n // 2]:.4f} s, p90 {p90:.4f} s, max {ranked[-1]:.4f} s; "
          f"generator late by median {sorted(late)[n // 2]:.6f} s, max "
          f"{max(late):.6f} s; window {end - t0:.3f} s", file=sys.stderr)
    calls = st.timed.calls
    starts = [c[0] for c in calls]
    ends = [c[1] for c in calls]
    waits = []
    for j in st.replies:
        # The call that served request j: the last one to end before its
        # future resolved. Calls the profiler slowed are left out.
        k = max(i for i, e in enumerate(ends) if e <= done[j])
        if starts[k] < t_traced:
            waits.append(starts[k] - t0 - due[j])
    thirds = [sorted(latency[k * n // 3:(k + 1) * n // 3]) for k in range(3)]
    run.counters["latency_thirds_median_s"] = [
        min(third[len(third) // 2], worst + 1.0) if third else None
        for third in thirds]
    run.counters.update(window_s=end - t0, service_stats=stats,
                        queue_waits_s=waits, batches=len(calls))
    if st.stretch is not None and st.stretch.done:
        run.profile = st.stretch.trace()


def check(run, st, control=False):
    t = run.traffic
    core.free(st.__dict__.pop("service"), st.__dict__.pop("timed"),
              st.__dict__.pop("model"))
    if run.failed:
        run.compare("requests_not_served", run.failed, 0)
    served = sorted(st.replies)
    k = min(t["check_requests"], len(served))
    picks = sorted(run.rng(core.CHECK).choice(served, size=k, replace=False))
    weights = run.weights()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            noise = torch.stack([seed_noise(int(st.seeds[j]), t["channels"],
                                            t["length"], run.device)
                                 for j in picks])
            ref = pcm16(denoise(weights, run.net, noise, t["num_steps"],
                                pr=FLOAT32)).cpu()

            def gap(a, b):
                a, b = torch.as_tensor(a).double(), b.double()
                return float(torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b))

            worst = max(gap(st.replies[j], ref[i])
                        for i, j in enumerate(picks))
            run.compare("pcm_rel_l2", worst, t["limits"]["pcm_rel_l2"])
            if not control:
                return None
            low = pcm16(denoise(weights, run.net, noise, t["num_steps"],
                                pr=FP8)).cpu()
            return {"pcm_rel_l2": max(gap(low[i], ref[i])
                                      for i in range(len(picks)))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
