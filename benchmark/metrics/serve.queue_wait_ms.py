"""The median, over served requests, of the time from when a request was
due to the start of the model call that served it."""
import statistics


def read(run):
    waits = run.counters.get("queue_waits_s")
    return statistics.median(waits) * 1e3 if waits else None
