"""The median, over the requests of the service's own recent batches (at
the traffic's step count, none begun under the profiler), of the time from
``submit`` to the start of the batch that served it, in ms: the service's
own counterpart of ``serve.queue_wait_ms``."""
from harness.timeline import median_ms, served_batches


def read(run):
    return median_ms(w for b in served_batches(run)
                     for w in b.get("queue_wait_s") or [])
