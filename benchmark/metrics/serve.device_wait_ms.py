"""How long the service worker waits for the device after enqueueing a
batch: the median, over its own recent batches (at the traffic's step
count, none begun under the profiler), of the copy of the result to the
host (``device_wait_s``), in ms."""
from harness.timeline import median_ms, served_batches


def read(run):
    return median_ms(b.get("device_wait_s") for b in served_batches(run))
