"""The service worker's host time per sampler step to enqueue a batch: the
median, over its own recent batches (at the traffic's step count, none
begun under the profiler), of the model call and the PCM16 conversion
(``dispatch_s``) over the batch's steps, in ms."""
from harness.timeline import median_ms, served_batches


def read(run):
    return median_ms(b["dispatch_s"] / b["num_steps"]
                     for b in served_batches(run)
                     if b.get("dispatch_s") is not None)
