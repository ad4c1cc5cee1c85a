"""The host's wait for the device per train step: the mean duration of the
program's ``train.wait`` ranges (``Trainer.fit``'s read of the step's loss
and gradient norm) in the traced stretch, in ms.

Taken in the traced stretch, where the profiler's cost per op slows the
host 2.5-3x on the H100's host and so leaves the device less to finish by
the read: compare it only with other traced runs."""
from harness.timeline import mean_range_ms


def read(run):
    return mean_range_ms(run, "train.wait")
