"""Host time per sampler step: the mean duration of the program's complete
``sampler.step`` ranges in the traced stretch, in ms.

Taken in the traced stretch, so it includes the profiler's cost per op
(2.5-3x the untraced step time on the H100's host): compare it only with
other traced runs, never with the untraced window's end-to-end metric."""
from harness.timeline import mean_range_ms


def read(run):
    return mean_range_ms(run, "sampler.step")
