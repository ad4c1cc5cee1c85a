"""The host's enqueue of a train step (forward, backward, clipping, Adam,
the EMA): the mean time from the end of each of the program's
``train.data`` ranges to the start of the ``train.wait`` that follows it on
the same thread, in ms.

Taken in the traced stretch, so it includes the profiler's cost per op
(2.5-3x the untraced step time on the H100's host): compare it only with
other traced runs, never with the untraced window's end-to-end metric."""
from harness.timeline import host_ranges


def read(run):
    gaps = []
    for ranges in host_ranges(run, "train.data", "train.wait").values():
        for (_, end, name), (start, _, after) in zip(ranges, ranges[1:]):
            if name == "train.data" and after == "train.wait":
                gaps.append(start - end)
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
