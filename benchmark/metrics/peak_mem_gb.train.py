"""The device memory the window's steps hold at their peak
(``max_memory_allocated`` after a reset at the window's start), in GB,
less the buffers the benchmark keeps for checking the window's steps."""


def read(run):
    peak = run.counters.get("window_peak_bytes")
    if not peak:
        return None
    return (peak - run.counters.get("late_check_bytes", 0)) / 1e9
