"""The service's mean batch occupancy over the window: requests served
over batch slots run (its own counters)."""


def read(run):
    stats = run.counters.get("service_stats")
    if not stats or not stats.get("batches"):
        return None
    return stats["mean_occupancy"]
