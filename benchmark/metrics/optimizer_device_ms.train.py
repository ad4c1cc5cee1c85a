"""Device time per train step of what follows the backward: the work
launched from the start of the optimizer's ``Optimizer.step#`` range to
the end of the step (clipping, Adam, the EMA update)."""


def read(run):
    if run.profile is None:
        return None
    total_us, found = 0.0, 0
    for step in run.profile.host:
        if step.name != "bench.train_step":
            continue
        children = step.cpu_children
        opt = [c for c in children if c.name.startswith("Optimizer.step#")]
        if not opt:
            continue
        found += 1
        start = opt[0].time_range.start
        total_us += sum(c.device_time_total for c in children
                        if c.time_range.start >= start)
    if not found:
        return None
    return total_us / 1e3 / found
