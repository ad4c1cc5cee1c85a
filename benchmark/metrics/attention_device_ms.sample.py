"""Device time per sampler step inside the self- and cross-attention
items' module ranges."""


def read(run):
    if run.profile is None:
        return None
    device_s = run.profile.marked_device_s("attention")
    if not device_s:
        return None
    return device_s * 1e3 / run.counters["stretch_steps"]
