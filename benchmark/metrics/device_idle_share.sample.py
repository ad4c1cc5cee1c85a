"""The device's idle share over the traced stretch: 1 − (union of kernel
intervals) / (the stretch's wall time)."""
from harness.readers import idle_share


def read(run):
    return idle_share(run)
