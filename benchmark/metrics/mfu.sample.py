"""The sampler step's model FLOPs (one forward at the item batch, from
shapes) over the step's time, in % of the bf16 dense peak."""
from harness.readers import mfu, sample_flops


def read(run):
    return mfu(run, sample_flops(run))
