"""The train step's model FLOPs (forward and a backward of twice its
products, from shapes) over the step's time, in % of the bf16 dense
peak."""
from harness.readers import mfu, train_flops


def read(run):
    return mfu(run, train_flops(run))
