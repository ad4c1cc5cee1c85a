"""The fused resnet item's forward: its summed bound (from the shapes of
the items the stretch ran) over the device time inside the items' module
ranges, in %."""
from harness.readers import item, item_bound_s, roofline


def read(run):
    if run.profile is None:
        return None
    return roofline(item_bound_s(run, item.forward),
                    run.profile.marked_device_s("item") or 0.0)
