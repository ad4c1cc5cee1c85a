"""The fused resnet item's backward: its summed bound (from the shapes of
the items the stretch's forwards ran) over the device time inside the
items' backward ranges, in %."""
from harness.readers import item, item_bound_s, roofline


def read(run):
    if run.profile is None:
        return None
    return roofline(item_bound_s(run, item.backward),
                    run.profile.marked_device_s("item_bwd") or 0.0)
