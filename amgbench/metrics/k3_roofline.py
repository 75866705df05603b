"""K3's share of its roofline over the traced window, in %: L0's updown
leg (``fused_updown``, ``csrc/vcycle_legs.cu``), the bound of its work over
the device time of the operations inside its ``L0/updown`` ranges."""

from amgbench.yardstick import roofline, trace


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share_pct(ctx.hierarchy, trace.range_device_s(ctx.trace, lambda name: name == "L0/updown"))
