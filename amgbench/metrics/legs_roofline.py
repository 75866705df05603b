"""The legs' and the tail's share of their roofline over the traced window,
in %: the summed bounds of every leg and tail call (``L<level>/down``,
``/up``, ``/updown``, ``/fused_tail``) over the device time of the
operations inside them.  The reader of every ``legs_roofline.<kind>``
metric."""

from amgbench.yardstick import roofline, trace


def read(ctx):
    if ctx.trace is None:
        return None
    ranges = trace.range_device_s(ctx.trace, lambda name: roofline.LEG_RANGE.match(name) is not None)
    return roofline.share_pct(ctx.hierarchy, ranges)
