"""The legs' and the tail's share of their roofline over a traced window.

The program marks each leg and tail call with a profiler range named
``L<level>/down``, ``L<level>/up``, ``L0/updown`` or ``L<level>/fused_tail``
(``models/device.py``).  For every such range that ran in the window, the
bound of its work (``bounds``: each input read once, each output written
once, at the published peaks) is summed, and so is the device time of the
operations inside the range.  A coarse level always starts from zero
(multilevel.jl:225), so a down leg or a tail entered below level 0 reads
no x; level 0's down leg reads its x.
"""

import re

from . import bounds

LEG_RANGE = re.compile(r"^L(\d+)/(down|up|updown|fused_tail)$")


def range_bound_ms(h, name):
    """The least time, in ms, of the work of the range ``name`` on the
    hierarchy ``h``; None where the name is not a leg or tail range."""
    m = LEG_RANGE.match(name)
    if m is None:
        return None
    lvl, kind = int(m.group(1)), m.group(2)
    if kind == "fused_tail":
        obj = h.tail
        words, flops = bounds.tail_work(obj, x_zero=lvl > 0)
        itemsize = obj.levels[0].dtype.itemsize
    else:
        obj = h.levels[lvl].fused
        if kind == "down":
            words, flops = bounds.leg_work(obj, obj.steps, False, True, x_zero=lvl > 0)
        elif kind == "up":
            words, flops = bounds.leg_work(obj, obj.steps, True, False)
        else:
            words, flops = bounds.leg_work(obj, obj.steps2, True, True)
        itemsize = obj.dtype.itemsize
    return bounds.bound(words, flops, itemsize, bounds.flops_rate(itemsize))[0]


def share_pct(h, ranges, keep=lambda name: True):
    """100 × (summed bounds) / (summed device time) over the ranges
    ``[(name, device_seconds), ...]`` whose name is a leg or tail range and
    passes ``keep``; None where none ran or none took device time."""
    cache = {}
    bound_ms = device_ms = 0.0
    for name, seconds in ranges:
        if not keep(name):
            continue
        if name not in cache:
            cache[name] = range_bound_ms(h, name)
        if cache[name] is None:
            continue
        bound_ms += cache[name]
        device_ms += seconds * 1e3
    if device_ms <= 0.0:
        return None
    return 100.0 * bound_ms / device_ms
