"""The device's idle share of the traced window, in %: 1 − (the union of
its operations' time) / (the window).  The reader of every
``idle_pct.<kind>`` metric; each kind lists the cells of one end-to-end
metric."""

from amgbench.yardstick import trace


def read(ctx):
    return trace.idle_pct(ctx.trace)
