"""Lowering of the hierarchy to the card (``models/device.py::
get_device_hierarchy``), synchronised: seconds by the host clock."""


def read(ctx):
    return ctx.spans.get("lowering")
