"""Host set-up of the hierarchy (``models/fastsetup.py``; for a reloaded
configuration with its save and load, ``utils/serialize.py``): seconds by
the host clock around the call."""


def read(ctx):
    return ctx.spans.get("hierarchy")
