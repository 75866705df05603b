"""The general generator of right-hand-side pools, read from a traffic file.

A traffic file's ``rhs`` says what each right-hand side is (its ``kind``:
``"standard_normal"``, independent N(0, 1) entries), in which ``dtype``, and whether the driver gets them ``on`` the ``"device"``
(a torch tensor) or the ``"host"`` (a numpy array).  The pool is made on the
device from the seed by one ``torch.Generator`` in one call, so every seed
gives the same sizes and the same work, and the same seed the same pool.
"""

import torch


def make_pool(spec, pool, n, seed, device):
    """``pool`` right-hand sides of length ``n``: a [pool, n] tensor on the
    device, or a list of numpy arrays on the host."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.randn((pool, n), generator=gen, dtype=torch.float64, device=device)
    if spec["kind"] != "standard_normal":
        raise ValueError(f"unknown right-hand side kind {spec['kind']!r}")
    u = u.to(getattr(torch, spec["dtype"]))
    if spec["on"] == "host":
        return [row.cpu().numpy() for row in u]
    if spec["on"] != "device":
        raise ValueError(f"a right-hand side is on the device or the host, not {spec['on']!r}")
    return u
