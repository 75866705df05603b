"""The control: the plain reference put in the program's place.  Each
request answers the next right-hand side of the cell's pool by the
reference's conjugate gradients in the precision below the
configuration's, with the stopping rule of the cell's limits file
(``control``); the run judges these answers as it judges the program's,
and has to come out not correct.  No run of the benchmark uses it:
``control.py`` and the tests put it in place of the traffic's driver."""

from amgbench.harness import Answer

WARMUP_REQUESTS = 0  # nothing to build or warm: the window's one request is the reading


def make(p, pool):
    """The request of the cell ``p`` (``harness.prepare``) on ``pool``."""
    spec = p.limits["control"]
    dtype = getattr(p.torch, spec["dtype"])

    def request(k):
        i = k % len(pool)
        b = p.torch.as_tensor(pool[i], device=p.dev)
        x, _ = p.reference.cg(b, p.dims, dtype, spec["tol"], spec["maxiter"])
        return Answer(x, i, True)

    return request


def end_to_end(win):
    """No end-to-end metric: the control is judged, not timed."""
    return {}
