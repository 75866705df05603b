"""Refined solves: each request is ``solve_refined(ml, b_k, tol=...,
dtype=..., coef_dtype=..., return_device=True)`` on the next right-hand
side of the pool, a device tensor; the answer is the float64 solution on
the device, synchronised.  The program's own residual history says whether
the solve met its tolerance."""

import numpy as np

from amgbench.harness import Answer


def make(p, pool):
    """The request of the cell ``p`` (``harness.prepare``) on ``pool``."""
    req = p.traffic["request"]

    def request(k):
        i = k % pool.shape[0]
        stats = {}
        x, history = p.amt.solve_refined(
            p.ml, pool[i], tol=req["tol"], max_rounds=req["max_rounds"], dtype=p.dtype,
            coef_dtype=p.coef_dtype, device=p.dev, return_device=True, log=True, stats=stats,
        )
        p.sync()
        ok = history[-1] <= req["tol"] * history[0]
        return Answer(x, i, ok, {"pcg_iters": sum(stats.get("inner_iters", []))})

    return request


def end_to_end(win):
    """solve_ms: the window over the solves that met the tolerance;
    solve_ms_p95: the 95th percentile of every solve's time."""
    out = {}
    if win.completed:
        out["solve_ms"] = 1e3 * win.seconds / win.completed
    if win.times:
        out["solve_ms_p95"] = 1e3 * float(np.percentile(win.times, 95))
    return out
