"""PCG iterations a refined solve took, summed over its rounds
(``solve_refined``'s ``stats["inner_iters"]``), the mean over the window's
solves."""


def read(ctx):
    iters = ctx.counters.get("pcg_iters")
    return sum(iters) / len(iters) if iters else None
