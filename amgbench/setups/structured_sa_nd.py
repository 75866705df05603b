"""Set-up of a lattice configuration of any dimension by the structured N-D
smoothed-aggregation driver: ``structured_smoothed_aggregation_nd(
poisson(grid, lattice=True), **kw)``, with the configuration's ``setup``
keywords other than ``route`` (``proxy``, ``cut_rows``, ``min_proxy_dim``,
``box``) as they are."""


def build(amt, problem, setup):
    """The program's hierarchy of the configuration."""
    kw = {k: v for k, v in setup.items() if k != "route"}
    return amt.structured_smoothed_aggregation_nd(amt.poisson(tuple(problem["grid"]), lattice=True), **kw)
