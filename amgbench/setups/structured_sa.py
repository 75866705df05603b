"""Set-up of a lattice configuration by the structured smoothed-aggregation
driver: ``structured_smoothed_aggregation(poisson(grid, lattice=True),
aggregate=StructuredAggregation(box=...))``, with any further keywords of the
configuration's ``setup`` (the proxy sizes of a small test grid)."""


def build(amt, problem, setup):
    """The program's hierarchy of the configuration."""
    kw = {k: v for k, v in setup.items() if k not in ("route", "aggregate_box")}
    A = amt.poisson(tuple(problem["grid"]), lattice=True)
    return amt.structured_smoothed_aggregation(A, aggregate=amt.StructuredAggregation(box=setup["aggregate_box"]), **kw)
