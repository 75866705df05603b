"""Set-up of a lattice configuration from a checkpoint, as a deployment
that sets its hierarchy up once and reloads it in the processes that serve
it: the structured smoothed-aggregation hierarchy (``structured_sa``),
written by ``save_hierarchy`` to a file in a temporary directory and read
back by ``load_hierarchy``.  The file holds the levels' operators and no
factored-prolongator stash, so the loaded hierarchy lowers to the legs' and
the tail's non-factored R/P-plane branches."""

import os
import tempfile

from amgbench.setups import structured_sa


def build(amt, problem, setup):
    """The hierarchy as ``load_hierarchy`` gives it back."""
    ml = structured_sa.build(amt, problem, setup)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hierarchy.npz")
        amt.save_hierarchy(ml, path)
        return amt.load_hierarchy(path)
