"""Fixed-cycle steps, as a time stepper spends them: each request is
``run_fixed_cycles(h, 0, b_k, cycles)`` from a zero guess on the next
right-hand side of the pool (padded to the fine level's length at set-up),
synchronised at its end; the answer is the step's x."""

from amgbench.harness import Answer


def make(p, pool):
    """The request of the cell ``p`` (``harness.prepare``) on ``pool``."""
    from algebraicmultigrid_tpu_torch.models import device as amg_device

    cycles = p.traffic["request"]["cycles"]
    padded = p.torch.zeros((pool.shape[0], p.h.fine_padded), dtype=p.dtype, device=p.dev)
    padded[:, : p.n] = pool

    def request(k):
        i = k % padded.shape[0]
        b = padded[i]
        x = amg_device.run_fixed_cycles(p.h, p.torch.zeros_like(b), b, cycles)
        p.sync()
        return Answer(x[: p.n], i, True, {"cycles": cycles})

    return request


def end_to_end(win):
    """cycle_ms: the window over every cycle the steps completed."""
    cycles = sum(win.counters.get("cycles", []))
    return {"cycle_ms": 1e3 * win.seconds / cycles} if cycles else {}
