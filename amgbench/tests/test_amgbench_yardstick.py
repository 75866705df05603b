"""The frozen yardstick: the bounds reproduce PERF.md's bound column at the
flagship's shapes, and the trace reduction's arithmetic on a made-up trace."""

from types import SimpleNamespace

import pytest
import torch

from amgbench.yardstick import bounds, roofline, trace

N0, N1 = 4096, 1366
OFFS5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
OFFS9 = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))
BF16, F32 = torch.bfloat16, torch.float32


def plane(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def leg(dims, cdims, nA, planes=BF16, dinv=None, factored=True, nR=21, nP=5, grid=((0, 1), (1, 0)),
        steps=(0, 1, 0), steps2=(0, 1, 0, 1, 0)):
    """A leg description at the given shapes (meta tensors: no memory)."""
    return SimpleNamespace(
        A=plane(nA, *dims, dtype=planes), dinv=plane(*dims, dtype=dinv or planes),
        T=plane(*dims, dtype=planes) if factored else None, S=plane(*dims, dtype=planes) if factored else None,
        R=None if factored else plane(nR, *cdims, dtype=planes), P=None if factored else plane(nP, *dims, dtype=planes),
        offsA=OFFS5 if nA == 5 else OFFS9, offsR=tuple(range(nR)), offsP=tuple(range(nP)),
        color_grid=grid, row_dims=dims, col_dims=cdims, factored=factored, dtype=F32, steps=steps, steps2=steps2,
    )


def ms(work):
    return bounds.bound(*work, 4)[0]


# PERF.md §6's bound column (ms, float32 vectors)
@pytest.mark.parametrize("name,planes,want", [
    ("K1 L0", BF16, 0.142), ("K1 L0", F32, 0.223), ("K3 L0", BF16, 0.145), ("K3 L0", F32, 0.225),
    ("K1 nf L0", BF16, 0.146), ("K1 nf L0", F32, 0.229), ("K1 L1", BF16, 0.0203),
])
def test_leg_bounds_reproduce_the_kernel_table(name, planes, want):
    if name == "K1 L1":
        f = leg((N1, N1), (456, 456), 9, planes, grid=((0, 1), (2, 3)), steps=(0, 1, 2, 3, 2, 1, 0))
        got = ms(bounds.leg_work(f, f.steps, False, True))
    elif name == "K3 L0":
        f = leg((N0, N0), (N1, N1), 5, planes)
        got = ms(bounds.leg_work(f, f.steps2, True, True))
    else:
        f = leg((N0, N0), (N1, N1), 5, planes, factored=name == "K1 L0")
        got = ms(bounds.leg_work(f, f.steps, False, True))
    assert round(got, 4 if want < 0.1 else 3) == want


def test_tail_bound_reproduces_the_kernel_table():
    levels = [leg((d, d), (c, c), 9, BF16, dinv=F32, grid=((0, 1), (2, 3)), steps=(0, 1, 2, 3, 2, 1, 0))
              for d, c in ((456, 153), (153, 51), (51, 17), (17, 6), (6, 2))]
    tail = SimpleNamespace(levels=levels, Mc=plane(4, 4, dtype=F32))
    assert round(ms(bounds.tail_work(tail, x_zero=False)), 4) == 0.0026
    assert ms(bounds.tail_work(tail, x_zero=True)) < ms(bounds.tail_work(tail, x_zero=False))


def test_roofline_share_counts_each_range_once():
    f = leg((N0, N0), (N1, N1), 5, BF16)
    h = SimpleNamespace(levels=[SimpleNamespace(fused=f)], tail=None)
    down0 = roofline.range_bound_ms(h, "L0/down")
    assert down0 == ms(bounds.leg_work(f, f.steps, False, True, x_zero=False))
    assert roofline.range_bound_ms(h, "L0/updown") == ms(bounds.leg_work(f, f.steps2, True, True))
    assert roofline.range_bound_ms(h, "amgbench/request") is None
    ranges = [("L0/down", 1e-3), ("L0/down", 1e-3), ("amgbench/request", 5.0)]
    assert roofline.share_pct(h, ranges) == pytest.approx(100 * 2 * down0 / 2.0)
    assert roofline.share_pct(h, []) is None


def made_up_trace():
    """A 100 ns window: two kernels and a copy; a leg range over the first
    kernel; host ops covering the first gap."""
    t = trace.Trace(window=(0, 100))
    t.ops = [(10, 30, "k_a", "kernel"), (25, 40, "k_b", "kernel"), (60, 70, "Memcpy HtoD", "gpu_memcpy")]
    t.annotations = [(10, 30, "L0/down"), (0, 100, "amgbench/request")]
    t.host = [(0, 100, "amgbench/request"), (41, 59, "aten::item"), (42, 58, "cudaStreamSynchronize")]
    return t


def test_busy_idle_and_ranges_of_a_made_up_trace():
    t = made_up_trace()
    assert trace.busy_intervals(t) == [(10, 40), (60, 70)]
    assert trace.busy_s(t) == 40e-9
    assert trace.idle_pct(t) == pytest.approx(60.0)
    assert trace.range_device_s(t, lambda n: n == "L0/down") == [("L0/down", 20e-9)]
    assert trace.top_ops(t)[0] == ["k_a", 20e-9]


def test_idle_gaps_are_named_by_the_innermost_host_event():
    gaps = dict((name, s) for name, s in trace.idle_gaps(made_up_trace()))
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-9)
    assert gaps["amgbench/request"] == pytest.approx(40e-9)


def test_an_empty_device_reads_nothing():
    t = trace.Trace(window=(0, 100))
    assert trace.idle_pct(t) is None and trace.idle_pct(None) is None
