"""``profile_torch.py``'s busy time on the CPU, on a fake
``key_averages()`` list shaped as ``torch.profiler`` reports a cycle with
``record_function`` phases: the CPU operator and range rows, the ranges'
device-side user-annotation rows (each spanning the kernels inside it) and
the kernel rows.  Only the kernel rows count, so the busy time is the
kernels' sum and no more than the window, and the idle share is in [0, 1)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def profile_torch():
    spec = importlib.util.spec_from_file_location("profile_torch", ROOT / "profile_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def row(key, device, us, count=20, annotation=False):
    return SimpleNamespace(key=key, device_type=device, self_device_time_total=us, count=count,
                           is_user_annotation=annotation)


# one window of 20 V-cycles, 2.12 ms each; the kernels sum to 2.078 ms a cycle
WINDOW_MS = 20 * 2.12
KERNELS = {"amg_fused_down_nf": 0.577, "amg_fused_up_nf": 0.558, "tail_nf_kernel": 0.516, "leg_nf_L1": 0.427}


def fake_profile(annotation_flag=True):
    rows = [row(k, DeviceType.CUDA, 20e3 * ms) for k, ms in KERNELS.items()]
    # the cycle's phases: the CPU range and its device-side annotation, each
    # with the device time of the kernels inside it
    for name, ms in (("amg::vcycle", sum(KERNELS.values())), ("amg::tail", KERNELS["tail_nf_kernel"])):
        rows.append(row(name, DeviceType.CPU, 20e3 * ms))
        rows.append(row(name, DeviceType.CUDA, 20e3 * ms, annotation=annotation_flag))
    # a CPU operator and the host launches carry no device time of their own
    rows += [row("aten::zeros", DeviceType.CPU, 0.0), row("cudaLaunchCooperativeKernel", DeviceType.CPU, 0.0)]
    return rows


@pytest.mark.parametrize("annotation_flag", [True, False], ids=["flagged", "by_name"])
def test_busy_time_sums_kernel_rows_only(profile_torch, annotation_flag):
    """The annotation rows are dropped whether the profiler flags them
    (``is_user_annotation``) or only names them as a CPU range."""
    rows = profile_torch.kernel_rows(fake_profile(annotation_flag))
    assert sorted(r[2] for r in rows) == sorted(KERNELS)
    busy = sum(r[0] for r in rows)
    assert busy == pytest.approx(20 * sum(KERNELS.values()))
    assert busy <= WINDOW_MS and 0 <= 1 - busy / WINDOW_MS < 1
    # every row with device time counted: the double count this replaces
    everything = sum(r.self_device_time_total for r in fake_profile(annotation_flag)) / 1e3
    assert everything > WINDOW_MS


def test_rows_carry_count_and_key(profile_torch):
    rows = profile_torch.kernel_rows([row("k", DeviceType.CUDA, 1500.0, count=40), row("z", DeviceType.CUDA, 0.0)])
    assert rows == [(1.5, 40, "k")]
