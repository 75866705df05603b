"""The multi-host start of the port: two launcher processes
(``torchrun --nnodes=2 --node-rank=i --nproc-per-node=2``, as two hosts
would run them) start 2 ranks each, which join one gloo group of 4 through
``make_row_mesh(init_method="env://")``, solve the 216² lattice of
tests/_multihost_worker.py with ``solve_lattice_sharded`` (tol 1e-6,
maxiter 40) to relres < 1e-6 and ‖x − 1‖₂/N < 1e-4 across the seam between
the launchers, and run one ``solve_sharded`` step; every rank reports
exactly once, with the same sharded step on every rank.  Then
``entry.dryrun_multichip(2)`` on CPU ranks."""

import os
import re
import socket
import subprocess
import sys

import pytest
import torch

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_launchers_join_through_env():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes=2", f"--node-rank={node}",
             "--nproc-per-node=2", "--master-addr=127.0.0.1", f"--master-port={port}", WORKER],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for node in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    joined = "\n----\n".join(outs)
    assert all(p.returncode == 0 for p in procs), joined[-4000:]
    lines = [ln for ln in joined.splitlines() if "MULTIHOST_OK" in ln]
    ranks = sorted(int(re.search(r"rank=(\d+)", ln).group(1)) for ln in lines)
    assert ranks == [0, 1, 2, 3], joined[-4000:]
    for node, out in enumerate(outs):  # each launcher ran its own two ranks
        mine = sorted(int(re.search(r"rank=(\d+)", ln).group(1)) for ln in out.splitlines() if "MULTIHOST_OK" in ln)
        assert mine == [2 * node, 2 * node + 1], out[-2000:]
    assert len({re.search(r"sharded_step_res=(\S+)", ln).group(1) for ln in lines}) == 1


def test_dryrun_multichip_on_cpu_ranks():
    from algebraicmultigrid_tpu_torch.entry import dryrun_multichip

    res = dryrun_multichip(2, device="cpu", timeout_s=240)
    assert [r["rank"] for r in res] == [0, 1] and all(r["n_sh"] == 2 and r["backend"] == "gloo" for r in res)
    assert res[0]["iters"] == res[1]["iters"] == 1 and res[0]["normres"] == res[1]["normres"]
    assert res[0]["lattice_iters"] == res[1]["lattice_iters"] <= 8


def test_entry_step_on_the_cpu():
    import numpy as np

    from algebraicmultigrid_tpu_torch.entry import entry

    step, (h, x, b) = entry(device="cpu")
    norms = []
    for _ in range(3):
        x, nr = step(h, x, b)
        norms.append(float(nr))
    assert np.all(np.isfinite(norms)) and norms[2] < norms[0] < float(b.norm())
    if not torch.cuda.is_available():  # the card by default: without one it raises
        with pytest.raises(RuntimeError):
            entry()
