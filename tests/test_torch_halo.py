"""The slab SpMV of the port's multi-GPU tier (``parallel/halo.py``) and its
overlapped form K8 (``parallel/async_halo.py``, here its plain version: the
ranks run on the CPU under gloo), on 2 and 4 spawned ranks, against the
single-device ``lat2d_spmv`` (bitwise, as ``tests/test_multichip.py``
asserts of the JAX ppermute op: the exchanged rows are copies and the sums
run in the same order) and against the JAX package's
``lat2d_spmv_halo_async`` in interpret mode on the 8-device virtual mesh at
64² (as ``tests/test_async_halo.py`` runs it, with no skip: an exception
fails the test)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import algebraicmultigrid_tpu as amg
from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec, lat2d_spmv
from algebraicmultigrid_tpu_torch.parallel import lat2d_spmv_halo, make_row_mesh, run_ranks

from torch_port_common import SLAB_DTYPES, halo_case, halo_rank

NAMES = ("p64", "p128", "sa9", "thin")
RANKS = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    """Each rank's slabs of every case, for n_sh = 2 and 4 (one gloo group
    each, spawned once for the module)."""
    return {n_sh: run_ranks(halo_rank, n_sh, NAMES, device="cpu", timeout_s=240) for n_sh in RANKS}


def _whole(spec, dtype):
    Wx, Wy = spec.row_dims
    x = np.random.default_rng(0).standard_normal(Wx * Wy)
    A = lat2d_from_spec(spec, getattr(torch, dtype), "cpu", row_pad=8)
    return lat2d_spmv(A, torch.as_tensor(x, dtype=getattr(torch, dtype))).numpy()[: Wx * Wy]


@pytest.mark.parametrize("dtype", SLAB_DTYPES)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_sh", RANKS)
def test_halo_spmv_matches_single_device(ranks, n_sh, name, dtype):
    spec = halo_case(name, n_sh)
    if name == "sa9":
        assert len(spec.offsets) == 9
    want = _whole(spec, dtype)
    plain = np.concatenate([r[name, dtype][0] for r in ranks[n_sh]])
    overlapped = np.concatenate([r[name, dtype][1] for r in ranks[n_sh]])
    assert np.array_equal(plain, want)
    assert np.array_equal(overlapped, want)


@pytest.mark.parametrize("name", NAMES)
def test_one_slab_overlap_matches_single_device(name):
    """n_sh = 1 in this process: no exchange, K8's two parts with zero
    halos."""
    mesh = make_row_mesh(device="cpu")
    spec = halo_case(name, 1)
    Wx, Wy = spec.row_dims
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(Wx * Wy))
    A = lat2d_from_spec(spec, torch.float64, "cpu", row_pad=8)
    want = _whole(spec, "float64")
    for overlap in (False, True):
        assert np.array_equal(lat2d_spmv_halo(A, x, mesh, overlap=overlap).numpy(), want)


def test_halo_spmv_matches_jax_async_halo(ranks):
    """The JAX K8 in Mosaic interpret mode on 8 virtual devices (8-row
    slabs) against the port's 2- and 4-slab results at 64², float32."""
    from algebraicmultigrid_tpu.ops.lattice_op import lat2d_from_spec as lat2d_j
    from algebraicmultigrid_tpu.parallel.async_halo import lat2d_spmv_halo_async
    from algebraicmultigrid_tpu.parallel.halo import shard_slab

    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide the 8-device virtual mesh"
    mesh = Mesh(np.array(devs[:8]), ("shards",))
    LP = amg.poisson((64, 64), lattice=True)
    A = lat2d_j(LP.spec, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal(64 * 64).astype(np.float32)
    want = np.asarray(lat2d_spmv_halo_async(A, shard_slab(jnp.asarray(x), mesh, 64, 64), mesh, interpret=True))
    for n_sh in RANKS:
        for which in (0, 1):
            got = np.concatenate([r["p64", "float32"][which] for r in ranks[n_sh]])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_overlap_refuses_a_slab_thinner_than_the_stencil():
    """Four slabs of one row each: thinner than 2·reach = 2."""
    from algebraicmultigrid_tpu_torch.parallel import RowMesh

    import datetime

    spec = halo_case("thin", 2)  # 4 × 77
    A = lat2d_from_spec(spec, torch.float64, "cpu", row_pad=8)
    mesh = RowMesh(rank=0, n_sh=4, device=torch.device("cpu"), backend="gloo", timeout=datetime.timedelta(seconds=1))
    with pytest.raises(ValueError, match="thinner"):
        lat2d_spmv_halo(A, torch.zeros(77, dtype=torch.float64), mesh, overlap=True)
    with pytest.raises(ValueError, match="do not divide"):
        lat2d_spmv_halo(lat2d_from_spec(halo_case("p64", 1), torch.float64, "cpu", row_pad=8),
                        torch.zeros(64 * 64, dtype=torch.float64),
                        RowMesh(rank=0, n_sh=3, device=torch.device("cpu"), backend="gloo",
                                timeout=datetime.timedelta(seconds=1)))
