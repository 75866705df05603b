"""Fused V-cycle legs (K1 down, K2 up) on Lat2D levels.

Port of the JAX package's ``ops/pallas/vcycle_kernels.py`` in its factored
form.  Structured SA stashes the tentative prolongator T (one offset, box-k)
and the smoothing scale S = ω·D̃⁻¹, so P = (I − diag(S)·A)·T and R = Pᵀ:

* **down** (K1): multicolor GS/SOR presmooth over the color-step list,
  r = b − A·x, and the restriction b_c = box_k-sum(T⊙(r − A·(S⊙r)));
* **up** (K2): Tup = T⊙upsample_k(x_c), x += Tup − S⊙(A·Tup), then the
  postsmooth color steps.

Each leg has a hand-written CUDA kernel (``csrc/vcycle_legs.cu``, built by
``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``) and a plain
PyTorch version beside it (``fused_down_reference`` / ``fused_up_reference``).
The wrappers ``fused_down`` / ``fused_up`` take the plain version only for
tensors on the CPU; on a CUDA tensor they launch the kernel or raise.
``launches`` counts the kernel launches of each wrapper.

Left for later (as in the JAX package, they are not on the SA main path):
the non-factored R/P-plane branches and bf16 coefficient storage.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..coloring import color_steps
from ..lattice_op import expand_planes

__all__ = [
    "FusedLegCache",
    "build_fused_leg_cache",
    "fused_down",
    "fused_up",
    "fused_down_reference",
    "fused_up_reference",
    "launches",
    "build_command",
    "load_library",
]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE = PACKAGE_DIR / "csrc" / "vcycle_legs.cu"
BUILD_DIR = PACKAGE_DIR / "_build"

# the kernel's fixed parameter-struct capacities (csrc/vcycle_legs.cu)
MAX_OFFSETS = 32
MAX_COLOR_CELLS = 64

launches = {"down": 0, "up": 0}


@dataclasses.dataclass(frozen=True)
class FusedLegCache:
    """Full-size coefficient planes of one level's factored legs."""

    A: torch.Tensor      # [nA, Wx, Wy] stencil planes
    dinv: torch.Tensor   # [Wx, Wy] 1/diag, 0 where diag == 0
    T: torch.Tensor      # [Wx, Wy] tentative prolongator (offset (0, 0))
    S: torch.Tensor      # [Wx, Wy] ω·D̃⁻¹ smoothing scale
    offsA: Tuple[Tuple[int, int], ...]
    color_grid: Tuple[Tuple[int, ...], ...]
    n_colors: int
    k: int
    row_dims: Tuple[int, int]   # fine (Wx, Wy)
    col_dims: Tuple[int, int]   # coarse (Wxc, Wyc)
    omega: float
    iter: int
    forward: bool
    backward: bool

    @property
    def steps(self) -> Tuple[int, ...]:
        return color_steps(self.n_colors, self.iter, self.forward, self.backward, self.omega)


def _factored_ok(specT, k, dims, cdims) -> bool:
    return (
        specT.base_x == (1, k)
        and specT.base_y == (1, k)
        and tuple(specT.row_dims) == dims
        and tuple(specT.col_dims) == cdims
        and any(tuple(o) == (0, 0) for o in specT.offsets)
        and all(
            tuple(o) == (0, 0) or not np.any(specT.table[i])
            for i, o in enumerate(specT.offsets)
        )
    )


def build_fused_leg_cache(
    specA, specR, specP, color_grid, n_colors: int, dtype, device,
    omega: float, iters: int, fwd: bool, bwd: bool, factored_T,
) -> Optional[FusedLegCache]:
    """Planes for the factored legs, from the same inputs as the JAX
    package's ``_maybe_build_fused_legs``: ``factored_T = (specT, scale)``
    with ``scale`` either ``("table", table, (Kx, sx, Ky, sy))`` or
    ``("vector", v)``.  None when the level is not a box-k factored level
    the kernels take (the cycle then runs the unfused path)."""
    if factored_T is None:
        return None
    if tuple(specA.base_x) != (1, 1) or tuple(specA.base_y) != (1, 1):
        return None
    kx, ky = tuple(specR.base_x), tuple(specR.base_y)
    if kx != ky or kx[1] != 1 or kx[0] not in (2, 3):
        return None
    k = kx[0]
    if tuple(specP.base_x) != (1, k) or tuple(specP.base_y) != (1, k):
        return None
    dims = tuple(specA.row_dims)
    cdims = tuple(specR.row_dims)
    if tuple(specP.row_dims) != dims or tuple(specP.col_dims) != cdims:
        return None
    grid = np.asarray(color_grid, dtype=np.int64)
    if len(specA.offsets) > MAX_OFFSETS or grid.size > MAX_COLOR_CELLS:
        return None
    specT, scale = factored_T
    if specT is None or scale is None or not _factored_ok(specT, k, dims, cdims):
        return None

    Wx, Wy = dims
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    A = expand_planes(specA, dtype, device)
    offsA = tuple(tuple(int(v) for v in o) for o in specA.offsets)
    if (0, 0) in offsA:
        diag = A[offsA.index((0, 0))]
        dinv = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1.0), 0.0)
    else:
        dinv = torch.zeros((Wx, Wy), dtype=dtype, device=device)
    idxT = [tuple(o) for o in specT.offsets].index((0, 0))
    cxT, cyT = specT.row_class_arrays()
    T = torch.as_tensor(np.asarray(specT.table[idxT], dtype=np_dtype), device=device)
    T = T[torch.as_tensor(cxT, device=device)][:, torch.as_tensor(cyT, device=device)]
    if scale[0] == "table":
        from ...models.lattice import axis_classes

        _, tbl, (KxS, sxS, KyS, syS) = scale
        cxS = axis_classes(np.arange(Wx), Wx, KxS, sxS)
        cyS = axis_classes(np.arange(Wy), Wy, KyS, syS)
        S = torch.as_tensor(np.asarray(tbl, dtype=np_dtype), device=device)
        S = S[torch.as_tensor(cxS, device=device)][:, torch.as_tensor(cyS, device=device)]
    else:
        S = torch.as_tensor(np.asarray(scale[1], dtype=np_dtype).reshape(Wx, Wy), device=device)
    return FusedLegCache(
        A=A,
        dinv=dinv.contiguous(),
        T=T.contiguous(),
        S=S.contiguous(),
        offsA=offsA,
        color_grid=tuple(tuple(int(c) for c in row) for row in grid),
        n_colors=int(n_colors),
        k=k,
        row_dims=dims,
        col_dims=cdims,
        omega=float(omega),
        iter=int(iters),
        forward=bool(fwd),
        backward=bool(bwd),
    )


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _stencil(A: torch.Tensor, X: torch.Tensor, offs) -> torch.Tensor:
    """Σₖ A_k ⊙ X[· + offₖ] with zeros outside the grid."""
    Wx, Wy = X.shape
    m = max((max(abs(dx), abs(dy)) for dx, dy in offs), default=0)
    Xp = torch.nn.functional.pad(X, (m, m, m, m))
    acc = None
    for kk, (dx, dy) in enumerate(offs):
        term = A[kk] * Xp[m + dx : m + dx + Wx, m + dy : m + dy + Wy]
        acc = term if acc is None else acc + term
    return acc


def _color_plane(cache: FusedLegCache, device) -> torch.Tensor:
    grid = torch.as_tensor(cache.color_grid, device=device)
    a, b = grid.shape
    Wx, Wy = cache.row_dims
    ix = torch.arange(Wx, device=device) % a
    iy = torch.arange(Wy, device=device) % b
    return grid[ix][:, iy]


def _sweep(cache: FusedLegCache, X, B):
    col = _color_plane(cache, X.device)
    for c in cache.steps:
        r = B - _stencil(cache.A, X, cache.offsA)
        X = torch.where(col == c, X + cache.omega * cache.dinv * r, X)
    return X


def _pad_out(X: torch.Tensor, length: int) -> torch.Tensor:
    v = X.reshape(-1)
    return torch.nn.functional.pad(v, (0, length - v.shape[0])) if length > v.shape[0] else v


def fused_down_reference(cache: FusedLegCache, x, b, x_zero: bool = False):
    """(x', b_c) = (presmooth(x, b), R·(b − A·x')) in plain PyTorch."""
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n, k = Wx * Wy, cache.k
    B = b[:n].reshape(Wx, Wy)
    X = torch.zeros_like(B) if x_zero else x[:n].reshape(Wx, Wy)
    X = _sweep(cache, X, B)
    r = B - _stencil(cache.A, X, cache.offsA)
    ts = cache.T * (r - _stencil(cache.A, cache.S * r, cache.offsA))
    ts = torch.nn.functional.pad(ts, (0, k * Wyc - Wy, 0, k * Wxc - Wx))
    bc = ts.reshape(Wxc, k, Wyc, k).sum(dim=1).sum(dim=2)
    return _pad_out(X, x.shape[0]), bc.reshape(Wxc * Wyc)


def fused_up_reference(cache: FusedLegCache, x, b, xc):
    """x = postsmooth(x + P·x_c, b) in plain PyTorch."""
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n, k = Wx * Wy, cache.k
    B = b[:n].reshape(Wx, Wy)
    XC = xc[: Wxc * Wyc].reshape(Wxc, Wyc)
    up = XC.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)[:Wx, :Wy]
    Tup = cache.T * up
    X = x[:n].reshape(Wx, Wy) + (Tup - cache.S * _stencil(cache.A, Tup, cache.offsA))
    X = _sweep(cache, X, B)
    return _pad_out(X, x.shape[0])


# --------------------------------------------------------------------------
# CUDA build and binding
# --------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    """Build output, named by the source's content hash so an edited
    source never loads a stale build."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libvcycle_legs-{digest}.so"


def build_command(out: Path) -> list:
    return [
        _nvcc(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(out), str(SOURCE),
    ]


_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_D = ctypes.c_double
_DOWN_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _IP, _I, _I, _IP, _I, _D, _I, _I, _I, _I, _I, _P]
_UP_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _IP, _I, _I, _IP, _I, _D, _I, _I, _I, _I, _P]


def load_library():
    """Build (at first use) and load the legs' shared library."""
    global _lib
    if _lib is not None:
        return _lib
    import subprocess

    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(build_command(tmp), check=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for sfx in ("f32", "f64"):
        down = getattr(lib, f"amg_fused_down_{sfx}")
        down.argtypes, down.restype = _DOWN_ARGS, _I
        up = getattr(lib, f"amg_fused_up_{sfx}")
        up.argtypes, up.restype = _UP_ARGS, _I
    _lib = lib
    return lib


def _ints(vals):
    vals = [int(v) for v in vals]
    return (ctypes.c_int * max(len(vals), 1))(*vals)


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(cache: FusedLegCache, name: str, t: torch.Tensor, min_len: int):
    if t.device != cache.A.device:
        raise ValueError(f"{name} is on {t.device}, the level's planes on {cache.A.device}")
    if t.dtype != cache.A.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the level's planes {cache.A.dtype}")
    if t.dim() != 1 or t.shape[0] < min_len:
        raise ValueError(f"{name} must be a flat vector of length >= {min_len}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stencil_args(cache: FusedLegCache):
    offs = _ints([v for o in cache.offsA for v in o])
    grid = np.asarray(cache.color_grid)
    steps = cache.steps
    return (
        offs, len(cache.offsA), _ints(grid.ravel()), grid.shape[0], grid.shape[1],
        _ints(steps), len(steps),
    )


def _raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def fused_down(cache: FusedLegCache, x, b, x_zero: bool = False):
    """(x', b_c) = (presmooth(x, b), R·(b − A·x')); ``x_zero`` asserts x is
    the zero vector (coarse-level cycles start from it), so x is not read.
    Returns x' at ``x``'s (padded) length and b_c at Wxc·Wyc."""
    if x.device.type == "cpu":
        return fused_down_reference(cache, x, b, x_zero=x_zero)
    if x.device.type != "cuda":
        raise ValueError(f"fused_down runs on cuda or cpu tensors, not {x.device}")
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n = Wx * Wy
    _check(cache, "x", x, n)
    _check(cache, "b", b, n)
    if cache.A.dtype not in _SUFFIX:
        raise TypeError(f"fused_down takes float32 or float64, not {cache.A.dtype}")
    lib = load_library()
    x_out = torch.empty_like(x)
    if x.shape[0] > n:
        x_out[n:].zero_()
    r = torch.empty((Wx, Wy), dtype=x.dtype, device=x.device)
    g = torch.empty_like(r)
    bc = torch.empty(Wxc * Wyc, dtype=x.dtype, device=x.device)
    offs, n_off, ctab, ca, cb, steps, n_steps = _stencil_args(cache)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(lib, f"amg_fused_down_{_SUFFIX[x.dtype]}")
    err = fn(
        x_out.data_ptr(), None if x_zero else x.data_ptr(), b.data_ptr(),
        cache.A.data_ptr(), cache.dinv.data_ptr(), cache.T.data_ptr(), cache.S.data_ptr(),
        r.data_ptr(), g.data_ptr(), bc.data_ptr(),
        offs, n_off, ctab, ca, cb, steps, n_steps, cache.omega,
        Wx, Wy, Wxc, Wyc, cache.k, stream,
    )
    _raise_on(err, "fused_down kernel")
    launches["down"] += 1
    return x_out, bc


def fused_up(cache: FusedLegCache, x, b, xc):
    """x = postsmooth(x + P·x_c, b); returns x at ``x``'s (padded) length."""
    if x.device.type == "cpu":
        return fused_up_reference(cache, x, b, xc)
    if x.device.type != "cuda":
        raise ValueError(f"fused_up runs on cuda or cpu tensors, not {x.device}")
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n = Wx * Wy
    _check(cache, "x", x, n)
    _check(cache, "b", b, n)
    _check(cache, "xc", xc, Wxc * Wyc)
    if cache.A.dtype not in _SUFFIX:
        raise TypeError(f"fused_up takes float32 or float64, not {cache.A.dtype}")
    lib = load_library()
    x_out = torch.empty_like(x)
    if x.shape[0] > n:
        x_out[n:].zero_()
    tup = torch.empty((Wx, Wy), dtype=x.dtype, device=x.device)
    offs, n_off, ctab, ca, cb, steps, n_steps = _stencil_args(cache)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(lib, f"amg_fused_up_{_SUFFIX[x.dtype]}")
    err = fn(
        x_out.data_ptr(), x.data_ptr(), b.data_ptr(),
        cache.A.data_ptr(), cache.dinv.data_ptr(), cache.T.data_ptr(), cache.S.data_ptr(),
        xc.data_ptr(), tup.data_ptr(),
        offs, n_off, ctab, ca, cb, steps, n_steps, cache.omega,
        Wx, Wy, Wyc, cache.k, stream,
    )
    _raise_on(err, "fused_up kernel")
    launches["up"] += 1
    return x_out
