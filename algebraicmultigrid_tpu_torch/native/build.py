"""ctypes loader for the native host setup kernels (built at first use).

``amg_setup.cpp`` (RS splitting, standard aggregation, natural-order greedy
coloring) is a copy of the JAX package's native tier.  It is built with g++
into the package's gitignored ``_build/`` directory, named by a hash of
the source and the compiler flags, and loaded with ``ctypes``.  There is no other tier:
where the library cannot be built, :func:`get_native` raises with the
compiler's message, so RS splitting, aggregation and coloring never run
with other semantics.  It is built for the generic x86-64 target, so a
``_build/`` carried to another host still loads there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["get_native", "library_path", "as_i64_ptr", "as_f64_ptr", "as_i32_ptr"]

_SRC = Path(__file__).resolve().parent / "amg_setup.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libamg_setup-{digest}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, text=True, timeout=120,
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ could not build {_SRC.name}:\n{e.stderr}") from e
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build {_SRC.name}: {e}") from e
    os.replace(tmp, out)


def get_native() -> ctypes.CDLL:
    """The loaded native library, built at the first call; raises
    RuntimeError where it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _compile(out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise RuntimeError(f"cannot load {out}: {e}") from e
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rs_cf_splitting.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p, i64p]
        lib.rs_cf_splitting.restype = None
        lib.standard_aggregation.argtypes = [ctypes.c_int64, i64p, i64p, f64p, i64p]
        lib.standard_aggregation.restype = ctypes.c_int64
        lib.greedy_coloring.argtypes = [ctypes.c_int64, i64p, i64p, i32p]
        lib.greedy_coloring.restype = ctypes.c_int32
        _lib = lib
        return _lib


def as_i64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def as_f64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def as_i32_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
