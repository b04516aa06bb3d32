"""ctypes loader for the native host-side data path (``mtm_native.c``).

Counterpart of ``multimodal_trajectory_modeling_tpu/native/__init__.py``
with this package's own copy of its C source.  The shared library is built
at first use with the system C compiler (``cc -O3 -fopenmp``, ``$CC`` if
set) into the kernels' build directory (``_build/`` beside the package,
or where ``config.enable_persistent_compilation_cache`` moved it), under a
name that carries a hash of the source and flags, never next to the
source.  Where the compiler has no OpenMP runtime (the card's machine:
its ``gcc`` has no ``libgomp``), the same source is built without
``-fopenmp``: its loops then run on one thread, with the same results;
:func:`uses_openmp` says which library was loaded.  A library that builds
in neither way raises :class:`NativeBuildError`: the NumPy fallback of the
JAX package is not kept.  The one fallback kept is the reference's
semantic one: past ``max_patterns`` distinct patterns,
:func:`pattern_groups` returns ``np.unique``'s grouping and order, through
:func:`..ops.gaussian.pattern_groups` (one sort of the rows' packed bits,
the same result as ``np.unique(..., axis=0)`` in a fraction of its time).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops

__all__ = [
    "NativeBuildError", "available", "finite_lengths", "pack_joint", "pattern_groups", "uses_openmp",
]

_SRC = Path(__file__).resolve().parent / "mtm_native.c"
_OPENMP_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
_SERIAL_FLAGS = ("-O3", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """The native library failed to build or load."""


def library_path(flags=_OPENMP_FLAGS) -> Path:
    cc = os.environ.get("CC", "cc")
    h = hashlib.sha256(" ".join((cc, *flags)).encode())
    h.update(_SRC.read_bytes())
    return Path(_build._BUILD_DIR) / f"libmtm_native_{h.hexdigest()[:16]}.so"


def _compile(out: Path, flags) -> str | None:
    """Build ``out`` with ``flags``: None on success, else the error."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), *flags, "-o", str(tmp), str(_SRC), "-lm"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        return f"cannot run {cmd[0]}: {err}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
    os.replace(tmp, out)
    return None


@functools.cache
def _load() -> tuple[ctypes.CDLL, bool]:
    """The library and whether it was built with OpenMP: the OpenMP build
    where it exists or builds, else the serial one."""
    errors = []
    for flags in (_OPENMP_FLAGS, _SERIAL_FLAGS):
        out = library_path(flags)
        if not out.exists():
            err = _compile(out, flags)
            if err is not None:
                errors.append(err)
                continue
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as err:
            raise NativeBuildError(f"cannot load {out}: {err}") from err
        lib.pack_joint_f64.restype = None
        lib.pattern_groups_f64.restype = ctypes.c_int64
        lib.finite_lengths_f64.restype = None
        return lib, flags is _OPENMP_FLAGS
    raise NativeBuildError("the native library built in neither way:\n" + "\n".join(errors))


def _lib() -> ctypes.CDLL:
    return _load()[0]


def available() -> bool:
    """Whether the library is built and loaded (builds it if needed;
    raises :class:`NativeBuildError` if that fails)."""
    return _lib() is not None


def uses_openmp() -> bool:
    """Whether the loaded library was built with ``-fopenmp``."""
    return _load()[1]


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_joint(z: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(T, n, d) + (T, n, l) → (n, T·(d+l)) float64 joint rows
    ``[z_1..z_T, x_1..x_T]`` (``native/__init__.py:68``)."""
    z = np.ascontiguousarray(z, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    T, n, d = z.shape
    l = x.shape[-1]
    out = np.empty((n, T * (d + l)), dtype=np.float64)
    _lib().pack_joint_f64(
        _ptr(z), _ptr(x), ctypes.c_int64(T), ctypes.c_int64(n), ctypes.c_int64(d), ctypes.c_int64(l), _ptr(out)
    )
    return out


def pattern_groups(v: np.ndarray, max_patterns: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Rows of ``v`` grouped by finite-mask in one hashed pass:
    ``(patterns bool (P, D), pattern_id int32 (n,))``, patterns in order of
    first appearance; past ``max_patterns`` patterns, ``np.unique``'s
    grouping and order (``native/__init__.py:98``)."""
    v = np.ascontiguousarray(np.atleast_2d(v), dtype=np.float64)
    n, D = v.shape
    patterns = np.zeros((max_patterns, D), dtype=np.uint8)
    pattern_id = np.zeros(n, dtype=np.int32)
    got = _lib().pattern_groups_f64(
        _ptr(v), ctypes.c_int64(n), ctypes.c_int64(D), _ptr(patterns), _ptr(pattern_id), ctypes.c_int64(max_patterns)
    )
    if got == -1:  # more patterns than the cap: np.unique's grouping and order
        return gops.pattern_groups(v)
    if got < 0:
        raise MemoryError("pattern_groups_f64 could not allocate its hash table")
    return patterns[:got].astype(bool), pattern_id


def finite_lengths(arr: np.ndarray) -> np.ndarray:
    """Fully-finite prefix length of each trajectory of a (T, n, d) array
    (``native/__init__.py:127``)."""
    arr = np.ascontiguousarray(np.atleast_3d(arr), dtype=np.float64)
    T, n, d = arr.shape
    out = np.empty(n, dtype=np.int32)
    _lib().finite_lengths_f64(_ptr(arr), ctypes.c_int64(T), ctypes.c_int64(n), ctypes.c_int64(d), _ptr(out))
    return out
