"""Build and load the package's CUDA kernels.

At first use, ``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, in ``_build/`` beside this package
(listed in ``.gitignore``; ``config.enable_persistent_compilation_cache``
moves it), and loaded with ``ctypes``.  The
library's name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edit to any of them triggers a
rebuild and a stale library is never loaded.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch.  Callers that skip a
    numerically degenerate run (a singular solve) re-raise this one."""


class KernelArgumentError(KernelError, ValueError):
    """A launch function refused its arguments."""


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of every exported function: pointers and the stream as void*
_SIGNATURES = {
    "mtm_markov_features": [_I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "mtm_markov_features_staged": [
        _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_markov_features_staged_config": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mtm_markov_em": [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _LL, _I, _I, _I, _I, _P,
    ],
    "mtm_markov_em_max_clusters": [],
    "mtm_markov_em_one": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _LL, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_markov_em_one_config": [_I, _I, _I, _I, _I, _P],
    "mtm_markov_em_multi": [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _LL, _I, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_markov_em_packed": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_markov_em_packed_mma_smem": [_I, _I, _I, _I, _I, _I],
    "mtm_markov_em_packed_one_config": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mtm_markov_em_packed_one_smem": [_I, _I, _I, _I, _I, _I],
    "mtm_estep_assign_block": [_I, _I, _I],
    "mtm_estep_tc_plan": [_I, _I, _P],
    "mtm_estep_assign": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_estep_assign_rows": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_estep_logliks_block": [_I, _I],
    "mtm_estep_logliks": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_mstep_stats_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    "mtm_mstep_stats": [
        _I, _I, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P,
    ],
    "mtm_mstep_gram_part": [_I],
    "mtm_mstep_gram_plan": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mtm_mstep_gram": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_masked_kalman_max_dim": [],
    "mtm_masked_kalman": [_I, _I, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "mtm_markov_features_longT_max_dim": [],
    "mtm_markov_features_longT": [_I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "mtm_markov_features_longT_staged": [
        _I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "mtm_markov_features_longT_staged_config": [_I, _I, _I, _I, _I, _I, _I, _P],
    "mtm_phi_stream_blocks": [_I, _I, _LL, _LL],
    "mtm_phi_stream": [_I, _I, _P, _LL, _LL, _P, _P, _I, _P, _P],
    "mtm_markov_em_batch_config": [_I, _I, _I, _I, _I, _I, _I, _P],
    "mtm_markov_em_batch": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError(
            "nvcc was not found on PATH or in /usr/local/cuda/bin; the CUDA "
            "kernels cannot be built"
        )
    return path


def set_build_dir(path) -> None:
    """Build into and load from ``path`` instead of ``_build/``.  Raises
    once the library is loaded: the process keeps the library it has."""
    global _BUILD_DIR
    if library.cache_info().currsize:
        raise RuntimeError("the kernel library is already loaded")
    _BUILD_DIR = Path(path)


def sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources() + sorted(_SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libmtm_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in sources():
        obj = out.with_name(f"{out.stem}.{src.stem}.{tag}.o")
        cmd = [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _obj, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} (exit {proc.returncode}):\n{stderr[-4000:]}")
    objs = [obj for _cmd, obj, _proc in jobs]
    if not failed:
        tmp = out.with_suffix(f".{tag}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        else:
            os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise KernelError("nvcc failed: " + "\n".join(failed))


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if needed."""
    out = library_path()
    if not out.exists():
        _compile(out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as err:
        raise KernelError(f"cannot load {out}: {err}") from err
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a nonzero code."""
    if rc == -1:
        raise KernelArgumentError(f"{what}: the kernel refused its arguments")
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")
