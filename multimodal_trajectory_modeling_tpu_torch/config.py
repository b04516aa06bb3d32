"""Runtime configuration helpers.

Counterpart of ``multimodal_trajectory_modeling_tpu/config.py``: the
JAX package points its compilation cache at a directory and switches its
platform and precision globally; here the kernels' build directory and the
process default device play those parts.
"""

from __future__ import annotations

import os
from pathlib import Path

from multimodal_trajectory_modeling_tpu_torch import device as _device
from multimodal_trajectory_modeling_tpu_torch.ops import _build

__all__ = ["enable_persistent_compilation_cache", "use_cpu_x64"]

_REPO_ROOT = Path(__file__).resolve().parent.parent


def enable_persistent_compilation_cache(path: str | os.PathLike | None = None) -> None:
    """Build the CUDA kernels into ``path`` (default ``tmp/kernel_cache``
    under the repository root, which ``.gitignore`` lists) and load them
    from there, so processes that share the directory build once.  The
    library's name carries a hash of its sources, so a stale build is never
    loaded.  Call it before the first kernel launch of the process."""
    path = Path(_REPO_ROOT / "tmp" / "kernel_cache" if path is None else path)
    path.mkdir(parents=True, exist_ok=True)
    _build.set_build_dir(path)


def use_cpu_x64() -> None:
    """Parity mode: entry points given no ``device`` run on the CPU, where
    the compute dtype is float64 (``device.resolve_dtype``).  A call to it
    is the caller asking for the CPU."""
    _device.set_default_device("cpu")
