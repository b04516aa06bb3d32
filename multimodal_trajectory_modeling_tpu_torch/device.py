"""Device and dtype resolution (counterpart of ``config.use_cpu_x64``).

The JAX package switches platform and precision globally
(``config.py:23``).  The port instead takes ``device=`` and ``dtype=`` at
every public entry point and resolves them here: float64 on the CPU (the
parity mode the JAX tests run in), float32 on CUDA.  Asking for CUDA
without a card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cpu") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def resolve_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """The compute dtype: ``dtype`` if given, else float64 on the CPU and
    float32 on CUDA."""
    if dtype is not None:
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported compute dtype {dtype}")
        return dtype
    return torch.float64 if device.type == "cpu" else torch.float32
