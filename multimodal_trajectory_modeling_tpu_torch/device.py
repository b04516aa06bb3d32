"""Device and dtype resolution.

The JAX package switches platform and precision globally
(``config.py:23``).  The port takes ``device=`` and ``dtype=`` at every
public entry point and resolves them here: float64 on the CPU (the parity
mode the JAX tests run in), float32 on CUDA.  An entry point's
``device=None`` is the process default: the card, unless the caller asked
for the CPU with :func:`set_default_device` (``config.use_cpu_x64``).
Asking for CUDA without a card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


_DEFAULT_DEVICE = ["cuda"]


def set_default_device(device) -> None:
    """Make ``device`` the process default of every entry point that is
    given ``device=None`` (the card until this is called)."""
    _DEFAULT_DEVICE[0] = str(resolve_device(device))


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (None: the process default, the
    card unless :func:`set_default_device` chose another); raises if CUDA
    is asked for and absent."""
    dev = torch.device(_DEFAULT_DEVICE[0] if device is None else device)
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
