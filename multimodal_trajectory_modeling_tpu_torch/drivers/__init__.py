"""The experiment drivers: counterparts of the JAX package's ``drivers/*.py``
scripts, each a module run as

    python -m multimodal_trajectory_modeling_tpu_torch.drivers.<name>

(hyphens in the script names become underscores).  They write what the
JAX drivers write, in the working directory.  Unlike the JAX drivers,
which default to the CPU in float64, they run on the card unless the
caller asks for the CPU: ``MTM_DEVICE=cpu`` selects the CPU in float64
(:func:`..config.use_cpu_x64`); on the card they compute in float32.
"""

from __future__ import annotations

import os

from multimodal_trajectory_modeling_tpu_torch import config

__all__ = ["configure_from_env"]


def configure_from_env() -> None:
    """Apply ``MTM_DEVICE``: ``cpu`` makes the CPU (in float64) the process
    default device; anything else, or unset, leaves the card."""
    if os.environ.get("MTM_DEVICE", "cuda") == "cpu":
        config.use_cpu_x64()
