"""The EM engine (``em``: the Markov and dense joint routes) and the public
mixture class."""

from multimodal_trajectory_modeling_tpu_torch.models.mixture import (
    MMLinGaussSS_marginalizable,
)

__all__ = ["MMLinGaussSS_marginalizable"]
