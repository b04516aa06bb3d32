"""The EM engine (``em``: the Markov and dense joint routes), the public
mixture class, the function API (``statespace_api``) and the extended
framework: the component models (linear-Gaussian, kNN, hybrid), the
generic mixture of components and the classifier."""

from multimodal_trajectory_modeling_tpu_torch.models import statespace_api
from multimodal_trajectory_modeling_tpu_torch.models.classifier import (
    StateSpaceModelClassifier,
)
from multimodal_trajectory_modeling_tpu_torch.models.hybrid import (
    StateSpaceHybrid,
)
from multimodal_trajectory_modeling_tpu_torch.models.knn_model import (
    StateSpaceKNN,
)
from multimodal_trajectory_modeling_tpu_torch.models.linear_gaussian import (
    StateSpaceLinearGaussian,
)
from multimodal_trajectory_modeling_tpu_torch.models.mixture import (
    MMLinGaussSS_marginalizable,
)
from multimodal_trajectory_modeling_tpu_torch.models.ssm_mixture import (
    StateSpaceMixtureModel,
)
from multimodal_trajectory_modeling_tpu_torch.models.state_space_model import (
    StateSpaceModel,
)

__all__ = [
    "MMLinGaussSS_marginalizable",
    "StateSpaceHybrid",
    "StateSpaceKNN",
    "StateSpaceLinearGaussian",
    "StateSpaceMixtureModel",
    "StateSpaceModel",
    "StateSpaceModelClassifier",
    "statespace_api",
]
