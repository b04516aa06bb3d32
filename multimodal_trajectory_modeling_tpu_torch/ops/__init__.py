"""Numerical ops of the port: small linear algebra, moments, masked
Gaussian densities and Kalman filters in plain torch, the samplers, the
kNN regression (``knn``), and the CUDA kernels of the Markov EM
(``markov_kernels``), of the sorted dense route (``estep_kernels``,
``mstep_kernels``) and of the masked filter (``kalman_kernels``), sources
in ``csrc/``.  The names exported here are those of the JAX package's
``ops/__init__.py``."""

from multimodal_trajectory_modeling_tpu_torch.ops.moments import (
    joint_cov,
    joint_mean,
    joint_moments,
    latent_cov,
    latent_cov_blocks,
    latent_means,
    observed_cov,
    observed_mean,
    observed_moments,
)
from multimodal_trajectory_modeling_tpu_torch.ops.gaussian import (
    masked_identity_pad,
    masked_mvn_logpdf,
    masked_mvn_logpdf_grouped,
    mvn_logpdf,
    pattern_groups,
)
from multimodal_trajectory_modeling_tpu_torch.ops.regression import (
    MomentStats,
    RegressionStats,
    masked_mean_and_cov,
    masked_moment_stats,
    mean_cov_from_stats,
    regress,
    solve_regression,
    weighted_regression_stats,
    weighted_regression_stats_timebatched,
)
from multimodal_trajectory_modeling_tpu_torch.ops.samplers import (
    sample_nonlinear_trajectories,
    sample_trajectories,
)
from multimodal_trajectory_modeling_tpu_torch.ops.knn import (
    KNNRegressor,
    grid_search_knn,
    knn_predict,
)
from multimodal_trajectory_modeling_tpu_torch.ops.markov import (
    is_suffix_mask,
    markov_cluster_weights,
    markov_suffix_logliks,
    suffix_lengths,
)
from multimodal_trajectory_modeling_tpu_torch.ops.kalman import (
    kalman_filter_covs,
    kalman_observed_logliks,
)

__all__ = [
    "KNNRegressor",
    "MomentStats",
    "RegressionStats",
    "grid_search_knn",
    "is_suffix_mask",
    "joint_cov",
    "joint_mean",
    "joint_moments",
    "kalman_filter_covs",
    "kalman_observed_logliks",
    "knn_predict",
    "latent_cov",
    "latent_cov_blocks",
    "latent_means",
    "markov_cluster_weights",
    "markov_suffix_logliks",
    "masked_identity_pad",
    "masked_mean_and_cov",
    "masked_moment_stats",
    "masked_mvn_logpdf",
    "masked_mvn_logpdf_grouped",
    "mean_cov_from_stats",
    "mvn_logpdf",
    "observed_cov",
    "observed_mean",
    "observed_moments",
    "pattern_groups",
    "regress",
    "sample_nonlinear_trajectories",
    "sample_trajectories",
    "solve_regression",
    "suffix_lengths",
    "weighted_regression_stats",
    "weighted_regression_stats_timebatched",
]
