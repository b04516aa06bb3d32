"""Numerical ops of the port: small linear algebra, moments, masked
Gaussian densities and Kalman filters in plain torch, the kNN regression
(``knn``), and the CUDA kernels of the Markov EM (``markov_kernels``), of
the sorted dense route (``estep_kernels``, ``mstep_kernels``) and of the
masked filter (``kalman_kernels``), sources in ``csrc/``."""

from multimodal_trajectory_modeling_tpu_torch.ops.knn import (
    KNNRegressor,
    grid_search_knn,
    knn_predict,
)

__all__ = ["KNNRegressor", "grid_search_knn", "knn_predict"]
