"""Numerical ops of the port: small linear algebra, moments, masked
Gaussian densities and Kalman filters in plain torch, and the CUDA kernels
of the Markov EM (``markov_kernels``), of the sorted dense route
(``estep_kernels``, ``mstep_kernels``) and of the masked filter
(``kalman_kernels``), sources in ``csrc/``."""
