"""Numerical ops of the port: small linear algebra, moments and masked
Gaussian densities in plain torch, and the CUDA kernels of the Markov EM
(``markov_kernels``) and of the sorted dense route (``estep_kernels``,
``mstep_kernels``), sources in ``csrc/``."""
