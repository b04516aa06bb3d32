"""Numerical ops of the port: small linear algebra in plain torch, and the
Markov EM kernels (``markov_kernels``, CUDA sources in ``csrc/``)."""
