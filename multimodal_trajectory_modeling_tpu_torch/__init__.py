"""PyTorch/CUDA port of ``multimodal_trajectory_modeling_tpu``.

The JAX package beside this one is the reference; every function here
names its counterpart there and is held against it by the
``tests/test_torch_*.py`` suite.  This package imports ``torch`` and never
``jax``.

What is ported so far is the Markov EM fast path for suffix-only
missingness (variable-length, NaN-suffix-padded trajectories):
``MMLinGaussSS_marginalizable(...).train(fast=True)`` and the slot-pool
multistart ``train_with_multiple_random_starts(fast=True)``, with its own
k-means init (no scikit-learn), the gzip-pickle cache, and five
hand-written CUDA kernels (``ops/markov_kernels.py``, sources in
``csrc/``).  Every other route raises ``NotImplementedError`` naming the
ROADMAP item that will bring it.

Devices are explicit: public entry points take ``device=`` (default
``"cpu"``) and ``dtype=`` (default float64 on the CPU, float32 on CUDA).
Nothing moves work between devices on its own.
"""

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)

__all__ = ["resolve_device", "resolve_dtype"]
