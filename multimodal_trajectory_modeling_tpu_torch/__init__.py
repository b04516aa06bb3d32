"""PyTorch/CUDA port of ``multimodal_trajectory_modeling_tpu``.

The JAX package beside this one is the reference; every function here
names its counterpart there and is held against it by the
``tests/test_torch_*.py`` suite.  This package imports ``torch`` and never
``jax``.

What is ported so far:

- the Markov EM fast path for suffix-only missingness (variable-length,
  NaN-suffix-padded trajectories) at any T: ``train(fast=True)`` and the
  slot-pool multistart ``train_with_multiple_random_starts(fast=True)``,
  with its own k-means init (no scikit-learn) and the gzip-pickle cache;
  kernels K1-K5 (``ops/markov_kernels.py``); without Φ
  (``MTM_MARKOV_PRECOMP=0``) and in the sequential multistart at long T,
  kernel K6 on the raw batch, and the E step on it, K10 (K11, the same
  function from canonical weights, has no caller);
- the dense joint route for any missingness: ``train()`` and the dense
  multistart (its candidates trained together in batches, K12 once on a
  batch's clusters an iteration on the card), and ``train(fast=True)`` / the fast
  multistart on interior missingness (up to 256 patterns and
  T(d+l) ≤ 512) through the pattern-sorted trainer, with kernels K8
  (``ops/estep_kernels.py``) and K9 (``ops/mstep_kernels.py``); on the
  card the dense log-likelihoods take kernel K12, and the dense entry
  points ``em.estep_logliks_sorted``, ``em.estep_assign_sorted``
  (row-major) and ``em.mstep(impl="pallas")`` kernels K13, K14 and K15;
- the exact O(T) masked Kalman route for any per-coordinate missingness
  past that gate: ``train(fast=True)`` and the fast multistart (one
  candidate after another, or pooled under ``MTM_MASKED_POOL=1``), with
  kernel K7 (``ops/kalman_kernels.py``; the filters in plain torch in
  ``ops/kalman.py``) and, one candidate at a time, the M step through
  kernel K15 on the batch in place (``ops/mstep_kernels.py``);
- the complete-data inference methods (log-likelihoods per cluster,
  propensities over time, ``e_complete_data_log_lik``,
  ``model_log_likelihood``, ``aic``/``bic``, ``mle_cluster_assignment``,
  the predictions), ``E_step``/``M_step`` and the verbose transcript of
  ``train`` and the multistart;
- the observed-only inference family (``observed_*``,
  ``observations_mle_cluster_assignment``: the hidden states
  marginalized), through the dense observed moments (K12 on the card) or
  past T·l = 512 the O(T) filters (K7 on the card).
- the reporting and plotting methods (``print_model``, ``print_tests``,
  the initial moments, the propensity and parameter plots), the numpy
  state-space helpers (``utils/state_space.py``) and the ADNI adapter
  (``utils/adni.py``: the data, the outcome table, the trajectory plot);
  pandas and matplotlib are imported only where a table is printed or a
  figure drawn.

The kernels are hand-written CUDA (sources in ``csrc/``).  Every other
route (out-of-core and data-parallel training) raises ``NotImplementedError`` naming the ROADMAP item that
will bring it.

Devices are explicit: public entry points take ``device=`` (default
``"cuda"``, the card; the tests pass ``device="cpu"``) and ``dtype=``
(default float64 on the CPU, float32 on CUDA).  Nothing moves work
between devices on its own.
"""

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)

__all__ = ["resolve_device", "resolve_dtype"]
