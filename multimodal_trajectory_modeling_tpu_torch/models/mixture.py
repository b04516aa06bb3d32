"""``MMLinGaussSS_marginalizable``: the public mixture-model class.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/mixture.py``:
the constructor (:69-174) with its RNG contract, the parameter plumbing
(:180-199), the per-instance suffix gate (:238) and ``train`` (:803-921)
on its suffix-missingness route, the Markov EM fast path.

RNG contract: the parameter inits draw from the global NumPy RNG in the
reference's order, and the random assignment from
``np.random.default_rng(random_seed)``.  ``np.random.seed(s)`` before each
constructor therefore gives this class and the JAX one identical inits.

Parameters live as per-cluster lists of float64 NumPy arrays, as in the
JAX package, and go to ``device`` in the compute dtype for each fit.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import string

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.models import em

np_eps = np.finfo(float).eps

# public methods of the JAX class that this port does not have yet
_INFERENCE_METHODS = frozenset(
    {
        "aic",
        "bic",
        "cluster_assignment_index",
        "cluster_propensities_over_time",
        "conditional_log_likelihoods",
        "conditional_log_likelihoods_first_T0_steps",
        "e_complete_data_log_lik",
        "initial_full_data_cluster_assignment",
        "mle_cluster_assignment",
        "model_log_likelihood",
        "observations_mle_cluster_assignment",
        "observed_cluster_propensities_over_time",
        "observed_conditional_log_likelihoods",
        "observed_condl_log_lik_first_T0_steps",
        "one_step_ahead_predictions",
        "one_step_ahead_predictions_no_history",
        "predictions_from_initial_data",
    }
)


def _now() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .replace(microsecond=0)
        .astimezone()
        .isoformat()
    )


class MMLinGaussSS_marginalizable:
    """Mixture of linear-Gaussian state-space models with exact NaN
    marginalization, trained by hard-assignment EM with PyTorch on
    ``device``."""

    def __init__(
        self,
        n_clusters: int,
        states: np.ndarray,
        observations: np.ndarray,
        random_seed: int = 42,
        init: str = "random",
        alpha: float = 0.0,
        *,
        device="cpu",
        dtype: torch.dtype | None = None,
    ):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.device, dtype)
        states, observations = map(np.atleast_3d, (states, observations))
        self.n_clusters = int(n_clusters)
        self.states = np.array(states, dtype=float)
        self.observations = np.array(observations, dtype=float)

        self.n_timesteps, self.n_data, self.d_states = self.states.shape
        self.d_observations = self.observations.shape[-1]

        C, d, l = self.n_clusters, self.d_states, self.d_observations

        self.cluster_propensities = np.ones(C) / C
        # the parameter inits consume the global NumPy RNG in the
        # reference's draw order
        self.init_state_means = [np.random.normal(size=[d]) for _ in range(C)]
        draws = [np.random.normal(size=[d, d]) for _ in range(C)]
        self.init_state_covs = [x @ x.T + np.eye(d) for x in draws]
        self.transition_matrices = [
            np.random.normal(size=[d, d]) for _ in range(C)
        ]
        draws = [np.random.normal(size=[d, d]) for _ in range(C)]
        self.transition_covs = [x @ x.T + np.eye(d) for x in draws]
        self.measurement_matrices = [
            np.random.normal(size=[d, l]) for _ in range(C)
        ]
        draws = [np.random.normal(size=[l, l]) for _ in range(C)]
        self.measurement_covs = [x @ x.T + np.eye(l) for x in draws]

        self.random_seed = random_seed
        self.rng = np.random.default_rng(seed=self.random_seed)
        self.init = init
        self.alpha = alpha if alpha > 2 * np_eps else 0
        if self.init in ("k-means", "kmeans"):
            first_finite_t = np.argmax(
                np.isfinite(self.states).all(axis=2), axis=0
            ).ravel()
            first_state = np.stack(
                [
                    self.states[first_finite_t[i], i, :]
                    for i in range(self.n_data)
                ]
            )
            first_state = np.where(
                np.isfinite(first_state),
                first_state,
                np.nanmean(first_state, axis=0, keepdims=True),
            )
            self.cluster_assignment = self._kmeans(first_state)
        elif self.init in ("kmeans-all", "k-means-all"):
            flat = np.stack(
                [self.states[:, i, :].ravel() for i in range(self.n_data)]
            )
            self.cluster_assignment = self._kmeans(flat)
        else:
            self.cluster_assignment = self.rng.integers(
                low=0, high=C, size=self.n_data
            )

        self._correspondence = dict(zip(range(C), string.ascii_uppercase))
        self.inverse_correspondence = {
            v: k for k, v in self._correspondence.items()
        }

        self.hex_hash = hashlib.md5(
            self.states.tobytes()
            + self.observations.tobytes()
            + str(self.n_clusters).encode("utf-8")
            + (
                np.format_float_positional(self.alpha, unique=True).encode(
                    "utf-8"
                )
                if self.alpha > 2 * np_eps
                else b""
            )
        ).hexdigest()
        self.time_stamp = _now()
        self.last_trained = None
        # iterations and status code of the last train() call
        self.last_iterations = None
        self.last_status = None

    def _kmeans(self, features: np.ndarray) -> np.ndarray:
        """sklearn KMeans(k-means++, n_init=10) labels, as the JAX
        package computes them (scikit-learn is imported only here)."""
        import sklearn.cluster as skl_cluster

        return skl_cluster.KMeans(
            n_clusters=self.n_clusters,
            init="k-means++",
            n_init=10,
            random_state=self.random_seed,
        ).fit_predict(features)

    def __getattr__(self, name):
        if name in _INFERENCE_METHODS:
            raise NotImplementedError(
                f"{name} is not ported (ROADMAP Queue 1, items 3 and 6)"
            )
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    # ------------------------------------------------------------------
    # parameter plumbing
    # ------------------------------------------------------------------

    def _stacked_params(self) -> em.MixtureParams:
        return em.mixture_params_from_numpy(
            (
                self.cluster_propensities,
                np.stack(self.init_state_means),
                np.stack(self.init_state_covs),
                np.stack(self.transition_matrices),
                np.stack(self.transition_covs),
                np.stack(self.measurement_matrices),
                np.stack(self.measurement_covs),
            ),
            device=self.device,
            dtype=self.dtype,
        )

    def _set_params(self, params: em.MixtureParams) -> None:
        pi, m, S, A, G, H, L = (
            np.asarray(p, dtype=float) for p in em.mixture_params_to_numpy(params)
        )
        self.cluster_propensities = pi
        self.init_state_means = list(m)
        self.init_state_covs = list(S)
        self.transition_matrices = list(A)
        self.transition_covs = list(G)
        self.measurement_matrices = list(H)
        self.measurement_covs = list(L)

    @staticmethod
    def _suffix_instance_lens(z_np, x_np):
        """Per-instance observed lengths ``(n,) int32`` if every instance's
        missingness is a pure time suffix (z and x in lockstep, no
        partially observed step, no interior gap, length ≥ 1); else
        ``None``."""
        fin_z = np.isfinite(z_np)  # (T, n, d)
        fin_x = np.isfinite(x_np)  # (T, n, l)
        z_all, z_any = fin_z.all(-1), fin_z.any(-1)
        x_all, x_any = fin_x.all(-1), fin_x.any(-1)
        if not (
            np.array_equal(z_all, z_any)
            and np.array_equal(x_all, x_any)
            and np.array_equal(z_all, x_all)
        ):
            return None  # partially-observed time steps or z/x mismatch
        lens = z_all.sum(axis=0)  # (n,)
        T = fin_z.shape[0]
        expect = np.arange(T)[:, None] < lens[None, :]
        if not np.array_equal(z_all, expect) or lens.min() < 1:
            return None  # interior gaps
        return lens.astype(np.int32)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def train(
        self, *, verbose: bool = False, n_steps: int = 1000, fast: bool = False
    ):
        """EM to convergence (0 switches) or ``n_steps``, with the
        near-empty-cluster guards.

        Only ``fast=True`` on data with suffix-only missingness (variable
        trajectory lengths) is ported: it runs :func:`em.train_em_markov`.
        Every other route raises ``NotImplementedError``."""
        if verbose:
            raise NotImplementedError(
                "train(verbose=True), the host-stepped loop, is not ported "
                "(ROADMAP Queue 1, item 6)"
            )
        if not fast:
            raise NotImplementedError(
                "train(fast=False), the dense bit-parity route, is not "
                "ported (ROADMAP Queue 1, item 5)"
            )
        if os.environ.get("MTM_MARKOV_OOC") == "1":
            raise NotImplementedError(
                "MTM_MARKOV_OOC=1, out-of-core training, is not ported "
                "(ROADMAP Queue 1, item 9)"
            )
        lens = self._suffix_instance_lens(self.states, self.observations)
        if lens is None:
            raise NotImplementedError(
                "missingness other than a pure time suffix needs the masked "
                "Kalman or dense route (ROADMAP Queue 1, items 5 and 7)"
            )
        reg_mode = "ridge" if self.alpha > 2 * np_eps else "lstsq"

        def on_device(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        params, assign, iters, status = em.train_em_markov(
            self._stacked_params(),
            on_device(self.cluster_assignment, torch.int32),
            on_device(self.states, self.dtype),
            on_device(self.observations, self.dtype),
            on_device(lens, torch.int32),
            n_steps=n_steps,
            reg_mode=reg_mode,
            alpha=float(self.alpha),
        )
        self.last_iterations, self.last_status = iters, status
        if status == em.STATUS_INIT_ABORT:
            # the reference returns before stamping last_trained
            return self
        self._set_params(params)
        self.cluster_assignment = assign.cpu().numpy()
        self.last_trained = _now()
        return self

    def train_with_multiple_random_starts(self, *args, **kwargs):
        """Not ported yet: the slot-pool multistart needs kernels K3/K4."""
        raise NotImplementedError(
            "multistart training is not ported (ROADMAP Queue 1, item 4)"
        )
