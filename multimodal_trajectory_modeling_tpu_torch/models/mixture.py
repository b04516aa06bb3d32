"""``MMLinGaussSS_marginalizable``: the public mixture-model class.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/mixture.py``:
the constructor (:69-174) with its RNG contract, the parameter plumbing
(:180-199), the per-instance suffix gate (:238), the ``correspondence``
property (:334-346), the gzip-pickle cache (``to_pickle``/``from_pickle``,
:348-425), ``train`` (:803-921) and ``train_with_multiple_random_starts``
(:1012-1472), both on their suffix-missingness route, the Markov EM fast
path.

RNG contract: the parameter inits draw from the global NumPy RNG in the
reference's order, and the random assignment from
``np.random.default_rng(random_seed)``.  ``np.random.seed(s)`` before each
constructor therefore gives this class and the JAX one identical inits.
The k-means init is :func:`.kmeans.kmeans_labels`, the counterpart of the
JAX package's scikit-learn call, so this package needs no scikit-learn.

Parameters live as per-cluster lists of float64 NumPy arrays, as in the
JAX package, and go to ``device`` in the compute dtype for each fit.  A
pickle written by either package loads in the other.
"""

from __future__ import annotations

import datetime
import glob
import gzip
import hashlib
import os
import pickle
import string
import time

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.models import em
from multimodal_trajectory_modeling_tpu_torch.models.kmeans import kmeans_labels

np_eps = np.finfo(float).eps

# repo root (…/multimodal_trajectory_modeling_tpu_torch/models/ → two up):
# the cache lives in <root>/tmp, beside the JAX package's
home_dir = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

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
        self._init_model(random_seed, init, alpha)
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
        # what the multistart that chose this model did (see
        # train_with_multiple_random_starts)
        self.last_multistart = None

    def _init_model(self, random_seed, init, alpha) -> None:
        """The constructor's draws, in the reference's order: parameter
        inits from the global NumPy RNG, then the initial assignment."""
        self.n_timesteps, self.n_data, self.d_states = self.states.shape
        self.d_observations = self.observations.shape[-1]

        C, d, l = self.n_clusters, self.d_states, self.d_observations

        self.cluster_propensities = np.ones(C) / C
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
            first_state = self.states[first_finite_t, np.arange(self.n_data), :]
            first_state = np.where(
                np.isfinite(first_state),
                first_state,
                np.nanmean(first_state, axis=0, keepdims=True),
            )
            self.cluster_assignment = self._kmeans(first_state)
        elif self.init in ("kmeans-all", "k-means-all"):
            flat = np.ascontiguousarray(
                self.states.transpose(1, 0, 2).reshape(self.n_data, -1)
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

    def _candidate(self, random_seed: int, init: str = "random"):
        """A multistart candidate: the model that
        ``MMLinGaussSS_marginalizable(n_clusters, states, observations,
        random_seed, init, alpha, device, dtype)`` builds on this model's
        data, with the same draws, but sharing this model's data arrays
        and hash instead of copying and rehashing them."""
        cand = object.__new__(type(self))
        cand.device, cand.dtype = self.device, self.dtype
        cand.n_clusters = self.n_clusters
        cand.states, cand.observations = self.states, self.observations
        cand._init_model(random_seed, init, self.alpha)
        cand.hex_hash = self.hex_hash
        cand.time_stamp = _now()
        cand.last_trained = None
        cand.last_iterations = cand.last_status = None
        cand.last_multistart = None
        return cand

    def _kmeans(self, features: np.ndarray) -> np.ndarray:
        """The labels of scikit-learn's ``KMeans(k-means++, n_init=10,
        random_state=random_seed)``, as the JAX package computes them,
        from :func:`.kmeans.kmeans_labels` on the host."""
        return kmeans_labels(
            features, self.n_clusters, random_state=self.random_seed
        )

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

    @property
    def correspondence(self) -> dict[int, str]:
        return self._correspondence

    @correspondence.setter
    def correspondence(self, corr: dict[int, str]) -> None:
        self._correspondence = corr
        self.inverse_correspondence = {
            v: k for k, v in self._correspondence.items()
        }

    # ------------------------------------------------------------------
    # persistence: content-addressed gzip-pickle cache
    # ------------------------------------------------------------------

    def to_pickle(
        self,
        save_location: str | os.PathLike = None,
        there_can_only_be_one: bool = True,
        include_training_data: bool = False,
    ):
        """The reference cache contract: a gzip pickle named
        ``mmm-<hash>-<utc stamp>.p.gz`` in ``save_location`` (default
        ``<repo>/tmp``), with the JAX package's payload keys; same-hash
        files are evicted first unless ``there_can_only_be_one`` is
        off."""
        if save_location is None:
            save_location = os.path.join(home_dir, "tmp")
        os.makedirs(save_location, exist_ok=True)
        ts = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%MZ"
        )
        if there_can_only_be_one:
            for f in glob.glob(
                os.path.join(save_location, f"mmm-{self.hex_hash}*")
            ):
                os.remove(f)
        payload = {
            "n_clusters": self.n_clusters,
            "cluster_propensities": self.cluster_propensities,
            "init_state_means": self.init_state_means,
            "init_state_covs": self.init_state_covs,
            "transition_matrices": self.transition_matrices,
            "transition_covs": self.transition_covs,
            "measurement_matrices": self.measurement_matrices,
            "measurement_covs": self.measurement_covs,
            "random_seed": self.random_seed,
            "rng": self.rng,
            "init": self.init,
            "alpha": self.alpha,
            "cluster_assignment": self.cluster_assignment,
            "correspondence": self.correspondence,
            "inverse_correspondence": self.inverse_correspondence,
            "hex_hash": self.hex_hash,
            "time_stamp": self.time_stamp,
            "last_trained": self.last_trained,
        }
        if include_training_data:
            payload |= {
                "states": self.states,
                "observations": self.observations,
            }
        with gzip.open(
            os.path.join(save_location, f"mmm-{self.hex_hash}-{ts}.p.gz"),
            "wb",
        ) as f:
            pickle.dump(payload, f)

    @staticmethod
    def from_pickle(
        file: str | os.PathLike,
        training_data: dict = None,
        *,
        device="cpu",
        dtype: torch.dtype | None = None,
    ):
        """A model from a pickle of :meth:`to_pickle` (of either package),
        on ``device``.  The constructor runs first, so it consumes the
        global NumPy RNG as the reference's loader does.  Unpickle only
        files this program wrote."""
        opener = gzip.open if os.path.splitext(file)[-1] == ".gz" else open
        with opener(file, "rb") as f:
            d = pickle.load(f)
        src = training_data if training_data is not None else d
        mdl = MMLinGaussSS_marginalizable(
            n_clusters=d["n_clusters"],
            states=src["states"],
            observations=src["observations"],
            random_seed=d["random_seed"],
            init=d["init"],
            alpha=d.get("alpha", 0),
            device=device,
            dtype=dtype,
        )
        mdl.cluster_propensities = d["cluster_propensities"]
        mdl.init_state_means = d["init_state_means"]
        mdl.init_state_covs = d["init_state_covs"]
        mdl.transition_matrices = d["transition_matrices"]
        mdl.transition_covs = d["transition_covs"]
        mdl.measurement_matrices = d["measurement_matrices"]
        mdl.measurement_covs = d["measurement_covs"]
        mdl.rng = d["rng"]
        mdl.cluster_assignment = d["cluster_assignment"]
        mdl.correspondence = d["correspondence"]
        mdl.inverse_correspondence = d["inverse_correspondence"]
        mdl.time_stamp = d["time_stamp"]
        mdl.last_trained = d["last_trained"]
        return mdl

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

    def _load_cached(self):
        """The newest cached model of this data's hash, or None (the
        cache is best-effort: a file that does not load is skipped)."""
        files = sorted(
            glob.glob(os.path.join(home_dir, "tmp", f"mmm-{self.hex_hash}*")),
            key=os.path.getmtime,
        )
        if not files:
            return None
        try:
            mdl = MMLinGaussSS_marginalizable.from_pickle(
                files[-1],
                training_data={
                    "states": self.states,
                    "observations": self.observations,
                },
                device=self.device,
                dtype=self.dtype,
            )
        except (OSError, EOFError, KeyError, ValueError, pickle.UnpicklingError):
            return None
        return mdl if mdl.hex_hash == self.hex_hash else None

    def train_with_multiple_random_starts(
        self,
        *,
        n_starts: int = 10,
        verbose: bool = False,
        n_steps: int = 100,
        return_objectives: bool = False,
        use_cache: bool = True,
        starts_per_batch: int = 256,
        fast: bool = None,
    ):
        """The reference multistart protocol on the suffix-missingness
        route.

        A cached model of the same data hash is returned if ``use_cache``.
        Else the candidates are one k-means start (seed 0) and
        ``n_starts`` random starts (seeds 100+i), drawn from the global
        NumPy RNG in constructor order.  They train through the slot pool
        (:func:`em.train_em_markov_pool`, ``MTM_MULTISTART_FUSE`` slots,
        default 32) with objectives from K4b in pool-sized groups, or, with
        one candidate or ``MTM_MULTISTART_FUSE`` ≤ 1, one after another
        (:func:`em.train_em_markov`, objectives from K4a).  The winner is
        the first candidate whose objective is strictly greater than all
        before it; if it is not finite, ``Exception("training failed")``.
        ``fast=None`` takes this route at n ≥ 200 000 on a CUDA device.

        The winner's ``last_multistart`` records the run: the k-means
        seconds, every candidate's iterations and status, and the pool's
        :class:`em.PoolStats` (None on the sequential branch).

        ``verbose=True``, the dense vmapped multistart (``fast=False``,
        and ``fast=None`` resolving to it), other missingness, long T and
        ``MTM_MULTICHIP=1`` on several cards raise
        ``NotImplementedError``.  ``starts_per_batch`` sizes only the
        dense route's batches."""
        if verbose:
            raise NotImplementedError(
                "verbose multistart, the host-stepped transcript, is not "
                "ported (ROADMAP Queue 1, item 6)"
            )
        if use_cache:
            cached = self._load_cached()
            if cached is not None:
                return cached
        if fast is None:
            fast = self.n_data >= 200_000 and self.device.type == "cuda"
        if not fast:
            raise NotImplementedError(
                "the vmapped dense multistart (fast=False) is not ported "
                "(ROADMAP Queue 1, item 5)"
            )
        lens = self._suffix_instance_lens(self.states, self.observations)
        if lens is None:
            raise NotImplementedError(
                "missingness other than a pure time suffix needs the masked "
                "Kalman or dense route (ROADMAP Queue 1, items 5 and 7)"
            )
        T, d, l = self.n_timesteps, self.d_states, self.d_observations
        if not em.markov_packed_ok(T, d, l):
            raise NotImplementedError(
                "long-T multistart needs the grid-over-T kernels (ROADMAP "
                "Queue 2, K5/K6)"
            )
        r_fuse = int(os.environ.get("MTM_MULTISTART_FUSE", "32"))
        pooled = r_fuse > 1 and n_starts > 0
        if (
            pooled
            and os.environ.get("MTM_MULTICHIP") == "1"
            and self.device.type == "cuda"
            and torch.cuda.device_count() > 1
        ):
            raise NotImplementedError(
                "the data-parallel pool (MTM_MULTICHIP=1) is not ported "
                "(ROADMAP Queue 1, item 9)"
            )

        t0 = time.perf_counter()
        candidates = [self._candidate(0, "kmeans")]
        kmeans_s = time.perf_counter() - t0
        candidates += [self._candidate(100 + i) for i in range(n_starts)]
        reg_mode = "ridge" if self.alpha > 2 * np_eps else "lstsq"

        def on_device(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        z = on_device(self.states, self.dtype)
        x = on_device(self.observations, self.dtype)
        lens_d = on_device(lens, torch.int32)
        n = self.n_data
        z_t = z.permute(0, 2, 1).reshape(T * d, n)
        x_t = x.permute(0, 2, 1).reshape(T * l, n)
        if pooled:
            u = em.pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
            del z_t, x_t
            results, pool_stats = em.train_em_markov_pool(
                [c._stacked_params() for c in candidates],
                [np.asarray(c.cluster_assignment) for c in candidates],
                z,
                x,
                lens_d,
                R=r_fuse,
                n_steps=n_steps,
                reg_mode=reg_mode,
                alpha=float(self.alpha),
                u=u,
            )
            # objectives (Σ max scores under a fresh E) in pool-sized groups
            objectives = []
            for i0 in range(0, len(results), r_fuse):
                grp = em.stack_params([p for p, *_ in results[i0 : i0 + r_fuse]])
                objs = em.complete_data_loglik_markov_multi(grp, lens_d, u, T=T)
                objectives += objs.cpu().tolist()
        else:
            results, objectives, pool_stats = [], [], None
            for cand in candidates:
                res = em.train_em_markov(
                    cand._stacked_params(),
                    on_device(cand.cluster_assignment, torch.int32),
                    z,
                    x,
                    lens_d,
                    n_steps=n_steps,
                    reg_mode=reg_mode,
                    alpha=float(self.alpha),
                )
                results.append(res)
                objectives.append(
                    float(em.complete_data_loglik_markov(res[0], z_t, x_t, lens_d, T=T))
                )

        objectives = np.asarray(objectives)
        best_i = 0
        for i in range(1, len(candidates)):
            if objectives[i] > objectives[best_i]:
                best_i = i
        if not np.isfinite(objectives[best_i]):
            raise Exception("training failed")

        best_mdl = candidates[best_i]
        # an init-aborted winner keeps its constructor parameters, as the
        # reference's untrained return does
        params_b, assign_b, iters_b, status_b = results[best_i]
        best_mdl._set_params(params_b)
        best_mdl.cluster_assignment = assign_b.cpu().numpy()
        best_mdl.last_iterations, best_mdl.last_status = iters_b, status_b
        best_mdl.last_trained = _now()
        best_mdl.last_multistart = {
            "kmeans_seconds": kmeans_s,
            "iterations": [r[2] for r in results],
            "statuses": [r[3] for r in results],
            "pool": pool_stats,
        }
        if use_cache:
            best_mdl.to_pickle()
        if return_objectives:
            return best_mdl, objectives
        return best_mdl
