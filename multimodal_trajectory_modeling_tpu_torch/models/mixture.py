"""``MMLinGaussSS_marginalizable``: the public mixture-model class.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/mixture.py``:
the constructor (:69-174) with its RNG contract, the parameter plumbing
(:180-199), the route predicate ``_needs_masked_filter_route`` (:201), the
suffix gates (:214, :238), ``_packed`` (:261), ``n_free_params`` (:315),
the ``correspondence`` property (:334-346), the gzip-pickle cache
(``to_pickle``/``from_pickle``, :348-425), the complete-data inference
family (:431-700: the per-cluster log-likelihoods, propensities over
time, ``e_complete_data_log_lik``, ``model_log_likelihood``, ``aic``,
``bic``, ``mle_cluster_assignment``, ``cluster_assignment_index``, the
predictions), ``regress``/``regress_alpha`` (:756-773), ``E_step`` and
``M_step`` (:779-801), ``train`` (:803-921) with its verbose transcript
(:968-1010) and ``train_with_multiple_random_starts`` (:1012-1472), on
the Markov route (suffix missingness, any T), the dense joint route (any
missingness within its size gate) and the masked-filter route (any
missingness past it); the observed-only family (:706-750), which
marginalizes the hidden states: ``_packed_observed`` (:288) and
``_all_observed_logliks`` (:496); and the reporting and plotting methods
(:1478-1843: ``print_model``, ``print_tests``,
``superimpose_model_on_plot``, ``get_initial_means_and_stds``,
``get_initial_diffs_means_and_stds``, the propensity plots,
``plot_matrix``, ``ponder`` and ``generate_model_plots``), which import
matplotlib and scipy where they are used and apply the JAX package's
matplotlib settings inside ``plt.rc_context`` only.

The suffix gate is taken per instance, before the joint batch is packed,
so the Markov route never packs it; it is the same gate as the JAX
package's per-pattern ``_suffix_pattern_lens``.  The inference methods
take it the same way past T(d+l) = 512, where the JAX package packs the
joint batch to group its patterns first: the result is the same.  The
observed-only family does likewise past T·l = 512 with the x-only gate
(``_suffix_pattern_lens_x``, :480), so the observed batch is then never
packed or grouped.

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
import torch.distributed as dist

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.models import em
from multimodal_trajectory_modeling_tpu_torch.models.kmeans import kmeans_labels
from multimodal_trajectory_modeling_tpu_torch.ops._build import KernelError
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from multimodal_trajectory_modeling_tpu_torch.ops import moments as jmom
from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops
from multimodal_trajectory_modeling_tpu_torch.parallel import sharded_em
from multimodal_trajectory_modeling_tpu_torch.parallel.mesh import make_mesh
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as ssu
from multimodal_trajectory_modeling_tpu_torch.utils.trace import EMTrace

np_eps = np.finfo(float).eps

# the dense multistart's batch budget, the JAX package's ~6 GB cap
# (mixture.py:1398-1408)
_DENSE_BATCH_BYTES = 6e9

# repo root (…/multimodal_trajectory_modeling_tpu_torch/models/ → two up):
# the cache lives in <root>/tmp, beside the JAX package's
home_dir = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
        device=None,
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
        self.last_trace = None
        self._device_cache = {}

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
        cand.last_multistart = cand.last_trace = None
        cand._device_cache = {}
        return cand

    def _kmeans(self, features: np.ndarray) -> np.ndarray:
        """The labels of scikit-learn's ``KMeans(k-means++, n_init=10,
        random_state=random_seed)``, as the JAX package computes them,
        from :func:`.kmeans.kmeans_labels` on the host."""
        return kmeans_labels(
            features, self.n_clusters, random_state=self.random_seed
        )

    # ------------------------------------------------------------------
    # parameter plumbing
    # ------------------------------------------------------------------

    def _params_numpy(self) -> tuple:
        """The parameters as one float64 array per leaf, clusters first."""
        return (
            np.asarray(self.cluster_propensities),
            np.stack(self.init_state_means),
            np.stack(self.init_state_covs),
            np.stack(self.transition_matrices),
            np.stack(self.transition_covs),
            np.stack(self.measurement_matrices),
            np.stack(self.measurement_covs),
        )

    def _stacked_params(self) -> em.MixtureParams:
        return em.mixture_params_from_numpy(
            self._params_numpy(), device=self.device, dtype=self.dtype
        )

    @staticmethod
    def _stack_candidates(batch, *, device, dtype) -> em.MixtureParams:
        """The parameters of a list of candidates on a leading restart
        axis, stacked on the host."""
        return em.mixture_params_from_numpy(
            tuple(np.stack(leaf) for leaf in zip(*(c._params_numpy() for c in batch))),
            device=device, dtype=dtype,
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

    def _needs_masked_filter_route(self, T, n_patterns) -> bool:
        """Whether the dense (T(d+l))² joint is too large for the fast
        routes, which then take the O(T) masked filter: a joint dimension
        past 512 or more than 256 missingness patterns.  One predicate for
        ``train(fast=True)`` and the fast multistart."""
        return (
            T * (self.d_states + self.d_observations) > 512
            or n_patterns > 256
        )

    def _on_device(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype or self.dtype, device=self.device)

    def _packed(self, states=None, observations=None, T0=None):
        """A dataset's first ``T0`` steps (all by default) packed for the
        dense route: ``(T0, z, x, v (n, T0·(d+l)), patterns (P, D) bool,
        pattern_id (n,) numpy int32)`` on ``device``, patterns in
        ``np.unique`` order.  The model's own data (``states=None``) is
        packed once per ``T0``, cached under ``("joint", T0)``, its z and x
        views of :meth:`_masked_batch`."""
        own = states is None
        if own:
            states, observations = self.states, self.observations
        T0 = states.shape[0] if T0 is None else min(T0, states.shape[0])
        key = ("joint", T0)
        if own and key in self._device_cache:
            return self._device_cache[key]
        z = np.atleast_3d(states)[:T0].astype(float)
        x = np.atleast_3d(observations)[:T0].astype(float)
        v_np = em.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
        patterns, pid = gops.pattern_groups(v_np)
        if own:
            z_dev, x_dev = (a[:T0] for a in self._masked_batch())
        else:
            z_dev, x_dev = self._on_device(z), self._on_device(x)
        out = (
            T0,
            z_dev,
            x_dev,
            self._on_device(v_np),
            self._on_device(patterns, torch.bool),
            pid,
        )
        if own:
            self._device_cache[key] = out
        return out

    def _packed_observed(self, observations=None, T0=None):
        """A dataset's first ``T0`` steps of observations packed for the
        observed-only family: ``(T0, vx (n, T0·l), patterns (P, T0·l)
        bool, pattern_id (n,) numpy int32)`` on ``device``, patterns in
        ``np.unique`` order.  The model's own data is packed once per
        ``T0``, cached under ``("obs", T0)``."""
        own = observations is None
        if own:
            observations = self.observations
        T0 = observations.shape[0] if T0 is None else min(T0, observations.shape[0])
        key = ("obs", T0)
        if own and key in self._device_cache:
            return self._device_cache[key]
        x = np.atleast_3d(observations)[:T0].astype(float)
        vx_np = em.pack_observed(torch.from_numpy(x)).numpy()
        patterns, pid = gops.pattern_groups(vx_np)
        out = (T0, self._on_device(vx_np), self._on_device(patterns, torch.bool), pid)
        if own:
            self._device_cache[key] = out
        return out

    def _takes_masked_filter_route(self) -> bool:
        """:meth:`_needs_masked_filter_route` for this model's data.  Past
        T(d+l) = 512 the width decides alone, so the joint batch is
        neither packed nor grouped into patterns (it would be ~1 GB on the
        card at T=128, n=2.5e5); else the pattern count of
        :meth:`_packed` decides."""
        T = self.n_timesteps
        if self._needs_masked_filter_route(T, 0):
            return True
        return self._needs_masked_filter_route(T, self._packed()[4].shape[0])

    def _masked_batch(self):
        """``(z, x)`` of the model's data on ``device``, made once and
        cached under ``("batch",)``; :meth:`_packed` takes its z and x from
        here, so the card holds one copy of the batch."""
        key = ("batch",)
        if key not in self._device_cache:
            self._device_cache[key] = (self._on_device(self.states), self._on_device(self.observations))
        return self._device_cache[key]

    def _sorted_batch(self):
        """The packed data sorted by missingness pattern for
        :func:`em.train_em_sorted`: ``(order, sizes, z, x, v, patterns,
        pattern_id)``, rows in ``order`` (an (n,) index tensor on
        ``device``)."""
        _T0, z, x, v, patterns, pid = self._packed()
        order = np.argsort(pid, kind="stable")
        sizes = tuple(int(c) for c in np.bincount(pid, minlength=patterns.shape[0]))
        pid_s = torch.as_tensor(pid[order], device=self.device)
        order = torch.as_tensor(order, device=self.device)
        return order, sizes, z[:, order], x[:, order], v[order], patterns, pid_s

    @staticmethod
    def _suffix_instance_lens_x(x_np):
        """The x-only suffix gate: per-instance observed lengths ``(n,)
        int32`` if every instance's values in ``x_np`` (T, n, ·) are missing
        over a pure time suffix (no partially observed step, no interior
        gap, length ≥ 1), else ``None``.  Taken per instance, it decides as
        the JAX package's per-pattern ``_suffix_pattern_lens_x``: an
        all-missing row goes to the masked filter."""
        fin = np.isfinite(x_np)  # (T, n, l)
        x_all, x_any = fin.all(-1), fin.any(-1)
        if not np.array_equal(x_all, x_any):
            return None  # partially observed steps
        lens = x_all.sum(axis=0)
        expect = np.arange(fin.shape[0])[:, None] < lens[None, :]
        if not np.array_equal(x_all, expect) or lens.min() < 1:
            return None  # interior gaps or all-missing rows
        return lens.astype(np.int32)

    @staticmethod
    def _suffix_instance_lens(z_np, x_np):
        """The joint suffix gate: :meth:`_suffix_instance_lens_x` of z and
        of x, the two lengths equal (z and x in lockstep); else ``None``."""
        gate = MMLinGaussSS_marginalizable._suffix_instance_lens_x
        lens = gate(z_np)
        if lens is None or not np.array_equal(lens, gate(x_np)):
            return None
        return lens

    @property
    def n_free_params(self) -> int:
        """Free-parameter count: means and matrices fully, covariances by
        their upper triangle."""
        full = sum(
            x.size
            for x in [np.asarray(self.cluster_propensities)]
            + list(self.init_state_means)
            + list(self.transition_matrices)
            + list(self.measurement_matrices)
        )
        tri = sum(
            len(np.triu_indices_from(np.atleast_2d(x))[0])
            for x in list(self.init_state_covs)
            + list(self.transition_covs)
            + list(self.measurement_covs)
        )
        return full + tri

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
        device=None,
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
    # the complete-data inference family
    # ------------------------------------------------------------------

    def conditional_log_likelihoods_first_T0_steps(
        self, c: int, T0: int, *, states=None, observations=None
    ) -> np.ndarray:
        """Per-instance joint log-likelihood under cluster ``c`` over the
        first ``T0`` steps."""
        if not 1 <= T0 <= self.n_timesteps:
            raise ValueError(f"T0 must be in [1, {self.n_timesteps}], got {T0}")
        return self._all_cluster_logliks(T0, states, observations)[c]

    def conditional_log_likelihoods(
        self, c: int, *, states=None, observations=None
    ) -> np.ndarray:
        return self.conditional_log_likelihoods_first_T0_steps(
            c, self.n_timesteps, states=states, observations=observations
        )

    def _all_cluster_logliks(self, T0, states, observations) -> np.ndarray:
        """``(C, n)`` float64 log-likelihoods of a dataset's first ``T0``
        steps (the model's own data by default).  Up to T0(d+l) = 512 the
        dense joint (:func:`em.estep_logliks` on :meth:`_packed`); past
        it, decided per instance without packing the joint batch, the O(T)
        Markov factorization on suffix data
        (:func:`em.suffix_logliks_markov`: K5's Φ on the card) and the
        masked filter on any other (:func:`em.masked_logliks_kalman`,
        K7)."""
        own = states is None
        z_np = self.states if own else np.atleast_3d(np.asarray(states, dtype=float))
        x_np = self.observations if own else np.atleast_3d(np.asarray(observations, dtype=float))
        T0 = min(T0, z_np.shape[0])
        params = self._stacked_params()
        if self._needs_masked_filter_route(T0, 0):
            lens = self._suffix_instance_lens(z_np[:T0], x_np[:T0])
            if own:
                z, x = (a[:T0] for a in self._masked_batch())
            else:
                z, x = self._on_device(z_np[:T0]), self._on_device(x_np[:T0])
            if lens is not None:
                ll = em.suffix_logliks_markov(params, z, x, self._on_device(lens, torch.int32))
            else:
                ll = em.masked_logliks_kalman(params, z, x)
        else:
            _T0, _z, _x, v, patterns, pid = self._packed(states, observations, T0)
            ll = em.estep_logliks(params, v, patterns, self._on_device(pid, torch.int32), T=T0)
        return ll.cpu().numpy().astype(float)

    def cluster_propensities_over_time(
        self, *, states=None, observations=None
    ) -> np.ndarray:
        """``(T, n, C)`` posterior membership from the first t+1 steps."""
        _T = min(
            self.n_timesteps,
            (self.states if states is None else states).shape[0],
        )
        probs = []
        for t in range(_T):
            ll = self._all_cluster_logliks(t + 1, states, observations)
            logits = np.log(self.cluster_propensities)[:, None] + ll
            probs.append(_softmax_cols(logits).T)  # (n, C)
        pc_t = np.stack(probs, axis=0)
        assert np.all(pc_t >= 0.0) and np.allclose(np.sum(pc_t, axis=-1), 1.0)
        return pc_t

    def e_complete_data_log_lik(
        self, *, states=None, observations=None
    ) -> float:
        """The hard-assignment complete-data log-likelihood under a fresh
        E assignment."""
        ll = self._all_cluster_logliks(self.n_timesteps, states, observations)
        a = np.argmax(np.log(self.cluster_propensities)[:, None] + ll, axis=0)
        return float(
            np.sum(np.log(self.cluster_propensities[a]))
            + np.sum(ll[a, np.arange(ll.shape[1])])
        )

    def model_log_likelihood(
        self, *, states=None, observations=None
    ) -> float:
        """The mixture's marginal log-likelihood Σ_i log Σ_c π_c L_ci
        (logsumexp)."""
        ll = self._all_cluster_logliks(self.n_timesteps, states, observations)
        logits = np.log(self.cluster_propensities)[:, None] + ll
        return float(np.sum(_logsumexp_cols(logits)))

    def aic(self, states=None, observations=None) -> float:
        return (
            -2 * self.model_log_likelihood(states=states, observations=observations)
            + 2 * self.n_free_params
        )

    def bic(self, states=None, observations=None) -> float:
        n = self.n_data if states is None else states.shape[1]
        return (
            -2 * self.model_log_likelihood(states=states, observations=observations)
            + np.log(n) * self.n_free_params
        )

    def mle_cluster_assignment(
        self,
        *,
        return_probs: bool = False,
        return_prenormalized_log_probs: bool = False,
        states=None,
        observations=None,
    ):
        """The hard MLE assignment (argmax of log π_c + ll_c); optionally
        the normalized posterior and the prenormalized log-probabilities."""
        ll = self._all_cluster_logliks(self.n_timesteps, states, observations)
        prenorm = np.log(self.cluster_propensities)[:, None] + ll
        assignments = np.argmax(prenorm, axis=0)
        if not (return_probs or return_prenormalized_log_probs):
            return assignments
        probs = _softmax_cols(prenorm)
        if not return_prenormalized_log_probs:
            return assignments, probs
        return assignments, probs, prenorm

    def cluster_assignment_index(
        self, *, cluster: str = "A", states=None, observations=None
    ) -> np.ndarray:
        """Prenormalized log-odds of membership in ``cluster``."""
        return self.mle_cluster_assignment(
            states=states,
            observations=observations,
            return_probs=True,
            return_prenormalized_log_probs=True,
        )[-1][self.inverse_correspondence[cluster]]

    def _mix_one_step_predictions(self, states, assignment_probs):
        last = states[-1]
        nz = np.zeros((1, *states.shape[1:]))
        nx = np.zeros((1, last.shape[0], self.d_observations))
        for c in range(self.n_clusters):
            zc = last @ self.transition_matrices[c]
            xc = zc @ self.measurement_matrices[c]
            w = assignment_probs[c][:, None]
            nz += w * zc
            nx += w * xc
        return nz, nx

    def one_step_ahead_predictions(self, *, states, observations):
        """Posterior-weighted one-step-ahead forecasts."""
        probs = self.mle_cluster_assignment(
            states=states, observations=observations, return_probs=True
        )[1]
        assert probs.shape == (self.n_clusters, states[-1].shape[0])
        return self._mix_one_step_predictions(states, probs)

    def one_step_ahead_predictions_no_history(self, *, states, observations):
        """The same forecasts, clusters assigned from the last step
        only."""
        z_nh = np.full_like(states, np.nan)
        z_nh[-1] = states[-1]
        x_nh = np.full_like(observations, np.nan)
        x_nh[-1] = observations[-1]
        probs = self.mle_cluster_assignment(
            states=z_nh, observations=x_nh, return_probs=True
        )[1]
        assert probs.shape == (self.n_clusters, states[-1].shape[0])
        return self._mix_one_step_predictions(states, probs)

    def initial_full_data_cluster_assignment(
        self, *, states=None, observations=None
    ) -> np.ndarray:
        """The assignment from the first step only."""
        ll = self._all_cluster_logliks(1, states, observations)
        return np.argmax(np.log(self.cluster_propensities)[:, None] + ll, axis=0)

    def predictions_from_initial_data(self, *, states=None, observations=None):
        """Each instance's assigned mean dynamics rolled forward from its
        own initial state.  As in the reference, the initial states are
        the training data's whatever the arguments."""
        assignments = self.initial_full_data_cluster_assignment(
            states=states, observations=observations
        )
        pred_z = np.zeros_like(self.states if states is None else states)
        pred_x = np.zeros_like(self.observations if observations is None else observations)
        Tz, Tx = pred_z.shape[0], pred_x.shape[0]
        # every instance's chain at once (float64, on the device), the
        # transition matrix gathered from its cluster
        z0s = self._on_device(self.states[0], torch.float64)
        A_by_instance = self._on_device(np.stack(self.transition_matrices), torch.float64)[
            torch.as_tensor(assignments, device=self.device)
        ]
        chains = jmom.latent_means(Tz, z0s, A_by_instance).cpu().numpy()  # (n, Tz, d)
        assert np.array_equal(chains[:, 0, :], self.states[0])
        pred_z[:] = chains.transpose(1, 0, 2)[:Tz]
        H_by_instance = np.stack(self.measurement_matrices)[assignments]
        pred_x[:] = np.einsum("ntl,nld->tnd", chains[:, :Tx, :], H_by_instance)
        return pred_z, pred_x

    # ------------------------------------------------------------------
    # the observed-only family (hidden states marginalized)
    # ------------------------------------------------------------------

    def _all_observed_logliks(self, T0, observations) -> np.ndarray:
        """``(C, n)`` float64 log-likelihoods of a dataset's first ``T0``
        steps of observations alone (the model's own by default).  Up to
        T0·l = 512 the dense observed moments (:func:`em.observed_logliks`
        on :meth:`_packed_observed`: K12 on the card); past it, without
        packing, the O(T) filters: on suffix data (the x-only gate)
        :func:`em.observed_logliks_kalman`, on any other the masked filter
        with an all-NaN state block (:func:`em.masked_logliks_kalman`,
        K7)."""
        own = observations is None
        x_np = self.observations if own else np.atleast_3d(np.asarray(observations, dtype=float))
        T0 = min(T0, x_np.shape[0])
        params = self._stacked_params()
        if T0 * self.d_observations > 512:
            lens = self._suffix_instance_lens_x(x_np[:T0])
            x = self._masked_batch()[1][:T0] if own else self._on_device(x_np[:T0])
            if lens is not None:
                ll = em.observed_logliks_kalman(params, x, self._on_device(lens, torch.int32))
            else:
                z_none = torch.full((T0, x.shape[1], self.d_states), torch.nan, dtype=x.dtype, device=x.device)
                ll = em.masked_logliks_kalman(params, z_none, x)
        else:
            _T0, vx, patterns, pid = self._packed_observed(observations, T0)
            ll = em.observed_logliks(params, vx, patterns, self._on_device(pid, torch.int32), T=T0)
        return ll.cpu().numpy().astype(float)

    def observed_condl_log_lik_first_T0_steps(
        self, c: int, T0: int, *, observations=None
    ) -> np.ndarray:
        """p(x | c) over the first ``T0`` steps, every hidden state
        marginalized."""
        assert 1 <= T0 <= self.n_timesteps
        return self._all_observed_logliks(T0, observations)[c]

    def observed_conditional_log_likelihoods(
        self, c: int, observations=None
    ) -> np.ndarray:
        return self.observed_condl_log_lik_first_T0_steps(
            c, self.n_timesteps, observations=observations
        )

    def observed_cluster_propensities_over_time(
        self, observations=None
    ) -> np.ndarray:
        """``(T, n, C)`` posterior membership from the first t+1 steps of
        the observations alone."""
        _T = (self.observations if observations is None else observations).shape[0]
        probs = []
        for t in range(_T):
            ll = self._all_observed_logliks(t + 1, observations)
            logits = np.log(self.cluster_propensities)[:, None] + ll
            probs.append(_softmax_cols(logits).T)
        pc_t = np.stack(probs, axis=0)
        assert np.all(pc_t >= 0.0) and np.allclose(np.sum(pc_t, axis=-1), 1.0)
        return pc_t

    def observations_mle_cluster_assignment(
        self, *, return_probs: bool = False, observations=None
    ):
        """The hard assignment from the observations alone (argmax of
        log π_c + log p(x | c)); optionally the normalized posterior."""
        ll = self._all_observed_logliks(self.n_timesteps, observations)
        prenorm = np.log(self.cluster_propensities)[:, None] + ll
        assignments = np.argmax(prenorm, axis=0)
        if return_probs:
            return assignments, _softmax_cols(prenorm)
        return assignments

    # ------------------------------------------------------------------
    # regression helpers
    # ------------------------------------------------------------------

    @staticmethod
    def regress(input_exogenous, output_endogenous, *, device=None, dtype=None):
        """``Y | X ~ N(X A, S)`` by least squares over the rows with no
        NaN: ``(A, S)`` as float64 arrays."""
        return _regress(input_exogenous, output_endogenous, "lstsq", 0.0, device, dtype)

    @staticmethod
    def regress_alpha(input_exogenous, output_endogenous, alpha, *, device=None, dtype=None):
        """:meth:`regress` with a ridge ``alpha``."""
        return _regress(input_exogenous, output_endogenous, "ridge", alpha, device, dtype)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def E_step(self) -> int:
        """One E step; returns the number of changed assignments."""
        new_assignment = self.mle_cluster_assignment()
        n_switches = int(np.sum(np.not_equal(self.cluster_assignment, new_assignment)))
        self.cluster_assignment = new_assignment
        return n_switches

    def M_step(self) -> None:
        """One M step from the current assignment (:func:`em.mstep`, all
        clusters at once)."""
        z, x = self._masked_batch()
        params = em.mstep(
            z,
            x,
            torch.as_tensor(np.asarray(self.cluster_assignment), device=self.device),
            n_clusters=self.n_clusters,
            reg_mode="ridge" if self.alpha > 2 * np_eps else "lstsq",
            alpha=float(self.alpha),
        )
        self._set_params(params)

    def train(
        self, *, verbose: bool = False, n_steps: int = 1000, fast: bool = False
    ):
        """EM to convergence (0 switches) or ``n_steps``, with the
        near-empty-cluster guards.

        ``fast=False`` runs the dense joint route :func:`em.train_em` (plain
        torch).  ``fast=True`` takes, on suffix-only missingness (variable
        trajectory lengths), the Markov route :func:`em.train_em_markov`
        (K2 or, past T·s = 512, K5 once, then K1 per iteration); on any
        other missingness past 256 patterns or T(d+l) = 512 the exact O(T)
        masked-filter route :func:`em.train_em_masked_kalman` (K7 per E
        step); else the pattern-sorted dense route
        :func:`em.train_em_sorted` (kernels K8 and K9), whose sort is
        undone on return.  On suffix data ``MTM_MARKOV_PRECOMP=0`` builds
        no Φ: every iteration rebuilds it (K4a, or past T·s = 512 K6 on
        the raw batch).  ``verbose=True`` takes the host-stepped loop
        (:meth:`E_step`, :meth:`M_step`, the objective printed after every
        M step as the reference prints it, an :class:`EMTrace` in
        ``last_trace``) and ignores ``fast``.  ``fast=True`` under
        ``MTM_MARKOV_OOC=1`` on suffix data streams Φ from host memory
        (:meth:`_train_markov_outofcore`)."""
        if verbose:
            return self._train_verbose(n_steps=n_steps)
        reg_mode = "ridge" if self.alpha > 2 * np_eps else "lstsq"
        if fast and os.environ.get("MTM_MARKOV_OOC") == "1":
            ooc = self._train_markov_outofcore(n_steps=n_steps, reg_mode=reg_mode)
            if ooc is not None:
                return ooc
        fit = dict(n_steps=n_steps, reg_mode=reg_mode, alpha=float(self.alpha))

        assign0 = self._on_device(self.cluster_assignment, torch.int32)
        lens = self._suffix_instance_lens(self.states, self.observations) if fast else None
        if lens is not None:
            params, assign, iters, status = em.train_em_markov(
                self._stacked_params(),
                assign0,
                self._on_device(self.states),
                self._on_device(self.observations),
                self._on_device(lens, torch.int32),
                **fit,
            )
        elif fast and self._takes_masked_filter_route():
            params, assign, iters, status = em.train_em_masked_kalman(
                self._stacked_params(), assign0, *self._masked_batch(), **fit
            )
        elif fast:
            order, sizes, z, x, v, patterns, _pid = self._sorted_batch()
            params, assign_s, iters, status = em.train_em_sorted(
                self._stacked_params(), assign0[order], z, x, v, patterns,
                sizes=sizes, **fit,
            )
            assign = torch.empty_like(assign_s)
            assign[order] = assign_s  # undo the sort
        else:
            _T0, z, x, v, patterns, pid = self._packed()
            params, assign, iters, status = em.train_em(
                self._stacked_params(), assign0, z, x, v, patterns,
                self._on_device(pid, torch.int32), **fit,
            )
        self.last_iterations, self.last_status = iters, status
        if status == em.STATUS_INIT_ABORT:
            # the reference returns before stamping last_trained
            return self
        self._set_params(params)
        self.cluster_assignment = assign.cpu().numpy()
        self.last_trained = _now()
        return self

    def _train_markov_outofcore(self, *, n_steps: int, reg_mode: str):
        """The ``MTM_MARKOV_OOC=1`` route of :meth:`train`'s fast path
        (``mixture.py:923``): suffix-missingness EM with Φ streamed from
        host memory (:func:`em.train_em_markov_outofcore`), so the device
        holds at most two chunks of Φ; the batch stays on the host and no
        device copy is cached.  Returns ``None`` when the missingness is
        not a pure suffix, so :meth:`train` falls through to its in-core
        routes.  ``MTM_MARKOV_OOC_CHUNK`` sets the chunk width (instances
        a streamed block, default 2²⁰)."""
        lens = self._suffix_instance_lens(self.states, self.observations)
        if lens is None:
            return None
        chunk = int(os.environ.get("MTM_MARKOV_OOC_CHUNK", str(1 << 20)))
        params, assign, iters, status = em.train_em_markov_outofcore(
            self._stacked_params(),
            np.asarray(self.cluster_assignment, np.int32),
            self.states,
            self.observations,
            lens,
            n_steps=n_steps,
            reg_mode=reg_mode,
            alpha=float(self.alpha),
            chunk_cols=chunk,
        )
        self.last_iterations, self.last_status = iters, status
        if status == em.STATUS_INIT_ABORT:
            return self  # the reference returns before stamping last_trained
        self._set_params(params)
        self.cluster_assignment = assign.numpy().copy()
        self.last_trained = _now()
        return self

    def _train_verbose(self, *, n_steps: int):
        """Host-stepped EM with the reference's prints: the objective
        rounded to 3 decimals after every M step, "Optimisation completed
        in {i} steps." and "Encountered near-empty cluster."; records an
        :class:`EMTrace` in ``last_trace``."""
        trace = EMTrace()
        self.last_trace = trace
        self.last_iterations = self.last_status = None
        counts = np.bincount(self.cluster_assignment, minlength=self.n_clusters)
        if np.min(counts) <= 3:
            print("Encountered near-empty cluster.")
            return self
        t0 = time.perf_counter()
        self.M_step()
        q = self.e_complete_data_log_lik()
        print(np.round(q, 3))
        trace.record(0, q, -1, time.perf_counter() - t0)
        for i in range(n_steps):
            t0 = time.perf_counter()
            n_switches = self.E_step()
            if n_switches == 0:
                print(f"Optimisation completed in {i} steps.")
                break
            counts = np.bincount(self.cluster_assignment, minlength=self.n_clusters)
            if np.min(counts) <= 3:
                print("Encountered near-empty cluster.")
                break
            self.M_step()
            q = self.e_complete_data_log_lik()
            print(np.round(q, 3))
            trace.record(i + 1, q, n_switches, time.perf_counter() - t0)
        self.last_trained = _now()
        return self

    def _load_cached(self, verbose: bool = False):
        """The newest cached model of this data's hash, or None (the
        cache is best-effort: a file that does not load is skipped).
        ``verbose`` prints what the reference prints."""
        files = sorted(
            glob.glob(os.path.join(home_dir, "tmp", f"mmm-{self.hex_hash}*")),
            key=os.path.getmtime,
        )
        if not files:
            if verbose:
                print("No model found in cache.")
            return None
        try:
            best_mdl = MMLinGaussSS_marginalizable.from_pickle(
                files[-1],
                training_data={
                    "states": self.states,
                    "observations": self.observations,
                },
                device=self.device,
                dtype=self.dtype,
            )
        except (OSError, EOFError, KeyError, ValueError, pickle.UnpicklingError) as err:
            if verbose:
                print(f"Issue loading cached model -- encountered {err}")
            return None
        if best_mdl.hex_hash != self.hex_hash:
            if verbose:
                print("Issue loading cached model -- encountered ")
            return None
        if verbose:
            print(f"Loaded model {best_mdl.last_trained=} from cache.")
        return best_mdl

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
        """The reference multistart protocol.

        A cached model of the same data hash is returned if ``use_cache``.
        Else the candidates are one k-means start (seed 0) and
        ``n_starts`` random starts (seeds 100+i), drawn from the global
        NumPy RNG in constructor order, and each is trained and scored by
        its complete-data objective under a fresh E step:

        - ``fast=True`` on suffix missingness: the slot pool
          (:func:`em.train_em_markov_pool`, ``MTM_MULTISTART_FUSE`` slots,
          default 32) with objectives from K4b in pool-sized groups (past
          T·s = 512: the pool on the canonical Φ, objectives from K3 on a
          wide canonical Φ), or, with one candidate or
          ``MTM_MULTISTART_FUSE`` ≤ 1, one after another
          (:func:`em.train_em_markov`, objectives from K4a, past
          T·s = 512 from K6 on the raw batch);
        - ``fast=True`` on other missingness past 256 patterns or
          T(d+l) = 512: one after another through
          :func:`em.train_em_masked_kalman`, or with ``MTM_MASKED_POOL=1``
          through :func:`em.train_em_masked_kalman_pool`
          (``MTM_MULTISTART_FUSE`` slots), objectives from
          :func:`em.complete_data_loglik_masked_kalman`;
        - ``fast=True`` on other missingness: one after another through
          the pattern-sorted :func:`em.train_em_sorted`, objectives from
          :func:`em.complete_data_loglik`;
        - ``fast=False``: the dense :func:`em.train_em_multistart`, the
          candidates in batches of ``starts_per_batch`` trained together
          (one K12 launch an iteration on the clusters of the batch's
          running candidates), the batch clamped by the JAX package's
          memory cap of ~6 GB at ≈ 4·n·D·C bytes a candidate
          (D = T(d+l)).

        ``fast=None`` takes ``fast=True`` at n ≥ 200 000 on a CUDA device.
        The winner is the first candidate whose objective is strictly
        greater than all before it; if it is not finite,
        ``Exception("training failed")``.  The winner's ``last_multistart``
        records the run: the k-means seconds, every candidate's iterations
        and status, the pool's :class:`em.PoolStats` (None off the pool)
        and the dense batches (0 off the dense route).

        ``verbose=True`` trains the candidates one after another through
        ``train(verbose=True)``, with the reference's transcript, and
        ranks them by :meth:`e_complete_data_log_lik` (a candidate whose
        training raises is skipped).

        ``MTM_MULTICHIP=1`` in an initialized ``torch.distributed`` group
        of more than one rank (every rank calls this with the same data):
        the slot pool's windows run data-parallel over the group
        (:func:`em.train_em_markov_pool` with ``mesh=``), and the masked
        trainer's candidates one after another through
        :func:`..parallel.sharded_em.train_em_masked_kalman_shardmap`
        where the ranks divide n (``mixture.py:1187-1213``, ``:1302-1333``);
        the ranks split the data, whatever the number of cards."""
        if use_cache:
            cached = self._load_cached(verbose)
            if cached is not None:
                return cached
        if fast is None:
            fast = self.n_data >= 200_000 and self.device.type == "cuda"
        lens = self._suffix_instance_lens(self.states, self.observations) if fast else None
        T, d, l = self.n_timesteps, self.d_states, self.d_observations
        r_fuse = int(os.environ.get("MTM_MULTISTART_FUSE", "32"))
        pooled = lens is not None and r_fuse > 1 and n_starts > 0 and not verbose
        packed_ok = em.markov_packed_ok(T, d, l)
        group_mesh = None
        if (
            os.environ.get("MTM_MULTICHIP") == "1"
            and dist.is_available()
            and dist.is_initialized()
            and dist.get_world_size() > 1
        ):
            group_mesh = make_mesh()
        masked = fast and lens is None and self._takes_masked_filter_route()
        sorted_batch = (
            self._sorted_batch() if fast and lens is None and not masked and not verbose else None
        )

        t0 = time.perf_counter()
        candidates = [self._candidate(0, "kmeans")]
        kmeans_s = time.perf_counter() - t0
        candidates += [self._candidate(100 + i) for i in range(n_starts)]
        if verbose:
            return self._verbose_multistart(candidates, n_steps, use_cache, return_objectives)
        reg_mode = "ridge" if self.alpha > 2 * np_eps else "lstsq"
        fit = dict(n_steps=n_steps, reg_mode=reg_mode, alpha=float(self.alpha))

        pool_stats = None
        batches = 0
        if lens is not None:
            z = self._on_device(self.states)
            x = self._on_device(self.observations)
            lens_d = self._on_device(lens, torch.int32)
            n = self.n_data
            z_t = z.permute(0, 2, 1).reshape(T * d, n)
            x_t = x.permute(0, 2, 1).reshape(T * l, n)
        if pooled:
            if packed_ok:
                u, phi_obj = em.pack_markov_batch(z_t, x_t, T=T, d=d, l=l), None
            else:
                # long T: the pool trains from the canonical Φ, and the
                # objectives rank on one wide canonical Φ
                # (mixture.py:1165-1186)
                u = None
                phi_obj = mk.markov_materialize_features_longT(z_t, x_t, lens_d, T=T, d=d, l=l)
            del z_t, x_t
            results, pool_stats = em.train_em_markov_pool(
                [c._stacked_params() for c in candidates],
                [np.asarray(c.cluster_assignment) for c in candidates],
                z,
                x,
                lens_d,
                R=r_fuse,
                u=u,
                mesh=group_mesh,
                **fit,
            )
            # objectives (Σ max scores under a fresh E) in pool-sized groups
            objectives = []
            for i0 in range(0, len(results), r_fuse):
                grp = em.stack_params([p for p, *_ in results[i0 : i0 + r_fuse]])
                objs = em.complete_data_loglik_markov_multi(grp, lens_d, u, T=T, phi=phi_obj)
                objectives += objs.cpu().tolist()
        elif lens is not None:
            results, objectives = [], []
            for cand in candidates:
                res = em.train_em_markov(
                    cand._stacked_params(),
                    self._on_device(cand.cluster_assignment, torch.int32),
                    z,
                    x,
                    lens_d,
                    **fit,
                )
                results.append(res)
                objectives.append(
                    float(em.complete_data_loglik_markov(res[0], z_t, x_t, lens_d, T=T))
                )
        elif masked:
            z, x = self._masked_batch()
            packed = kk.plan_masked_batch(z, x)
            if os.environ.get("MTM_MASKED_POOL", "0") == "1" and r_fuse > 1 and n_starts > 0:
                results, pool_stats = em.train_em_masked_kalman_pool(
                    [c._stacked_params() for c in candidates],
                    [np.asarray(c.cluster_assignment) for c in candidates],
                    z, x, R=r_fuse, packed=packed, **fit,
                )
            elif group_mesh is not None and self.n_data % group_mesh.size == 0:
                # the masked trainer has no pad lanes: equal blocks only
                results = [
                    sharded_em.train_em_masked_kalman_shardmap(
                        c._stacked_params(), self._on_device(c.cluster_assignment, torch.int32),
                        z, x, mesh=group_mesh, **fit,
                    )
                    for c in candidates
                ]
            else:
                results = [
                    em.train_em_masked_kalman(
                        c._stacked_params(), self._on_device(c.cluster_assignment, torch.int32),
                        z, x, packed=packed, **fit,
                    )
                    for c in candidates
                ]
            objectives = [
                float(em.complete_data_loglik_masked_kalman(p, z, x, packed=packed))
                for p, *_ in results
            ]
        elif fast:
            order, sizes, z, x, v, patterns, pid = sorted_batch
            results, objectives = [], []
            for cand in candidates:
                params_c, assign_s, iters_c, status_c = em.train_em_sorted(
                    cand._stacked_params(),
                    self._on_device(cand.cluster_assignment, torch.int32)[order],
                    z, x, v, patterns, sizes=sizes, **fit,
                )
                assign_c = torch.empty_like(assign_s)
                assign_c[order] = assign_s  # undo the sort
                results.append((params_c, assign_c, iters_c, status_c))
                objectives.append(
                    float(em.complete_data_loglik(params_c, v, patterns, pid, T=T))
                )
        else:
            _T0, z, x, v, patterns, pid = self._packed()
            pid = self._on_device(pid, torch.int32)
            # the JAX package's memory model of its vmapped batch
            # (mixture.py:1398-1408): ≈ 4·n·D·C bytes a restart, D = T(d+l)
            per_restart = 4 * self.n_data * T * (d + l) * self.n_clusters
            starts_per_batch = min(starts_per_batch, max(1, int(_DENSE_BATCH_BYTES // per_restart)))
            results, objectives = [], []
            for lo in range(0, len(candidates), starts_per_batch):
                batch = candidates[lo : lo + starts_per_batch]
                params_b, assign_b, iters_b, status_b, obj_b = em.train_em_multistart(
                    self._stack_candidates(batch, device=self.device, dtype=self.dtype),
                    self._on_device(np.stack([c.cluster_assignment for c in batch]), torch.int32),
                    z, x, v, patterns, pid, **fit,
                )
                results += zip(
                    em.unstack_params(params_b), assign_b, iters_b.tolist(), status_b.tolist()
                )
                objectives += obj_b.cpu().tolist()
                batches += 1

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
            "batches": batches,
        }
        if use_cache:
            best_mdl.to_pickle()
        if return_objectives:
            return best_mdl, objectives
        return best_mdl


    @staticmethod
    def _verbose_multistart(candidates, n_steps, use_cache, return_objectives):
        """The reference's verbose multistart: each candidate through
        ``train(verbose=True)`` in turn, the first strictly greater
        objective wins, a candidate whose training raises is skipped as a
        degenerate start.  A kernel that fails to build, load or launch
        (:class:`_build.KernelError`) is no degenerate start and
        propagates."""
        best_mdl = candidates[0]
        try:
            best_mdl = best_mdl.train(verbose=True, n_steps=n_steps)
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — a degenerate start, keep going
            pass
        objective_list = [best_mdl.e_complete_data_log_lik()]
        for cand in candidates[1:]:
            try:
                mdl = cand.train(verbose=True, n_steps=n_steps)
                objective_list.append(mdl.e_complete_data_log_lik())
                if mdl.e_complete_data_log_lik() > best_mdl.e_complete_data_log_lik():
                    best_mdl = mdl
            except KernelError:
                raise
            except Exception:  # noqa: BLE001
                pass
        if not np.isfinite(best_mdl.e_complete_data_log_lik()):
            raise Exception("training failed")
        if use_cache:
            best_mdl.to_pickle()
        if return_objectives:
            return best_mdl, np.array(objective_list)
        return best_mdl

    # ------------------------------------------------------------------
    # reporting and plotting (mixture.py:1478-1843); pandas-free, with
    # matplotlib and scipy imported where they are used
    # ------------------------------------------------------------------

    def print_model(self, *, verbose: bool = False, line_len: int = 79):
        """Pretty-print the parameters per lettered cluster
        (``mixture.py:1478``)."""
        print(
            "MixtureModelLinearGaussianStateSpace |".ljust(line_len, "=") + "\n"
        )
        for s in string.ascii_uppercase[: self.n_clusters]:
            c = self.inverse_correspondence[s]
            print(f"Cluster {s} |".ljust(line_len, "-"))
            print(f"Cluster propensity:\n {self.cluster_propensities[c]:.3f}")
            print(f"Initial state mean:\n {np.round(self.init_state_means[c], 3)}")
            if verbose:
                print(f"Initial state cov:\n {np.round(self.init_state_covs[c], 3)}")
            print(f"State transition coeffs:\n {np.round(self.transition_matrices[c], 3)}")
            if verbose:
                print(f"Transition cov:\n {np.round(self.transition_covs[c], 3)}")
            print(f"Measurement coeffs:\n {np.round(self.measurement_matrices[c], 3)}")
            if verbose:
                print(f"Measurement cov:\n {np.round(self.measurement_covs[c], 3)}")
        print(f"{self.last_trained=}")
        print(f"{self.hex_hash=}")
        print("=" * line_len)

    def print_tests(
        self,
        *,
        test_1: bool = False,
        test_01: bool = False,
        test_obs: bool = False,
    ) -> None:
        """Per-cluster OLS diagnostics of the transition and measurement
        models (``mixture.py:1518``): coefficients, t statistics, p values,
        R², and the optional hypothesis t-tests, in numpy and
        ``scipy.stats``."""
        for s in string.ascii_uppercase[: self.n_clusters]:
            c = self.inverse_correspondence[s]
            mask = self.cluster_assignment == c
            Zp = np.vstack(list(self.states[:-1, mask, :]))
            Zn = np.vstack(list(self.states[1:, mask, :]))
            keep = np.isfinite(np.column_stack([Zp, Zn])).all(axis=1)
            Zp, Zn = Zp[keep], Zn[keep]
            for i in range(self.d_states):
                print(f" Cluster {s} -- State {i} ".center(78, "-"))
                _print_ols_summary(Zp, Zn[:, i])
                if test_1:
                    _print_t_test(Zp, Zn[:, i], {i: 1.0})
                if test_01:
                    other = 0 if i + 1 == 2 else 1
                    _print_t_test(Zp, Zn[:, i], {other: 0.0, i: 1.0})
            if test_obs:
                Xs = np.vstack(list(self.observations[:, mask, :]))
                Zs = np.vstack(list(self.states[:, mask, :]))
                keep = np.isfinite(np.column_stack([Xs, Zs])).all(axis=1)
                Xs, Zs = Xs[keep], Zs[keep]
                for j in range(self.d_observations):
                    print(f" Cluster {s} -- Observation {j} ")
                    _print_ols_summary(Zs, Xs[:, j])

    def superimpose_model_on_plot(self, ax, std_param):
        """Contour the initial-state Gaussians on an existing 2-D axis
        (``mixture.py:1553``)."""
        import scipy.stats as sp_stats

        for i, s in enumerate(string.ascii_uppercase[: self.n_clusters]):
            c = self.inverse_correspondence[s]
            me, co = ssu.unstandardize_mean_and_cov(
                self.init_state_means[c], self.init_state_covs[c], params=std_param
            )
            xv, yv = np.meshgrid(
                np.linspace(*ax.get_xlim(), num=1000),
                np.linspace(*ax.get_ylim(), num=1000),
            )
            zv = sp_stats.multivariate_normal(mean=me, cov=co).pdf(np.dstack((xv, yv)))
            ax.contour(
                xv, yv, zv, colors=ssu.CLUSTER_COLORS[i],
                linewidths=np.flip(1.5 ** -np.arange(10)),
            )

    def get_initial_means_and_stds(self, std_param=None):
        """``{cluster letter: {"μ": …, "σ": …}}`` of the initial (z, x)
        features (``mixture.py:1578``)."""
        out = {}
        for j in range(self.n_clusters):
            mz = self.init_state_means[j]
            cz = self.init_state_covs[j]
            H = self.measurement_matrices[j]
            mx = mz @ H
            cx = self.measurement_covs[j] + H.T @ cz @ H
            if std_param is not None:
                mz, cz = ssu.unstandardize_mean_and_cov(mz, cz, params=std_param)
            mzx = np.concatenate([mz, mx])
            var = np.concatenate([np.diag(np.atleast_2d(cz)), np.diag(np.atleast_2d(cx))])
            out[self.correspondence[j]] = {"μ": mzx, "σ": np.sqrt(var)}
        return out

    def get_initial_diffs_means_and_stds(self, std_param=None):
        """The same for the first differences, step 2 minus step 1
        (``mixture.py:1599``): the joint moments of two steps from
        :mod:`..ops.moments`, in float64 on the CPU whatever the model's
        device."""
        d, l = self.d_states, self.d_observations
        coeff = np.block(
            [
                [-np.eye(d), np.eye(d), np.zeros((d, 2 * l))],
                [np.zeros((l, 2 * d)), -np.eye(l), np.eye(l)],
            ]
        )

        def host(a):
            return torch.as_tensor(np.asarray(a, dtype=float))

        out = {}
        for j in range(self.n_clusters):
            m, S, A, G, H, L = map(host, (
                self.init_state_means[j], self.init_state_covs[j],
                self.transition_matrices[j], self.transition_covs[j],
                self.measurement_matrices[j], self.measurement_covs[j],
            ))
            mu = coeff @ jmom.joint_mean(2, m, A, H).numpy()
            cc = coeff @ jmom.joint_cov(2, S, A, G, H, L).numpy() @ coeff.T
            if std_param is not None:
                mu[:d], cc[:d, :d] = ssu.unstandardize_mean_and_cov_diffs(
                    mu[:d], cc[:d, :d], params=std_param
                )
            out[self.correspondence[j]] = {"μ": mu, "σ": np.sqrt(np.diag(np.atleast_2d(cc)))}
        return out

    def plot_cluster_propensity_evolution(
        self,
        savename: str,
        *,
        title: str = "Cluster Assignment Probability (using observed only) \n"
        "vs. Number of Time steps",
        observations=None,
    ) -> None:
        """Mean ± sem of the membership probability in the finally assigned
        cluster over time, from the observations alone
        (``mixture.py:1641``)."""
        self._plot_propensity_evolution(
            savename,
            title,
            self.observed_cluster_propensities_over_time(observations=observations),
            self.observations_mle_cluster_assignment(observations=observations),
            self.observations.shape[0] if observations is None else observations.shape[0],
        )

    def plot_overall_cluster_propensity_evolution(
        self,
        savename: str,
        *,
        title: str = "Cluster Assignment Probability\n"
        "vs. Number of Time steps",
        observations=None,
        states=None,
    ) -> None:
        """The same from the hidden and observed data (``mixture.py:1670``)."""
        if observations is None:
            observations = self.observations
            states = self.states
        self._plot_propensity_evolution(
            savename,
            title,
            self.cluster_propensities_over_time(states=states, observations=observations),
            self.mle_cluster_assignment(states=states, observations=observations),
            observations.shape[0],
        )

    def _plot_propensity_evolution(
        self, savename, title, propensities_over_time, final_assignments, _T0
    ) -> None:
        import matplotlib.pyplot as plt
        import scipy.stats as sp_stats

        assert final_assignments.shape[0] == propensities_over_time.shape[1]
        chosen = np.stack(
            [
                propensities_over_time[:, i, final_assignments[i]]
                for i in range(propensities_over_time.shape[1])
            ]
        )
        with plt.rc_context(ssu.PLOT_RC):
            fig, ax = plt.subplots()
            ax.spines["right"].set_visible(False)
            ax.spines["top"].set_visible(False)
            for i, s in enumerate(string.ascii_uppercase[: self.n_clusters]):
                sel = final_assignments == self.inverse_correspondence[s]
                ax.errorbar(
                    x=np.arange(_T0) + 0.025 * (i - int(self.n_clusters / 2)),
                    y=np.nanmean(chosen[sel], axis=0).T,
                    yerr=sp_stats.sem(chosen[sel], axis=0).T,
                    color=ssu.CLUSTER_COLORS[i],
                    linestyle="solid",
                    label=f"cluster {s}",
                    capsize=5,
                )
            handles, labels = ax.get_legend_handles_labels()
            uniq = dict(zip(labels, handles))
            ax.legend(uniq.values(), uniq.keys(), fontsize="large")
            plt.xticks(ticks=range(self.n_timesteps), labels=range(1, self.n_timesteps + 1))
            plt.title(title)
            ax.set_xlabel("Time steps")
            ax.set_ylabel("Probability")
            plt.savefig(savename, transparent=True)

    @staticmethod
    def plot_matrix(
        mat,
        *,
        show_colorbar: bool = False,
        show_labels: bool = True,
        xticks: list = None,
        xlabel: str = None,
        yticks: list = None,
        ylabel: str = None,
        title: str = None,
        fmt_str: str = "{:.2f}",
        figsize: tuple = (6.4, 4.8),
        savename=None,
        show: bool = False,
    ):
        """Annotated matshow of a parameter matrix (``mixture.py:1731``)."""
        import matplotlib.pyplot as plt

        mat = np.atleast_2d(mat)
        with plt.rc_context(ssu.PLOT_RC):
            fig, ax = plt.subplots(layout="constrained", figsize=figsize)
            im = ax.matshow(mat, cmap="cividis")
            if show_colorbar:
                ax.figure.colorbar(im, ax=ax)
            if xticks:
                ax.set_xticks(np.arange(len(xticks)), labels=xticks)
                plt.setp(ax.get_xticklabels(), rotation=-30, ha="right", rotation_mode="anchor")
            if yticks is not None:
                ax.set_yticks(np.arange(len(yticks)), labels=yticks)
            if title is not None:
                plt.title(title)
            if xlabel is not None:
                plt.xlabel(xlabel)
            if ylabel is not None:
                plt.ylabel(ylabel)
            if show_labels:
                mid = np.mean(im.get_clim())
                for (i, j), val in np.ndenumerate(mat):
                    ax.text(
                        j, i, fmt_str.format(val), ha="center", va="center",
                        c="black" if val > mid else "white",
                    )
            plt.tick_params(bottom=False)
            if mat.shape[0] == 1:
                plt.tick_params(left=False, labelleft=False, bottom=False)
            if savename is not None:
                plt.savefig(savename, transparent=True)
            if show:
                plt.show()

    @staticmethod
    def ponder():
        import webbrowser

        webbrowser.open_new_tab("https://doi.org/10.1017/prm.2023.96")

    def generate_model_plots(self, folder, **kwargs):
        """One annotated-matrix PDF per parameter per cluster
        (``mixture.py:1796``)."""
        sub = os.path.join(folder, f"{self.hex_hash}-{self.n_clusters}cl")
        os.makedirs(sub, exist_ok=True)
        order = np.argsort(np.array([self.correspondence[i] for i in range(self.n_clusters)]))
        self.plot_matrix(
            self.cluster_propensities[order],
            savename=os.path.join(sub, f"{self.hex_hash}-propensities.pdf"),
            title="Overall cluster propensities",
            **kwargs,
        )
        for c in range(self.n_clusters):
            for param in (
                "init_state_means",
                "init_state_covs",
                "transition_matrices",
                "transition_covs",
                "measurement_matrices",
                "measurement_covs",
            ):
                self.plot_matrix(
                    getattr(self, param)[c],
                    savename=os.path.join(
                        sub, f"{self.hex_hash}-{param}-{self.correspondence[c]}.pdf"
                    ),
                    title="Cluster {c} {param}".format(
                        c=self.correspondence[c],
                        param=param[:-1].replace("_", " ").replace("matrice", "matrix"),
                    ),
                    **kwargs,
                )


def _ols(X: np.ndarray, y: np.ndarray):
    """``(beta, residual dof, σ², (XᵀX)⁺)`` of the least-squares fit."""
    n, p = X.shape
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    dof = n - p
    return beta, resid, dof, resid @ resid / dof, np.linalg.pinv(X.T @ X)


def _print_ols_summary(X: np.ndarray, y: np.ndarray) -> None:
    """A minimal OLS summary (coefficients, standard errors, t, p, R²;
    ``mixture.py:1856``)."""
    import scipy.stats as sp_stats

    n, p = X.shape
    beta, resid, dof, sigma2, XtX_inv = _ols(X, y)
    se = np.sqrt(np.diag(XtX_inv) * sigma2)
    tvals = beta / se
    pvals = 2 * sp_stats.t.sf(np.abs(tvals), dof)
    ss_tot = np.sum((y - y.mean()) ** 2)
    r2 = 1 - resid @ resid / ss_tot if ss_tot > 0 else np.nan
    print(f"OLS  n={n}  dof={dof}  R²={r2:.4f}  sigma²={sigma2:.4f}")
    for i in range(p):
        print(
            f"  x{i + 1}: coef={beta[i]: .4f}  se={se[i]:.4f}  "
            f"t={tvals[i]: .3f}  p={pvals[i]:.4g}"
        )


def _print_t_test(X: np.ndarray, y: np.ndarray, hypotheses: dict[int, float]) -> None:
    """t-tests of ``beta[k] == value`` for each (k, value) pair
    (``mixture.py:1878``)."""
    import scipy.stats as sp_stats

    beta, _resid, dof, sigma2, XtX_inv = _ols(X, y)
    desc = ", ".join(f"x{k + 1}={v}" for k, v in hypotheses.items())
    print(f"testing {desc}")
    for k, v in hypotheses.items():
        se = np.sqrt(XtX_inv[k, k] * sigma2)
        t = (beta[k] - v) / se
        pv = 2 * sp_stats.t.sf(np.abs(t), dof)
        print(f"  x{k + 1}: t={t:.3f}  p={pv:.4g}  dof={dof}")
    print(f"dof={dof}")


def _regress(X, Y, mode, alpha, device, dtype):
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    A, S = rops.regress(
        torch.as_tensor(np.atleast_2d(X), dtype=dt, device=dev),
        torch.as_tensor(np.atleast_2d(Y), dtype=dt, device=dev),
        mode=mode,
        alpha=alpha,
    )
    return A.cpu().numpy().astype(float), S.cpu().numpy().astype(float)


def _softmax_cols(logits: np.ndarray) -> np.ndarray:
    """Column-wise softmax of a (C, n) matrix of log-probabilities."""
    z = logits - np.max(logits, axis=0, keepdims=True)
    e = np.exp(z)
    return e / np.sum(e, axis=0, keepdims=True)


def _logsumexp_cols(logits: np.ndarray) -> np.ndarray:
    mx = np.max(logits, axis=0)
    return mx + np.log(np.sum(np.exp(logits - mx[None, :]), axis=0))
