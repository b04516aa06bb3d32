"""Generic mixture of state-space component models, trained by hard EM.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/ssm_mixture.py``
(reference: framework_extended/state_space_model_mixture.py:29-506).  The
EM loop stays on the host (component models send their own work to the
device); the cache / restart / guard protocol is the reference's:

- init switch: random / k-means on initial states / k-means on flattened
  sequences / k-means on finite time-slices (:220-253), the k-means being
  :func:`.kmeans.kmeans_labels` (scikit-learn's ``KMeans(k-means++,
  n_init=10, random_state=0)`` labels, without scikit-learn);
- a near-empty initialisation (min membership ≤ 3) is warned about and
  re-randomized (:255-262);
- the EM loop breaks silently on convergence or on a nearly-empty cluster
  (raised + swallowed, :264-277);
- restarts are fresh instances seeded ``default_rng(i)``, best by
  ``score()`` (strictly greater, in ascending seed order); all-failed ⇒
  ``Exception("training failed")`` (:284-298);
- md5 cache of (data, n_clusters, component class, hyperparams) under
  ``tmp/mmm-<hash>-<ts>.p.gz`` (:68-80, 310-404), one file a hash.

A degenerate start (a raise inside a fit) is skipped, but a kernel that
fails to build, load or launch (:class:`..ops._build.KernelError`) is no
degenerate start and propagates, from the EM loop, the restart loop and
the restart workers.

``device=`` and ``dtype=`` are keyword-only; every component is built with
them.  They go neither into ``component_model_hyperparams`` nor into
``hex_hash``.  ``hex_hash`` keeps the reference's recipe over this
package's ``str(component_model)``, so it differs from the JAX package's
for the same inputs and the two packages never delete each other's cache
files.  :func:`mixture_state` and :func:`mixture_from_state` carry a trained
mixture across packages as plain numpy.
"""

from __future__ import annotations

import datetime
import glob
import gzip
import hashlib
import json
import os
import pickle
import string
import warnings

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.models.kmeans import kmeans_labels
from multimodal_trajectory_modeling_tpu_torch.models.state_space_model import (
    component_state,
)
from multimodal_trajectory_modeling_tpu_torch.ops._build import KernelError
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as util

# cache root (tests may monkeypatch this to a scratch dir)
home_dir = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# import root for restart workers — always the real package parent, never
# patched: a worker child must be able to import this package no matter
# where the cache has been redirected to
_PACKAGE_PARENT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _now() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .replace(microsecond=0)
        .astimezone()
        .isoformat()
    )


def _restart_worker(args):
    """Run one chunk of independently-seeded restarts.

    Returns {seed: (score, blob)} for the restarts that trained without a
    nearly-empty-cluster abort."""
    (
        states,
        observations,
        n_clusters,
        component_model,
        hyperparams,
        seeds,
        n_iter,
        device,
        dtype,
    ) = args
    out = {}
    for i in seeds:
        try:
            cand = StateSpaceMixtureModel(
                n_clusters=n_clusters,
                data=(states, observations),
                component_model=component_model,
                component_model_hyperparams=hyperparams,
                rng=np.random.default_rng(seed=i),
                device=device,
                dtype=dtype,
            ).fit(init="random", n_iter=n_iter, use_cache=False)
            out[i] = (cand.score(), cand._extract_blob())
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — degenerate start, skip
            pass
    return out


def _subprocess_entry(path: str) -> None:
    """Worker entry point: reads the pickled payload (the restart chunk,
    the parent's device and dtype, and its share of the CPU threads), runs
    the chunk, writes pickled results next to the input file."""
    with open(path, "rb") as f:
        args, threads = pickle.load(f)
    torch.set_num_threads(threads)
    out = _restart_worker(args)
    with open(path + ".out", "wb") as f:
        pickle.dump(out, f)


def _parallel_restarts(
    states,
    observations,
    n_clusters,
    component_model,
    hyperparams,
    n_restarts,
    n_iter,
    n_jobs,
    device,
    dtype,
):
    """Fan restart chunks out to plain subprocess workers.

    Subprocesses (not multiprocessing) on purpose: spawn-based pools
    re-import the parent's __main__, which recurses under pytest and
    script entry points; a `python -c` child has a clean __main__, imports only
    this package and works on the parent's device in the parent's dtype.
    On CUDA the parent loads the kernel library first, so the children
    find it built and never run ``nvcc`` at the same time."""
    import subprocess
    import sys
    import tempfile

    if device.type == "cuda":
        from multimodal_trajectory_modeling_tpu_torch.ops import _build

        _build.library()
    # children must import this package regardless of cwd: prepend the
    # package parent to PYTHONPATH, preserving whatever is already there
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_PARENT]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    threads = max(1, torch.get_num_threads() // n_jobs)

    chunks = [list(range(w, n_restarts, n_jobs)) for w in range(n_jobs)]
    procs = []
    tmpdir = tempfile.mkdtemp(prefix="mtm_restarts_")
    for w, chunk in enumerate(c for c in chunks if c):
        path = os.path.join(tmpdir, f"chunk{w}.pkl")
        payload = (
            states,
            observations,
            n_clusters,
            component_model,
            hyperparams,
            chunk,
            n_iter,
            str(device),
            dtype,
        )
        with open(path, "wb") as f:
            pickle.dump((payload, threads), f)
        stderr_file = open(path + ".err", "wb")
        procs.append(
            (
                path,
                payload,
                subprocess.Popen(
                    [
                        sys.executable,
                        "-c",
                        "from multimodal_trajectory_modeling_tpu_torch.models."
                        "ssm_mixture import _subprocess_entry; "
                        f"_subprocess_entry({path!r})",
                    ],
                    cwd=_PACKAGE_PARENT,
                    env=env,
                    stderr=stderr_file,
                ),
                stderr_file,
            )
        )
    results = {}
    for path, payload, proc, stderr_file in procs:
        proc.wait()
        stderr_file.close()
        out_path = path + ".out"
        if proc.returncode == 0 and os.path.exists(out_path):
            with open(out_path, "rb") as f:
                results.update(pickle.load(f))
        else:
            # a dead worker must not silently change the multistart winner:
            # replay its chunk sequentially in this process (identical
            # per-seed protocol, just not parallel) — and surface the
            # child's stderr so the failure is diagnosable
            with open(path + ".err", "rb") as f:
                child_err = f.read().decode(errors="replace")[-2000:]
            warnings.warn(
                f"restart worker exited with {proc.returncode}; replaying "
                f"its chunk sequentially; child stderr tail:\n{child_err}"
            )
            results.update(_restart_worker(payload))
    return results


class StateSpaceMixtureModel:
    """Mixture of state-space models (any component-model class), its
    components on ``device`` in ``dtype``."""

    def __init__(
        self,
        n_clusters: int,
        data: tuple[np.ndarray, np.ndarray],
        component_model,
        *,
        component_model_hyperparams: dict = dict(),
        rng: np.random.Generator = None,
        device=None,
        dtype=None,
    ):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.device, dtype)
        self.rng = rng if rng is not None else np.random.default_rng(seed=42)

        self.states, self.observations = map(np.atleast_3d, data)
        self.n_timesteps, self.n_data, self.d_states = self.states.shape
        self.d_observations = self.observations.shape[-1]

        self.n_clusters = n_clusters
        self.cluster_propensities = np.ones(n_clusters) / n_clusters
        self.cluster_assignment = self.rng.integers(
            n_clusters, size=self.n_data
        )

        self.component_model = component_model
        self.component_model_hyperparams = component_model_hyperparams
        self.cluster_models = [
            self._component(**component_model_hyperparams)
            for _ in range(n_clusters)
        ]

        self._correspondence = dict(
            zip(range(n_clusters), string.ascii_uppercase)
        )
        self.inverse_correspondence = {
            v: k for k, v in self._correspondence.items()
        }

        self.hex_hash = hashlib.md5(
            self.states.tobytes()
            + self.observations.tobytes()
            + str(self.n_clusters).encode("utf-8")
            + str(self.component_model).encode("utf-8")
            + (
                json.dumps(
                    self.component_model_hyperparams, sort_keys=True
                ).encode("utf-8")
                if self.component_model_hyperparams != {}
                else b""
            )
        ).hexdigest()

        self.time_stamp = _now()
        self.last_trained = None

    def __str__(self):
        return "Mixture of state space models with {} components".format(
            self.component_model
        )

    def _component(self, **hyperparams):
        """A component model on this mixture's device and dtype."""
        return self.component_model(**hyperparams, device=self.device, dtype=self.dtype)

    def _sibling(self, seed: int):
        """A fresh mixture on the same data and components, seeded
        ``default_rng(seed)``: one restart."""
        return StateSpaceMixtureModel(
            n_clusters=self.n_clusters,
            data=self.data,
            component_model=self.component_model,
            component_model_hyperparams=self.component_model_hyperparams,
            rng=np.random.default_rng(seed=seed),
            device=self.device,
            dtype=self.dtype,
        )

    @property
    def data(self) -> tuple[np.ndarray, np.ndarray]:
        return self.states, self.observations

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
    # EM internals
    # ------------------------------------------------------------------

    def _component_logits(self, data) -> np.ndarray:
        """(n, C) matrix of log π_c + per-instance component scores."""
        return np.column_stack(
            [
                np.log(self.cluster_propensities[c])
                + np.asarray(self.cluster_models[c].score(data), dtype=float)
                for c in range(self.n_clusters)
            ]
        )

    def _E_step(self) -> int:
        """Hard-assign every instance to its most likely component
        (reference ssmm:110-132); asserts all clusters stay populated."""
        new_assignment = np.argmax(self._component_logits(self.data), axis=1)
        assert new_assignment.size == self.n_data
        assert set(new_assignment) == set(range(self.n_clusters))
        n_switches = int(
            np.sum(np.not_equal(self.cluster_assignment, new_assignment))
        )
        self.cluster_assignment = new_assignment
        return n_switches

    def _M_step(self) -> None:
        """Refit each component on its members (reference ssmm:134-149)."""
        for c in range(self.n_clusters):
            members = self.cluster_assignment == c
            self.cluster_propensities[c] = np.mean(members)
            self.cluster_models[c].fit(
                (self.states[:, members], self.observations[:, members])
            )
        assert np.isclose(sum(self.cluster_propensities), 1.0)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def fit(
        self,
        *,
        init: str = "random",
        n_iter: int = 1000,
        n_restarts: int = 0,
        use_cache: bool = True,
        verbose: bool = False,
        n_jobs: int = 1,
    ):
        if bool(use_cache):
            try:
                pfile = sorted(
                    glob.glob(
                        os.path.join(home_dir, "tmp", f"mmm-{self.hex_hash}*")
                    ),
                    key=os.path.getmtime,
                ).pop()
                best_mdl = StateSpaceMixtureModel.from_pickle(
                    pfile,
                    training_data={
                        "states": self.states,
                        "observations": self.observations,
                    },
                    device=self.device,
                    dtype=self.dtype,
                )
                assert self.hex_hash == best_mdl.hex_hash
                if verbose:
                    print(f"cache hit: {best_mdl.last_trained=}")
                return best_mdl
            except IndexError:
                if verbose:
                    print("cache miss: no pickle for this hash")
            except AssertionError:
                if verbose:
                    print("cache entry rejected: hash mismatch")
            except KernelError:
                raise
            except Exception as err:  # noqa: BLE001 — cache is best-effort
                if verbose:
                    print(f"cache entry unreadable ({err}); retraining")

        def _kmeans_labels(features):
            return kmeans_labels(features, self.n_clusters, random_state=0)

        if init in ("k-means", "kmeans"):
            self.cluster_assignment = _kmeans_labels(self.states[0])
        elif init in ("kmeans-all", "k-means-all"):
            flat = np.stack(
                [self.states[:, i, :].ravel() for i in range(self.n_data)]
            )
            self.cluster_assignment = _kmeans_labels(flat)
        elif init in ("kmeans-take-finite", "k-means-take-finite"):
            self.cluster_assignment = _kmeans_labels(
                np.column_stack(util.take_finite_along_axis(self.states, 0))
            )
        else:
            self.cluster_assignment = self.rng.integers(
                low=0, high=self.n_clusters, size=self.n_data
            )
        assert len(self.cluster_assignment) == self.n_data
        if np.min(np.bincount(self.cluster_assignment)) <= 3:
            warnings.warn(
                "init left a cluster with <=3 members; re-randomizing"
            )
            self.cluster_assignment = self.rng.integers(
                low=0, high=self.n_clusters, size=self.n_data
            )

        try:
            self._M_step()
            for _ in range(n_iter):
                n_switches = self._E_step()
                if n_switches == 0:
                    break
                if np.min(np.bincount(self.cluster_assignment)) <= 3:
                    raise Exception("cluster dropped to <=3 members")
                self._M_step()
        except KernelError:
            raise
        except Exception:  # noqa: BLE001 — nearly-empty cluster aborts a start
            pass

        try:
            score = self.score()
        except TypeError:
            score = -np.inf
        best_mdl, best_score = self, score
        if n_jobs > 1 and n_restarts > 0:
            # process-parallel restarts: every restart is independently
            # seeded (default_rng(i)) exactly as in the sequential protocol,
            # and the winner rule (strictly greater, ascending seed order)
            # is applied to the collected scores — results are identical to
            # the sequential loop, wall time is ÷ n_jobs
            results = _parallel_restarts(
                self.states,
                self.observations,
                self.n_clusters,
                self.component_model,
                self.component_model_hyperparams,
                n_restarts,
                n_iter,
                n_jobs,
                self.device,
                self.dtype,
            )
            for i in sorted(results):
                new_score, blob = results[i]
                if new_score > best_score:
                    cand = self._sibling(i)
                    cand._restore_blob(blob)
                    best_mdl, best_score = cand, new_score
        else:
            for i in range(n_restarts):
                try:
                    cand = self._sibling(i).fit(
                        init="random", n_iter=n_iter, use_cache=False
                    )
                    if (new_score := cand.score()) > best_score:
                        best_mdl, best_score = cand, new_score
                except KernelError:
                    raise
                except Exception:  # noqa: BLE001 — degenerate start, skip
                    pass
        if best_score == -np.inf:
            raise Exception("training failed")

        best_mdl.last_trained = _now()
        if use_cache:
            best_mdl.to_pickle(include_training_data=False)
        return best_mdl

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def _extract_blob(self) -> dict:
        """Trained state as plain objects (for cross-process transfer)."""
        return {
            "cluster_propensities": self.cluster_propensities,
            "cluster_models": [cm.to_pickle() for cm in self.cluster_models],
            "cluster_assignment": self.cluster_assignment,
        }

    def _restore_blob(self, blob: dict) -> None:
        self.cluster_propensities = blob["cluster_propensities"]
        self.cluster_models = [
            self._component().from_pickle(p) for p in blob["cluster_models"]
        ]
        self.cluster_assignment = blob["cluster_assignment"]

    def to_pickle(
        self,
        save_location: str | os.PathLike = None,
        there_can_only_be_one: bool = True,
        include_training_data: bool = False,
    ):
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
            "component_model": self.component_model,
            "component_model_hyperparams": self.component_model_hyperparams,
            "cluster_models": [cm.to_pickle() for cm in self.cluster_models],
            "rng": self.rng,
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
        dtype=None,
    ):
        """A mixture from a pickle of :meth:`to_pickle`, on ``device``.
        Unpickle only files this program wrote."""
        opener = gzip.open if os.path.splitext(file)[-1] == ".gz" else open
        with opener(file, "rb") as f:
            d = pickle.load(f)
        src = training_data if training_data is not None else d
        mdl = StateSpaceMixtureModel(
            n_clusters=d["n_clusters"],
            data=(src["states"], src["observations"]),
            component_model=d["component_model"],
            component_model_hyperparams=d.get(
                "component_model_hyperparams", dict()
            ),
            rng=d["rng"],
            device=device,
            dtype=dtype,
        )
        mdl.cluster_propensities = d["cluster_propensities"]
        mdl.cluster_models = [
            mdl._component().from_pickle(p) for p in d["cluster_models"]
        ]
        mdl.rng = d["rng"]
        mdl.cluster_assignment = d["cluster_assignment"]
        mdl.correspondence = d["correspondence"]
        mdl.inverse_correspondence = d["inverse_correspondence"]
        mdl.last_trained = d["last_trained"]
        return mdl

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def predict_proba(
        self,
        data: tuple[np.ndarray, np.ndarray] = None,
        return_prenormalized_log_probs: bool = False,
    ):
        """Posterior membership probabilities (softmax of log π_c + score_c;
        reference ssmm:406-433)."""
        if data is None:
            data = self.data
        logits = self._component_logits(data)  # (n, C)
        shifted = logits - logits.max(axis=1, keepdims=True)
        preds = np.exp(shifted)
        preds /= preds.sum(axis=1, keepdims=True)
        if return_prenormalized_log_probs:
            return preds, logits.T
        return preds

    def predict(
        self,
        *,
        data: tuple[np.ndarray, np.ndarray] = None,
        letters: bool = True,
    ) -> np.ndarray:
        preds = np.argmax(self.predict_proba(data=data), axis=1)
        if letters:
            return np.array([self.correspondence[i] for i in preds])
        return preds

    def score(self, data: tuple[np.ndarray, np.ndarray] = None) -> float:
        """Hard-assignment complete-data log-likelihood; −inf when any
        cluster is unused on the scored data (reference ssmm:447-474)."""
        if data is None:
            data = self.data
        assignment = self.predict(data=data, letters=False)
        try:
            assert set(assignment) == set(range(self.n_clusters))
            assert assignment.size == data[0].shape[1]
        except AssertionError:
            return -np.inf
        scores = np.column_stack(
            [
                np.asarray(self.cluster_models[c].score(data), dtype=float)
                for c in range(self.n_clusters)
            ]
        )
        return float(
            np.sum(np.log(self.cluster_propensities[assignment]))
            + np.sum(scores[np.arange(assignment.size), assignment])
        )

    def model_log_likelihood(
        self, data: tuple[np.ndarray, np.ndarray] = None
    ) -> float:
        """Marginal mixture log-likelihood via logsumexp (reference
        ssmm:476-497)."""
        if data is None:
            data = self.data
        logits = self._component_logits(data)
        mx = logits.max(axis=1)
        return float(
            np.sum(mx + np.log(np.sum(np.exp(logits - mx[:, None]), axis=1)))
        )

    def cluster_assignment_index(
        self, *, cluster: str = "A", data=None
    ) -> np.ndarray:
        """Prenormalized log-odds of membership in ``cluster``
        (reference ssmm:499-506)."""
        return self.predict_proba(
            data=data, return_prenormalized_log_probs=True
        )[-1][self.inverse_correspondence[cluster]]


# ----------------------------------------------------------------------
# state carried across packages
# ----------------------------------------------------------------------


def mixture_state(model) -> dict:
    """A trained mixture as plain numpy: the propensities, the assignment
    and each component's :func:`..state_space_model.component_state`.
    Reads attributes only, so it takes the JAX package's mixtures too (a
    JAX pickle cannot be loaded here: unpickling would import the JAX
    package)."""
    return {
        "cluster_propensities": np.array(model.cluster_propensities, dtype=float),
        "cluster_assignment": np.array(model.cluster_assignment),
        "cluster_models": [component_state(cm) for cm in model.cluster_models],
    }


def mixture_from_state(
    n_clusters: int,
    data: tuple[np.ndarray, np.ndarray],
    component_model,
    state: dict,
    *,
    component_model_hyperparams: dict = dict(),
    device=None,
    dtype=None,
) -> StateSpaceMixtureModel:
    """This package's trained mixture from :func:`mixture_state`'s dict,
    its components built by ``component_model.from_state`` with
    ``component_model_hyperparams`` on ``device``."""
    mdl = StateSpaceMixtureModel(
        n_clusters,
        data,
        component_model,
        component_model_hyperparams=component_model_hyperparams,
        device=device,
        dtype=dtype,
    )
    mdl.cluster_propensities = np.array(state["cluster_propensities"], dtype=float)
    mdl.cluster_assignment = np.array(state["cluster_assignment"])
    mdl.cluster_models = [
        component_model.from_state(
            s, device=mdl.device, dtype=mdl.dtype, **component_model_hyperparams
        )
        for s in state["cluster_models"]
    ]
    return mdl
