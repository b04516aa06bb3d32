"""kNN component model: cross-validated k-NN means with homoskedastic
Gaussian residuals for both transition and measurement models.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/knn_model.py``
(reference: framework_extended/state_space_model_knn.py:20-155).  The
kNN blocks are :class:`..ops.knn.KNNRegressor` on the component's device
(the host path below its work threshold) with the contiguous k-fold grid
search; the factorized score stays numpy and scipy on the host, as the
JAX module decides (``knn_model.py:144-150``).
"""

from __future__ import annotations

import hashlib
import pickle

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.ops.knn import (
    KNNRegressor,
    grid_search_knn,
)
from multimodal_trajectory_modeling_tpu_torch.models.state_space_model import (
    StateSpaceModel,
    resolve_pair as _resolve_pair,
)
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as util


def _fit_knn_block(inp, outp, k_grid, n_folds, *, device, dtype):
    """Reference knn:61-97 semantics: CV-pick k on (inp, outp); predict the
    training inputs with the refit model; store a *second* kNN fit on those
    smoothed predictions plus the residual covariance."""
    kw = dict(device=device, dtype=dtype)
    best_k = grid_search_knn(inp, outp, k_grid, n_folds, **kw)
    refit = KNNRegressor(n_neighbors=best_k, **kw).fit(inp, outp)
    smoothed = refit.predict(inp)
    return {
        "mean": KNNRegressor(n_neighbors=best_k, **kw).fit(inp, smoothed),
        "cov": np.cov(outp - smoothed, rowvar=False),
    }


def _finite_rows(*arrays):
    keep = np.isfinite(np.column_stack(arrays)).all(axis=1)
    return keep


class StateSpaceKNN(StateSpaceModel):
    """State-space model with cross-validated k-NN mean models and
    homoskedastic covariances; allows for non-linearities."""

    def __init__(self, n_neighbors: int | list = 10, n_folds: int = 3, *, device=None, dtype=None):
        super().__init__(device=device, dtype=dtype)
        self.n_neighbors = (
            n_neighbors if isinstance(n_neighbors, list) else [n_neighbors]
        )
        self.n_folds = n_folds

    def __str__(self):
        return "State space model with k-NN-based components"

    def fit(self, data: tuple[np.ndarray, np.ndarray]):
        self.data = tuple(map(np.atleast_3d, data))
        states, measurements = self.data
        self.data_hash = hashlib.md5(
            states.tobytes() + measurements.tobytes()
        ).hexdigest()

        self.state_init = {
            "mean": np.nanmean(states[0], axis=0),
            "cov": np.cov(
                util.take_finite_along_axis(states[0]), rowvar=False
            ),
        }
        kw = dict(device=self.device, dtype=self.dtype)

        inp = np.vstack(list(states[:-1]))
        outp = np.vstack(list(states[1:]))
        keep = _finite_rows(inp, outp)
        self.state_model = _fit_knn_block(
            inp[keep], outp[keep], self.n_neighbors, self.n_folds, **kw
        )

        inp = np.vstack(list(states[:]))
        outp = np.vstack(list(measurements[:]))
        keep = _finite_rows(inp, outp)
        self.measurement_model = _fit_knn_block(
            inp[keep], outp[keep], self.n_neighbors, self.n_folds, **kw
        )
        return self

    def to_pickle(self) -> bytes:
        return pickle.dumps(
            {
                "n_folds": self.n_folds,
                "n_neighbors": self.n_neighbors,
                "data_hash": self.data_hash,
                "state_init": self.state_init,
                "state_model": self.state_model,
                "measurement_model": self.measurement_model,
            }
        )

    def from_pickle(self, p: bytes):
        """Restore :meth:`to_pickle`'s bytes; the kNN regressors move to
        this component's device."""
        d = pickle.loads(p)
        self.n_folds = d["n_folds"]
        self.n_neighbors = d["n_neighbors"]
        self.data_hash = d["data_hash"]
        self.state_init = d["state_init"]
        self.state_model = self._restore_block(d["state_model"])
        self.measurement_model = self._restore_block(d["measurement_model"])
        return self

    def score(self, data: tuple[np.ndarray, np.ndarray]):
        """Factorized per-instance log-likelihood with kNN conditional means;
        any-NaN rows of a factor are skipped for that factor (reference
        knn:123-155)."""
        states, measurements = _resolve_pair(self.data, data)
        T = states.shape[0]
        lp = _gauss_logpdf_rows_mean(
            states[0].astype(float),
            self.state_init["mean"],
            self.state_init["cov"],
        )
        for t in range(T - 1):
            s0, s1 = states[t], states[t + 1]
            keep = _finite_rows(s0, s1)
            if keep.any():
                resid = s1[keep] - self.state_model["mean"].predict(s0[keep])
                lp[keep] += _gauss_logpdf_rows(
                    resid, self.state_model["cov"]
                )
        for t in range(T):
            s0, m0 = states[t], measurements[t]
            keep = _finite_rows(s0, m0)
            if keep.any():
                resid = m0[keep] - self.measurement_model["mean"].predict(
                    s0[keep]
                )
                lp[keep] += _gauss_logpdf_rows(
                    resid, self.measurement_model["cov"]
                )
        return lp


def _gauss_logpdf_rows(resid: np.ndarray, cov) -> np.ndarray:
    """Dense Gaussian log-pdf of residual rows, on the host.

    The factorized kNN/hybrid scores evaluate this per (time step, cluster)
    on a few hundred rows inside a host EM loop, where a device round trip
    would cost more than the work, so this stays numpy."""
    import scipy.linalg as sp_linalg

    cov = np.atleast_2d(cov)
    resid = np.atleast_2d(resid).astype(float)
    k = cov.shape[0]
    L = np.linalg.cholesky(cov)
    y = sp_linalg.solve_triangular(L, resid.T, lower=True)
    logdet = 2.0 * np.sum(np.log(np.diag(L)))
    return -0.5 * (
        k * np.log(2 * np.pi) + logdet + np.sum(y * y, axis=0)
    )


def _gauss_logpdf_rows_mean(
    x: np.ndarray, mean: np.ndarray, cov
) -> np.ndarray:
    return _gauss_logpdf_rows(np.atleast_2d(x) - np.atleast_1d(mean), cov)
