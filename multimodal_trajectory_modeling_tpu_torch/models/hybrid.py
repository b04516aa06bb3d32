"""Hybrid component model: linear-Gaussian state transitions + k-NN-mean
measurement model.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/hybrid.py``
(reference: framework_extended/state_space_model_linear_trans_knn_meas.py:
22-164).  The kNN block runs on the component's device; the factorized
score is numpy and scipy on the host.
"""

from __future__ import annotations

import pickle

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.models.knn_model import (
    _finite_rows,
    _fit_knn_block,
    _gauss_logpdf_rows,
    _gauss_logpdf_rows_mean,
)
from multimodal_trajectory_modeling_tpu_torch.models.state_space_model import (
    StateSpaceModel,
    resolve_pair as _resolve_pair,
)
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as util

np_eps = np.finfo(float).eps


class StateSpaceHybrid(StateSpaceModel):
    """Linear, Gaussian state transitions; Gaussian measurement model with a
    cross-validated k-NN mean and homoskedastic covariance — a non-linear
    state→measurement relationship."""

    def __init__(
        self,
        *,
        n_neighbors: int | list = 10,
        n_folds: int = 3,
        alpha: float = 0.0,
        device=None,
        dtype=None,
    ):
        super().__init__(device=device, dtype=dtype)
        self.n_neighbors = (
            n_neighbors if isinstance(n_neighbors, list) else [n_neighbors]
        )
        self.n_folds = n_folds
        self.alpha = alpha if alpha > 2 * np_eps else 0

    def __str__(self):
        return (
            "State space model with linear state model and "
            f"k={self.n_neighbors}-NN-based measurement model "
            f"({self.n_folds=}, {self.alpha=})"
        )

    def fit(self, data: tuple[np.ndarray, np.ndarray]):
        self.data = tuple(map(np.atleast_3d, data))
        states, measurements = self.data

        self.state_init = {
            "mean": np.nanmean(states[0], axis=0),
            "cov": np.cov(
                util.take_finite_along_axis(states[0]), rowvar=False
            ),
        }

        Xp, Yn = np.vstack(list(states[:-1])), np.vstack(list(states[1:]))
        if self.alpha > 2 * np_eps:
            A, G = util.regress_alpha(Xp, Yn, self.alpha)
        else:
            A, G = util.regress(Xp, Yn)
        self.state_model = {"coeff": A, "covar": G}

        inp = np.vstack(list(states[:]))
        outp = np.vstack(list(measurements[:]))
        keep = _finite_rows(inp, outp)
        self.measurement_model = _fit_knn_block(
            inp[keep], outp[keep], self.n_neighbors, self.n_folds,
            device=self.device, dtype=self.dtype,
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
                "alpha": self.alpha,
            }
        )

    def from_pickle(self, p: bytes):
        """Restore :meth:`to_pickle`'s bytes; the kNN regressor moves to
        this component's device."""
        d = pickle.loads(p)
        self.n_folds = d["n_folds"]
        self.n_neighbors = d["n_neighbors"]
        self.data_hash = d["data_hash"]
        self.state_init = d["state_init"]
        self.state_model = d["state_model"]
        self.measurement_model = self._restore_block(d["measurement_model"])
        self.alpha = d.get("alpha", 0)
        return self

    def score(self, data: tuple[np.ndarray, np.ndarray]):
        """Factorized per-instance log-likelihood: linear transitions, kNN
        measurement means (reference hybrid:133-164)."""
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
                resid = s1[keep] - s0[keep] @ self.state_model["coeff"]
                lp[keep] += _gauss_logpdf_rows(resid, self.state_model["covar"])
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
