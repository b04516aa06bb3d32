"""Linear-Gaussian component model (Kalman-type linear dynamical system).

Counterpart of ``multimodal_trajectory_modeling_tpu/models/linear_gaussian.py``
(reference: framework_extended/state_space_model_linear_gaussian.py:19-144).
Fitting pools all time steps through the numpy regression helpers
(:mod:`..utils.state_space`); scoring builds the joint moments and
evaluates the masked Gaussian through :mod:`.statespace_api`, kernel K12
on the card — the main framework's per-cluster likelihood.
"""

from __future__ import annotations

import pickle

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.models import statespace_api as ssapi
from multimodal_trajectory_modeling_tpu_torch.models.state_space_model import (
    StateSpaceModel,
    resolve_pair as _resolve_pair,
)
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as util

np_eps = np.finfo(float).eps


class StateSpaceLinearGaussian(StateSpaceModel):
    """Linear Gaussian state-space model; also known as a Linear Dynamical
    System / Kalman-type model."""

    def __init__(self, alpha: float = 0.0, *, device=None, dtype=None):
        super().__init__(device=device, dtype=dtype)
        self.alpha = alpha if alpha > 2 * np_eps else 0

    def __str__(self):
        return "State space model with linear Gaussian components"

    def fit(self, data: tuple[np.ndarray, np.ndarray]):
        """Initial moments from finite first-step states; transition and
        measurement models by (eps- or alpha-ridged) pooled least squares
        (reference lg:40-79)."""
        self.data = tuple(map(np.atleast_3d, data))
        states, measurements = self.data

        first = states[0]
        self.state_init = {
            "mean": np.nanmean(first, axis=0),
            "cov": np.cov(util.take_finite_along_axis(first), rowvar=False),
        }

        def _reg(X, Y):
            if self.alpha > 2 * np_eps:
                return util.regress_alpha(X, Y, self.alpha)
            return util.regress(X, Y)

        A, G = _reg(
            np.vstack(list(states[:-1])), np.vstack(list(states[1:]))
        )
        self.state_model = {"coeff": A, "covar": G}
        H, L = _reg(
            np.vstack(list(states[:])), np.vstack(list(measurements[:]))
        )
        self.measurement_model = {"coeff": H, "covar": L}
        return self

    def to_pickle(self) -> bytes:
        return pickle.dumps(
            {
                "state_init": self.state_init,
                "state_model": self.state_model,
                "measurement_model": self.measurement_model,
                "alpha": self.alpha,
            }
        )

    def from_pickle(self, p: bytes):
        d = pickle.loads(p)
        self.state_init = d["state_init"]
        self.state_model = d["state_model"]
        self.measurement_model = d["measurement_model"]
        self.alpha = d.get("alpha", 0)
        return self

    def _moments(self, T: int):
        kw = dict(device=self.device, dtype=self.dtype)
        mean = ssapi.mm(
            T,
            self.state_init["mean"],
            self.state_model["coeff"],
            self.measurement_model["coeff"],
            **kw,
        )
        cov = ssapi.CC(
            T,
            self.state_init["cov"],
            self.state_model["coeff"],
            self.state_model["covar"],
            self.measurement_model["coeff"],
            self.measurement_model["covar"],
            **kw,
        )
        return mean, cov

    def score(self, data: tuple[np.ndarray, np.ndarray] = None):
        """Per-instance joint log-likelihood via the masked Gaussian, K12 on
        the card (reference lg:99-126)."""
        states, measurements = _resolve_pair(self.data, data)
        T = states.shape[0]
        mean, cov = self._moments(T)
        n = states.shape[1]
        v = np.concatenate(
            [
                states.transpose(1, 0, 2).reshape(n, -1),
                measurements.transpose(1, 0, 2).reshape(n, -1),
            ],
            axis=1,
        )
        return ssapi.multivariate_normal_log_likelihood(
            v, mean, cov, device=self.device, dtype=self.dtype
        )

    def score_alt(self, data: tuple[np.ndarray, np.ndarray] = None):
        """Same semantics through the slow general path (reference
        lg:128-144) — used as a cross-check."""
        states, measurements = _resolve_pair(self.data, data)
        return ssapi.full_marginalizable_log_prob(
            z=states,
            x=measurements,
            T=states.shape[0],
            m=self.state_init["mean"],
            S=self.state_init["cov"],
            A=self.state_model["coeff"],
            Γ=self.state_model["covar"],
            H=self.measurement_model["coeff"],
            Λ=self.measurement_model["covar"],
            device=self.device,
            dtype=self.dtype,
        )
