"""This package's own copy of
``multimodal_trajectory_modeling_tpu/utils/survival.py`` (numpy and pandas; nothing of
JAX), so that the port imports nothing of the JAX package.

Survival analysis: Cox proportional-hazards regression, concordance
index and k-fold cross-validation.

The reference's post-hoc stage uses ``lifelines`` (posthoc/
prognostic_survival_models_adni.py:24-146); that package is not available
here, so this module provides a self-contained implementation with a
lifelines-compatible surface for the pieces the pipeline uses:

- :class:`CoxPHFitter` — Newton—Raphson maximization of the Efron-tie
  partial likelihood with an optional ridge penalizer (``penalizer``,
  ``l1_ratio=0``), ``fit_options={"step_size", "max_steps"}`` and a
  ``robust`` flag (accepted; point estimates are identical, only standard
  errors would differ — the pipeline consumes concordances, not SEs).
- :func:`concordance_index` — Harrell's C with tied-risk pairs counted 1/2.
- :func:`k_fold_cross_validation` — seeded shuffled k-fold CV scored by
  held-out concordance.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

__all__ = ["CoxPHFitter", "concordance_index", "k_fold_cross_validation"]


def _efron_neg_loglik_grad_hess(beta, X, durations, events, penalizer):
    """Negative Efron partial log-likelihood with ridge penalty, plus
    gradient and Hessian.  Rows must be sorted by duration ascending."""
    n, p = X.shape
    eta = X @ beta
    # stabilize
    eta = eta - eta.max()
    w = np.exp(eta)

    neg_ll = 0.0
    grad = np.zeros(p)
    hess = np.zeros((p, p))

    # cumulative (from the end) risk-set sums
    rs_w = np.cumsum(w[::-1])[::-1]
    rs_xw = np.cumsum((X * w[:, None])[::-1], axis=0)[::-1]
    rs_xxw = np.cumsum(
        (X[:, :, None] * X[:, None, :] * w[:, None, None])[::-1], axis=0
    )[::-1]

    # group tied event times
    i = 0
    while i < n:
        j = i
        while j < n and durations[j] == durations[i]:
            j += 1
        idx = np.arange(i, j)
        ev = idx[events[idx] > 0]
        m = len(ev)
        if m > 0:
            tie_w = w[ev].sum()
            tie_xw = X[ev].T @ w[ev]
            tie_xxw = (X[ev] * w[ev, None]).T @ X[ev]
            s_w = rs_w[i]
            s_xw = rs_xw[i]
            s_xxw = rs_xxw[i]
            neg_ll -= eta[ev].sum()
            for r in range(m):
                c = r / m
                denom = s_w - c * tie_w
                num_x = s_xw - c * tie_xw
                num_xx = s_xxw - c * tie_xxw
                neg_ll += np.log(denom)
                grad += num_x / denom
                hess += num_xx / denom - np.outer(num_x, num_x) / denom**2
            grad -= X[ev].sum(axis=0)
        i = j

    # ridge penalty (lifelines: penalizer * 0.5 * n? lifelines scales by
    # n_examples in newer versions; we use the plain 0.5*||β||² form which
    # matches lifelines' behaviour for the small penalizers used here)
    neg_ll += 0.5 * penalizer * beta @ beta * n
    grad += penalizer * beta * n
    hess += penalizer * np.eye(p) * n
    return neg_ll, grad, hess


class CoxPHFitter:
    """Cox proportional-hazards model (Efron ties, ridge penalizer)."""

    def __init__(self, penalizer: float = 0.0, l1_ratio: float = 0.0):
        if l1_ratio not in (0, 0.0):
            raise NotImplementedError("only l1_ratio=0 (ridge) is supported")
        self.penalizer = penalizer
        self.l1_ratio = l1_ratio
        self.params_ = None
        self._columns = None
        self.duration_col = None
        self.event_col = None

    def fit(
        self,
        df: pd.DataFrame,
        duration_col: str,
        event_col: str,
        *,
        robust: bool = False,
        fit_options: dict = None,
        show_progress: bool = False,
    ):
        # fit_options' step_size/max_steps are accepted for lifelines
        # signature compatibility, but optimization uses damped Newton with
        # backtracking — same optimum, far fewer iterations than fixed tiny
        # steps
        fit_options = fit_options or {}
        max_steps = int(fit_options.get("max_steps", 500))
        max_steps = min(max_steps, 200)

        self.duration_col = duration_col
        self.event_col = event_col
        cols = [c for c in df.columns if c not in (duration_col, event_col)]
        self._columns = cols

        X = df[cols].to_numpy(dtype=float)
        durations = df[duration_col].to_numpy(dtype=float)
        events = df[event_col].to_numpy(dtype=float)
        order = np.argsort(durations, kind="stable")
        X, durations, events = X[order], durations[order], events[order]

        # normalize for optimization stability; un-scale at the end
        mu = X.mean(axis=0)
        sd = X.std(axis=0)
        sd[sd == 0] = 1.0
        Xn = (X - mu) / sd

        beta = np.zeros(X.shape[1])
        nll, grad, hess = _efron_neg_loglik_grad_hess(
            beta, Xn, durations, events, self.penalizer
        )
        for _ in range(max_steps):
            try:
                delta = np.linalg.solve(hess, grad)
            except np.linalg.LinAlgError:
                delta = np.linalg.lstsq(hess, grad, rcond=None)[0]
            step = 1.0
            for _bt in range(20):  # backtracking line search
                cand = beta - step * delta
                nll_c, grad_c, hess_c = _efron_neg_loglik_grad_hess(
                    cand, Xn, durations, events, self.penalizer
                )
                if np.isfinite(nll_c) and nll_c <= nll + 1e-12:
                    break
                step *= 0.5
            converged = abs(nll - nll_c) < 1e-10 * (abs(nll) + 1e-10)
            beta, nll, grad, hess = cand, nll_c, grad_c, hess_c
            if converged:
                break

        self.params_ = pd.Series(beta / sd, index=cols)
        self._train_df = df
        return self

    def predict_log_partial_hazard(self, df: pd.DataFrame) -> pd.Series:
        X = df[self._columns].to_numpy(dtype=float)
        return pd.Series(X @ self.params_.to_numpy(), index=df.index)

    def predict_partial_hazard(self, df: pd.DataFrame) -> pd.Series:
        return np.exp(self.predict_log_partial_hazard(df))

    def score(
        self, df: pd.DataFrame, scoring_method: str = "log_likelihood"
    ) -> float:
        if scoring_method == "concordance_index":
            return concordance_index(
                df[self.duration_col].to_numpy(),
                -self.predict_log_partial_hazard(df).to_numpy(),
                df[self.event_col].to_numpy(),
            )
        raise NotImplementedError(scoring_method)

    @property
    def concordance_index_(self) -> float:
        return self.score(self._train_df, scoring_method="concordance_index")


def concordance_index(
    event_times: np.ndarray,
    predicted_scores: np.ndarray,
    event_observed: np.ndarray = None,
) -> float:
    """Harrell's concordance: fraction of comparable pairs whose predicted
    scores are ordered like their survival times (ties count 1/2)."""
    t = np.asarray(event_times, dtype=float)
    s = np.asarray(predicted_scores, dtype=float)
    e = (
        np.ones_like(t)
        if event_observed is None
        else np.asarray(event_observed, dtype=float)
    )
    n = len(t)
    num, den = 0.0, 0.0
    for i in range(n):
        if e[i] == 0:
            continue
        # pairs (i, j): i experienced the event first
        later = (t > t[i]) | ((t == t[i]) & (e == 0))
        later[i] = False
        cnt = later.sum()
        if cnt == 0:
            continue
        den += cnt
        num += np.sum(s[later] > s[i]) + 0.5 * np.sum(s[later] == s[i])
    if den == 0:
        return 0.5
    return num / den


def k_fold_cross_validation(
    fitter,
    df: pd.DataFrame,
    duration_col: str,
    event_col: str,
    k: int = 5,
    scoring_method: str = "concordance_index",
    fitter_kwargs: dict = None,
    seed: int = None,
):
    """Seeded k-fold CV; returns the per-fold held-out scores.

    Replicates ``lifelines.utils.k_fold_cross_validation``'s split exactly
    (the reference's posthoc stage depends on it for its published
    concordances 0.836/0.887): seed the *global* NumPy RandomState, shuffle
    the frame by permuting its index, re-sort by the event column (pandas'
    default unstable quicksort — the shuffle determines tie order), then
    deal rows into folds cyclically ``1..k``.  Events end up spread across
    folds because censored rows sort first.
    """
    fitter_kwargs = fitter_kwargs or {}
    n = len(df)
    if seed is not None:
        np.random.seed(seed)
    shuffled = df.reindex(np.random.permutation(df.index)).sort_values(
        event_col
    )
    fold_of_row = np.array((n // k + 1) * list(range(1, k + 1)))[:n]
    scores = []
    for fold in range(1, k + 1):
        held_out = fold_of_row == fold
        fit = fitter.__class__(
            penalizer=fitter.penalizer, l1_ratio=fitter.l1_ratio
        )
        fit.fit(
            shuffled.loc[~held_out], duration_col, event_col, **fitter_kwargs
        )
        scores.append(
            fit.score(shuffled.loc[held_out], scoring_method=scoring_method)
        )
    return scores
