"""Cross-validated post-hoc helpers: CV residualization, logistic-regression
AUCs and stratified CV metrics.

Counterpart of ``multimodal_trajectory_modeling_tpu/utils/post_hoc.py``
without scikit-learn (the card's machine has none).  The estimators that
module takes from scikit-learn are solved here in float64:

- ``RidgeCV()`` (:class:`RidgeCV`): alphas 0.1, 1 and 10, an unpenalized
  intercept, the alpha of least mean squared leave-one-out error (the
  first on ties), from the closed-form leave-one-out residuals
  ``e_i / (1 − h_ii)`` with ``H = 11ᵀ/n + X̃(X̃ᵀX̃ + αI)⁻¹X̃ᵀ`` on the centred
  ``X̃``, as scikit-learn's efficient leave-one-out computes them;
- ``LogisticRegressionCV(Cs=10)`` (:class:`LogisticRegressionCV`): C on
  ``logspace(-4, 4, 10)``, L2 on the weights and not the intercept, each
  problem ``min mean log-loss + ‖w‖²/(2·C·n)`` solved as scikit-learn's
  ``lbfgs`` solver solves it: scipy's L-BFGS-B from zeros, ``gtol`` 1e-4,
  at most 100 iterations, each C of a fold's path started from the last
  one's solution.  (Its stop at 1e-4 is part of the result: the exact
  optimum ranks held-out rows differently in a few folds.)  The C of the
  highest summed score over a 5-fold :class:`..skl.StratifiedKFold`
  (accuracy, or ROC AUC where asked; the first on ties), then refit on all
  the data from the folds' mean solution at that C;
- ``cross_val_predict`` over ``KFold(5)`` (regressors) or
  ``StratifiedKFold(5)`` (classifiers), unshuffled, and
  :func:`..skl.roc_auc_score`.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.optimize as sp_optimize
import scipy.special as sp_special
import scipy.stats as sp_stats

from multimodal_trajectory_modeling_tpu_torch.utils.skl import KFold, StratifiedKFold, roc_auc_score

__all__ = [
    "LogisticRegressionCV",
    "RidgeCV",
    "logit_cv_auc",
    "regressed_out_effect_cv",
    "stratified_logit_cv_metrics",
]


class RidgeCV:
    """``sklearn.linear_model.RidgeCV()`` (alphas 0.1, 1 and 10) with its
    efficient leave-one-out selection; ``y`` (n,) or (n, k)."""

    alphas = (0.1, 1.0, 10.0)

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, p = X.shape
        x_mean, y_mean = X.mean(axis=0), y.mean(axis=0)
        Xc, yc = X - x_mean, y - y_mean
        gram = Xc.T @ Xc
        best = None
        for alpha in self.alphas:
            inv = np.linalg.inv(gram + alpha * np.eye(p))
            coef = inv @ (Xc.T @ yc)
            resid = yc - Xc @ coef
            hat = 1.0 / n + np.einsum("ij,jk,ik->i", Xc, inv, Xc)
            loo = resid / (1.0 - hat).reshape((-1,) + (1,) * (y.ndim - 1))
            score = -np.mean(loo**2)
            if best is None or score > best[0]:
                best = (score, alpha, coef)
        _, self.alpha_, self.coef_ = best
        self.intercept_ = y_mean - x_mean @ self.coef_
        return self

    def predict(self, X):
        return np.asarray(X, dtype=np.float64) @ self.coef_ + self.intercept_


def _half_binomial(y, z):
    """scikit-learn's pointwise half binomial loss and its gradient in the
    raw prediction ``z``, by its four branches (``_loss.pyx.tp``)."""
    loss, grad = np.empty_like(z), np.empty_like(z)
    lo = z <= -37
    e = np.exp(z[lo])
    loss[lo], grad[lo] = e - y[lo] * z[lo], e - y[lo]
    mid = (z > -37) & (z <= -2)
    e, yy = np.exp(z[mid]), y[mid]
    loss[mid], grad[mid] = np.log1p(e) - yy * z[mid], ((1 - yy) * e - yy) / (1 + e)
    hi = (z > -2) & (z <= 18)
    e, yy = np.exp(-z[hi]), y[hi]
    loss[hi], grad[hi] = np.log1p(e) + (1 - yy) * z[hi], ((1 - yy) - yy * e) / (1 + e)
    top = z > 18
    e, yy = np.exp(-z[top]), y[top]
    loss[top], grad[top] = e + (1 - yy) * z[top], ((1 - yy) - yy * e) / (1 + e)
    return loss, grad


def _loss_gradient(theta, X, y, l2):
    """scikit-learn's ``LinearModelLoss.loss_gradient`` of the half
    binomial loss: the mean loss plus ``l2/2·‖w‖²``, and its gradient (the
    intercept, ``theta[-1]``, unpenalized), in its order of operations."""
    w = theta[:-1]
    z = X @ w + theta[-1]
    n = z.shape[0]
    loss, g = _half_binomial(y, z)
    loss = float(np.sum(loss) / n) + float(0.5 * l2 * (w @ w))
    g /= n
    grad = np.empty_like(theta)
    grad[:-1] = X.T @ g + l2 * w
    grad[-1] = np.sum(g)
    return loss, grad


def _logistic_path(X, y, Cs, theta0=None, *, tol=1e-4, max_iter=100):
    """scikit-learn's ``_logistic_regression_path`` with ``solver="lbfgs"``
    for binary ``y ∈ {0, 1}``: one ``(w, b)`` per C, each solve started
    from the last one's (the first from ``theta0``, else zeros)."""
    theta = np.zeros(X.shape[1] + 1) if theta0 is None else np.array(theta0, dtype=np.float64)
    out = []
    for C in Cs:
        res = sp_optimize.minimize(
            _loss_gradient, theta, method="L-BFGS-B", jac=True, args=(X, y, 1.0 / (C * X.shape[0])),
            options={"maxiter": max_iter, "maxls": 50, "gtol": tol, "ftol": 64 * np.finfo(float).eps},
        )
        theta = res.x
        out.append(theta)
    return out


class LogisticRegressionCV:
    """``sklearn.linear_model.LogisticRegressionCV()`` for binary ``y``:
    the 10 Cs of ``logspace(-4, 4)``, L2, an unpenalized intercept, 5-fold
    stratified selection of C by accuracy (``scoring="roc_auc"``: ROC AUC),
    refit on all the data."""

    Cs_ = np.logspace(-4, 4, 10)

    def __init__(self, *, scoring=None):
        if scoring not in (None, "roc_auc"):
            raise NotImplementedError(f"scoring={scoring!r}")
        self.scoring = scoring

    def _score(self, w, b, X, y):
        z = X @ w + b
        if self.scoring == "roc_auc":
            return roc_auc_score(y, z)
        return float(np.mean((z > 0).astype(int) == y))

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y).reshape(-1)
        self.classes_ = np.unique(y)
        if self.classes_.size != 2:
            raise ValueError(f"binary y only, got classes {self.classes_}")
        y01 = (y == self.classes_[1]).astype(np.float64)
        folds = list(StratifiedKFold(5).split(X, y))
        paths = [_logistic_path(X[tr], y01[tr], self.Cs_) for tr, _ in folds]
        scores = np.array(
            [[self._score(th[:-1], th[-1], X[te], y01[te]) for th in path] for path, (_, te) in zip(paths, folds)]
        )
        self.scores_ = scores
        best = int(np.argmax(scores.sum(axis=0)))
        self.C_ = float(self.Cs_[best])
        (theta,) = _logistic_path(X, y01, [self.C_], np.mean([path[best] for path in paths], axis=0))
        self.coef_, self.intercept_ = theta[:-1], theta[-1]
        return self

    def decision_function(self, X):
        return np.asarray(X, dtype=np.float64) @ self.coef_ + self.intercept_

    def predict_proba(self, X):
        p1 = sp_special.expit(self.decision_function(X))
        return np.column_stack([1.0 - p1, p1])


def _cross_val_predict(make_model, X, y, splitter, method="predict"):
    """``sklearn.model_selection.cross_val_predict``: each row predicted by
    the model fitted on the other folds."""
    out = None
    for train, test in splitter.split(X, y):
        pred = getattr(make_model().fit(X[train], y[train]), method)(X[test])
        if out is None:
            out = np.empty((len(X),) + pred.shape[1:], dtype=np.float64)
        out[test] = pred
    return out


def regressed_out_effect_cv(regressand: np.ndarray, effect: np.ndarray, model=None):
    """Residuals of ``regressand`` after cross-validated removal of
    ``effect`` (``post_hoc.py:15``): 5-fold predictions of a
    :class:`RidgeCV` (or of ``model()``, a factory of objects with ``fit``
    and ``predict``) subtracted; rows with a non-finite value NaN."""
    make_model = RidgeCV if model is None else model
    fin = np.isfinite(np.column_stack([regressand, effect])).all(axis=1)
    if not fin.all():
        warnings.warn(f"Encountered {int((~fin).sum())} nans")
    preds = _cross_val_predict(make_model, effect[fin], regressand[fin], KFold(5))
    resids = np.full_like(regressand, np.nan)
    resids[fin] = regressand[fin] - np.reshape(preds, np.shape(regressand[fin]))
    return resids


def logit_cv_auc(X: np.ndarray, y: np.ndarray, cv: int = 5):
    """AUC of cross-validated ``LogisticRegressionCV(scoring="roc_auc")``
    probabilities (``post_hoc.py:38``)."""
    fin = np.isfinite(np.column_stack([X, y])).all(axis=1)
    if (n_nan := int((~fin).sum())) > 0:
        warnings.warn(f"Dropping {n_nan} nans")
        X, y = X[fin], y[fin]
    y = np.asarray(y).reshape(-1)
    preds = _cross_val_predict(
        lambda: LogisticRegressionCV(scoring="roc_auc"), X, y, StratifiedKFold(cv), method="predict_proba"
    )[:, 1]
    return roc_auc_score(y, preds)


def stratified_logit_cv_metrics(X: np.ndarray, y: np.ndarray, return_perfs: bool = False):
    """Per-fold AUCs of a 10-fold stratified (shuffled, seed 42)
    ``LogisticRegressionCV`` (``post_hoc.py:57``)."""
    pred_col = 0.0 * y
    fold_aucs = []
    splitter = StratifiedKFold(n_splits=10, shuffle=True, random_state=42)
    for train_idx, test_idx in splitter.split(X, y):
        pred_col[test_idx] = (
            LogisticRegressionCV()
            .fit(X[train_idx], y[train_idx])
            .predict_proba(X[test_idx])[:, 1][:, np.newaxis]
        )
        fold_aucs.append(roc_auc_score(y[test_idx], pred_col[test_idx]))
    perf = {
        "AUC": round(float(roc_auc_score(y, pred_col)), 4),
        "mean batch AUC": round(float(np.mean(fold_aucs)), 4),
        "std dev batch AUC": round(float(np.std(fold_aucs)), 4),
        "std err of the mean": round(float(sp_stats.sem(fold_aucs)), 4),
    }
    return fold_aucs if not return_perfs else (fold_aucs, perf)
