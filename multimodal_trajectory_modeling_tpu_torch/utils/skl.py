"""Stand-ins for the scikit-learn pieces the experiment drivers use, so the
port needs no scikit-learn (the card's machine has none).

- :class:`KFold` and :class:`StratifiedKFold`: scikit-learn's folds,
  index for index (``sklearn/model_selection/_split.py``);
- :class:`GaussianMixture`: ``GaussianMixture(covariance_type="full",
  init_params="kmeans", n_init=1)`` with its ``fit_predict``, ``predict``
  and ``predict_proba``, following ``sklearn/mixture/_gaussian_mixture.py``
  and ``_base.py`` operation for operation in float64 (the k-means start is
  :func:`..models.kmeans.kmeans_labels` with ``n_init=1`` from
  ``RandomState(random_state)``, as scikit-learn's ``KMeans(n_init=1)``
  draws);
- :func:`roc_auc_score`: the area under the ROC curve from average ranks
  (ties count one half), equal to scikit-learn's trapezoid up to rounding.

The cross-validated regressions of ``utils/post_hoc.py`` are in that module.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sp_linalg
import scipy.stats as sp_stats

from multimodal_trajectory_modeling_tpu_torch.models.kmeans import kmeans_labels

__all__ = ["GaussianMixture", "KFold", "StratifiedKFold", "roc_auc_score"]


class KFold:
    """``sklearn.model_selection.KFold``: ``n_splits`` contiguous test
    folds of a (shuffled) index, the first ``n % n_splits`` one longer."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X, y=None, groups=None):
        n = len(X)
        if self.n_splits > n:
            raise ValueError(f"cannot have n_splits={self.n_splits} greater than the number of samples {n}")
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.random_state).shuffle(indices)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        start = 0
        for size in sizes:
            test = indices[start : start + size]
            mask = np.zeros(n, dtype=bool)
            mask[test] = True
            yield np.arange(n)[~mask], np.arange(n)[mask]
            start += size


class StratifiedKFold:
    """``sklearn.model_selection.StratifiedKFold``: each class's members
    dealt to the folds in blocks by a round robin over the sorted labels,
    the blocks shuffled per class where ``shuffle``."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def _test_folds(self, y) -> np.ndarray:
        rng = np.random.RandomState(self.random_state) if self.shuffle else None
        y = np.asarray(y).reshape(-1)
        _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        counts = np.bincount(y_encoded)
        if np.all(self.n_splits > counts):
            raise ValueError(
                f"n_splits={self.n_splits} cannot be greater than the number of members in each class."
            )
        y_order = np.sort(y_encoded)
        allocation = np.asarray(
            [np.bincount(y_order[i :: self.n_splits], minlength=n_classes) for i in range(self.n_splits)]
        )
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y, groups=None):
        folds = self._test_folds(y)
        idx = np.arange(len(folds))
        for i in range(self.n_splits):
            yield idx[folds != i], idx[folds == i]


def roc_auc_score(y_true, y_score) -> float:
    """The area under the ROC curve of binary ``y_true`` (the larger label
    positive) scored by ``y_score``: the Mann-Whitney statistic on average
    ranks, ties counting one half."""
    y = np.asarray(y_true).reshape(-1)
    s = np.asarray(y_score, dtype=float).reshape(-1)
    labels = np.unique(y)
    if labels.size != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined in that case.")
    pos = y == labels[1]
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    ranks = sp_stats.rankdata(s)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _logsumexp_rows(a: np.ndarray) -> np.ndarray:
    """``sklearn.utils._array_api._logsumexp(a, axis=1)``, operation for
    operation."""
    a_max = np.max(a, axis=1, keepdims=True)
    index_max = a == a_max
    a = np.array(a, copy=True)
    a[index_max] = -np.inf
    m = np.sum(index_max.astype(a.dtype), axis=1, keepdims=True, dtype=a.dtype)
    shift = np.where(np.isfinite(a_max), a_max, 0)
    s = np.sum(np.exp(a - shift), axis=1, keepdims=True)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + a_max, axis=1)


def _gaussian_parameters(X, resp, reg_covar):
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, np.newaxis]
    n_components, n_features = means.shape
    covariances = np.empty((n_components, n_features, n_features), dtype=X.dtype)
    for k in range(n_components):
        diff = X - means[k, :]
        covariances[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        covariances[k].flat[:: n_features + 1] += reg_covar
    return nk, means, covariances


def _precision_cholesky(covariances):
    n_components, n_features, _ = covariances.shape
    out = np.empty_like(covariances)
    eye = np.eye(n_features, dtype=covariances.dtype)
    for k in range(n_components):
        try:
            chol = sp_linalg.cholesky(covariances[k], lower=True)
        except np.linalg.LinAlgError as err:
            raise ValueError(
                "Fitting the mixture model failed because some components have ill-defined empirical "
                "covariance (for instance caused by singleton or collapsed samples)."
            ) from err
        out[k] = sp_linalg.solve_triangular(chol, eye, lower=True).T
    return out


def _log_gaussian_prob(X, means, precisions_chol):
    n_samples, n_features = X.shape
    n_components = means.shape[0]
    log_det = np.sum(np.log(precisions_chol.reshape(n_components, -1)[:, :: n_features + 1]), axis=1)
    log_prob = np.empty((n_samples, n_components), dtype=X.dtype)
    for k in range(n_components):
        y = (X @ precisions_chol[k]) - (means[k] @ precisions_chol[k])
        log_prob[:, k] = np.sum(np.square(y), axis=1)
    return -0.5 * (n_features * np.log(2 * np.pi) + log_prob) + log_det


class GaussianMixture:
    """``sklearn.mixture.GaussianMixture(n_components,
    covariance_type="full", tol, reg_covar, max_iter, n_init=1,
    init_params="kmeans", random_state)`` in float64."""

    def __init__(
        self,
        n_components: int = 1,
        *,
        covariance_type: str = "full",
        tol: float = 1e-3,
        reg_covar: float = 1e-6,
        max_iter: int = 100,
        init_params: str = "kmeans",
        random_state=None,
    ):
        if covariance_type != "full" or init_params != "kmeans":
            raise NotImplementedError("only covariance_type='full' with init_params='kmeans'")
        if not isinstance(random_state, (int, np.integer)):
            raise ValueError("random_state must be an int (the k-means start's seed)")
        self.n_components = int(n_components)
        self.covariance_type = covariance_type
        self.tol = tol
        self.reg_covar = reg_covar
        self.max_iter = int(max_iter)
        self.init_params = init_params
        self.random_state = int(random_state)

    def _estimate_weighted_log_prob(self, X):
        return _log_gaussian_prob(X, self.means_, self.precisions_cholesky_) + np.log(self.weights_)

    def _estimate_log_prob_resp(self, X):
        weighted = self._estimate_weighted_log_prob(X)
        norm = _logsumexp_rows(weighted)
        with np.errstate(under="ignore"):
            log_resp = weighted - norm[:, np.newaxis]
        return norm, log_resp

    def _m_step(self, X, log_resp):
        self.weights_, self.means_, self.covariances_ = _gaussian_parameters(X, np.exp(log_resp), self.reg_covar)
        self.weights_ /= np.sum(self.weights_)
        self.precisions_cholesky_ = _precision_cholesky(self.covariances_)

    def _initialize(self, X):
        n = X.shape[0]
        resp = np.zeros((n, self.n_components), dtype=X.dtype)
        label = kmeans_labels(X, self.n_components, random_state=self.random_state, n_init=1)
        resp[np.arange(n), label] = 1
        weights, self.means_, self.covariances_ = _gaussian_parameters(X, resp, self.reg_covar)
        self.weights_ = weights / n
        self.precisions_cholesky_ = _precision_cholesky(self.covariances_)

    def fit_predict(self, X, y=None) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2 or X.shape[0] < max(2, self.n_components):
            raise ValueError(f"X must be (n, p) with n >= max(2, n_components), got {X.shape}")
        if not np.isfinite(X).all():
            raise ValueError("Input X contains NaN or infinity.")
        self._initialize(X)
        lower_bound = -np.inf
        self.converged_ = False
        for n_iter in range(1, self.max_iter + 1):
            prev = lower_bound
            log_prob_norm, log_resp = self._estimate_log_prob_resp(X)
            self._m_step(X, log_resp)
            lower_bound = np.mean(log_prob_norm)
            if abs(lower_bound - prev) < self.tol:
                self.converged_ = True
                break
        self.n_iter_ = n_iter
        self.lower_bound_ = lower_bound
        _, log_resp = self._estimate_log_prob_resp(X)
        return np.argmax(log_resp, axis=1)

    def predict(self, X) -> np.ndarray:
        return np.argmax(self._estimate_weighted_log_prob(np.asarray(X, dtype=np.float64)), axis=1)

    def predict_proba(self, X) -> np.ndarray:
        _, log_resp = self._estimate_log_prob_resp(np.asarray(X, dtype=np.float64))
        return np.exp(log_resp)
