"""Batched k-nearest-neighbour regression.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/knn.py``, which
replaces scikit-learn's ``KNeighborsRegressor`` and ``GridSearchCV`` in the
extended framework.  The routing is the JAX module's:

- below ``_DEVICE_WORK_THRESHOLD`` (train × query rows) the numpy host
  path, copied unchanged;
- above it, on the regressor's device, the dense path (one distance GEMM
  by ``torch.matmul`` a query chunk, then a top-k), or past
  ``_STREAM_TRAIN_THRESHOLD`` training rows the streaming path (the
  training rows in blocks, a running top-k merged block by block).

The JAX kernels rely on ``lax.top_k`` keeping the lower index among equal
distances.  ``torch.topk`` promises no order among ties on either device,
so :func:`_nearest` breaks them to the lower training index explicitly:
in the dense path, in each streaming block and in the merge.  The
neighbours of a query are averaged in the order (distance, index).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)

__all__ = [
    "KNNRegressor",
    "knn_predict",
    "knn_predict_streaming",
    "grid_search_knn",
]

# past this many training rows the dense (B, m) distance tile is replaced by
# a streaming scan over train blocks with a running top-k merge
_STREAM_TRAIN_THRESHOLD = 32_768


def _nearest(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``d2 (B, m)``, ties to the
    lower column: ``(distances (B, k), columns (B, k))`` ordered by
    (distance, column).  ``topk`` gives the k-th distance; every entry
    below it is taken, and of the entries equal to it the first ones in
    column order; no host synchronization.  NaN counts as +∞."""
    d2 = torch.where(torch.isnan(d2), math.inf, d2)
    m = d2.shape[1]
    kth = torch.topk(d2, k, dim=1, largest=False).values.amax(1, keepdim=True)
    less = d2 < kth
    tie = d2 == kth
    need = k - less.sum(1, keepdim=True, dtype=torch.int32)
    keep = less | (tie & (torch.cumsum(tie, dim=1, dtype=torch.int32) <= need))
    # exactly k kept entries a row, each keyed m - column (distinct, ≥ 1)
    col = torch.arange(m, 0, -1, device=d2.device)
    cols = m - torch.topk(torch.where(keep, col, 0), k, dim=1).values
    dist = d2.gather(1, cols)
    order = torch.sort(dist, dim=1, stable=True).indices
    return dist.gather(1, order), cols.gather(1, order)


def _sqdist(q, train_x, x_sq):
    """``‖q‖² − 2 q·x + ‖x‖²`` in the JAX kernels' order of operations."""
    return torch.sum(q * q, dim=1, keepdim=True) - 2.0 * q @ train_x.T + x_sq[None, :]


def knn_predict(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    query: torch.Tensor,
    *,
    k: int,
    query_chunk: int = 4096,
) -> torch.Tensor:
    """Mean of the ``k`` nearest training targets for each query row, on
    the tensors' device.

    Euclidean metric; distances via the ``‖q‖² − 2 q·x + ‖x‖²`` expansion,
    so the inner products are one GEMM.  Queries go in chunks to bound the
    (chunk × m) distance matrix in memory (``knn.py:31``)."""
    m = train_x.shape[0]
    k = min(k, m)
    x_sq = torch.sum(train_x * train_x, dim=1)
    return torch.cat([
        train_y[_nearest(_sqdist(q, train_x, x_sq), k)[1]].mean(dim=1)
        for q in query.split(query_chunk)
    ])


def knn_predict_streaming(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    query: torch.Tensor,
    *,
    k: int,
    query_chunk: int = 1024,
    train_chunk: int = 8192,
) -> torch.Tensor:
    """:func:`knn_predict` at train-set sizes where a (B, m) distance tile
    does not fit: the training rows in blocks of ``train_chunk``, each
    block's ``min(k, train_chunk)`` nearest merged with the running best
    (``knn.py:66``).  Memory O(B·(k + train_chunk)), independent of m.

    In the merge the running best (ordered by distance, then index) comes
    before the block's candidates, whose indices are all higher, so taking
    the lower column among ties takes the lower training index: the result
    is the dense path's."""
    m = train_x.shape[0]
    k = min(k, m)
    kb = min(k, train_chunk)
    x_sq = torch.sum(train_x * train_x, dim=1)
    out = []
    for q in query.split(query_chunk):
        q_sq = torch.sum(q * q, dim=1, keepdim=True)
        best_d = torch.full((q.shape[0], k), math.inf, dtype=q.dtype, device=q.device)
        best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
        for b0 in range(0, m, train_chunk):
            bx = train_x[b0 : b0 + train_chunk]
            d2 = q_sq - 2.0 * q @ bx.T + x_sq[None, b0 : b0 + train_chunk]
            vals, idx = _nearest(d2, min(kb, bx.shape[0]))
            cat_i = torch.cat([best_i, idx + b0], dim=1)
            best_d, sel = _nearest(torch.cat([best_d, vals], dim=1), k)
            best_i = cat_i.gather(1, sel)
        out.append(train_y[best_i].mean(dim=1))
    return torch.cat(out)


def _sqdist_np(train_x, query):
    return (
        np.sum(query * query, axis=1, keepdims=True)
        - 2.0 * query @ train_x.T
        + np.sum(train_x * train_x, axis=1)[None, :]
    )


def _knn_predict_np(train_x, train_y, query, k):
    """Host path: argpartition top-k.  Used below a work threshold — inside
    the generic-mixture EM the train-set shape changes every M step, and a
    device round trip per shape costs more than the work."""
    k = min(k, train_x.shape[0])
    d2 = _sqdist_np(train_x, query)
    idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
    return train_y[idx].mean(axis=1)


def _knn_predict_np_multi_k(train_x, train_y, query, ks):
    """One distance matrix + one ordered top-k(max) shared by every k in
    the grid — the k-fold grid search evaluates |grid| models per fold for
    the price of one."""
    kmax = min(max(ks), train_x.shape[0])
    d2 = _sqdist_np(train_x, query)
    part = np.argpartition(d2, kmax - 1, axis=1)[:, :kmax]
    order = np.take_along_axis(d2, part, axis=1).argsort(axis=1)
    nearest = np.take_along_axis(part, order, axis=1)  # (n, kmax) sorted
    out = {}
    for k in ks:
        kk = min(k, kmax)
        out[k] = train_y[nearest[:, :kk]].mean(axis=1)
    return out


# below this (train × query) work size the host path wins
_DEVICE_WORK_THRESHOLD = 5_000_000


def _device_kernel(m: int):
    return knn_predict_streaming if m > _STREAM_TRAIN_THRESHOLD else knn_predict


class KNNRegressor:
    """scikit-learn-style ``fit`` / ``predict`` over :func:`knn_predict`;
    picklable.  Small problems take the host path; large ones the device
    paths on ``device`` (default the card) in ``dtype``."""

    def __init__(self, n_neighbors: int = 5, *, device=None, dtype=None):
        self.n_neighbors = int(n_neighbors)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.device, dtype)
        self._x = None
        self._y = None

    @classmethod
    def from_state(cls, state: dict, *, device=None, dtype=None):
        """A fitted regressor from ``{"n_neighbors", "_x", "_y"}`` (the JAX
        class's ``__getstate__()``) on ``device``."""
        reg = cls(state["n_neighbors"], device=device, dtype=dtype)
        reg._x, reg._y = state["_x"], state["_y"]
        return reg

    def fit(self, X: np.ndarray, y: np.ndarray):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.asarray(y, dtype=float)
        if y.ndim == 1:
            y = y[:, None]
        self._x, self._y = X, y
        return self

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if self._x.shape[0] * X.shape[0] < _DEVICE_WORK_THRESHOLD:
            return _knn_predict_np(self._x, self._y, X, self.n_neighbors)
        out = _device_kernel(self._x.shape[0])(
            self._on_device(self._x),
            self._on_device(self._y),
            self._on_device(X),
            k=self.n_neighbors,
        )
        return out.cpu().numpy()


def _kfold_bounds(n: int, n_folds: int) -> list[tuple[int, int]]:
    """scikit-learn ``KFold(shuffle=False)`` contiguous fold boundaries."""
    sizes = np.full(n_folds, n // n_folds, dtype=int)
    sizes[: n % n_folds] += 1
    stops = np.cumsum(sizes)
    starts = stops - sizes
    return list(zip(starts.tolist(), stops.tolist()))


def grid_search_knn(
    X: np.ndarray,
    Y: np.ndarray,
    k_grid: list[int],
    n_folds: int = 3,
    *,
    device=None,
    dtype=None,
) -> int:
    """Pick ``k`` by k-fold CV on negative MSE (first-best on ties),
    replicating ``GridSearchCV(KNeighborsRegressor, cv=n_folds,
    scoring="neg_mean_squared_error")`` with deterministic contiguous folds.
    Past the work threshold every (fold, k) prediction runs on ``device``.
    """
    X = np.atleast_2d(np.asarray(X, dtype=float))
    Y = np.asarray(Y, dtype=float)
    if Y.ndim == 1:
        Y = Y[:, None]
    n = X.shape[0]
    scores = np.zeros((len(k_grid), n_folds))
    small = n * n < _DEVICE_WORK_THRESHOLD
    if not small:
        dev = resolve_device(device)
        dt = resolve_dtype(dev, dtype)
        X, Y = (torch.as_tensor(a, dtype=dt, device=dev) for a in (X, Y))
    for f, (lo, hi) in enumerate(_kfold_bounds(n, n_folds)):
        va_x, va_y = X[lo:hi], Y[lo:hi]
        if small:
            tr_x = np.concatenate([X[:lo], X[hi:]])
            tr_y = np.concatenate([Y[:lo], Y[hi:]])
            preds = _knn_predict_np_multi_k(tr_x, tr_y, va_x, k_grid)
            for ki, k in enumerate(k_grid):
                scores[ki, f] = -float(np.mean((preds[k] - va_y) ** 2))
        else:
            tr_x = torch.cat([X[:lo], X[hi:]])
            tr_y = torch.cat([Y[:lo], Y[hi:]])
            kernel = _device_kernel(tr_x.shape[0])
            for ki, k in enumerate(k_grid):
                pred = kernel(tr_x, tr_y, va_x, k=k)
                scores[ki, f] = -float(torch.mean((pred - va_y) ** 2))
    mean_scores = scores.mean(axis=1)
    return int(k_grid[int(np.argmax(mean_scores))])
