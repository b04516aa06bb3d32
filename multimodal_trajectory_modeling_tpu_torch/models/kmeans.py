"""The k-means labels of the multistart's first candidate, without
scikit-learn.

The JAX package computes them with one scikit-learn call,
``KMeans(n_clusters=C, init="k-means++", n_init=10,
random_state=seed).fit_predict(X)`` (``models/mixture.py:128-143``).
:func:`kmeans_labels` is a numpy counterpart of that call for dense float64
input, following scikit-learn's own algorithm (``sklearn/cluster/_kmeans.py``
and ``_k_means_lloyd.pyx``):

- the column means are subtracted from ``X``; the tolerance is
  ``_TOL`` = 1e-4 times the mean column variance;
- each of the ``n_init`` runs (default ``_N_INIT`` = 10) is seeded by
  greedy k-means++ with ``2 + int(log k)`` local trials, all runs drawing
  from one ``np.random.RandomState(seed)``;
- Lloyd iterations stop at identical labels, else when the squared center
  shift is within the tolerance, after at most ``_MAX_ITER`` = 300; empty
  clusters are relocated to the points farthest from their centers; a run
  that did not stop on identical labels ends with one more E step;
- the run of least inertia wins, unless its clustering equals the best so
  far up to a permutation of the labels.

It runs on the host (CPU) in float64, as scikit-learn does.  Distances are
formed as scikit-learn forms them (``‖c‖² − 2 x·c``, and ``‖x‖² + ‖c‖² −
2 x·c`` while seeding), so the labels agree with scikit-learn's up to ties
within round-off.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["kmeans_labels"]

# the values the replaced scikit-learn call runs with
_N_INIT = 10
_MAX_ITER = 300
_TOL = 1e-4


def _sq_distances(C: np.ndarray, X: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """``(k, n)`` squared distances of the rows of ``C`` to those of ``X``
    as scikit-learn's ``_euclidean_distances`` forms them, clipped at 0."""
    dist = -2 * (C @ X.T)
    dist += np.einsum("ij,ij->i", C, C)[:, None]
    dist += x_sq[None, :]
    np.maximum(dist, 0, out=dist)
    return dist


def _kmeans_plusplus(X, k, x_sq, rs) -> np.ndarray:
    """Greedy k-means++ seeding (``_kmeans.py:_kmeans_plusplus``)."""
    n = X.shape[0]
    weight = np.ones(n)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[rs.choice(n, p=weight / weight.sum())]
    closest = _sq_distances(centers[0:1], X, x_sq)
    pot = closest @ weight
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        cand = _sq_distances(X[ids], X, x_sq)
        np.minimum(closest, cand, out=cand)
        cand_pot = cand @ weight.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = cand[best]
        centers[c] = X[ids[best]]
    return centers


def _assign(X, centers):
    """Labels of the nearest center (first on ties), by ``‖c‖² − 2 x·c``
    formed in one GEMM (``alpha=-2``, ``beta=1``) as scikit-learn's Lloyd
    step does; torch's CPU GEMM and argmin run on all cores."""
    c_sq = torch.from_numpy(np.einsum("ij,ij->i", centers, centers))
    dist = torch.addmm(
        c_sq[None, :], torch.from_numpy(X), torch.from_numpy(centers).T, alpha=-2.0
    )
    return dist.argmin(dim=1).to(torch.int32).numpy()


def _lloyd_step(X, Xt, centers, k):
    """One Lloyd iteration: labels under ``centers``, the new centers
    (empty clusters relocated, ``_k_means_common.pyx``) and each center's
    shift.  ``Xt`` is ``X.T`` in contiguous rows, for the column sums."""
    labels = _assign(X, centers)
    weight = np.bincount(labels, minlength=k).astype(float)
    sums = np.stack([np.bincount(labels, weights=col, minlength=k) for col in Xt], axis=1)
    empty = np.flatnonzero(weight == 0)
    if empty.size:
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        if dist.max() != 0:
            far = np.argpartition(dist, -empty.size)[: -empty.size - 1 : -1]
            for new_id, idx in zip(empty, far):
                old_id = labels[idx]
                sums[old_id] -= X[idx]
                sums[new_id] = X[idx]
                weight[new_id] = 1.0
                weight[old_id] -= 1.0
    # in place and in order, as _average_centers does: a cluster still
    # empty takes the biggest cluster's row as it stands at that point
    biggest = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            sums[j] *= 1.0 / weight[j]
        else:
            sums[j] = sums[biggest]
    shift = np.sqrt(((sums - centers) ** 2).sum(axis=1))
    return labels, sums, shift


def _lloyd(X, centers, k, *, tol):
    """One k-means run from ``centers``: ``(labels, inertia)``."""
    labels_old = np.full(X.shape[0], -1, np.int32)
    Xt = np.ascontiguousarray(X.T)
    strict = False
    for _ in range(_MAX_ITER):
        labels, new, shift = _lloyd_step(X, Xt, centers, k)
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift**2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """Whether two labelings are equal up to a permutation of labels."""
    pairs = np.unique(a.astype(np.int64) * k + b)
    return np.unique(pairs // k).size == pairs.size


def kmeans_labels(
    X: np.ndarray,
    n_clusters: int,
    *,
    random_state: int,
    n_init: int = _N_INIT,
) -> np.ndarray:
    """``KMeans(n_clusters, init="k-means++", n_init=n_init,
    random_state=random_state).fit_predict(X)`` of scikit-learn, for dense
    ``X (n, p)``: int32 labels ``(n,)``.  ``n_init=1`` is the k-means start
    of scikit-learn's ``GaussianMixture(init_params="kmeans")``."""
    X = np.array(X, dtype=np.float64, order="C")
    if X.ndim != 2 or X.shape[0] < n_clusters:
        raise ValueError(
            f"X must be (n, p) with n >= n_clusters={n_clusters}, got {X.shape}"
        )
    if not np.isfinite(X).all():
        raise ValueError("X contains NaN or infinity")  # as scikit-learn
    tol = float(np.mean(np.var(X, axis=0)) * _TOL)
    X -= X.mean(axis=0)
    x_sq = np.einsum("ij,ij->i", X, X)
    rs = np.random.RandomState(random_state)
    best_labels, best_inertia = None, None
    for _ in range(n_init):
        centers = _kmeans_plusplus(X, n_clusters, x_sq, rs)
        labels, inertia = _lloyd(X, centers, n_clusters, tol=tol)
        if best_inertia is None or (
            inertia < best_inertia
            and not _same_clustering(labels, best_labels, n_clusters)
        ):
            best_labels, best_inertia = labels, inertia
    return best_labels
