"""Per-cluster regression and moment solves of the M step.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/regression.py``:
``RegressionStats`` (:52), ``_psd_pinv_solve`` (:157), ``solve_regression``
(:171) in its four modes, ``MomentStats`` (:242) and
``mean_cov_from_stats`` (:263), and the statistics of the dense M step:
``weighted_regression_stats`` (:63), its time-batched (:91) and Gram
(:117) forms, ``masked_moment_stats`` (:250) and ``masked_mean_and_cov``
(:278), and the one-group ``regress`` (:220).  A row (or pair) with a
non-finite coordinate is dropped by a where-select, never by a multiply
with a 0/1 mask, so an ``inf`` cannot turn into NaN.  The rest is small
batched (C, p, p) linear algebra.

A failed factorization gives NaN, never an exception, as in JAX: a
degenerate cluster then ends the fit with the same status code in both
packages.  TF32 is never enabled here; the residual Gram below subtracts
moments much larger than its result and needs full-precision products.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "RegressionStats",
    "MomentStats",
    "masked_mean_and_cov",
    "masked_moment_stats",
    "mean_cov_from_stats",
    "regress",
    "solve_regression",
    "weighted_regression_stats",
    "weighted_regression_stats_gram",
    "weighted_regression_stats_timebatched",
]


class RegressionStats(NamedTuple):
    """Weighted sufficient statistics, one leading cluster axis ``C``."""

    xtx: torch.Tensor  # (C, p, p)
    xty: torch.Tensor  # (C, p, q)
    yty: torch.Tensor  # (C, q, q)
    sx: torch.Tensor  # (C, p)
    sy: torch.Tensor  # (C, q)
    count: torch.Tensor  # (C,)


class MomentStats(NamedTuple):
    """Additive first/second-moment statistics per cluster."""

    count: torch.Tensor  # (C,)
    s: torch.Tensor  # (C, d)   Σ w z
    ss: torch.Tensor  # (C, d, d)  Σ w z zᵀ


def weighted_regression_stats(
    X: torch.Tensor, Y: torch.Tensor, W: torch.Tensor
) -> RegressionStats:
    """Weighted sufficient statistics of the rows ``X (N, p)``, ``Y (N,
    q)`` under weights ``W (N, C)``; a row takes part only if every
    coordinate of ``[X_row, Y_row]`` is finite."""
    valid = torch.isfinite(X).all(-1) & torch.isfinite(Y).all(-1)
    Xc = torch.where(valid[:, None], X, 0.0)
    Yc = torch.where(valid[:, None], Y, 0.0)
    Wv = torch.where(valid[:, None], W, 0.0)
    return RegressionStats(
        xtx=torch.einsum("nc,ni,nj->cij", Wv, Xc, Xc),
        xty=torch.einsum("nc,ni,nj->cij", Wv, Xc, Yc),
        yty=torch.einsum("nc,ni,nj->cij", Wv, Yc, Yc),
        sx=Wv.T @ Xc,
        sy=Wv.T @ Yc,
        count=Wv.sum(0),
    )


def _valid_pairs(X, Y):
    """Per-(t, n) pair validity of ``X (T', n, p)``, ``Y (T', n, q)`` and
    both with the invalid pairs zeroed."""
    valid = torch.isfinite(X).all(-1) & torch.isfinite(Y).all(-1)  # (T', n)
    Xm = torch.where(valid[..., None], X, 0.0)
    Ym = torch.where(valid[..., None], Y, 0.0)
    return valid, Xm, Ym


def weighted_regression_stats_timebatched(
    X: torch.Tensor, Y: torch.Tensor, W: torch.Tensor
) -> RegressionStats:
    """Time-batched statistics: pairs ``X (T', n, p)``, ``Y (T', n, q)``
    under a per-instance weight ``W (n, C)`` at every step, the time axis
    contracted inside the sums."""
    valid, Xm, Ym = _valid_pairs(X, Y)
    return RegressionStats(
        xtx=torch.einsum("tni,tnj,nc->cij", Xm, Xm, W),
        xty=torch.einsum("tni,tnj,nc->cij", Xm, Ym, W),
        yty=torch.einsum("tni,tnj,nc->cij", Ym, Ym, W),
        sx=torch.einsum("tni,nc->ci", Xm, W),
        sy=torch.einsum("tni,nc->ci", Ym, W),
        count=torch.einsum("tn,nc->c", valid.to(W.dtype), W),
    )


def weighted_regression_stats_gram(
    X: torch.Tensor, Y: torch.Tensor, W: torch.Tensor
) -> RegressionStats:
    """:func:`weighted_regression_stats_timebatched` as one Gram sum: with
    ``U = [X_masked, Y_masked, valid]``, ``G = Σ_t Σ_n w_nc U Uᵀ`` holds
    every statistic in its (p, q, 1) blocks."""
    valid, Xm, Ym = _valid_pairs(X, Y)
    U = torch.cat([Xm, Ym, valid.to(W.dtype)[..., None]], dim=-1)  # (T', n, u)
    G = torch.einsum("tnu,tnv,nc->cuv", U, U, W)
    p, q = X.shape[-1], Y.shape[-1]
    return RegressionStats(
        xtx=G[:, :p, :p],
        xty=G[:, :p, p : p + q],
        yty=G[:, p : p + q, p : p + q],
        sx=G[:, -1, :p],
        sy=G[:, -1, p : p + q],
        count=G[:, -1, -1],
    )


def _nan_where(ok: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``X`` on the batch entries where ``ok`` (shape ``X.shape[:-2]``)
    holds, NaN elsewhere."""
    return torch.where(ok[..., None, None], X, torch.nan)


def _psd_pinv_solve(
    M: torch.Tensor, B: torch.Tensor, rcond: float
) -> torch.Tensor:
    """Solve ``M A = B`` for PSD ``M`` via an eigh-based pseudo-inverse:
    the min-norm solution of ``np.linalg.lstsq`` for singular ``M``.
    Batch entries of ``M`` that are not finite give NaN (torch's eigh
    would raise on them; JAX's returns NaN)."""
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    w, U = torch.linalg.eigh(torch.where(finite[..., None, None], M, eye))
    cutoff = rcond * w.abs().amax(dim=-1, keepdim=True)
    winv = torch.where(w > cutoff, 1.0 / w, torch.zeros_like(w))
    X = U @ (winv[..., None] * (U.mT @ B))
    return _nan_where(finite, X)


def solve_regression(
    stats: RegressionStats,
    *,
    mode: str = "lstsq",
    alpha: float = 0.0,
    eps: float = 1e-6,
    rcond: float = 1e-14,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Turn sufficient statistics into ``(A, S)`` per cluster.

    ``A`` is ``(C, p, q)``; ``S`` is the ddof-1 mean-centered residual
    covariance ``(C, q, q)``, as ``np.cov(Y - X A, rowvar=False)``.
    Modes: ``lstsq`` (min-norm), ``eps`` (``X^T X + eps I``, pinv),
    ``ridge`` (``X^T X + alpha I``, LU solve) and ``chol`` (``eps``-ridged
    normal equations through Cholesky)."""
    xtx, xty, yty, sx, sy, count = stats
    p = xtx.shape[-1]
    eye = torch.eye(p, dtype=xtx.dtype, device=xtx.device)
    if mode == "lstsq":
        A = _psd_pinv_solve(xtx, xty, rcond)
    elif mode == "eps":
        A = _psd_pinv_solve(xtx + eps * eye, xty, rcond)
    elif mode == "ridge":
        A, info = torch.linalg.solve_ex(xtx + alpha * eye, xty)
        A = _nan_where(info == 0, A)
    elif mode == "chol":
        Lc, info = torch.linalg.cholesky_ex(xtx + eps * eye)
        A = torch.cholesky_solve(xty, _nan_where(info == 0, Lc))
    else:
        raise ValueError(f"unknown mode {mode!r}")

    At = A.mT
    # the cancellation site of the M step: the residual Gram subtracts
    # moments ~1e4 times the result on wide-range data
    rtr = yty - At @ xty - xty.mT @ A + At @ xtx @ A
    sr = sy - torch.einsum("cp,cpq->cq", sx, A)  # Σ residual
    n = count[:, None, None]
    centered = rtr - sr[:, :, None] * sr[:, None, :] / n
    S = centered / (n - 1.0)
    return A, S


def mean_cov_from_stats(
    stats: MomentStats,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Finalize :class:`MomentStats` into (mean, ddof-1 covariance), as
    ``np.mean`` / ``np.cov(rowvar=False)`` over the kept rows."""
    count, s, ss = stats
    mean = s / count[:, None]
    centered = ss - count[:, None, None] * (
        mean[:, :, None] * mean[:, None, :]
    )
    cov = centered / (count[:, None, None] - 1.0)
    return mean, cov


def masked_moment_stats(Z: torch.Tensor, W: torch.Tensor) -> MomentStats:
    """Moments of the fully finite rows of ``Z (N, d)`` under weights
    ``W (N, C)``."""
    valid = torch.isfinite(Z).all(-1)
    Zc = torch.where(valid[:, None], Z, 0.0)
    Wv = torch.where(valid[:, None], W, 0.0)
    return MomentStats(
        count=Wv.sum(0),
        s=Wv.T @ Zc,
        ss=torch.einsum("nc,ni,nj->cij", Wv, Zc, Zc),
    )


def masked_mean_and_cov(
    Z: torch.Tensor, W: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster mean and ddof-1 covariance of the fully finite rows of
    ``Z`` under ``W``."""
    return mean_cov_from_stats(masked_moment_stats(Z, W))


def regress(
    X: torch.Tensor,
    Y: torch.Tensor,
    *,
    mode: str = "eps",
    alpha: float = 0.0,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The MLE of ``Y | X ~ N(X A, S)`` over the rows with no NaN, as one
    group: ``(A (p, q), S (q, q))`` in any mode of
    :func:`solve_regression`."""
    X = torch.atleast_2d(X)
    Y = torch.atleast_2d(Y)
    W = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    A, S = solve_regression(weighted_regression_stats(X, Y, W), mode=mode, alpha=alpha, eps=eps)
    return A[0], S[0]
