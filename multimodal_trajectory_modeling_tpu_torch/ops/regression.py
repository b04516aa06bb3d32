"""Per-cluster regression and moment solves of the M step.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/regression.py``:
``RegressionStats`` (:52), ``_psd_pinv_solve`` (:157), ``solve_regression``
(:171) in its four modes, ``MomentStats`` (:242) and
``mean_cov_from_stats`` (:263).  The statistics arrive already summed (by
the Markov EM kernel); what remains is small batched (C, p, p) linear
algebra in plain torch.

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
    "solve_regression",
    "mean_cov_from_stats",
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
