"""Masked (NaN-marginalizing) multivariate-normal log-densities.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/gaussian.py``.
For a finite-mask ``f`` the identity-padded matrix
``Σ' = (f fᵀ) ⊙ Σ + diag(1 − f)`` and the masked residual
``r = f ⊙ (x − μ)`` give ``logdet Σ' = logdet Σ_sub`` and
``rᵀ Σ'⁻¹ r = r_subᵀ Σ_sub⁻¹ r_sub``, so a row's log-density over its
finite coordinates needs no gather; an all-NaN row gives 0.

- :func:`masked_mvn_logpdf`: one factorization per row, the oracle;
- :func:`masked_mvn_logpdf_grouped`: one factorization per missingness
  pattern (``solve``, ``inverse``, ``bucketed``, ``auto``).

A failed factorization gives NaN, never an exception, as in JAX
(``cholesky_ex`` / ``solve_ex``: torch raises where JAX returns NaN).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "masked_identity_pad",
    "masked_mvn_logpdf",
    "masked_mvn_logpdf_grouped",
    "mvn_logpdf",
    "pattern_groups",
]

_LOG_2PI = math.log(2.0 * math.pi)
_SOLVE_ELEMENTS = 1 << 27  # the most (P, D, rows) elements one "solve" chunk holds


def masked_identity_pad(cov: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``(f fᵀ) ⊙ Σ + diag(1 − f)`` for a float 0/1 mask ``f`` (..., D)."""
    D = cov.shape[-1]
    eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
    return cov * (f[..., :, None] * f[..., None, :]) + eye * (1.0 - f[..., None, :])


def cholesky_nan(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of ``M``; NaN where the
    factorization fails (JAX's ``cholesky``)."""
    Lc, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], Lc, torch.nan)


def _logdet_from_chol(Lc: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1)


def masked_mvn_logpdf(
    x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor, *, method: str = "lu"
) -> torch.Tensor:
    """Per-row Gaussian log-density ``(n,)`` of ``x (n, D)`` with
    non-finite coordinates marginalized; ``method`` is ``"lu"``
    (slogdet/solve: an indefinite sub-block gives NaN) or ``"cholesky"``."""
    x = torch.atleast_2d(x)
    finite = torch.isfinite(x)
    f = finite.to(cov.dtype)
    r = torch.where(finite, x - mean, 0.0)  # (n, D)
    covm = masked_identity_pad(cov, f)  # (n, D, D)
    k = f.sum(-1)
    if method == "lu":
        sign, logabsdet = torch.linalg.slogdet(covm)
        logdet = torch.where(sign > 0, logabsdet, torch.nan)
        sol, info = torch.linalg.solve_ex(covm, r[..., None])
        q = (r[..., None, :] @ sol)[..., 0, 0]
        q = torch.where(info == 0, q, torch.nan)
    elif method == "cholesky":
        Lc = cholesky_nan(covm)
        y = torch.linalg.solve_triangular(Lc, r[..., None], upper=False)[..., 0]
        logdet = _logdet_from_chol(Lc)
        q = (y * y).sum(-1)
    else:
        raise ValueError(f"unknown method {method!r}")
    return -0.5 * (k * _LOG_2PI + logdet + q)


def mvn_logpdf(x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Dense (no-missing-data) Gaussian log-density of the rows of ``x``:
    one Cholesky, one triangular solve over all rows."""
    x = torch.atleast_2d(x)
    D = x.shape[-1]
    Lc = cholesky_nan(cov)
    y = torch.linalg.solve_triangular(Lc, (x - mean).T, upper=False)  # (D, n)
    return -0.5 * (D * _LOG_2PI + _logdet_from_chol(Lc) + (y * y).sum(0))


def pattern_groups(x) -> tuple[np.ndarray, np.ndarray]:
    """Group the rows of ``x`` (numpy, host) by missingness pattern:
    ``(patterns (P, D) bool, pattern_id (n,) int32)`` with
    ``patterns[pattern_id[i]] == isfinite(x[i])``, patterns in
    ``np.unique(..., axis=0)`` order.  Each row's mask is packed into
    bytes, most significant bit first, so the bytes sort as the rows do,
    and one sort of short keys replaces ``np.unique``'s sort of whole
    boolean rows, which dominated the dense route's set-up at n=1e6."""
    fin = np.isfinite(np.atleast_2d(np.asarray(x)))
    # contiguous rows for the void view (a strided x gives strided bits)
    packed = np.ascontiguousarray(np.packbits(fin, axis=1))
    keys = packed.view(np.dtype((np.void, packed.shape[1]))).ravel()
    _keys, first, pattern_id = np.unique(keys, return_index=True, return_inverse=True)
    return fin[first], pattern_id.astype(np.int32).reshape(-1)


def masked_mvn_logpdf_grouped(
    x: torch.Tensor,
    mean: torch.Tensor,
    cov: torch.Tensor,
    patterns: torch.Tensor,
    pattern_id: torch.Tensor,
    *,
    method: str = "auto",
) -> torch.Tensor:
    """Pattern-grouped masked log-density ``(n,)``: one identity-padded
    Cholesky per pattern, then per row

    - ``"solve"``: triangular solves against every pattern's factor, each
      row taking its own pattern's result;
    - ``"inverse"``: per-pattern inverses, ``rowsum((r Σ'⁻¹) ⊙ r)``;
    - ``"bucketed"``: per-pattern inverses, each row contracted only with
      its own pattern's (chunks of 4096 rows);
    - ``"auto"``: ``"solve"`` while ``P ≤ max(8, D)``, else ``"bucketed"``.
    """
    x = torch.atleast_2d(x)
    n, D = x.shape
    P = patterns.shape[0]
    if method == "auto":
        method = "solve" if P <= max(8, D) else "bucketed"
    f = patterns.to(cov.dtype)  # (P, D)
    k = f.sum(-1)  # (P,)
    Lc = cholesky_nan(masked_identity_pad(cov, f))  # (P, D, D)
    logdet = _logdet_from_chol(Lc)  # (P,)
    r = torch.where(torch.isfinite(x), x - mean, 0.0)  # (n, D)
    pid = pattern_id.long()

    if method in ("bucketed", "inverse"):
        eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
        inv = torch.cholesky_solve(eye.expand(P, D, D), Lc)  # (P, D, D)
        if method == "inverse":
            q_all = torch.einsum("nd,pde,ne->np", r, inv, r)
            q = q_all.gather(1, pid[:, None])[:, 0]
        else:
            B = min(4096, n)
            q = torch.cat([
                torch.einsum("nd,nde,ne->n", r[i : i + B], inv[pid[i : i + B]], r[i : i + B])
                for i in range(0, n, B)
            ])
    elif method == "solve":
        # rows in chunks, so that the (P, D, rows) solves stay within
        # _SOLVE_ELEMENTS (whole, they take 12.8 GB in float32 at P=40,
        # D=80, n=1e6); each row's result does not depend on the chunking
        B = max(1, _SOLVE_ELEMENTS // (P * D))
        parts = []
        for i in range(0, max(n, 1), B):
            y = torch.linalg.solve_triangular(Lc, r[i : i + B].T[None], upper=False)  # (P, D, B)
            parts.append((y * y).sum(1).gather(0, pid[None, i : i + B])[0])
        q = torch.cat(parts)
    else:
        raise ValueError(f"unknown method {method!r}")
    return -0.5 * (k[pid] * _LOG_2PI + logdet[pid] + q)
