"""Closed-form joint moments of a linear-Gaussian state-space model.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/moments.py``.
The latent process follows ``Z_t | Z_{t-1} ~ N(Z_{t-1} A, G)`` with
``Z_1 ~ N(m, S)``, observations ``X_t | Z_t ~ N(Z_t H, L)`` (row-vector
convention); the joint ``(Z_1..Z_T, X_1..X_T)`` is Gaussian, and this
module builds its mean and covariance.  The joint layout is
``[z_1, .., z_T, x_1, .., x_T]``.

Every function takes optional leading batch axes on its parameters (a
cluster axis ``C``), where the JAX package ``vmap``s a per-cluster
function; each ``lax.scan`` there is a Python loop over T here.
"""

from __future__ import annotations

import torch

__all__ = [
    "latent_means",
    "joint_mean",
    "observed_mean",
    "latent_cov_blocks",
    "latent_cov",
    "observed_cov",
    "joint_cov",
    "joint_moments",
    "observed_moments",
]


def latent_means(T: int, m: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``E[Z_t] = m A^{t-1}`` for t = 1..T: ``(..., T, d)``."""
    mus = [m]
    for _ in range(T - 1):
        mus.append((mus[-1][..., None, :] @ A)[..., 0, :])
    return torch.stack(mus, dim=-2)


def observed_mean(T: int, m, A, H) -> torch.Tensor:
    """Stacked mean of the observed process, ``(..., T·l)``."""
    mus = latent_means(T, m, A) @ H
    return mus.reshape(*mus.shape[:-2], -1)


def joint_mean(T: int, m, A, H) -> torch.Tensor:
    """Stacked mean of ``(Z_1..Z_T, X_1..X_T)``, ``(..., T·(d+l))``."""
    mus = latent_means(T, m, A)
    lead = mus.shape[:-2]
    return torch.cat(
        [mus.reshape(*lead, -1), (mus @ H).reshape(*lead, -1)], dim=-1
    )


def _variance_chain(T: int, S, A, G) -> torch.Tensor:
    """``Var(Z_t)`` for t = 1..T by ``V_{t+1} = G + Aᵀ V_t A``:
    ``(..., T, d, d)``."""
    Vs = [S]
    for _ in range(T - 1):
        Vs.append(G + A.mT @ Vs[-1] @ A)
    return torch.stack(Vs, dim=-3)


def latent_cov_blocks(T: int, S, A, G) -> torch.Tensor:
    """Blocks ``B[i, j] = Cov(Z_{i+1}, Z_{j+1})``, ``(..., T, T, d, d)``:
    ``Var(Z_i) A^{j-i}`` for j ≥ i, transposed below the diagonal."""
    Vs = _variance_chain(T, S, A, G)  # (..., T, d, d)
    Gk = [Vs]  # Gk[k][..., i] = Var(Z_i) A^k
    A_ = A[..., None, :, :]
    for _ in range(T - 1):
        Gk.append(Gk[-1] @ A_)
    Gk = torch.stack(Gk, dim=-4)  # (..., T_k, T_i, d, d)
    idx = torch.arange(T, device=S.device)
    ii, jj = torch.meshgrid(idx, idx, indexing="ij")
    B = Gk[..., (jj - ii).abs(), torch.minimum(ii, jj), :, :]
    lower = (jj < ii)[:, :, None, None]
    return torch.where(lower, B.mT, B)


def _blocks_to_matrix(B: torch.Tensor) -> torch.Tensor:
    """``(..., T1, T2, p, q)`` blocks → ``(..., T1·p, T2·q)`` matrix."""
    *lead, T1, T2, p, q = B.shape
    return B.transpose(-3, -2).reshape(*lead, T1 * p, T2 * q)


def latent_cov(T: int, S, A, G) -> torch.Tensor:
    """Full ``(..., T·d, T·d)`` covariance of the latent chain."""
    return _blocks_to_matrix(latent_cov_blocks(T, S, A, G))


def _xx_blocks(B, H, L, T):
    """``Cov(X_i, X_j) = Hᵀ Cov(Z_i, Z_j) H + δ_ij L`` blocks."""
    core = torch.einsum("...ka,...ijkl,...lb->...ijab", H, B, H)
    eye = torch.eye(T, dtype=B.dtype, device=B.device)[:, :, None, None]
    return core + eye * L[..., None, None, :, :]


def observed_cov(T: int, S, A, G, H, L) -> torch.Tensor:
    """Full ``(..., T·l, T·l)`` covariance of the observed process."""
    return _blocks_to_matrix(_xx_blocks(latent_cov_blocks(T, S, A, G), H, L, T))


def joint_cov(T: int, S, A, G, H, L) -> torch.Tensor:
    """Full ``(..., T·(d+l), T·(d+l))`` covariance of ``(Z, X)``: the ZZ,
    ZX and XX quadrants from one set of latent blocks."""
    B = latent_cov_blocks(T, S, A, G)
    CZZ = _blocks_to_matrix(B)
    CZX = _blocks_to_matrix(torch.einsum("...ijab,...bl->...ijal", B, H))
    CXX = _blocks_to_matrix(_xx_blocks(B, H, L, T))
    top = torch.cat([CZZ, CZX], dim=-1)
    bot = torch.cat([CZX.mT, CXX], dim=-1)
    return torch.cat([top, bot], dim=-2)


def joint_moments(T: int, m, S, A, G, H, L):
    """(mean, cov) of the stacked joint vector."""
    return joint_mean(T, m, A, H), joint_cov(T, S, A, G, H, L)


def observed_moments(T: int, m, S, A, G, H, L):
    """(mean, cov) of the stacked observed vector (states marginalized)."""
    return observed_mean(T, m, A, H), observed_cov(T, S, A, G, H, L)
