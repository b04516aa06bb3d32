"""E-score weights of the O(T) Markov-factorized joint density.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/markov.py``
(``_chol_inv_logdet`` :59, ``markov_cluster_weights_grouped`` :73,
``markov_em_feature_dim`` :231, ``markov_em_weights`` :238,
``markov_em_features`` :270).

For suffix-only missingness the chain rule factorizes each cluster's joint
density over ``(z_{1:T}, x_{1:T})`` (``z_1 ~ N(m, S)``, ``z_{t+1} | z_t ~
N(z_t A, G)``, ``x_t | z_t ~ N(z_t H, L)``, row-vector convention) into a
dot product of per-instance, T-reduced features g with per-cluster
weights.  The weights come from Cholesky inverses of S, G and L; the
feature layout ("g-layout") is::

    [g1 Σ z⊗z, g2 Σ vm⁺ z⊗z, g3 Σ z⊗z_next, g4 Σ x⊗x, g5 Σ z⊗x,
     g6 z0⊗z0, g7 Σ vm⁺ z, g8 Σ z, g9 Σ x, g10 z0, g11 len, g12 1]

with ``vm⁺_t = [t + 1 < len]``.  g7-g9 feed only the M step and carry
zero score weight.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "markov_cluster_weights_grouped",
    "markov_em_feature_dim",
    "markov_em_weights",
    "markov_em_features",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _chol_inv_logdet(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched (C, k, k) -> (inverse, logdet) via Cholesky.  A matrix that
    is not positive definite gives NaN (JAX's ``cholesky`` does the same;
    torch's would raise)."""
    Lc, info = torch.linalg.cholesky_ex(M)
    Lc = torch.where((info == 0)[:, None, None], Lc, torch.nan)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    inv = torch.cholesky_solve(eye.expand_as(M), Lc)
    logdet = 2.0 * torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1)
    return inv, logdet


def markov_cluster_weights_grouped(
    m: torch.Tensor,  # (C, d)
    S: torch.Tensor,  # (C, d, d)
    A: torch.Tensor,  # (C, d, d)
    G: torch.Tensor,  # (C, d, d)
    H: torch.Tensor,  # (C, d, l)
    L: torch.Tensor,  # (C, l, l)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-mask-group feature weights:

    - ``W1 (C, d²+l²+dl)`` against per-step features [z⊗z, x⊗x, z⊗x]
    - ``W2 (C, 2d²)`` against vm_{t+1} features [z_t⊗z_t, z_t⊗z_{t+1}]
    - ``W3 (C, d²+d+2)`` against the end features [z_0⊗z_0, z_0, len, 1]
    """
    C, d = m.shape
    l = H.shape[-1]
    Sinv, ldS = _chol_inv_logdet(S)
    Ginv, ldG = _chol_inv_logdet(G)
    Linv, ldL = _chol_inv_logdet(L)

    HLH = torch.einsum("cda,cab,ceb->cde", H, Linv, H)  # H L⁻¹ Hᵀ
    AGA = torch.einsum("cda,cab,ceb->cde", A, Ginv, A)
    AG = torch.einsum("cda,cab->cdb", A, Ginv)  # A G⁻¹
    HL = torch.einsum("cda,cab->cdb", H, Linv)  # H L⁻¹
    Sm = torch.einsum("cab,cb->ca", Sinv, m)  # S⁻¹ m
    mSm = torch.einsum("ca,ca->c", m, Sm)

    W1 = torch.cat(
        [
            -0.5 * (HLH + Ginv).reshape(C, d * d),
            -0.5 * Linv.reshape(C, l * l),
            HL.reshape(C, d * l),
        ],
        dim=1,
    )
    W2 = torch.cat(
        [-0.5 * AGA.reshape(C, d * d), AG.reshape(C, d * d)], dim=1
    )
    w_len = (-0.5 * ((d + l) * _LOG_2PI + ldG + ldL))[:, None]
    w_one = (-0.5 * (ldS - ldG + mSm))[:, None]
    W3 = torch.cat(
        [-0.5 * (Sinv - Ginv).reshape(C, d * d), Sm, w_len, w_one], dim=1
    )
    return W1, W2, W3


def markov_em_feature_dim(d: int, l: int) -> int:
    """F, the length of the g-layout feature vector."""
    return 4 * d * d + l * l + d * l + 2 * d + l + d + 2


def markov_em_weights(
    m: torch.Tensor,
    S: torch.Tensor,
    A: torch.Tensor,
    G: torch.Tensor,
    H: torch.Tensor,
    L: torch.Tensor,
) -> torch.Tensor:
    """E-score weights over the g-layout: ``(C, F)`` with zeros on the
    M-only linear-sum slots (g7, g8, g9)."""
    C, d = m.shape
    l = H.shape[-1]
    W1, W2, W3 = markov_cluster_weights_grouped(m, S, A, G, H, L)
    dd = d * d
    zeros = torch.zeros((C, 2 * d + l), dtype=W1.dtype, device=W1.device)
    return torch.cat(
        [
            W1[:, :dd],  # g1
            W2[:, :dd],  # g2
            W2[:, dd:],  # g3
            W1[:, dd : dd + l * l],  # g4
            W1[:, dd + l * l :],  # g5
            W3[:, :dd],  # g6
            zeros,  # g7, g8, g9
            W3[:, dd : dd + d],  # g10 (S⁻¹m)
            W3[:, dd + d : dd + d + 1],  # g11 (len)
            W3[:, dd + d + 1 :],  # g12 (const)
        ],
        dim=1,
    )


def markov_em_features(
    z: torch.Tensor,  # (T, n, d) NaN beyond each row's length
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int32
) -> torch.Tensor:
    """Per-row g-layout feature matrix ``(n, F)``, straight from the
    definitions — the oracle the materialization kernel's plain version is
    held against in the tests."""
    T, n, d = z.shape
    dtype = z.dtype
    zm = torch.where(torch.isfinite(z), z, 0.0)
    xm = torch.where(torch.isfinite(x), x, 0.0)
    tgrid = torch.arange(T, device=z.device)
    vm_next = (tgrid[:, None] + 1 < lens[None, :]).to(dtype)  # (T, n)
    zm_vmn = zm * vm_next[:, :, None]

    def pair(a, b):  # Σ_t a_t ⊗ b_t per row → (n, p·q)
        return torch.einsum("tni,tnj->nij", a, b).reshape(n, -1)

    z0 = zm[0]
    return torch.cat(
        [
            pair(zm, zm),
            pair(zm_vmn, zm),
            pair(zm[:-1], zm[1:]),
            pair(xm, xm),
            pair(zm, xm),
            (z0[:, :, None] * z0[:, None, :]).reshape(n, -1),
            zm_vmn.sum(0),
            zm.sum(0),
            xm.sum(0),
            z0,
            lens.to(dtype)[:, None],
            torch.ones((n, 1), dtype=dtype, device=z.device),
        ],
        dim=1,
    )
