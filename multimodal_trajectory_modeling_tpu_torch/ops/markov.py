"""E-score weights of the O(T) Markov-factorized joint density.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/markov.py``
(``_chol_inv_logdet`` :59, ``markov_cluster_weights_grouped`` :73,
``markov_cluster_weights`` :128, ``markov_suffix_logliks`` :158,
``suffix_lengths`` :214, ``is_suffix_mask`` :220,
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

import numpy as np
import torch

__all__ = [
    "canonical_weights",
    "is_suffix_mask",
    "markov_cluster_weights",
    "markov_cluster_weights_grouped",
    "markov_em_feature_dim",
    "markov_em_weights",
    "markov_em_features",
    "markov_suffix_logliks",
    "suffix_lengths",
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


def markov_cluster_weights(
    m: torch.Tensor,  # (C, d)
    S: torch.Tensor,  # (C, d, d)
    A: torch.Tensor,  # (C, d, d)
    G: torch.Tensor,  # (C, d, d)
    H: torch.Tensor,  # (C, d, l)
    L: torch.Tensor,  # (C, l, l)
) -> torch.Tensor:
    """Stacked feature weights ``W (F, C)``, F = 4d² + l² + dl + d + 2, in
    the feature order of :func:`markov_suffix_logliks`: [Φ1 Σ z⊗z, Φ0
    z0⊗z0, Φ2 Σ vm⁺ z⊗z, Φc Σ z⊗z_next, Φx Σ x⊗x, Φxz Σ z⊗x, z0, len,
    1]."""
    d = m.shape[1]
    l = H.shape[-1]
    W1, W2, W3 = markov_cluster_weights_grouped(m, S, A, G, H, L)
    dd = d * d
    return torch.cat(
        [
            W1[:, :dd],  # Φ1
            W3[:, :dd],  # Φ0
            W2[:, :dd],  # Φ2
            W2[:, dd:],  # Φc
            W1[:, dd : dd + l * l],  # Φx
            W1[:, dd + l * l :],  # Φxz
            W3[:, dd:],  # z0, len, 1
        ],
        dim=1,
    ).T


def markov_suffix_logliks(
    z: torch.Tensor,  # (T, n, d) NaN beyond each row's length
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int observed prefix lengths
    W: torch.Tensor,  # (F, C) from markov_cluster_weights
) -> torch.Tensor:
    """``(C, n)`` joint log-densities in O(T) time and memory: the
    slice-pair features (each a sum over t of one coordinate product)
    against ``W``.  The dense masked-Gaussian values wherever each row's
    missingness is a pure suffix; rows with interior gaps are out of
    contract."""
    T, n, d = z.shape
    dtype = z.dtype
    zm = torch.where(torch.isfinite(z), z, 0.0)
    xm = torch.where(torch.isfinite(x), x, 0.0)
    tgrid = torch.arange(T, device=z.device)
    vm_next = (tgrid[:, None] + 1 < lens[None, :]).to(dtype)  # (T, n)
    zm_vmn = zm * vm_next[:, :, None]

    def pair(a, b):  # Σ_t a_t ⊗ b_t per row → (n, p·q)
        return torch.stack(
            [
                (a[:, :, i] * b[:, :, j]).sum(0)
                for i in range(a.shape[2])
                for j in range(b.shape[2])
            ],
            dim=1,
        )

    z0 = zm[0]
    feats = torch.cat(
        [
            pair(zm, zm),  # Φ1
            (z0[:, :, None] * z0[:, None, :]).reshape(n, -1),  # Φ0
            pair(zm_vmn, zm),  # Φ2
            pair(zm[:-1], zm[1:]),  # Φc
            pair(xm, xm),  # Φx
            pair(zm, xm),  # Φxz
            z0,
            lens.to(dtype)[:, None],
            torch.ones((n, 1), dtype=dtype, device=z.device),
        ],
        dim=1,
    )  # (n, F)
    return (feats @ W).T


def suffix_lengths(valid_t: torch.Tensor) -> torch.Tensor:
    """Per-row prefix length ``(n,) int32`` from a (T, n) validity mask;
    callers guarantee suffix structure (:func:`is_suffix_mask`)."""
    return valid_t.to(torch.int32).sum(dim=0, dtype=torch.int32)


def is_suffix_mask(valid_t) -> bool:
    """Whether every column of the (T, n) validity mask is a contiguous
    prefix of True, the contract of the O(T) factorized densities."""
    if isinstance(valid_t, torch.Tensor):
        valid_t = valid_t.cpu().numpy()
    v = np.asarray(valid_t, dtype=bool)
    lens = v.sum(axis=0)
    expect = np.arange(v.shape[0])[:, None] < lens[None, :]
    return bool(np.array_equal(v, expect))


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
    d = m.shape[1]
    l = H.shape[-1]
    return canonical_weights(*markov_cluster_weights_grouped(m, S, A, G, H, L), d=d, l=l)


def canonical_weights(
    W1: torch.Tensor, W2: torch.Tensor, W3: torch.Tensor, *, d: int, l: int
) -> torch.Tensor:
    """The grouped weights of :func:`markov_cluster_weights_grouped` (log π
    folded into ``W3[:, -1]`` or not) scattered into the g-layout ``(C,
    F)``, with no arithmetic: W1's z⊗z, x⊗x and z⊗x blocks to g1, g4 and
    g5, W2's two blocks to g2 and g3, W3 to g6, g10, len and 1, zeros on
    g7, g8 and g9."""
    C = W1.shape[0]
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
