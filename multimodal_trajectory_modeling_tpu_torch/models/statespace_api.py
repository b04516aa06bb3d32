"""Function-level API of the marginalizable state-space layer.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/statespace_api.py``:
numpy in, numpy out, under the reference's module-level names and
signatures (the Greek keywords ``Γ`` and ``Λ`` kept), so that code written
against the reference's ``statespace`` module runs unchanged.  Every
function that computes takes keyword-only ``device=`` (default the card)
and ``dtype=`` (default float64 on the CPU, float32 on CUDA), resolved by
:mod:`..device`; they replace the JAX module's global x64 flag (``_dt``).

- The moments (``mmZ`` … ``CC``) go through :mod:`..ops.moments`.
- ``full_marginalizable_log_prob`` and the reference's hot kernel
  ``multivariate_normal_log_likelihood`` group the rows by missingness
  pattern and go through ``em._masked_logliks`` with one cluster: kernel
  K12 on the card, the grouped form on the CPU (the JAX package's
  ``masked_mvn_logpdf_grouped``).
- ``hidden_log_prob``, ``observed_log_prob`` and
  ``marginalizable_gaussian_log_prob`` take the per-row masked form;
  ``full_log_prob`` and the ``composite_*`` functions the dense form, the
  latter one time step at a time.
- The samplers are numpy on the host: the same ``Generator`` gives the
  same draws as the JAX module's, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.models import em
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu_torch.ops import moments as jmom

__all__ = [
    "mmZ",
    "mmX",
    "mm",
    "CZZ",
    "CZX",
    "CXX",
    "CC",
    "full_log_prob",
    "composite_log_prob",
    "hidden_log_prob",
    "composite_hidden_log_prob",
    "observed_log_prob",
    "full_marginalizable_log_prob",
    "multivariate_normal_log_likelihood",
    "marginalizable_gaussian_log_prob",
    "sample_trajectory",
    "sample_nonlinear_nongaussian_trajectory",
]


def _ctx(device, dtype):
    dev = resolve_device(device)
    return dev, resolve_dtype(dev, dtype)


def _t(a, ctx):
    dev, dt = ctx
    return torch.tensor(np.asarray(a, dtype=float), dtype=dt, device=dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def mmZ(T: int, m, A, *, device=None, dtype=None) -> np.ndarray:
    """Stacked latent mean (reference statespace:294-314)."""
    ctx = _ctx(device, dtype)
    A = np.atleast_2d(A)
    m = np.atleast_1d(m)
    return _np(jmom.latent_means(T, _t(m, ctx), _t(A, ctx))).ravel()


def mmX(T: int, m, A, H, *, device=None, dtype=None) -> np.ndarray:
    """Stacked observed mean (reference statespace:317-339)."""
    ctx = _ctx(device, dtype)
    A, H = map(np.atleast_2d, (A, H))
    m = np.atleast_1d(m)
    return _np(jmom.observed_mean(T, _t(m, ctx), _t(A, ctx), _t(H, ctx)))


def mm(T: int, m, A, H, *, device=None, dtype=None) -> np.ndarray:
    """Stacked joint mean (reference statespace:342-364)."""
    ctx = _ctx(device, dtype)
    A, H = map(np.atleast_2d, (A, H))
    m = np.atleast_1d(m)
    return _np(jmom.joint_mean(T, _t(m, ctx), _t(A, ctx), _t(H, ctx)))


def CZZ(T: int, S, A, Γ, *, device=None, dtype=None) -> np.ndarray:
    """Latent-chain covariance (reference statespace:108-133)."""
    ctx = _ctx(device, dtype)
    S, A, Γ = (_t(a, ctx) for a in map(np.atleast_2d, (S, A, Γ)))
    return _np(jmom.latent_cov(T, S, A, Γ))


def CZX(T: int, S, A, Γ, H, *, device=None, dtype=None) -> np.ndarray:
    """Latent-observed cross covariance (reference ``_CZX``,
    statespace:136-166)."""
    ctx = _ctx(device, dtype)
    S, A, Γ, H = (_t(a, ctx) for a in map(np.atleast_2d, (S, A, Γ, H)))
    blocks = jmom.latent_cov_blocks(T, S, A, Γ)
    czx = torch.einsum("ijab,bl->ijal", blocks, H)
    Tn, _, d, l = czx.shape
    return _np(czx.permute(0, 2, 1, 3).reshape(Tn * d, Tn * l))


def CXX(T: int, S, A, Γ, H, Λ, *, device=None, dtype=None) -> np.ndarray:
    """Observed-process covariance (reference statespace:225-256)."""
    ctx = _ctx(device, dtype)
    S, A, Γ, H, Λ = (_t(a, ctx) for a in map(np.atleast_2d, (S, A, Γ, H, Λ)))
    return _np(jmom.observed_cov(T, S, A, Γ, H, Λ))


def CC(T: int, S, A, Γ, H, Λ, *, device=None, dtype=None) -> np.ndarray:
    """Full joint covariance (reference statespace:259-291)."""
    ctx = _ctx(device, dtype)
    S, A, Γ, H, Λ = (_t(a, ctx) for a in map(np.atleast_2d, (S, A, Γ, H, Λ)))
    return _np(jmom.joint_cov(T, S, A, Γ, H, Λ))


def _pack(z, x):
    z, x = map(np.atleast_3d, (z, x))
    n = z.shape[1]
    return np.concatenate(
        [
            z.transpose(1, 0, 2).reshape(n, -1),
            x.transpose(1, 0, 2).reshape(n, -1),
        ],
        axis=1,
    )


def _grouped_log_prob(v, mean, cov, ctx) -> torch.Tensor:
    """Per-row masked log-density of the rows of ``v`` (numpy) under one
    Gaussian, the rows grouped by pattern: K12 on the card, the grouped
    form on the CPU."""
    patterns, pid = gops.pattern_groups(v)
    dev = ctx[0]
    return em._masked_logliks(
        _t(mean, ctx)[None],
        _t(cov, ctx)[None],
        _t(v, ctx),
        torch.as_tensor(patterns, device=dev),
        torch.as_tensor(pid, device=dev),
        "auto",
    )[0]


def full_log_prob(z, x, T, m, S, A, Γ, H, Λ, *, device=None, dtype=None) -> np.ndarray:
    """Joint log-pdf via analytic moments (reference statespace:367-426)."""
    ctx = _ctx(device, dtype)
    kw = dict(device=device, dtype=dtype)
    mean, cov = mm(T, m, A, H, **kw), CC(T, S, A, Γ, H, Λ, **kw)
    return _np(gops.mvn_logpdf(_t(_pack(z, x), ctx), _t(mean, ctx), _t(cov, ctx)))


def composite_log_prob(z, x, T, m, S, A, Γ, H, Λ, *, device=None, dtype=None) -> np.ndarray:
    """Joint log-pdf via the generative factorization (reference
    statespace:429-496)."""
    ctx = _ctx(device, dtype)
    z, x = map(np.atleast_3d, (z, x))
    S, A, Γ, H, Λ = map(np.atleast_2d, (S, A, Γ, H, Λ))
    m = np.atleast_1d(m)
    lp = _np(gops.mvn_logpdf(_t(z[0], ctx), _t(m, ctx), _t(S, ctx)))
    zero_d = _t(np.zeros(A.shape[0]), ctx)
    zero_l = _t(np.zeros(Λ.shape[0]), ctx)
    for t in range(T - 1):
        lp = lp + _np(gops.mvn_logpdf(_t(z[t + 1] - z[t] @ A, ctx), zero_d, _t(Γ, ctx)))
    for t in range(T):
        lp = lp + _np(gops.mvn_logpdf(_t(x[t] - z[t] @ H, ctx), zero_l, _t(Λ, ctx)))
    return lp


def hidden_log_prob(z, T, m, S, A, Γ, *, device=None, dtype=None) -> np.ndarray:
    """Latent-chain log-pdf via analytic moments (reference
    statespace:499-540)."""
    ctx = _ctx(device, dtype)
    kw = dict(device=device, dtype=dtype)
    z = np.atleast_3d(z)
    n = z.shape[1]
    v = z.transpose(1, 0, 2).reshape(n, -1)
    return _np(gops.masked_mvn_logpdf(
        _t(v, ctx), _t(mmZ(T, m, A, **kw), ctx), _t(CZZ(T, S, A, Γ, **kw), ctx)
    ))


def composite_hidden_log_prob(z, T, m, S, A, Γ, *, device=None, dtype=None) -> np.ndarray:
    """Latent-chain log-pdf via factorization (reference statespace:543-594).
    """
    ctx = _ctx(device, dtype)
    z = np.atleast_3d(z)
    S, A, Γ = map(np.atleast_2d, (S, A, Γ))
    m = np.atleast_1d(m)
    lp = _np(gops.mvn_logpdf(_t(z[0], ctx), _t(m, ctx), _t(S, ctx)))
    zero_d = _t(np.zeros(A.shape[0]), ctx)
    for t in range(T - 1):
        lp = lp + _np(gops.mvn_logpdf(_t(z[t + 1] - z[t] @ A, ctx), zero_d, _t(Γ, ctx)))
    return lp


def observed_log_prob(x, T, m, S, A, Γ, H, Λ, *, device=None, dtype=None) -> np.ndarray:
    """Observed-process log-pdf, hidden states marginalized analytically
    (reference statespace:597-651)."""
    ctx = _ctx(device, dtype)
    kw = dict(device=device, dtype=dtype)
    x = np.atleast_3d(x)
    n = x.shape[1]
    v = x.transpose(1, 0, 2).reshape(n, -1)
    return _np(gops.masked_mvn_logpdf(
        _t(v, ctx), _t(mmX(T, m, A, H, **kw), ctx), _t(CXX(T, S, A, Γ, H, Λ, **kw), ctx)
    ))


def full_marginalizable_log_prob(z, x, T, m, S, A, Γ, H, Λ, *, device=None, dtype=None) -> np.ndarray:
    """Joint log-pdf with per-instance exact marginalization of non-finite
    coordinates (reference statespace:654-725): K12 on the card."""
    ctx = _ctx(device, dtype)
    kw = dict(device=device, dtype=dtype)
    mean, cov = mm(T, m, A, H, **kw), CC(T, S, A, Γ, H, Λ, **kw)
    return _np(_grouped_log_prob(_pack(z, x), mean, cov, ctx))


def multivariate_normal_log_likelihood(x, μ, Σ, p=None, *, device=None, dtype=None) -> np.ndarray:
    """The reference hot kernel (statespace:728-773): per-row masked Gaussian
    log-likelihood, K12 on the card.  ``p`` (the guvectorize output buffer)
    is accepted for signature compatibility; it is filled and returned."""
    ctx = _ctx(device, dtype)
    x = np.atleast_2d(np.asarray(x, dtype=float))
    Σ = np.atleast_2d(Σ)
    μ = np.atleast_1d(μ)
    out = np.asarray(_np(_grouped_log_prob(x, μ, Σ, ctx)), dtype=float)
    if p is not None:
        np.asarray(p)[...] = out
    return out


def marginalizable_gaussian_log_prob(x, μ=None, Σ=None, *, device=None, dtype=None) -> np.ndarray:
    """Masked Gaussian log-pdf with identity/zero defaults (reference
    statespace:908-943), one factorization per row."""
    ctx = _ctx(device, dtype)
    x = np.atleast_2d(np.asarray(x, dtype=float))
    d = x.shape[1]
    μ = np.zeros(d) if μ is None else np.atleast_1d(μ)
    Σ = np.eye(d) if Σ is None else np.atleast_2d(Σ)
    return np.asarray(
        _np(gops.masked_mvn_logpdf(_t(x, ctx), _t(μ, ctx), _t(Σ, ctx))), dtype=float
    )


def sample_trajectory(
    n: int,
    T: int,
    m,
    S,
    A,
    Γ,
    H,
    Λ,
    rng: np.random.Generator = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side LG-SSM sampler matching the reference's signature
    (statespace:776-836); uses a NumPy Generator for reproducibility."""
    if rng is None:
        rng = np.random.default_rng(42)
    S, A, Γ, H, Λ = map(np.atleast_2d, (S, A, Γ, H, Λ))
    m = np.atleast_1d(m)
    d, l = A.shape[0], H.shape[1]
    z = np.zeros((T, n, d))
    x = np.zeros((T, n, l))
    z[0] = rng.multivariate_normal(m, S, size=n)
    x[0] = z[0] @ H + rng.multivariate_normal(np.zeros(l), Λ, size=n)
    for t in range(T - 1):
        z[t + 1] = z[t] @ A + rng.multivariate_normal(np.zeros(d), Γ, size=n)
        x[t + 1] = z[t + 1] @ H + rng.multivariate_normal(
            np.zeros(l), Λ, size=n
        )
    return z, x


def sample_nonlinear_nongaussian_trajectory(
    n: int,
    dz: int,
    dx: int,
    T: int,
    m,
    f,
    Γ,
    h,
    Λ,
    rng: np.random.Generator = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side nonlinear/non-Gaussian sampler (reference
    statespace:839-905): ``m``/``Γ``/``Λ`` are callables (size, rng) →
    samples, ``f``/``h`` map single latent vectors."""
    if rng is None:
        rng = np.random.default_rng(42)
    z = np.zeros((T, n, dz))
    x = np.zeros((T, n, dx))
    z[0] = m(n, rng)
    x[0] = np.apply_along_axis(h, -1, z[0]) + Λ(n, rng)
    for t in range(T - 1):
        z[t + 1] = np.apply_along_axis(f, -1, z[t]) + Γ(n, rng)
        x[t + 1] = np.apply_along_axis(h, -1, z[t + 1]) + Λ(n, rng)
    return z, x
