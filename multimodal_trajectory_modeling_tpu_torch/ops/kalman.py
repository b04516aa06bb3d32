"""O(T) Kalman filters of the LG-SSM in plain torch: the suffix filter of
the observations and the exact masked filter under any per-coordinate
missingness.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/kalman.py``:
``kalman_filter_covs`` (:51), ``kalman_observed_logliks`` (:85), the
unrolled list algebra ``_list_chol`` (:169), ``_fwd_solve`` (:198),
``_bwd_solve`` (:209), ``_tri_pack`` (:220), ``_tri_unpack`` (:226), the
masked filter steps ``masked_filter_step`` (:240, the combined form),
``_masked_gauss_update`` (:360), ``_seq_z_conditioning`` (:420) and
``masked_filter_step_split`` (:475, the production step), and
``kalman_masked_logliks`` (:547).

The step functions work on "lanes": every state entry is a tensor, every
model parameter a scalar or a tensor that broadcasts against the lanes.
:func:`kalman_masked_logliks` runs all clusters at once on ``(C, n)``
lanes with ``(C, 1)`` parameters, each element computed by the same
operations as the JAX package's per-cluster ``vmap``.  Kernel K7
(``csrc/masked_kalman.cu``, wrapper :mod:`.kalman_kernels`) runs the same
step per thread.

Masked coordinates are zeroed by ``where``-selects, never by a multiply
with the 0/1 mask: ``0 · inf`` is NaN, and an expansive transition can
overflow the state across a long unobserved tail in float32 while the
observed prefix's log-density stays finite.

Row-vector convention: ``z' = z A + w``, ``x = z H + v``.
"""

from __future__ import annotations

import math

import torch

from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops

_LOG_2PI = math.log(2.0 * math.pi)

__all__ = [
    "kalman_filter_covs",
    "kalman_masked_logliks",
    "kalman_observed_logliks",
    "masked_filter_scan",
    "masked_filter_step",
    "masked_filter_step_split",
]


def kalman_filter_covs(
    S: torch.Tensor,  # (d, d) initial state covariance
    A: torch.Tensor,  # (d, d) row-form transition
    G: torch.Tensor,  # (d, d) transition covariance
    H: torch.Tensor,  # (d, l) row-form observation map
    L: torch.Tensor,  # (l, l) observation covariance
    T: int,
):
    """The data-independent filter quantities of one cluster for t = 1..T:
    ``(K (T, d, l), Sinv (T, l, l), logdet (T,))``, the gains, innovation
    inverses and log-determinants.  A failed factorization gives NaN."""
    eye = torch.eye(L.shape[0], dtype=S.dtype, device=S.device)
    P = S
    Ks, Sinvs, logdets = [], [], []
    for _ in range(T):
        Sin = H.T @ P @ H + L
        Lc = gops.cholesky_nan(Sin)
        Sinv = torch.cholesky_solve(eye, Lc)
        logdets.append(2.0 * torch.log(torch.diagonal(Lc)).sum())
        K = P @ H @ Sinv
        P_post = P - K @ H.T @ P
        P_next = A.T @ P_post @ A + G
        P = 0.5 * (P_next + P_next.T)
        Ks.append(K)
        Sinvs.append(Sinv)
    return torch.stack(Ks), torch.stack(Sinvs), torch.stack(logdets)


def kalman_observed_logliks(
    x: torch.Tensor,  # (T, n, l) NaN beyond each row's length
    lens: torch.Tensor,  # (n,) int observed prefix lengths
    m: torch.Tensor,  # (C, d)
    S: torch.Tensor,  # (C, d, d)
    A: torch.Tensor,  # (C, d, d)
    G: torch.Tensor,  # (C, d, d)
    H: torch.Tensor,  # (C, d, l)
    L: torch.Tensor,  # (C, l, l)
) -> torch.Tensor:
    """``(C, n)`` marginal log-densities ``log p(x_{1:len_i})`` per
    cluster under suffix missingness, by the prediction-error
    decomposition: the covariance recursion per cluster
    (:func:`kalman_filter_covs`), then the mean/innovation recursion over
    all rows."""
    T, n, l = x.shape
    dtype = torch.promote_types(x.dtype, m.dtype)
    x = x.to(dtype)
    m, S, A, G, H, L = (a.to(dtype) for a in (m, S, A, G, H, L))
    xm = torch.where(torch.isfinite(x), x, 0.0)
    vm = torch.arange(T, device=x.device)[:, None] < lens[None, :]  # (T, n)
    out = []
    for mc, Sc, Ac, Gc, Hc, Lc in zip(m, S, A, G, H, L):
        K, Sinv, logdet = kalman_filter_covs(Sc, Ac, Gc, Hc, Lc, T)
        mu = mc[None, :].expand(n, mc.shape[0])
        ll = torch.zeros((n,), dtype=dtype, device=x.device)
        for t in range(T):
            e = xm[t] - mu @ Hc  # (n, l) innovation
            quad = torch.einsum("nl,lk,nk->n", e, Sinv[t], e)
            # select before adding: a masked step's overflowed mu would
            # otherwise give 0·inf = NaN
            ll = ll + torch.where(
                vm[t], -0.5 * (l * _LOG_2PI + logdet[t] + quad), 0.0
            )
            mu_post = mu + e @ K[t].T
            mu = torch.where(vm[t][:, None], mu_post @ Ac, mu)
        out.append(ll)
    return torch.stack(out)


# ----------------------------------------------------------------------
# unrolled list algebra on lanes
# ----------------------------------------------------------------------


def _list_chol(Smat, D):
    """Unrolled Cholesky of a D×D matrix of lanes (lower triangle read):
    ``(L, invd)`` with ``invd[j] = 1/L[j][j]`` from one ``rsqrt`` per
    column, so the triangular solves need no division."""
    L = [[None] * D for _ in range(D)]
    invd = [None] * D
    for j in range(D):
        s = Smat[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        inv = torch.rsqrt(s)
        L[j][j] = s * inv
        invd[j] = inv
        for i in range(j + 1, D):
            t = Smat[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv
    return L, invd


def _fwd_solve(L, invd, b, D):
    """Solve ``L w = b`` (lower, unrolled)."""
    w = []
    for i in range(D):
        t = b[i]
        for k in range(i):
            t = t - L[i][k] * w[k]
        w.append(t * invd[i])
    return w


def _bwd_solve(L, invd, y, D):
    """Solve ``Lᵀ x = y`` (unrolled)."""
    x = [None] * D
    for i in reversed(range(D)):
        t = y[i]
        for k in range(i + 1, D):
            t = t - L[k][i] * x[k]
        x[i] = t * invd[i]
    return x


def _tri_pack(P, d):
    """Nested d×d list → row-major lower-triangle list (d(d+1)/2)."""
    return [P[i][j] for i in range(d) for j in range(i + 1)]


def _tri_unpack(tri, d):
    """Lower-triangle list → nested d×d list, the upper triangle the same
    objects as the lower (symmetric by construction)."""
    P = [[None] * d for _ in range(d)]
    k = 0
    for i in range(d):
        for j in range(i + 1):
            P[i][j] = tri[k]
            P[j][i] = tri[k]
            k += 1
    return P


def _msk(o, v):
    """``v`` where the 0/1 mask ``o`` is set, else 0 (a select)."""
    return torch.where(o > 0, v, 0.0)


def _msk2(oa, ob, v):
    return torch.where((oa > 0) & (ob > 0), v, 0.0)


def masked_filter_step(mu, P, z_t, x_t, oz_t, ox_t, Hs, As, Gs, Ls, d: int, l: int):
    """One partial-observation filter step with the combined (d+l)-dim
    observation ``[z_t, x_t]``: ``(mu_next, P_next, ll_delta)``.  Missing
    coordinates are decoupled by zeroing their innovation rows/columns and
    planting unit dummy variances; only observed coordinates count in the
    2π term.  ``mu`` (d), ``P`` (d×d nested), ``z_t``/``oz_t`` (d) and
    ``x_t``/``ox_t`` (l) are lists of lanes; ``Hs``/``As``/``Gs``/``Ls``
    nested lists of parameters.  No production caller: the split step is
    held against it."""
    D = d + l
    ozr, oxr = list(oz_t), list(ox_t)
    PH = [[sum(P[i][k] * Hs[k][b] for k in range(d)) for b in range(l)] for i in range(d)]
    HPH = [[sum(Hs[k][a] * PH[k][b] for k in range(d)) for b in range(l)] for a in range(l)]
    Sig = [[None] * D for _ in range(D)]
    for a_ in range(d):
        for b_ in range(d):
            Sig[a_][b_] = _msk2(ozr[a_], ozr[b_], P[a_][b_])
        Sig[a_][a_] = Sig[a_][a_] + (1.0 - ozr[a_])
    for a_ in range(d):
        for b_ in range(l):
            v = _msk2(ozr[a_], oxr[b_], PH[a_][b_])
            Sig[a_][d + b_] = v
            Sig[d + b_][a_] = v
    for a_ in range(l):
        for b_ in range(l):
            Sig[d + a_][d + b_] = _msk2(oxr[a_], oxr[b_], HPH[a_][b_] + Ls[a_][b_])
        Sig[d + a_][d + a_] = Sig[d + a_][d + a_] + (1.0 - oxr[a_])

    mux = [sum(mu[i] * Hs[i][b] for i in range(d)) for b in range(l)]
    e = [_msk(ozr[a_], z_t[a_] - mu[a_]) for a_ in range(d)] + [
        _msk(oxr[b_], x_t[b_] - mux[b_]) for b_ in range(l)
    ]

    Lch, invd = _list_chol(Sig, D)
    w = _fwd_solve(Lch, invd, e, D)
    logdet = sum(torch.log(Lch[i][i]) for i in range(D)) * 2.0
    quad = sum(wi * wi for wi in w)
    nobs = sum(ozr) + sum(oxr)
    ll_delta = -0.5 * (logdet + quad + nobs * _LOG_2PI)

    PM = [
        [_msk(ozr[a_], P[i][a_]) for a_ in range(d)]
        + [_msk(oxr[b_], PH[i][b_]) for b_ in range(l)]
        for i in range(d)
    ]
    K = []
    for i in range(d):
        yi = _fwd_solve(Lch, invd, PM[i], D)
        K.append(_bwd_solve(Lch, invd, yi, D))
    mu_post = [mu[i] + sum(e[a_] * K[i][a_] for a_ in range(D)) for i in range(d)]
    P_post = [
        [P[i][j] - sum(K[i][a_] * PM[j][a_] for a_ in range(D)) for j in range(d)]
        for i in range(d)
    ]
    mu_next = [sum(mu_post[i] * As[i][j] for i in range(d)) for j in range(d)]
    AP = [[sum(As[k][i] * P_post[k][j] for k in range(d)) for j in range(d)] for i in range(d)]
    P_next = [
        [sum(AP[i][k] * As[k][j] for k in range(d)) + Gs[i][j] for j in range(d)]
        for i in range(d)
    ]
    P_next = [[0.5 * (P_next[i][j] + P_next[j][i]) for j in range(d)] for i in range(d)]
    return mu_next, P_next, ll_delta


def _masked_gauss_update(mu, P, e_raw, Sig_raw, PM_raw, o, q, d):
    """Condition ``(mu, P)`` on one masked q-dim observation block:
    ``e_raw`` (q) the unmasked innovation, ``Sig_raw`` (q×q, lower
    triangle read) its covariance, ``PM_raw`` (d×q) the state↔observation
    cross-covariance, ``o`` (q) the 0/1 masks.  The gain is applied in
    factored form (``U_i = L⁻¹ PM_i``, ``w = L⁻¹ e``: ``μ⁺ = μ + Uᵀw``,
    ``P⁺ = P − UᵀU`` on the lower triangle).  Returns ``(mu_c, P_c,
    ll_delta)`` with ``P_c`` lower-aliased."""
    Sig = [[None] * q for _ in range(q)]
    for a in range(q):
        for b in range(a):
            Sig[a][b] = _msk2(o[a], o[b], Sig_raw[a][b])
        Sig[a][a] = _msk(o[a], Sig_raw[a][a]) + (1.0 - o[a])
    Lch, invd = _list_chol(Sig, q)
    e = [_msk(o[a], e_raw[a]) for a in range(q)]
    w = _fwd_solve(Lch, invd, e, q)
    quad = sum(wi * wi for wi in w)
    logdet = 2.0 * sum(torch.log(Lch[a][a]) for a in range(q))
    nobs = sum(o)
    ll_delta = -0.5 * (logdet + quad + nobs * _LOG_2PI)

    U = [
        _fwd_solve(Lch, invd, [_msk(o[a], PM_raw[i][a]) for a in range(q)], q)
        for i in range(d)
    ]
    mu_c = [mu[i] + sum(w[a] * U[i][a] for a in range(q)) for i in range(d)]
    P_c = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            v = P[i][j] - sum(U[i][a] * U[j][a] for a in range(q))
            P_c[i][j] = v
            P_c[j][i] = v
    return mu_c, P_c, ll_delta


def _seq_z_conditioning(mu, P, z_t, oz_t, d: int):
    """Condition ``(mu, P)`` on the observed z coordinates one at a time
    (each a noiseless scalar observation of the state: a rank-1 downdate,
    no Cholesky).  The P row, the reciprocal, the innovation and the term
    are each selected under ``obs``, so an overflowed state entry on a
    masked lane cannot reach the log-density.  ``P`` may be
    lower-aliased; returns ``(mu_c, P_c, ll_z)`` with ``P_c``
    lower-aliased."""
    ll = None
    mu = list(mu)
    P = [[P[i][j] for j in range(d)] for i in range(d)]
    for a in range(d):
        obs = oz_t[a] > 0
        pa = [torch.where(obs, P[a][j], 0.0) for j in range(d)]
        s = P[a][a]
        ri = torch.rsqrt(s)  # division-free reciprocal, as in _list_chol
        inv = torch.where(obs, ri * ri, 0.0)
        e = torch.where(obs, z_t[a] - mu[a], 0.0)
        g = e * inv
        term = torch.where(obs, torch.log(s) + e * g + _LOG_2PI, 0.0)
        ll = term if ll is None else ll + term
        k = [pa[i] * inv for i in range(d)]
        for i in range(d):
            mu[i] = mu[i] + k[i] * e
        for i in range(d):
            for j in range(i + 1):
                v = P[i][j] - k[i] * pa[j]
                P[i][j] = v
                P[j][i] = v
    return mu, P, -0.5 * ll


def masked_filter_step_split(mu, P, z_t, x_t, oz_t, ox_t, Hs, As, Gs, Ls, d: int, l: int):
    """The production masked filter step: condition on the observed z
    coordinates (:func:`_seq_z_conditioning`), then update on the observed
    x coordinates against the conditioned moments (innovation covariance
    masked ``HᵀP_cH + Λ`` through a masked Cholesky,
    :func:`_masked_gauss_update`), then predict.  The same density as
    :func:`masked_filter_step` by the chain rule, at about half the
    operations; ``P`` may be lower-aliased and ``P_next`` is returned
    lower-aliased."""
    mu_c, P_c, ll_z = _seq_z_conditioning(mu, P, z_t, oz_t, d)

    PH = [[sum(P_c[i][k] * Hs[k][b] for k in range(d)) for b in range(l)] for i in range(d)]
    SigX = [[None] * l for _ in range(l)]
    for a in range(l):
        for b in range(a + 1):
            SigX[a][b] = sum(Hs[k][a] * PH[k][b] for k in range(d)) + Ls[a][b]
    mux = [sum(mu_c[i] * Hs[i][b] for i in range(d)) for b in range(l)]
    ex = [x_t[b] - mux[b] for b in range(l)]
    mu_p, P_p, ll_x = _masked_gauss_update(mu_c, P_c, ex, SigX, PH, ox_t, l, d)

    mu_next = [sum(mu_p[i] * As[i][j] for i in range(d)) for j in range(d)]
    AP = [[sum(As[k][i] * P_p[k][j] for k in range(d)) for j in range(d)] for i in range(d)]
    P_next = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            v = sum(AP[i][k] * As[k][j] for k in range(d)) + Gs[i][j]
            P_next[i][j] = v
            P_next[j][i] = v
    return mu_next, P_next, ll_z + ll_x


def masked_filter_scan(zc, xc, oz, ox, m, S, A, G, H, L, extent=None) -> torch.Tensor:
    """The split-step filter over T steps for every (cluster, row):
    ``zc (T, d, n)``/``xc (T, l, n)`` the data with missing entries
    zeroed, ``oz``/``ox`` their 0/1 masks in the compute dtype, parameters
    with a leading cluster axis C.  Returns ``(C, n)``; the lanes are
    ``(C, n)`` tensors and the parameters ``(C, 1)`` columns.  With
    ``extent (n,)`` a row's log-density takes only its steps ``t <
    extent`` (K7's loop bound: each row stops at its last observed
    step)."""
    T, d, n = zc.shape
    l = xc.shape[1]
    C = m.shape[0]

    def cols(P, r, c):
        return [[P[:, i, j, None] for j in range(c)] for i in range(r)]

    Hs, As, Gs, Ls = cols(H, d, l), cols(A, d, d), cols(G, d, d), cols(L, l, l)
    ones = torch.ones((C, n), dtype=zc.dtype, device=zc.device)
    mu = [m[:, i, None] * ones for i in range(d)]
    Ptri = [S[:, i, j, None] * ones for i in range(d) for j in range(i + 1)]
    ll = torch.zeros((C, n), dtype=zc.dtype, device=zc.device)
    for t in range(T):
        mu, P_next, dll = masked_filter_step_split(
            mu, _tri_unpack(Ptri, d), list(zc[t]), list(xc[t]), list(oz[t]),
            list(ox[t]), Hs, As, Gs, Ls, d, l,
        )
        Ptri = _tri_pack(P_next, d)
        ll = ll + dll if extent is None else torch.where(t < extent, ll + dll, ll)
    return ll


def kalman_masked_logliks(
    z: torch.Tensor,  # (T, n, d) arbitrary per-coordinate NaNs
    x: torch.Tensor,  # (T, n, l)
    m: torch.Tensor,  # (C, d)
    S: torch.Tensor,  # (C, d, d)
    A: torch.Tensor,  # (C, d, d)
    G: torch.Tensor,  # (C, d, d)
    H: torch.Tensor,  # (C, d, l)
    L: torch.Tensor,  # (C, l, l)
) -> torch.Tensor:
    """``(C, n)`` exact log-density of the observed entries of
    ``(z_{1:T}, x_{1:T})`` under arbitrary per-coordinate missingness, in
    O(T): the chain-rule equivalent of the dense drop-rows/columns
    marginalization.  A row with no finite entry gives exactly 0.0."""
    dtype = torch.promote_types(z.dtype, m.dtype)
    z, x = z.to(dtype), x.to(dtype)
    fz, fx = torch.isfinite(z), torch.isfinite(x)
    zc = torch.where(fz, z, 0.0).permute(0, 2, 1)  # (T, d, n)
    xc = torch.where(fx, x, 0.0).permute(0, 2, 1)
    oz = fz.to(dtype).permute(0, 2, 1)
    ox = fx.to(dtype).permute(0, 2, 1)
    return masked_filter_scan(zc, xc, oz, ox, *(a.to(dtype) for a in (m, S, A, G, H, L)))
