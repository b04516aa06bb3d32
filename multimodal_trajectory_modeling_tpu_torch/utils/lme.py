"""This package's own copy of
``multimodal_trajectory_modeling_tpu/utils/lme.py`` (numpy, scipy and
pandas; nothing of JAX), so that the port imports nothing of the JAX
package.

Random-intercept linear mixed-effects models.

Replaces the two external LME dependencies of the reference pipeline that
are unavailable here:

- statsmodels ``smf.mixedlm("y ~ cluster * x", df, groups=...)`` used by the
  collate driver (inference-adni-xval-collate-results.py:602-787);
- the lme4/lmerTest R scripts (posthoc/lme_*.R) fitting
  ``y ~ cluster * time + (1 | id)`` with tests of the interaction.

Model: ``y = X β + b_g + ε`` with ``b_g ~ N(0, τ²)`` per group and
``ε ~ N(0, σ²)``.  REML estimation by profiling: for a given variance ratio
``λ = τ²/σ²`` the per-group GLS solve is rank-one (Sherman—Morrison), so
the whole profile likelihood is closed-form; a scalar bounded optimization
over ``log λ`` finishes the job.  Fixed-effect naming follows patsy
(``Intercept``, ``cluster[T.B]``, ``x``, ``cluster[T.B]:x``) so downstream
code written against statsmodels results objects keeps working.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import pandas as pd
import scipy.optimize as sp_opt
import scipy.stats as sp_stats

__all__ = ["mixedlm", "MixedLMResult", "build_design", "emtrends"]


def build_design(
    formula: str, df: pd.DataFrame
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Tiny patsy-like design builder supporting ``y ~ a * b``, ``y ~ a + b``
    and single-term formulas, with treatment coding for
    categorical/object-typed columns (first sorted level is the baseline)."""
    lhs, rhs = [s.strip() for s in formula.split("~")]
    y = df[lhs].to_numpy(dtype=float)

    def is_cat(col):
        return not pd.api.types.is_numeric_dtype(df[col])

    def levels_of(col):
        return sorted(pd.unique(df[col].astype(str)))

    def encode(col, drop_first=True):
        s = df[col]
        if is_cat(col):
            lvls = levels_of(col)
            keep = lvls[1:] if drop_first else lvls
            tag = "[T.{}]" if drop_first else "[{}]"
            return [
                (f"{col}{tag.format(lv)}", (s.astype(str) == lv).to_numpy(float))
                for lv in keep
            ]
        return [(col, s.to_numpy(dtype=float))]

    names = ["Intercept"]
    columns = [np.ones(len(df))]

    if "*" in rhs:
        # a * b → a + b + a:b (both main effects + treatment-coded interaction)
        terms = [t.strip() for t in rhs.split("*")]
        encoded = [encode(t) for t in terms]
        for enc in encoded:
            for nm, colv in enc:
                names.append(nm)
                columns.append(colv)
        for nm1, c1 in encoded[0]:
            for nm2, c2 in encoded[1]:
                names.append(f"{nm1}:{nm2}")
                columns.append(c1 * c2)
    else:
        # additive terms; a pure interaction term ``num:cat`` (without the
        # numeric main effect) gets one slope per *full* categorical level —
        # the patsy/lme4 rule used by ``y ~ x:cluster + cluster``
        terms = [t.strip() for t in rhs.split("+")]
        plain = [t for t in terms if ":" not in t]
        for t in plain:
            for nm, colv in encode(t):
                names.append(nm)
                columns.append(colv)
        for t in terms:
            if ":" not in t:
                continue
            a, b = [s.strip() for s in t.split(":")]
            if is_cat(b) and not is_cat(a):
                a, b = b, a  # put the categorical first
            if is_cat(a) and not is_cat(b):
                num = df[b].to_numpy(dtype=float)
                for lv in levels_of(a):
                    names.append(f"{b}:{a}[{lv}]")
                    columns.append(
                        (df[a].astype(str) == lv).to_numpy(float) * num
                    )
            else:
                enc_a, enc_b = encode(a), encode(b)
                for nm1, c1 in enc_a:
                    for nm2, c2 in enc_b:
                        names.append(f"{nm1}:{nm2}")
                        columns.append(c1 * c2)
    X = np.column_stack(columns)
    return y, X, names


class _SuffStats:
    """Per-group sufficient statistics: everything the REML likelihood, the
    fixed-effect information and the variance-component derivatives need.
    With a single random intercept each group's covariance is
    ``V_g = σ² I + τ² 1 1ᵀ`` (rank-one), so only ``XᵀX``, ``Xᵀ1``, ``Xᵀy``,
    ``yᵀ1``, ``yᵀy`` and ``n_g`` per group are ever touched."""

    def __init__(self, y, X, group_slices):
        self.G = np.stack([X[lo:hi].T @ X[lo:hi] for lo, hi in group_slices])
        self.s = np.stack([X[lo:hi].sum(axis=0) for lo, hi in group_slices])
        self.xy = np.stack([X[lo:hi].T @ y[lo:hi] for lo, hi in group_slices])
        self.sy = np.array([y[lo:hi].sum() for lo, hi in group_slices])
        self.yy = np.array([y[lo:hi] @ y[lo:hi] for lo, hi in group_slices])
        self.ng = np.array([hi - lo for lo, hi in group_slices], dtype=float)
        self.n = int(self.ng.sum())
        self.p = X.shape[1]

    def info_and_derivs(self, sigma2, tau2):
        """``M = XᵀV⁻¹X`` and its derivatives w.r.t. (σ², τ²).

        Sherman—Morrison per group: ``V⁻¹ = (I − c 11ᵀ)/σ²`` with
        ``c = τ²/(σ² + n τ²)``; then ``∂M/∂σ² = −XᵀV⁻²X`` with
        ``V⁻² = (I − c(2 − cn) 11ᵀ)/σ⁴`` and ``∂M/∂τ² = −Σ u uᵀ`` with
        ``u = XᵀV⁻¹1 = s/(σ² + n τ²)``."""
        denom = sigma2 + self.ng * tau2
        c = tau2 / denom
        ss = np.einsum("gi,gj->gij", self.s, self.s)
        M = (self.G - c[:, None, None] * ss).sum(axis=0) / sigma2
        c2 = c * (2.0 - c * self.ng)
        dM_ds = -(self.G - c2[:, None, None] * ss).sum(axis=0) / sigma2**2
        u = self.s / denom[:, None]
        dM_dt = -np.einsum("gi,gj->ij", u, u)
        return M, dM_ds, dM_dt

    def neg2_reml(self, sigma2, tau2):
        """Exact −2·REML log-likelihood at (σ², τ²) (constants dropped) —
        the function whose numerical Hessian yields the asymptotic
        covariance of the variance components (lmerTest's recipe)."""
        denom = sigma2 + self.ng * tau2
        c = tau2 / denom
        ss = np.einsum("gi,gj->gij", self.s, self.s)
        M = (self.G - c[:, None, None] * ss).sum(axis=0) / sigma2
        Xty = (self.xy - c[:, None] * self.s * self.sy[:, None]).sum(
            axis=0
        ) / sigma2
        ytVy = float((self.yy - c * self.sy**2).sum() / sigma2)
        beta = np.linalg.solve(M, Xty)
        logdetV = float(
            (self.ng - 1).sum() * np.log(sigma2) + np.log(denom).sum()
        )
        sign, logdetM = np.linalg.slogdet(M)
        return logdetV + logdetM + (ytVy - beta @ Xty), beta, M


@dataclass
class MixedLMResult:
    params: pd.Series
    bse: pd.Series
    cov_params_: pd.DataFrame
    sigma2: float
    tau2: float
    loglike: float
    n_groups: int
    n_obs: int
    names: list[str] = field(default_factory=list)
    vc_cov: np.ndarray = None  # 2×2 asymptotic cov of (σ̂², τ̂²)
    _stats: _SuffStats = None

    def tvalues(self) -> pd.Series:
        return self.params / self.bse

    def pvalues(self) -> pd.Series:
        """Per-coefficient two-sided p-values on Satterthwaite t references
        (falls back to normal if the variance-component covariance is
        unavailable)."""
        t = self.tvalues()
        if self.vc_cov is None:
            return pd.Series(
                2 * sp_stats.norm.sf(np.abs(t.values)), index=t.index
            )
        dofs = self.coef_df().values
        return pd.Series(
            2 * sp_stats.t.sf(np.abs(t.values), dofs), index=t.index
        )

    # -- Satterthwaite machinery ------------------------------------------

    def _var_and_grad(self, w: np.ndarray):
        """Variance of the contrast ``wᵀβ̂`` and its gradient w.r.t.
        (σ², τ²): f = wᵀ M⁻¹ w, ∂f/∂θ = −(M⁻¹w)ᵀ (∂M/∂θ) (M⁻¹w)."""
        M, dM_ds, dM_dt = self._stats.info_and_derivs(self.sigma2, self.tau2)
        v = np.linalg.solve(M, w)
        f = float(w @ v)
        return f, np.array([-(v @ dM_ds @ v), -(v @ dM_dt @ v)])

    def satterthwaite_df(self, w: np.ndarray) -> float:
        """ν = 2 f² / (∇fᵀ A ∇f) where A = Cov(σ̂², τ̂²)."""
        if self.vc_cov is None:
            return float(self.n_obs - len(self.names))
        f, g = self._var_and_grad(np.asarray(w, dtype=float))
        denom = float(g @ self.vc_cov @ g)
        if denom <= 0:
            return float(self.n_obs - len(self.names))
        return 2.0 * f * f / denom

    def coef_df(self) -> pd.Series:
        """Satterthwaite denominator dof for each fixed effect."""
        eye = np.eye(len(self.names))
        return pd.Series(
            [self.satterthwaite_df(eye[i]) for i in range(len(self.names))],
            index=self.names,
        )

    def contest(self, L, joint: bool = True) -> pd.DataFrame:
        """lmerTest-style contrast test.  ``L`` is one contrast vector or a
        (q×p) matrix in coefficient space.  Returns the lmerTest ``contest``
        columns: Sum Sq / Mean Sq / NumDF / DenDF / F value / Pr(>F), where
        DenDF combines per-eigencomponent Satterthwaite dofs
        (ν from 2E/(E−q), E = Σ νᵢ/(νᵢ−2))."""
        L = np.atleast_2d(np.asarray(L, dtype=float))
        q = L.shape[0]
        b = self.params.values
        C = self.cov_params_.values
        VL = L @ C @ L.T
        Lb = L @ b
        fstat = float(Lb @ np.linalg.solve(VL, Lb)) / q
        if q == 1:
            ddf = self.satterthwaite_df(L[0])
        else:
            d, P = np.linalg.eigh(VL)
            nus = []
            for i in range(q):
                li = P[:, i] @ L  # contrast with variance d[i]
                nus.append(self.satterthwaite_df(li))
            nus = np.asarray(nus)
            ok = nus > 2.0
            E = float((nus[ok] / (nus[ok] - 2.0)).sum())
            ddf = 2.0 * E / (E - q) if E > q else float("inf")
        pval = float(sp_stats.f.sf(fstat, q, ddf))
        ss = fstat * q * self.sigma2
        return pd.DataFrame(
            {
                "Sum Sq": [ss],
                "Mean Sq": [ss / q],
                "NumDF": [q],
                "DenDF": [ddf],
                "F value": [fstat],
                "Pr(>F)": [pval],
            }
        )

    def anova(self) -> pd.DataFrame:
        """Type III ANOVA table with Satterthwaite denominator dof for an
        ``a * b`` fit (categorical × numeric), matching lmerTest's
        coding-independent hypotheses: the categorical main effect tests its
        treatment offsets jointly, the numeric main effect tests the
        *level-averaged* slope, the interaction tests its offsets jointly."""
        names = self.names
        p = len(names)
        inter = [nm for nm in names if ":" in nm]
        cat_main = [
            nm for nm in names if "[" in nm and ":" not in nm
        ]
        num_main = [
            nm
            for nm in names
            if nm != "Intercept" and "[" not in nm and ":" not in nm
        ]
        rows = {}
        if cat_main:
            L = np.zeros((len(cat_main), p))
            for r, nm in enumerate(cat_main):
                L[r, names.index(nm)] = 1.0
            label = cat_main[0].split("[")[0]
            rows[label] = self.contest(L).iloc[0]
        for nm in num_main:
            L = np.zeros(p)
            L[names.index(nm)] = 1.0
            hits = [j for j, im in enumerate(names) if ":" in im]
            k = len(hits) + 1
            for j in hits:
                L[j] = 1.0 / k
            rows[nm] = self.contest(L).iloc[0]
        if inter:
            L = np.zeros((len(inter), p))
            for r, nm in enumerate(inter):
                L[r, names.index(nm)] = 1.0
            label = inter[0].split("[")[0] + ":" + inter[0].split(":")[-1]
            rows[label] = self.contest(L).iloc[0]
        return pd.DataFrame(rows).T

    def wald_test_terms(self, term_names: list[str]) -> tuple[float, float]:
        """Joint F test that the named coefficients are all zero, on the
        Satterthwaite denominator-dof reference; returns (F, p-value)."""
        idx = [self.names.index(nm) for nm in term_names]
        L = np.zeros((len(idx), len(self.names)))
        for r, j in enumerate(idx):
            L[r, j] = 1.0
        row = self.contest(L).iloc[0]
        return float(row["F value"]), float(row["Pr(>F)"])

    def summary(self) -> pd.DataFrame:
        out = pd.DataFrame(
            {
                "coef": self.params,
                "se": self.bse,
                "t": self.tvalues(),
                "p": self.pvalues(),
            }
        )
        if self.vc_cov is not None:
            out.insert(2, "df", self.coef_df())
        return out


def _profile_reml(lam, y, X, group_sizes, group_slices):
    """−2·REML log-likelihood (up to constants) for variance ratio λ, plus
    the GLS β and variance estimates.  Rank-one per-group inverse:
    V_g⁻¹ = I − (λ / (1 + λ n_g)) 1 1ᵀ."""
    n, p = X.shape
    XtVX = np.zeros((p, p))
    XtVy = np.zeros(p)
    ytVy = 0.0
    logdetV = 0.0
    for (lo, hi), ng in zip(group_slices, group_sizes):
        Xg = X[lo:hi]
        yg = y[lo:hi]
        c = lam / (1.0 + lam * ng)
        sx = Xg.sum(axis=0)
        sy = yg.sum()
        XtVX += Xg.T @ Xg - c * np.outer(sx, sx)
        XtVy += Xg.T @ yg - c * sx * sy
        ytVy += yg @ yg - c * sy * sy
        logdetV += np.log1p(lam * ng)
    beta = np.linalg.solve(XtVX, XtVy)
    rss = ytVy - beta @ XtVy  # y' V⁻¹ y − β' X' V⁻¹ y
    sigma2 = rss / (n - p)  # REML variance estimate
    sign, logdetXtVX = np.linalg.slogdet(XtVX)
    neg2reml = (
        (n - p) * np.log(sigma2) + logdetV + logdetXtVX + (n - p)
    )
    return neg2reml, beta, sigma2, XtVX


def _vc_covariance(stats: _SuffStats, sigma2: float, tau2: float):
    """Asymptotic covariance of the REML variance-component estimates:
    ``2 H⁻¹`` with ``H`` the numerical Hessian of −2·REML log-likelihood at
    (σ̂², τ̂²) — lmerTest's recipe for the Satterthwaite denominator dof."""
    theta = np.array([sigma2, tau2], dtype=float)
    h = 1e-4 * np.maximum(np.abs(theta), 1e-8)

    def f(t):
        return stats.neg2_reml(max(t[0], 1e-12), max(t[1], 0.0))[0]

    H = np.zeros((2, 2))
    f0 = f(theta)
    for i in range(2):
        ei = np.zeros(2)
        ei[i] = h[i]
        H[i, i] = (f(theta + ei) - 2 * f0 + f(theta - ei)) / h[i] ** 2
    e0 = np.array([h[0], 0.0])
    e1 = np.array([0.0, h[1]])
    H[0, 1] = H[1, 0] = (
        f(theta + e0 + e1)
        - f(theta + e0 - e1)
        - f(theta - e0 + e1)
        + f(theta - e0 - e1)
    ) / (4 * h[0] * h[1])
    try:
        A = 2.0 * np.linalg.inv(H)
    except np.linalg.LinAlgError:
        return None
    # H must be PD at an interior optimum; boundary fits get no vc cov
    if not np.all(np.linalg.eigvalsh(A) > 0):
        return None
    return A


def emtrends(
    res: MixedLMResult, var: str, factor: str = "cluster"
) -> tuple[pd.DataFrame, pd.DataFrame]:
    """Per-level slopes of ``var`` with SEs, plus Tukey-adjusted pairwise
    contrasts — the pipeline's use of emmeans::emtrends with
    ``lmer.df = "satterthwaite"`` (posthoc/lme_*.R)."""
    names = res.names
    cov = res.cov_params_.values
    p = len(names)

    # discover levels from coefficient names
    weights = {}
    if var in names:  # a*b coding: baseline slope is `var`
        base_levels = sorted(
            {
                nm.split("[T.")[1].split("]")[0]
                for nm in names
                if nm.startswith(f"{factor}[T.") and ":" not in nm
            }
        )
        # baseline level name: the letter preceding the first coded level
        # (cluster levels are single letters A.. in this pipeline)
        inferred_base = chr(min(ord(lv[0]) for lv in base_levels) - 1)
        all_levels = [inferred_base] + base_levels
        for lv in all_levels:
            w = np.zeros(p)
            w[names.index(var)] = 1.0
            inter = f"{factor}[T.{lv}]:{var}"
            if inter in names:
                w[names.index(inter)] = 1.0
            weights[lv] = w
    else:  # num:cat coding: one slope per full level `var:factor[L]`
        for nm in names:
            if nm.startswith(f"{var}:{factor}["):
                lv = nm.split("[")[1].split("]")[0]
                w = np.zeros(p)
                w[names.index(nm)] = 1.0
                weights[lv] = w

    rows = []
    for lv, w in sorted(weights.items()):
        est = float(w @ res.params.values)
        se = float(np.sqrt(w @ cov @ w))
        dof = res.satterthwaite_df(w)
        t_lo, t_hi = sp_stats.t.interval(0.95, dof)
        rows.append((lv, est, se, dof, est + t_lo * se, est + t_hi * se))
    trends = pd.DataFrame(
        rows,
        columns=[factor, f"{var}.trend", "SE", "df", "lower.CL", "upper.CL"],
    )

    lv_list = sorted(weights)
    k = len(lv_list)
    crows = []
    for i in range(k):
        for j in range(i + 1, k):
            w = weights[lv_list[i]] - weights[lv_list[j]]
            est = float(w @ res.params.values)
            se = float(np.sqrt(w @ cov @ w))
            dof = res.satterthwaite_df(w)
            t = est / se
            # Tukey adjustment over a family of k estimates
            pval = float(
                sp_stats.studentized_range.sf(abs(t) * np.sqrt(2), k, dof)
            )
            crows.append(
                (f"{lv_list[i]} - {lv_list[j]}", est, se, dof, t, pval)
            )
    contrasts = pd.DataFrame(
        crows,
        columns=["contrast", "estimate", "SE", "df", "t.ratio", "p.value"],
    )
    return trends, contrasts


def mixedlm(
    formula: str,
    df: pd.DataFrame,
    groups: pd.Series | np.ndarray,
) -> "_MixedLM":
    """statsmodels-like entry point: ``mixedlm(formula, df, groups).fit()``."""
    return _MixedLM(formula, df, np.asarray(groups))


class _MixedLM:
    def __init__(self, formula, df, groups):
        self.formula = formula
        self.df = df
        self.groups = groups

    def fit(self) -> MixedLMResult:
        y, X, names = build_design(self.formula, self.df)
        order = np.argsort(self.groups, kind="stable")
        y, X, g = y[order], X[order], self.groups[order]
        uniq, starts = np.unique(g, return_index=True)
        starts = np.sort(starts)
        bounds = list(starts) + [len(g)]
        group_slices = [
            (bounds[i], bounds[i + 1]) for i in range(len(uniq))
        ]
        group_sizes = [hi - lo for lo, hi in group_slices]

        def objective(log_lam):
            lam = np.exp(log_lam)
            return _profile_reml(lam, y, X, group_sizes, group_slices)[0]

        res = sp_opt.minimize_scalar(
            objective, bounds=(-10.0, 10.0), method="bounded"
        )
        lam = float(np.exp(res.x))
        neg2reml, beta, sigma2, XtVX = _profile_reml(
            lam, y, X, group_sizes, group_slices
        )
        cov = np.linalg.inv(XtVX) * sigma2
        stats = _SuffStats(y, X, group_slices)
        vc_cov = _vc_covariance(stats, float(sigma2), float(lam * sigma2))
        return MixedLMResult(
            params=pd.Series(beta, index=names),
            bse=pd.Series(np.sqrt(np.diag(cov)), index=names),
            cov_params_=pd.DataFrame(cov, index=names, columns=names),
            sigma2=float(sigma2),
            tau2=float(lam * sigma2),
            loglike=-0.5 * float(neg2reml),
            n_groups=len(uniq),
            n_obs=len(y),
            names=names,
            vc_cov=vc_cov,
            _stats=stats,
        )
