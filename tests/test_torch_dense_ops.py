"""The dense route's ops in the port against the JAX package, on the same
seeded numpy inputs, in float64 on the CPU, to 1e-12: the joint moments
(``ops/moments.py``), the masked Gaussian log-densities in every form
(``ops/gaussian.py``), the M step's weighted statistics
(``ops/regression.py``) and the per-(cluster, pattern) inverses of the E
step (``ops/estep_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import gaussian as jg
from multimodal_trajectory_modeling_tpu.ops import moments as jmom
from multimodal_trajectory_modeling_tpu.ops import pallas_estep as jpe
from multimodal_trajectory_modeling_tpu.ops import regression as jreg
from multimodal_trajectory_modeling_tpu_torch.ops import estep_kernels as tek
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as tg
from multimodal_trajectory_modeling_tpu_torch.ops import moments as tmom
from multimodal_trajectory_modeling_tpu_torch.ops import regression as treg

TOL = dict(rtol=1e-12, atol=1e-12)


def _ssm_params(seed, C=3, d=2, l=3):
    """Stable LG-SSM parameters (m, S, A, G, H, L) for C clusters."""
    rng = np.random.default_rng(seed)

    def spd(k):
        a = rng.normal(size=(C, k, k))
        return a @ a.transpose(0, 2, 1) + np.eye(k)

    return (
        rng.normal(size=(C, d)),
        spd(d),
        rng.normal(scale=0.4, size=(C, d, d)),
        spd(d),
        rng.normal(size=(C, d, l)),
        spd(l),
    )


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


_MOMENTS = {
    "latent_means": lambda m, S, A, G, H, L: (m, A),
    "observed_mean": lambda m, S, A, G, H, L: (m, A, H),
    "joint_mean": lambda m, S, A, G, H, L: (m, A, H),
    "latent_cov_blocks": lambda m, S, A, G, H, L: (S, A, G),
    "latent_cov": lambda m, S, A, G, H, L: (S, A, G),
    "observed_cov": lambda m, S, A, G, H, L: (S, A, G, H, L),
    "joint_cov": lambda m, S, A, G, H, L: (S, A, G, H, L),
}


@pytest.mark.parametrize("name", sorted(_MOMENTS))
@pytest.mark.parametrize("T", [1, 4])
def test_moments_match_jax(name, T):
    """Each function on a leading cluster axis equals JAX's per-cluster
    value."""
    params = _ssm_params(0)
    pick = _MOMENTS[name]
    args = pick(*params)
    got = getattr(tmom, name)(T, *map(torch.from_numpy, args))
    for c in range(params[0].shape[0]):
        want = getattr(jmom, name)(T, *(jnp.asarray(a[c]) for a in args))
        _close(got[c], want)


@pytest.mark.parametrize("name", ["joint_moments", "observed_moments"])
def test_moment_pairs_match_jax(name):
    params = _ssm_params(1)
    got = getattr(tmom, name)(5, *map(torch.from_numpy, params))
    for c in range(params[0].shape[0]):
        want = getattr(jmom, name)(5, *(jnp.asarray(a[c]) for a in params))
        for g, w in zip(got, want):
            _close(g[c], w)


def _gapped_rows(seed, n=300, D=12, all_nan_rows=(5,)):
    """Rows of a Gaussian with a few missingness patterns (interior gaps,
    one all-NaN row), and its mean and covariance."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(D, D))
    cov = a @ a.T / D + np.eye(D)
    mean = rng.normal(size=D)
    x = rng.multivariate_normal(mean, cov, size=n)
    masks = rng.uniform(size=(6, D)) < 0.3
    x[np.where(masks[rng.integers(0, 6, size=n)])] = np.nan
    x[3, 2] = np.inf  # an inf counts as missing
    for i in all_nan_rows:
        x[i] = np.nan
    return x, mean, cov


def test_masked_identity_pad_matches_jax():
    _x, _mean, cov = _gapped_rows(0)
    f = (np.random.default_rng(1).uniform(size=(4, 12)) < 0.6).astype(float)
    got = tg.masked_identity_pad(torch.from_numpy(cov), torch.from_numpy(f))
    for p in range(4):
        _close(got[p], jg.masked_identity_pad(jnp.asarray(cov), jnp.asarray(f[p])))


@pytest.mark.parametrize("method", ["lu", "cholesky"])
def test_masked_mvn_logpdf_matches_jax(method):
    x, mean, cov = _gapped_rows(2)
    got = tg.masked_mvn_logpdf(*map(torch.from_numpy, (x, mean, cov)), method=method)
    _close(got, jg.masked_mvn_logpdf(*map(jnp.asarray, (x, mean, cov)), method=method))
    assert got[5].item() == 0.0  # the all-NaN row


def test_mvn_logpdf_matches_jax():
    x, mean, cov = _gapped_rows(3)
    x = np.nan_to_num(x, nan=0.5, posinf=0.5)
    _close(
        tg.mvn_logpdf(*map(torch.from_numpy, (x, mean, cov))),
        jg.mvn_logpdf(*map(jnp.asarray, (x, mean, cov))),
    )


@pytest.mark.parametrize("D,p", [(None, None), (3, 0.5), (17, 0.1), (80, 0.05), (512, 0.002)])
def test_pattern_groups_match_jax(D, p):
    """The gapped rows, and scattered NaNs at widths that are and are not
    a multiple of 8 (the packed keys' padding bits)."""
    if D is None:
        x, _mean, _cov = _gapped_rows(4)
    else:
        rng = np.random.default_rng(D)
        x = rng.normal(size=(3000, D))
        x[rng.random(x.shape) < p] = np.nan
        x[::7, -1] = np.inf
    pt, it = tg.pattern_groups(x)
    pj, ij = jg.pattern_groups(x)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(it, ij)
    assert it.dtype == np.int32 and pt.dtype == bool


@pytest.mark.parametrize("method", ["solve", "inverse", "bucketed", "auto"])
@pytest.mark.parametrize("many_patterns", [False, True])
def test_grouped_logpdf_matches_jax(method, many_patterns):
    """Every grouped form against JAX's and against the per-row oracle;
    ``auto`` takes ``bucketed`` once P > max(8, D)."""
    x, mean, cov = _gapped_rows(5, D=6 if many_patterns else 12)
    if many_patterns:  # unstructured missingness: P > max(8, D)
        x[np.random.default_rng(6).uniform(size=x.shape) < 0.2] = np.nan
    patterns, pid = tg.pattern_groups(x)
    if many_patterns:
        assert patterns.shape[0] > max(8, x.shape[1])
    got = tg.masked_mvn_logpdf_grouped(
        *map(torch.from_numpy, (x, mean, cov, patterns, pid)), method=method
    )
    want = jg.masked_mvn_logpdf_grouped(
        *map(jnp.asarray, (x, mean, cov, patterns, pid)), method=method
    )
    _close(got, want)
    _close(got, tg.masked_mvn_logpdf(*map(torch.from_numpy, (x, mean, cov))))
    assert got[5].item() == 0.0


def test_grouped_logpdf_nan_on_indefinite_cov():
    """A covariance whose factorization fails gives NaN, never raises."""
    x, mean, cov = _gapped_rows(7)
    cov = cov.copy()
    cov[0, 0] = -1.0
    patterns, pid = tg.pattern_groups(x)
    got = tg.masked_mvn_logpdf_grouped(
        *map(torch.from_numpy, (x, mean, cov, patterns, pid)), method="solve"
    )
    observed0 = np.isfinite(x[:, 0])
    assert bool(torch.isnan(got[torch.from_numpy(observed0)]).all())


@pytest.mark.parametrize("rows_per_chunk", [1, 7, 64])
def test_grouped_solve_in_row_chunks_matches_jax(monkeypatch, rows_per_chunk):
    """``solve`` takes its rows in chunks of _SOLVE_ELEMENTS // (P·D);
    small chunks, a ragged last one included, give JAX's one-pass result."""
    x, mean, cov = _gapped_rows(8, n=301)
    patterns, pid = tg.pattern_groups(x)
    monkeypatch.setattr(tg, "_SOLVE_ELEMENTS", rows_per_chunk * patterns.shape[0] * x.shape[1])
    got = tg.masked_mvn_logpdf_grouped(
        *map(torch.from_numpy, (x, mean, cov, patterns, pid)), method="solve"
    )
    want = jg.masked_mvn_logpdf_grouped(
        *map(jnp.asarray, (x, mean, cov, patterns, pid)), method="solve"
    )
    _close(got, want)
    assert got.shape == (301,) and got[5].item() == 0.0


def _stat_rows(seed, Tp=4, n=200, p=3, q=2, C=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Tp, n, p)) * 3.0
    Y = rng.normal(size=(Tp, n, q))
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    Y[rng.uniform(size=Y.shape) < 0.05] = np.inf
    W = np.eye(C)[rng.integers(0, C, size=n)]
    return X, Y, W


@pytest.mark.parametrize(
    "name", ["weighted_regression_stats_timebatched", "weighted_regression_stats_gram"]
)
def test_timebatched_stats_match_jax(name):
    X, Y, W = _stat_rows(8)
    got = getattr(treg, name)(*map(torch.from_numpy, (X, Y, W)))
    want = getattr(jreg, name)(*map(jnp.asarray, (X, Y, W)))
    for g, w in zip(got, want):
        _close(g, w)


def test_weighted_regression_stats_match_jax():
    X, Y, W = _stat_rows(9)
    got = treg.weighted_regression_stats(*map(torch.from_numpy, (X[0], Y[0], W)))
    want = jreg.weighted_regression_stats(*map(jnp.asarray, (X[0], Y[0], W)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("name", ["masked_moment_stats", "masked_mean_and_cov"])
def test_masked_moments_match_jax(name):
    X, _Y, W = _stat_rows(10)
    got = getattr(treg, name)(torch.from_numpy(X[0]), torch.from_numpy(W))
    want = getattr(jreg, name)(jnp.asarray(X[0]), jnp.asarray(W))
    for g, w in zip(got, want):
        _close(g, w)


def test_cluster_pattern_inverses_match_jax():
    rng = np.random.default_rng(11)
    C, D = 3, 10
    a = rng.normal(size=(C, D, D))
    covs = a @ a.transpose(0, 2, 1) / D + np.eye(D)
    means = rng.normal(size=(C, D))
    patterns = rng.uniform(size=(5, D)) < 0.7
    inv_t, const_t = tek.precompute_cluster_pattern_inverses(
        *map(torch.from_numpy, (means, covs, patterns))
    )
    inv_j, const_j = jpe.precompute_cluster_pattern_inverses(
        *map(jnp.asarray, (means, covs, patterns))
    )
    _close(inv_t, inv_j)
    _close(const_t, const_j)
