"""The port's small-matrix ops and layouts against the JAX package, on
the same seeded numpy inputs, in float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.ops import markov as jmarkov
from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu.ops import regression as jreg
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import markov as tmarkov
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as tmk
from multimodal_trajectory_modeling_tpu_torch.ops import regression as treg


def _regression_stats(seed, C=4, p=3, q=2, rank_deficient=False):
    """Stats of weighted (X, Y) samples; optionally with a singular X^T X
    in cluster 0 (a repeated column)."""
    rng = np.random.default_rng(seed)
    fields = []
    for _c in range(C):
        N = 40
        X = rng.normal(size=(N, p)) * 5.0
        if rank_deficient and _c == 0:
            X[:, -1] = X[:, 0]
        Y = X @ rng.normal(size=(p, q)) + rng.normal(size=(N, q))
        fields.append((X.T @ X, X.T @ Y, Y.T @ Y, X.sum(0), Y.sum(0), N))
    return tuple(np.stack([f[i] for f in fields]).astype(float) for i in range(6))


@pytest.mark.parametrize(
    "mode,kwargs,rank_deficient",
    [
        ("lstsq", {}, False),
        ("lstsq", {}, True),  # the min-norm solution of a singular X^T X
        ("eps", {"eps": 1e-3}, False),
        ("ridge", {"alpha": 0.5}, False),
        ("chol", {"eps": 1e-6}, False),
    ],
)
def test_solve_regression_matches_jax(mode, kwargs, rank_deficient):
    stats = _regression_stats(0, rank_deficient=rank_deficient)
    A_j, S_j = jreg.solve_regression(
        jreg.RegressionStats(*map(jnp.asarray, stats)), mode=mode, **kwargs
    )
    A_t, S_t = treg.solve_regression(
        treg.RegressionStats(*map(torch.from_numpy, stats)), mode=mode, **kwargs
    )
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["lstsq", "chol", "ridge"])
def test_solve_regression_nan_instead_of_raising(mode):
    """A non-finite or indefinite system gives NaN, as in JAX, and never
    raises."""
    stats = list(_regression_stats(1))
    # lstsq: NaN input; chol: indefinite; ridge: singular
    stats[0][1] = {"lstsq": np.nan, "chol": -np.eye(3), "ridge": 0.0}[mode]
    A_t, S_t = treg.solve_regression(
        treg.RegressionStats(*map(torch.from_numpy, stats)), mode=mode
    )
    assert torch.isnan(A_t[1]).any()
    assert torch.isfinite(A_t[[0, 2, 3]]).all()


def test_mean_cov_from_stats_matches_jax():
    rng = np.random.default_rng(2)
    Z = rng.normal(size=(3, 50, 4))
    stats = (
        np.full(3, 50.0),
        Z.sum(1),
        np.einsum("cni,cnj->cij", Z, Z),
    )
    m_j, S_j = jreg.mean_cov_from_stats(jreg.MomentStats(*map(jnp.asarray, stats)))
    m_t, S_t = treg.mean_cov_from_stats(treg.MomentStats(*map(torch.from_numpy, stats)))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-12)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(S_t.numpy()[0], np.cov(Z[0], rowvar=False), rtol=1e-12)


def _markov_params(seed, C=3, d=3, l=2):
    rng = np.random.default_rng(seed)

    def spd(k):
        M = rng.normal(size=(C, k, k))
        return M @ M.transpose(0, 2, 1) / k + np.eye(k)

    return (
        rng.normal(size=(C, d)),
        spd(d),
        rng.normal(scale=0.3, size=(C, d, d)),
        spd(d),
        rng.normal(size=(C, d, l)),
        spd(l),
    )


def test_markov_em_weights_match_jax():
    params = _markov_params(3)
    W_j = jmarkov.markov_em_weights(*map(jnp.asarray, params))
    W_t = tmarkov.markov_em_weights(*map(torch.from_numpy, params))
    assert W_t.shape == (3, tmarkov.markov_em_feature_dim(3, 2))
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), rtol=1e-12, atol=1e-12)


def test_markov_em_weights_nan_for_indefinite_covariance():
    params = list(_markov_params(4))
    params[3] = params[3].copy()
    params[3][1] = -np.eye(3)  # G of cluster 1 is not positive definite
    W_t = tmarkov.markov_em_weights(*map(torch.from_numpy, params))
    W_j = jmarkov.markov_em_weights(*map(jnp.asarray, params))
    np.testing.assert_array_equal(
        torch.isnan(W_t).numpy(), np.isnan(np.asarray(W_j))
    )
    assert torch.isnan(W_t[1]).any() and torch.isfinite(W_t[[0, 2]]).all()


@pytest.mark.parametrize("T,d,l", [(4, 2, 4), (10, 5, 3), (6, 3, 2), (3, 8, 9)])
def test_layout_specs_identical(T, d, l):
    s_j, ks_j, Facc_j, rows_j = jpm.markov_packed_spec(T, d, l)
    s_t, ks_t, Facc_t, rows_t = tmk.markov_packed_spec(T, d, l)
    assert (s_t, ks_t, Facc_t) == (s_j, ks_j, Facc_j)
    np.testing.assert_array_equal(rows_t, rows_j)
    for a, b in zip(tmk.markov_compact_spec(T, d, l), jpm.markov_compact_spec(T, d, l)):
        np.testing.assert_array_equal(a, b)
    assert tem.markov_packed_ok(T, d, l) == jem.markov_packed_ok(T, d, l)


def test_acc_row_table_covers_compact_rows():
    """Every referenced ACC row has a kernel descriptor of the right kind
    (the CUDA kernel computes Φ from these)."""
    T, d, l = 10, 5, 3
    _Fc_pad, uniq, _pos = tmk.markov_compact_spec(T, d, l)
    table = tmk._acc_row_table(d, l)[uniq]
    s = 8
    assert set(table[:, 0]) <= set(range(8))  # no ZERO rows referenced
    b_rows = table[table[:, 0] == tmk._ROW_B]
    assert np.all(b_rows[:, 1] + b_rows[:, 2] < s)


def test_quantize_phi_matches_jax():
    rng = np.random.default_rng(5)
    phi = rng.normal(size=(16, 300)) * rng.uniform(0.1, 100, size=(16, 1))
    phi[3] = 0.0  # an all-zero row gets scale 1
    phi[5, :7] = [0.5, -0.5, 1.5, 2.5, -2.5, 1e-9, 3.0]  # ties, small values
    q_j = jpm.quantize_phi(jnp.asarray(phi))
    q_t = tmk.quantize_phi(torch.from_numpy(phi))
    np.testing.assert_array_equal(q_t.q.numpy(), np.asarray(q_j.q))
    np.testing.assert_array_equal(q_t.scale.numpy(), np.asarray(q_j.scale))
    assert q_t.q.dtype == torch.int16
    np.testing.assert_allclose(
        tmk.dequantize_phi(q_t).numpy(), np.asarray(jpm.dequantize_phi(q_j)),
        rtol=0, atol=0,
    )


def test_mixture_params_round_trip():
    rng = np.random.default_rng(6)
    C, d, l = 3, 2, 4
    fields = (
        rng.uniform(size=C),
        rng.normal(size=(C, d)),
        rng.normal(size=(C, d, d)),
        rng.normal(size=(C, d, d)),
        rng.normal(size=(C, d, d)),
        rng.normal(size=(C, d, l)),
        rng.normal(size=(C, l, l)),
    )
    jparams = jem.MixtureParams(*map(jnp.asarray, fields))
    tparams = tem.mixture_params_from_numpy(jparams)
    assert tparams.m.dtype == torch.float64 and tparams.n_clusters == C
    back = tem.mixture_params_to_numpy(tparams)
    assert len(back) == 7
    for a, b in zip(back, fields):
        np.testing.assert_array_equal(a, b)
    f32 = tem.mixture_params_from_numpy(fields, dtype=torch.float32)
    assert f32.L.dtype == torch.float32 and f32.L.shape == (C, l, l)
