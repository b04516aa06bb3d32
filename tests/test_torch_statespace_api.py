"""The port's function API (``models/statespace_api.py``) against the JAX
package's, float64 on the CPU, on the same numpy inputs: every function of
``__all__`` (the moments, the dense and composite log-densities, the
marginalizing ones on rows with NaN, ±Inf and an all-NaN column) within
1e-10 relative, and the samplers bit for bit from the same ``Generator``.
The port's ``full_marginalizable_log_prob`` and
``multivariate_normal_log_likelihood`` go through ``em._masked_logliks``
with one cluster: the grouped form here, kernel K12 on the card."""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import statespace_api as jssa
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import statespace_api as tssa

TOL = dict(rtol=1e-10, atol=1e-10)
CPU = dict(device="cpu")
T, D, L = 4, 3, 2


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(20)
    return dict(
        m=rng.normal(size=D),
        S=np.eye(D) / 5.0 + 0.02,
        A=rng.normal(scale=0.5, size=(D, D)),
        Γ=np.eye(D) / 2.0 + 0.05,
        H=rng.normal(size=(D, L)),
        Λ=np.eye(L) / 3.0 + 0.03,
    )


@pytest.fixture(scope="module")
def sample(model):
    z, x = jssa.sample_trajectory(60, T, *model.values(), rng=np.random.default_rng(3))
    return z, x


@pytest.fixture(scope="module")
def gapped(sample):
    """The sample with scattered NaNs, a +Inf and a −Inf coordinate, a
    fully missing row and an all-NaN column (state 1 at t=2)."""
    z, x = (a.copy() for a in sample)
    rng = np.random.default_rng(4)
    z[rng.random(z.shape) < 0.15] = np.nan
    x[rng.random(x.shape) < 0.15] = np.nan
    z[1, 5, 0] = np.inf
    x[0, 7, 1] = -np.inf
    z[:, 9], x[:, 9] = np.nan, np.nan
    z[2, :, 1] = np.nan
    return z, x


_MOMENTS = {
    "mmZ": ("m", "A"),
    "mmX": ("m", "A", "H"),
    "mm": ("m", "A", "H"),
    "CZZ": ("S", "A", "Γ"),
    "CZX": ("S", "A", "Γ", "H"),
    "CXX": ("S", "A", "Γ", "H", "Λ"),
    "CC": ("S", "A", "Γ", "H", "Λ"),
}


@pytest.mark.parametrize("name", sorted(_MOMENTS))
def test_moments_match_jax(model, name):
    args = [model[k] for k in _MOMENTS[name]]
    want = getattr(jssa, name)(T, *args)
    got = getattr(tssa, name)(T, *args, **CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["full_log_prob", "composite_log_prob"])
def test_joint_log_probs_match_jax(model, sample, name):
    z, x = sample
    want = getattr(jssa, name)(z, x, T, *model.values())
    got = getattr(tssa, name)(z, x, T, *model.values(), **CPU)
    np.testing.assert_allclose(got, want, **TOL)


def test_hidden_and_observed_log_probs_match_jax(model, sample, gapped):
    p = model
    for z, x in (sample, gapped):
        np.testing.assert_allclose(
            tssa.hidden_log_prob(z, T, p["m"], p["S"], p["A"], p["Γ"], **CPU),
            jssa.hidden_log_prob(z, T, p["m"], p["S"], p["A"], p["Γ"]),
            **TOL,
        )
        np.testing.assert_allclose(
            tssa.observed_log_prob(x, T, *p.values(), **CPU),
            jssa.observed_log_prob(x, T, *p.values()),
            **TOL,
        )
    z, _x = sample
    np.testing.assert_allclose(
        tssa.composite_hidden_log_prob(z, T, p["m"], p["S"], p["A"], p["Γ"], **CPU),
        jssa.composite_hidden_log_prob(z, T, p["m"], p["S"], p["A"], p["Γ"]),
        **TOL,
    )


def test_marginalizable_log_probs_match_jax(model, sample, gapped):
    for z, x in (sample, gapped):
        want = jssa.full_marginalizable_log_prob(z, x, T, *model.values())
        got = tssa.full_marginalizable_log_prob(z, x, T, *model.values(), **CPU)
        np.testing.assert_allclose(got, want, **TOL)
    assert got[9] == 0.0 and np.isfinite(got).all()


def test_hot_kernel_matches_jax_and_fills_p(model, gapped):
    z, x = gapped
    v = jssa._pack(z, x)
    mean = jssa.mm(T, model["m"], model["A"], model["H"])
    cov = jssa.CC(T, model["S"], model["A"], model["Γ"], model["H"], model["Λ"])
    want = jssa.multivariate_normal_log_likelihood(v, mean, cov)
    p = np.empty(v.shape[0])
    got = tssa.multivariate_normal_log_likelihood(v, mean, cov, p, **CPU)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(p, got)
    assert got.dtype == np.float64
    # the same rows in a transposed (non-contiguous) view
    vt = np.ascontiguousarray(v.T).T
    np.testing.assert_array_equal(tssa.multivariate_normal_log_likelihood(vt, mean, cov, **CPU), got)


def test_hot_kernel_routes_through_the_masked_logliks(model, gapped, monkeypatch):
    """One ``em._masked_logliks`` call with one cluster and ``"auto"``: the
    router that takes K12 on the card."""
    calls = []
    real = tem._masked_logliks

    def spy(means, covs, v, patterns, pattern_id, method):
        calls.append((means.shape, covs.shape, v.dtype, method))
        return real(means, covs, v, patterns, pattern_id, method)

    monkeypatch.setattr(tem, "_masked_logliks", spy)
    z, x = gapped
    tssa.full_marginalizable_log_prob(z, x, T, *model.values(), **CPU)
    Dj = T * (D + L)
    assert calls == [((1, Dj), (1, Dj, Dj), torch.float64, "auto")]


def test_marginalizable_gaussian_log_prob_matches_jax(model, gapped):
    z, _x = gapped
    v = z[0]
    np.testing.assert_allclose(
        tssa.marginalizable_gaussian_log_prob(v, **CPU),
        jssa.marginalizable_gaussian_log_prob(v),
        **TOL,
    )
    np.testing.assert_allclose(
        tssa.marginalizable_gaussian_log_prob(v, model["m"], model["S"], **CPU),
        jssa.marginalizable_gaussian_log_prob(v, model["m"], model["S"]),
        **TOL,
    )


def test_samplers_are_bit_equal(model):
    for seed in (0, 7):
        want = jssa.sample_trajectory(25, T, *model.values(), rng=np.random.default_rng(seed))
        got = tssa.sample_trajectory(25, T, *model.values(), rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    A = model["A"]
    args = dict(
        m=lambda n, rng: rng.normal(size=(n, D)),
        f=lambda z: np.tanh(z @ A),
        Γ=lambda n, rng: 0.1 * rng.standard_t(4, size=(n, D)),
        h=lambda z: np.sin(z[:L]),
        Λ=lambda n, rng: 0.2 * rng.laplace(size=(n, L)),
    )
    want = jssa.sample_nonlinear_nongaussian_trajectory(30, D, L, T, **args, rng=np.random.default_rng(5))
    got = tssa.sample_nonlinear_nongaussian_trajectory(30, D, L, T, **args, rng=np.random.default_rng(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the default generator too
    for g, w in zip(tssa.sample_trajectory(5, T, *model.values()), jssa.sample_trajectory(5, T, *model.values())):
        np.testing.assert_array_equal(g, w)


def test_float32_on_request(model, gapped):
    z, x = gapped
    want = tssa.full_marginalizable_log_prob(z, x, T, *model.values(), **CPU)
    got = tssa.full_marginalizable_log_prob(z, x, T, *model.values(), device="cpu", dtype=torch.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_default_device_is_the_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tssa.mm(T, model["m"], model["A"], model["H"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tssa.multivariate_normal_log_likelihood(np.zeros((2, D)), np.zeros(D), np.eye(D))
