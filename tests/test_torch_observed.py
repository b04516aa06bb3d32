"""The observed-only inference family of ``MMLinGaussSS_marginalizable``
in the port against the JAX class, float64 on the CPU: the per-cluster
log-likelihoods of the observations alone (every hidden state
marginalized) at every T0 prefix, the propensities over time and the
assignment, on the model's own data and on caller data.  Up to
T0·l = 512 the dense observed moments (K12's plain version here); past
it the O(T) filters, decided per instance by the x-only suffix gate:
the suffix Kalman filter up to T = 128, the masked filter with an
all-NaN state block otherwise (K7's plain version).  "Matches" is
log-likelihoods to 1e-10 relative and identical assignments."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.ops import gaussian as jg
from multimodal_trajectory_modeling_tpu.utils import adni
from multimodal_trajectory_modeling_tpu.utils import state_space as util
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)

TOL = dict(rtol=1e-10, atol=1e-10)


def _stable_params(rng, C, d, l):
    """Stable dynamics, so that the dense observed covariance of a long
    horizon stays positive definite (the JAX battery pins them so too)."""
    return (
        np.full(C, 1.0 / C), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
        rng.normal(scale=0.3, size=(C, d, d)), np.stack([np.eye(d)] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C),
    )


def _pair(z, x, seed, params=None, C=3):
    np.random.seed(seed)
    jm = JaxMixture(n_clusters=C, states=z, observations=x, random_seed=seed)
    np.random.seed(seed)
    tm = TorchMixture(n_clusters=C, states=z, observations=x, random_seed=seed, device="cpu")
    if params is not None:
        jm._set_params(jem.MixtureParams(*map(jnp.asarray, params)))
        tm._set_params(tem.mixture_params_from_numpy(params, device="cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def adni_pair():
    """ADNI (T=4, n=571, d=2, l=4, suffix-padded) with one random fit's
    worth of stable parameters on both classes."""
    z, x, _d, _ids, _time = adni.get_trajectories()
    zs = util.standardize(z)
    params = _stable_params(np.random.default_rng(3), 3, zs.shape[2], x.shape[2])
    return (zs, x, *_pair(zs, x, 0, params))


def _caller_data(x, seed):
    """Caller observations: the training data's first 200 instances with
    interior gaps and a lost coordinate, and two all-missing rows."""
    rng = np.random.default_rng(seed)
    xc = x[:, :200].copy()
    xc[1, rng.uniform(size=200) < 0.2] = np.nan
    xc[2, rng.uniform(size=200) < 0.1, 0] = np.nan
    xc[:, [7, 150]] = np.nan
    return xc


def test_observed_logliks_at_every_prefix(adni_pair):
    zs, x, jm, tm = adni_pair
    xc = _caller_data(x, 1)
    for T0 in range(1, tm.n_timesteps + 1):
        for c in range(tm.n_clusters):
            np.testing.assert_allclose(tm.observed_condl_log_lik_first_T0_steps(c, T0),
                                       jm.observed_condl_log_lik_first_T0_steps(c, T0), **TOL)
            got = tm.observed_condl_log_lik_first_T0_steps(c, T0, observations=xc)
            np.testing.assert_allclose(got, jm.observed_condl_log_lik_first_T0_steps(c, T0, observations=xc),
                                       **TOL)
            assert np.all(got[[7, 150]] == 0.0)  # all-missing rows
    np.testing.assert_allclose(tm.observed_conditional_log_likelihoods(2, observations=xc),
                               jm.observed_conditional_log_likelihoods(2, observations=xc), **TOL)
    with pytest.raises(AssertionError):
        tm.observed_condl_log_lik_first_T0_steps(0, tm.n_timesteps + 1)
    assert ("obs", 2) in tm._device_cache and not any(k[0] == "joint" for k in tm._device_cache)


def test_observed_propensities_and_assignment(adni_pair):
    zs, x, jm, tm = adni_pair
    xc = _caller_data(x, 2)
    for obs in (None, xc):
        got = tm.observed_cluster_propensities_over_time(observations=obs)
        want = jm.observed_cluster_propensities_over_time(observations=obs)
        assert got.shape == want.shape == ((obs if obs is not None else x).shape[0],
                                           (obs if obs is not None else x).shape[1], 3)
        np.testing.assert_allclose(got, want, **TOL)
        a, probs = tm.observations_mle_cluster_assignment(return_probs=True, observations=obs)
        a_j, probs_j = jm.observations_mle_cluster_assignment(return_probs=True, observations=obs)
        np.testing.assert_array_equal(a, a_j)
        np.testing.assert_allclose(probs, probs_j, **TOL)
        np.testing.assert_array_equal(tm.observations_mle_cluster_assignment(observations=obs), a_j)


def test_observed_is_the_joint_with_all_nan_states(adni_pair):
    """``observations_mle_cluster_assignment(observations=x)`` is
    ``mle_cluster_assignment(states=all-NaN, observations=x)``: the dense
    joint with every state missing is the observed-only density."""
    zs, x, _jm, tm = adni_pair
    xc = _caller_data(x, 3)
    a, probs = tm.observations_mle_cluster_assignment(return_probs=True, observations=xc)
    a_j, probs_j, prenorm = tm.mle_cluster_assignment(
        states=np.full((xc.shape[0], xc.shape[1], zs.shape[2]), np.nan), observations=xc,
        return_probs=True, return_prenormalized_log_probs=True)
    np.testing.assert_array_equal(a, a_j)
    np.testing.assert_allclose(probs, probs_j, **TOL)
    obs_prenorm = np.log(tm.cluster_propensities)[:, None] + tm._all_observed_logliks(tm.n_timesteps, xc)
    np.testing.assert_allclose(obs_prenorm, prenorm, **TOL)


@pytest.mark.parametrize("regime", ["suffix", "gapped"])
def test_long_T_observed_routes_match_jax(regime):
    """T·l = 600 > 512: the masked filter with an all-NaN state block on
    suffix data (past T = 128) and on gapped data, as JAX routes both; an
    all-missing row gives 0.0.  The observed batch is not packed."""
    rng = np.random.default_rng(31)
    T, n, d, l = 300, 40, 1, 2
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    if regime == "suffix":
        lens = rng.integers(1, T + 1, size=n)
        x[~(np.arange(T)[:, None] < lens[None, :])] = np.nan
    else:
        x[rng.random(size=x.shape) < 0.05] = np.nan
        x[:, 5] = np.nan
    jm, tm = _pair(z, x, 11, _stable_params(rng, 2, d, l), C=2)
    assert (tm._suffix_instance_lens_x(x) is None) == (regime == "gapped")
    got = tm._all_observed_logliks(T, None)
    np.testing.assert_allclose(got, jm._all_observed_logliks(T, None), **TOL)
    np.testing.assert_array_equal(tm.observations_mle_cluster_assignment(),
                                  jm.observations_mle_cluster_assignment())
    if regime == "gapped":
        assert np.all(got[:, 5] == 0.0)
    assert not any(k[0] == "obs" for k in tm._device_cache)


def test_long_T_suffix_kalman_route_equals_dense():
    """T·l = 550 > 512 with T = 110 ≤ 128 on suffix data: the suffix
    Kalman filter, equal to the dense observed moments (f64)."""
    rng = np.random.default_rng(32)
    T, n, d, l = 110, 30, 1, 5
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n)
    x[~(np.arange(T)[:, None] < lens[None, :])] = np.nan
    np.random.seed(0)
    tm = TorchMixture(n_clusters=2, states=z, observations=x, device="cpu")
    tm._set_params(tem.mixture_params_from_numpy(_stable_params(rng, 2, d, l), device="cpu"))
    np.testing.assert_array_equal(tm._suffix_instance_lens_x(x), lens)
    got = tm._all_observed_logliks(T, None)
    _T0, vx, patterns, pid = tm._packed_observed(None, T)
    dense = tem.observed_logliks(tm._stacked_params(), vx, patterns, torch.from_numpy(pid), T=T)
    np.testing.assert_allclose(got, dense.numpy(), rtol=1e-7, atol=1e-7)


def _gate_cases():
    rng = np.random.default_rng(5)
    T, n, l = 6, 12, 2
    base = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n)
    suffix = base.copy()
    suffix[~(np.arange(T)[:, None] < lens[None, :])] = np.nan
    gap = suffix.copy()
    gap[1, np.argmax(lens >= 3)] = np.nan
    partial = suffix.copy()
    partial[0, 0, 1] = np.nan
    empty = suffix.copy()
    empty[:, 3] = np.nan
    return {"full": base, "suffix": suffix, "gap": gap, "partial": partial, "all-missing": empty}


@pytest.mark.parametrize("case", ["full", "suffix", "gap", "partial", "all-missing"])
def test_x_suffix_gate_decides_as_jax(case):
    """The per-instance gate against JAX's per-pattern
    ``_suffix_pattern_lens_x``: the same decision, the same lengths."""
    x = _gate_cases()[case]
    T, _n, l = x.shape
    patterns, pid = jg.pattern_groups(np.asarray(jem.pack_observed(jnp.asarray(x))))
    want = JaxMixture._suffix_pattern_lens_x(patterns, T, l)
    got = TorchMixture._suffix_instance_lens_x(x)
    assert (got is None) == (want is None) == (case in ("gap", "partial", "all-missing"))
    if got is not None:
        np.testing.assert_array_equal(got, want[pid])
        assert got.dtype == np.int32


def test_pack_observed_and_observed_moments_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 9, 3))
    np.testing.assert_array_equal(tem.pack_observed(torch.from_numpy(x)).numpy(),
                                  np.asarray(jem.pack_observed(jnp.asarray(x))))
    params = _stable_params(rng, 2, 2, 3)
    got = tem.cluster_observed_moments(tem.mixture_params_from_numpy(params, device="cpu"), 4)
    want = jem.cluster_observed_moments(jem.MixtureParams(*map(jnp.asarray, params)), 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
