"""The port's masked-filter route against the JAX package, float64 on the
CPU: ``train_em_masked_kalman`` (ridge, an init abort, the step budget),
``mstep_multi``, ``emstep_masked_kalman_multi``,
``train_em_masked_kalman_pool`` and the objectives, then
``MMLinGaussSS_marginalizable.train(fast=True)`` on unstructured
missingness (> 256 patterns) and at T(d+l) > 512 with interior gaps, and
the masked multistart one candidate after another and under
``MTM_MASKED_POOL=1``.  "Matches" is identical assignments, iterations,
statuses and winners, parameters and objectives to 1e-10.  JAX runs its
XLA filter here (K7's semantics; the kernel itself is held against it in
``test_torch_kalman.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)

TOL = dict(rtol=1e-10, atol=1e-10)
_PARAM_LISTS = (
    "cluster_propensities",
    "init_state_means",
    "init_state_covs",
    "transition_matrices",
    "transition_covs",
    "measurement_matrices",
    "measurement_covs",
)


def _scattered(seed, T=8, n=300, d=3, l=2, p=0.15, shift=2.0):
    """Two clusters, each coordinate missing with probability ``p``."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l)) + 0.7 * np.repeat(z[:, :, :1], l, axis=2)
    z[:, n // 2 :, :] += shift
    z[rng.random(z.shape) < p] = np.nan
    x[rng.random(x.shape) < p] = np.nan
    labels = (np.arange(n) >= n // 2).astype(np.int64)
    return z, x, labels


def _init_params(seed, C, d, l):
    rng = np.random.default_rng(seed)
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    return (
        np.full(C, 1.0 / C), rng.normal(size=(C, d)), eye(d),
        rng.normal(scale=0.3, size=(C, d, d)), eye(d), rng.normal(size=(C, d, l)), eye(l),
    )


def _warm(labels, seed, flip=0.25):
    rng = np.random.default_rng(seed)
    return np.where(rng.uniform(size=labels.size) < flip, 1 - labels, labels)


def _jp(params):
    return jem.MixtureParams(*map(jnp.asarray, params))


def _tp(params):
    return tem.mixture_params_from_numpy(params, device="cpu")


def _assert_params(tp, jp):
    for a, b in zip(tem.mixture_params_to_numpy(tp), jp):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _assert_fit_equal(jfit, tfit):
    pj, aj, ij, sj = jfit
    pt, at, it, st = tfit
    assert (it, st) == (int(ij), int(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    _assert_params(pt, pj)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reg_mode", ["lstsq", "ridge"])
def test_train_em_masked_kalman_matches_jax(seed, reg_mode):
    z, x, labels = _scattered(seed)
    params0 = _init_params(seed, 2, 3, 2)
    assign0 = _warm(labels, 10 + seed)
    kw = dict(n_steps=50, reg_mode=reg_mode, alpha=0.5 if reg_mode == "ridge" else 0.0)
    jfit = jem.train_em_masked_kalman(_jp(params0), jnp.asarray(assign0), jnp.asarray(z), jnp.asarray(x), **kw)
    tfit = tem.train_em_masked_kalman(_tp(params0), torch.from_numpy(assign0), torch.from_numpy(z),
                                      torch.from_numpy(x), **kw)
    _assert_fit_equal(jfit, tfit)
    assert tfit[3] == tem.STATUS_CONVERGED and tfit[2] > 1


def test_init_abort_and_step_budget_match_jax():
    z, x, labels = _scattered(2, n=120)
    params0 = _init_params(2, 2, 3, 2)
    abort = np.zeros(labels.size, np.int64)
    abort[:3] = 1
    for assign0, n_steps, want in ((abort, 50, (0, tem.STATUS_INIT_ABORT)),
                                   (_warm(labels, 3, flip=0.45), 2, (2, tem.STATUS_RUNNING))):
        args = (assign0, z, x)
        jfit = jem.train_em_masked_kalman(_jp(params0), *map(jnp.asarray, args), n_steps=n_steps)
        tfit = tem.train_em_masked_kalman(_tp(params0), *map(torch.from_numpy, args), n_steps=n_steps)
        assert tfit[2:] == want
        _assert_fit_equal(jfit, tfit)


def test_mstep_multi_matches_jax():
    """Three assignments, one of them an idle slot (all -1)."""
    z, x, labels = _scattered(4)
    assign = np.stack([labels, _warm(labels, 5), np.full(labels.size, -1)])
    want = jem.mstep_multi(jnp.asarray(z), jnp.asarray(x), jnp.asarray(assign), n_clusters=2)
    got = tem.mstep_multi(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(assign), n_clusters=2)
    for a, b in zip(tem.mixture_params_to_numpy(got), want):
        np.testing.assert_allclose(a[:2], np.asarray(b)[:2], **TOL)
        assert np.array_equal(np.isnan(a), np.isnan(np.asarray(b)))
    single = tem.mstep(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(labels), n_clusters=2)
    for a, b in zip(tem.mixture_params_to_numpy(got), tem.mixture_params_to_numpy(single)):
        np.testing.assert_allclose(a[0], b, **TOL)


def test_emstep_masked_kalman_multi_matches_jax():
    z, x, labels = _scattered(6)
    plist = [_init_params(s, 2, 3, 2) for s in (0, 1, 2)]
    stacked = tuple(np.stack(f) for f in zip(*plist))
    prev = np.stack([labels, _warm(labels, 7), _warm(labels, 8)]).astype(np.int32)
    force = np.array([0, 1, 0], np.int32)
    jout = jem.emstep_masked_kalman_multi(
        jem.MixtureParams(*map(jnp.asarray, stacked)), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(prev), force_prev=jnp.asarray(force),
    )
    tout = tem.emstep_masked_kalman_multi(
        _tp(stacked), torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(prev),
        force_prev=torch.from_numpy(force),
    )
    for k in (1, 2, 3):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    np.testing.assert_array_equal(tout[1][1].numpy(), prev[1])  # the forced slot
    _assert_params(tout[0], jout[0])


def test_objectives_match_jax():
    z, x, _labels = _scattered(9)
    params = _init_params(9, 3, 3, 2)
    want = jem.masked_logliks_kalman(_jp(params), jnp.asarray(z), jnp.asarray(x))
    got = tem.masked_logliks_kalman(_tp(params), torch.from_numpy(z), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-9)
    want = jem.complete_data_loglik_masked_kalman(_jp(params), jnp.asarray(z), jnp.asarray(x))
    got = tem.complete_data_loglik_masked_kalman(_tp(params), torch.from_numpy(z), torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def test_train_em_masked_kalman_pool_matches_jax():
    """Five candidates through two slots, one an init abort: each
    candidate's result as JAX's pool gives it (and as a standalone fit)."""
    z, x, labels = _scattered(11, n=200)
    plist = [_init_params(s, 2, 3, 2) for s in range(5)]
    alist = [_warm(labels, 20 + k, flip=0.1 * (k + 1)).astype(np.int32) for k in range(5)]
    alist[2] = np.zeros(labels.size, np.int32)
    alist[2][:2] = 1
    kw = dict(R=2, n_steps=30, sync_every=3)
    jres = jem.train_em_masked_kalman_pool(
        [_jp(p) for p in plist], alist, jnp.asarray(z), jnp.asarray(x), **kw
    )
    tres, stats = tem.train_em_masked_kalman_pool(
        [_tp(p) for p in plist], alist, torch.from_numpy(z), torch.from_numpy(x), **kw
    )
    assert stats.windows >= 1 and stats.status_reads == stats.windows
    assert tres[2][2:] == (0, tem.STATUS_INIT_ABORT)
    for k, (jr, tr) in enumerate(zip(jres, tres)):
        _assert_fit_equal(jr, tr)
        solo = tem.train_em_masked_kalman(_tp(plist[k]), torch.from_numpy(alist[k]),
                                          torch.from_numpy(z), torch.from_numpy(x), n_steps=30)
        assert solo[2:] == tr[2:]


# ----------------------------------------------------------------------
# the API
# ----------------------------------------------------------------------


def _assert_models_equal(tm, jm):
    np.testing.assert_array_equal(tm.cluster_assignment, np.asarray(jm.cluster_assignment))
    for name in _PARAM_LISTS:
        np.testing.assert_allclose(np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)), **TOL)


def _spy(monkeypatch):
    calls = []
    real = tem.train_em_masked_kalman

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tem, "train_em_masked_kalman", spy)
    return calls


def test_train_fast_unstructured_missingness_routes_filter(monkeypatch):
    """More than 256 missingness patterns at T(d+l) ≤ 512."""
    z, x, _labels = _scattered(13, n=400)
    calls = _spy(monkeypatch)
    np.random.seed(3)
    jm = JaxMixture(n_clusters=2, states=z, observations=x, random_seed=3)
    np.random.seed(3)
    tm = TorchMixture(n_clusters=2, states=z, observations=x, random_seed=3, device="cpu")
    assert tm._packed()[4].shape[0] > 256
    jm.train(fast=True, n_steps=40)
    tm.train(fast=True, n_steps=40)
    assert calls == [1]
    assert tm.last_status in (tem.STATUS_CONVERGED, tem.STATUS_EMPTY_CLUSTER)
    _assert_models_equal(tm, jm)


def test_train_fast_long_T_interior_missingness_routes_filter(monkeypatch):
    """T(d+l) = 550 with per-coordinate gaps (the JAX package's
    ``test_train_fast_long_T_interior_missingness_routes_filter``): the
    filter route, and the joint batch is never packed."""
    rng = np.random.default_rng(17)
    C, T, n, d, l = 2, 110, 48, 2, 3
    centers = np.array([[-6.0, -6.0], [6.0, 6.0]])
    labels = np.arange(n) % C
    z = np.cumsum(rng.normal(0, 0.1, size=(T, n, d)), axis=0) + centers[labels][None]
    x = z @ rng.normal(size=(d, l)) * 0.5 + rng.normal(0, 0.3, (T, n, l))
    z[rng.random(z.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = np.nan
    calls = _spy(monkeypatch)
    jm = JaxMixture(n_clusters=C, states=z, observations=x, random_seed=3, init="kmeans")
    tm = TorchMixture(n_clusters=C, states=z, observations=x, random_seed=3, init="kmeans", device="cpu")
    jm.train(n_steps=30, fast=True)
    tm.train(n_steps=30, fast=True)
    assert calls == [1] and not any(k[0] == "joint" for k in tm._device_cache)
    _assert_models_equal(tm, jm)
    acc = max(np.mean(tm.cluster_assignment == labels), np.mean(tm.cluster_assignment != labels))
    assert acc > 0.95


@pytest.mark.parametrize("pool", ["0", "1"])
def test_masked_multistart_matches_jax(monkeypatch, pool):
    """The masked multistart one candidate after another and through the
    pool (``MTM_MASKED_POOL=1``, two slots): the same objectives, winner,
    assignment and statuses as JAX."""
    z, x, _labels = _scattered(17)
    monkeypatch.setenv("MTM_MULTISTART_FUSE", "2")
    monkeypatch.setenv("MTM_MASKED_POOL", pool)
    calls = _spy(monkeypatch)
    kw = dict(n_starts=3, n_steps=8, use_cache=False, fast=True, return_objectives=True)
    np.random.seed(2468)
    jb, jo = JaxMixture(n_clusters=2, states=z, observations=x).train_with_multiple_random_starts(**kw)
    np.random.seed(2468)
    tb, to = TorchMixture(n_clusters=2, states=z, observations=x, device="cpu").train_with_multiple_random_starts(**kw)
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    assert tb.random_seed == jb.random_seed
    _assert_models_equal(tb, jb)
    run = tb.last_multistart
    assert len(run["statuses"]) == 4
    if pool == "1":
        assert calls == [] and run["pool"] is not None and run["pool"].windows >= 1
    else:
        assert calls == [1] * 4 and run["pool"] is None
