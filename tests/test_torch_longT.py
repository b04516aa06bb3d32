"""The port's long-T Markov route (T·s > 512) against the JAX package,
float64 on the CPU: K5's plain version against JAX's
``markov_materialize_features_longT`` in interpret mode, K1's and K3's
plain versions on the canonical Φ against JAX's
``markov_em_from_features[_multi](layout="canonical")``, then
``train_em_markov``, ``train_em_markov_pool`` and the objectives at long
T, ``train(fast=True)`` on long-T suffix data and the pooled long-T
multistart, and the API routes that run kernel K6.  "Matches" is
identical assignments, iterations, statuses and winners, parameters and
objectives to 1e-10 (Φ to 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)
from multimodal_trajectory_modeling_tpu_torch.ops import markov as tmops
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as tmk

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


def _suffix(seed, T=72, n=160, d=3, l=2):
    """Two clusters, NaN past a length in [4, T] (T·s = 8T > 512)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l)) + 0.7 * np.repeat(z[:, :, :1], l, axis=2)
    z[:, n // 2 :, :] += 2.0
    lens = rng.integers(4, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    labels = (np.arange(n) >= n // 2).astype(np.int64)
    return z, x, lens, labels


def _transposed(z, x):
    T, n, d = z.shape
    return z.transpose(0, 2, 1).reshape(T * d, n), x.transpose(0, 2, 1).reshape(T * x.shape[2], n)


def _init_params(seed, C, d, l):
    rng = np.random.default_rng(seed)
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    return (
        np.full(C, 1.0 / C), rng.normal(size=(C, d)), eye(d),
        rng.normal(scale=0.3, size=(C, d, d)), eye(d), rng.normal(size=(C, d, l)), eye(l),
    )


def _warm(labels, seed, flip=0.2):
    rng = np.random.default_rng(seed)
    return np.where(rng.uniform(size=labels.size) < flip, 1 - labels, labels)


def _tp(params):
    return tem.mixture_params_from_numpy(params, device="cpu")


def _jp(params):
    return jem.MixtureParams(*map(jnp.asarray, params))


def _assert_fit_equal(jfit, tfit):
    pj, aj, ij, sj = jfit
    pt, at, it, st = tfit
    assert (it, st) == (int(ij), int(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("T,d,l", [(72, 3, 2), (80, 5, 3), (70, 2, 4)])
def test_longT_features_match_jax(T, d, l):
    z, x, lens, _labels = _suffix(T + d, T=T, n=200, d=d, l=l)
    z_t, x_t = _transposed(z, x)
    want = np.asarray(jpm.markov_materialize_features_longT(
        jnp.asarray(z_t), jnp.asarray(x_t), jnp.asarray(lens), T=T, d=d, l=l, interpret=True,
    ))[:, :200]
    got = tmk.markov_materialize_features_longT(
        *map(torch.from_numpy, (z_t, x_t, lens)), T=T, d=d, l=l
    ).numpy()
    F_pad, pos = tmk._feature_layout(T, d, l)
    assert got.shape == (F_pad, 200) and len(pos) == 4 * d * d + l * l + d * l + 3 * d + l + 2
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    # the g-layout oracle of the feature definition
    feats = tmops.markov_em_features(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got[: len(pos)], feats.numpy().T, rtol=1e-12, atol=1e-9)


def _canonical_phi(seed, C=3, R=None):
    z, x, lens, labels = _suffix(seed)
    T, _n, d = z.shape
    l = x.shape[2]
    z_t, x_t = _transposed(z, x)
    phi = tmk.markov_materialize_features_longT(*map(torch.from_numpy, (z_t, x_t, lens)), T=T, d=d, l=l)
    shape = (C,) if R is None else (R, C)
    rng = np.random.default_rng(seed)
    params = [_init_params(seed + k, C, d, l) for k in range(1 if R is None else R)]
    if R is None:
        Wg = tem._weights(_tp(params[0]))
    else:
        Wg = tem._stacked_weights(_tp(tuple(np.stack(f) for f in zip(*params))))
    prev = rng.integers(0, C, size=shape[:-1] + (lens.size,)).astype(np.int32)
    return phi, torch.from_numpy(lens), torch.from_numpy(prev), Wg, (T, d, l)


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
def test_k1_on_canonical_phi_matches_jax(assign_mode):
    phi, lens, prev, Wg, (T, d, l) = _canonical_phi(21)
    kw = dict(T=T, d=d, l=l, assign_mode=assign_mode)
    want = jpm.markov_em_from_features(
        jnp.asarray(phi.numpy()), jnp.asarray(lens.numpy()), jnp.asarray(prev.numpy()),
        jnp.asarray(Wg.numpy()), layout="canonical", interpret=True, **kw,
    )
    got = tmk.markov_em_from_features(phi, prev, Wg, **kw)
    for k in (0, 1, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)
    np.testing.assert_allclose(float(got[4]), float(want[4]), **TOL)


def test_k3_on_canonical_phi_matches_jax():
    phi, lens, prev, Wg, (T, d, l) = _canonical_phi(22, R=3)
    force = np.array([0, 1, 0], np.int32)
    kw = dict(T=T, d=d, l=l)
    want = jpm.markov_em_from_features_multi(
        jnp.asarray(phi.numpy()), jnp.asarray(lens.numpy()), jnp.asarray(prev.numpy()),
        jnp.asarray(Wg.numpy()), force_prev=jnp.asarray(force), layout="canonical", interpret=True, **kw,
    )
    got = tmk.markov_em_from_features_multi(phi, lens, prev, Wg, force_prev=torch.from_numpy(force), **kw)
    for k in (0, 1, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), **TOL)


@pytest.mark.parametrize("reg_mode", ["lstsq", "ridge"])
def test_train_em_markov_longT_matches_jax(reg_mode):
    z, x, lens, labels = _suffix(23)
    params0 = _init_params(23, 2, 3, 2)
    assign0 = _warm(labels, 24)
    kw = dict(n_steps=30, reg_mode=reg_mode, alpha=0.5 if reg_mode == "ridge" else 0.0)
    args = (assign0, z, x, lens)
    jfit = jem.train_em_markov(_jp(params0), *map(jnp.asarray, args), **kw)
    before = tmk.markov_materialize_features_longT.launches
    tfit = tem.train_em_markov(_tp(params0), *map(torch.from_numpy, args), **kw)
    assert tmk.markov_materialize_features_longT.launches == before  # CPU: the plain version
    _assert_fit_equal(jfit, tfit)
    assert tfit[3] == tem.STATUS_CONVERGED and tfit[2] > 1


def test_train_em_markov_pool_longT_matches_jax():
    """Four candidates through two slots on the canonical Φ, and their
    objectives from K3 on the wide canonical Φ."""
    z, x, lens, labels = _suffix(25)
    T, _n, d = z.shape
    l = x.shape[2]
    plist = [_init_params(s, 2, d, l) for s in range(4)]
    alist = [_warm(labels, 30 + k, flip=0.1 * (k + 1)).astype(np.int32) for k in range(4)]
    kw = dict(R=2, n_steps=20, sync_every=3)
    jres = jem.train_em_markov_pool(
        [_jp(p) for p in plist], alist, *map(jnp.asarray, (z, x, lens)), **kw
    )
    tres, stats = tem.train_em_markov_pool(
        [_tp(p) for p in plist], alist, *map(torch.from_numpy, (z, x, lens)), **kw
    )
    assert stats.windows >= 1
    for jr, tr in zip(jres, tres):
        _assert_fit_equal(jr, tr)
    z_t, x_t = _transposed(z, x)
    phi_j = jpm.markov_materialize_features_longT(
        jnp.asarray(z_t), jnp.asarray(x_t), jnp.asarray(lens), T=T, d=d, l=l, interpret=True
    )
    want = jem.complete_data_loglik_markov_multi(
        jem.MixtureParams(*(jnp.stack(f) for f in zip(*[r[0] for r in jres]))),
        jnp.asarray(lens), None, T=T, phi=phi_j, phi_layout="canonical",
    )
    phi_t = tmk.markov_materialize_features_longT(*map(torch.from_numpy, (z_t, x_t, lens)), T=T, d=d, l=l)
    got = tem.complete_data_loglik_markov_multi(
        tem.stack_params([r[0] for r in tres]), torch.from_numpy(lens), None, T=T, phi=phi_t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_train_fast_on_long_T_suffix_data_matches_jax():
    z, x, _lens, _labels = _suffix(27)
    np.random.seed(5)
    jm = JaxMixture(n_clusters=2, states=z, observations=x, random_seed=5)
    np.random.seed(5)
    tm = TorchMixture(n_clusters=2, states=z, observations=x, random_seed=5, device="cpu")
    jm.train(fast=True, n_steps=30)
    tm.train(fast=True, n_steps=30)
    assert not any(k[0] == "joint" for k in tm._device_cache)  # the Markov route packs no joint batch
    np.testing.assert_array_equal(tm.cluster_assignment, np.asarray(jm.cluster_assignment))
    for name in _PARAM_LISTS:
        np.testing.assert_allclose(np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)), **TOL)


def test_pooled_multistart_longT_matches_jax(monkeypatch):
    """Four candidates through two slots at long T: the same objectives
    (ranked on the wide canonical Φ), winner and assignment as JAX."""
    z, x, _lens, _labels = _suffix(29)
    monkeypatch.setenv("MTM_MULTISTART_FUSE", "2")
    kw = dict(n_starts=3, n_steps=8, use_cache=False, fast=True, return_objectives=True)
    np.random.seed(4321)
    jb, jo = JaxMixture(n_clusters=2, states=z, observations=x).train_with_multiple_random_starts(**kw)
    np.random.seed(4321)
    tb, to = TorchMixture(n_clusters=2, states=z, observations=x, device="cpu").train_with_multiple_random_starts(**kw)
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    assert tb.random_seed == jb.random_seed and tb.last_multistart["pool"] is not None
    np.testing.assert_array_equal(tb.cluster_assignment, np.asarray(jb.cluster_assignment))


def test_k6_branches_raise(monkeypatch):
    """The API routes that run kernel K6 at long T, once raising, now
    match JAX: ``train(fast=True)`` under ``MTM_MARKOV_PRECOMP=0`` (K6 per
    iteration) and the sequential multistart (``MTM_MULTISTART_FUSE=1``,
    each objective one K6 pass): the same objectives, winner, assignment
    and parameters."""
    z, x, _lens, _labels = _suffix(31, n=60)
    monkeypatch.setenv("MTM_MARKOV_PRECOMP", "0")
    np.random.seed(6)
    jm = JaxMixture(n_clusters=2, states=z, observations=x, random_seed=6)
    np.random.seed(6)
    tm = TorchMixture(n_clusters=2, states=z, observations=x, random_seed=6, device="cpu")
    before = tmk.markov_materialize_features_longT.launches
    jm.train(fast=True, n_steps=6)
    tm.train(fast=True, n_steps=6)
    assert tmk.markov_materialize_features_longT.launches == before
    np.testing.assert_array_equal(tm.cluster_assignment, np.asarray(jm.cluster_assignment))
    for name in _PARAM_LISTS:
        np.testing.assert_allclose(np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)), **TOL)
    monkeypatch.delenv("MTM_MARKOV_PRECOMP")
    monkeypatch.setenv("MTM_MULTISTART_FUSE", "1")
    kw = dict(n_starts=2, n_steps=4, use_cache=False, fast=True, return_objectives=True)
    np.random.seed(77)
    jb, jo = JaxMixture(n_clusters=2, states=z, observations=x).train_with_multiple_random_starts(**kw)
    np.random.seed(77)
    tb, to = TorchMixture(n_clusters=2, states=z, observations=x, device="cpu").train_with_multiple_random_starts(**kw)
    assert tb.last_multistart["pool"] is None
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    assert tb.random_seed == jb.random_seed
    np.testing.assert_array_equal(tb.cluster_assignment, np.asarray(jb.cluster_assignment))


def test_mstep_long_T_matches_jax():
    """The masked M step's time-batched statistics at T = 128 (the long-T
    shape of the masked route), against JAX."""
    rng = np.random.default_rng(33)
    T, n, d, l, C = 128, 300, 5, 3, 3
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[rng.random(z.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = np.nan
    assign = rng.integers(0, C, size=n)
    want = jem.mstep(jnp.asarray(z), jnp.asarray(x), jnp.asarray(assign), n_clusters=C)
    got = tem.mstep(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(assign), n_clusters=C)
    for a, b in zip(tem.mixture_params_to_numpy(got), want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
