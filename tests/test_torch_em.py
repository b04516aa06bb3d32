"""The port's Markov EM trainer against the JAX package's
``em.train_em_markov`` on NaN-suffix synthetic data, float64 on the CPU:
identical assignments, iteration count and status, parameters to 1e-10 —
with Φ materialized once (K2 + K1) and rebuilt in every iteration
(``precompute=False``, K4a)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.parallel.mesh import make_mesh

from _torch_parallel_ranks import one_rank_group


def _two_cluster_data(seed, n=400, T=5, d=2, l=3):
    """Two LG-SSM clusters, NaN-suffix-padded to lengths 1..T."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n)
    z = np.empty((T, n, d))
    x = np.empty((T, n, l))
    for c in range(2):
        sel = labels == c
        k = int(sel.sum())
        A = rng.normal(scale=0.4, size=(d, d))
        H = rng.normal(size=(d, l))
        zc = rng.normal(loc=3.0 * c, size=(k, d))
        for t in range(T):
            z[t, sel] = zc
            x[t, sel] = zc @ H + 0.3 * rng.normal(size=(k, l))
            zc = zc @ A + 0.5 * rng.normal(size=(k, d))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    steps = np.arange(T)[:, None] >= lens[None, :]
    z[steps] = np.nan
    x[steps] = np.nan
    return z, x, lens, labels


def _init_params(seed, C, d, l):
    rng = np.random.default_rng(seed)
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    return (
        np.full(C, 1.0 / C),
        rng.normal(size=(C, d)),
        eye(d),
        rng.normal(scale=0.3, size=(C, d, d)),
        eye(d),
        rng.normal(size=(C, d, l)),
        eye(l),
    )


def _fit_both(params, assign0, z, x, lens, **kw):
    pj, aj, ij, sj = jem.train_em_markov(
        jem.MixtureParams(*map(jnp.asarray, params)),
        jnp.asarray(assign0, jnp.int32),
        jnp.asarray(z),
        jnp.asarray(x),
        jnp.asarray(lens),
        **kw,
    )
    pt, at, it, st = tem.train_em_markov(
        tem.mixture_params_from_numpy(params, device="cpu"),
        torch.from_numpy(assign0.astype(np.int32)),
        torch.from_numpy(z),
        torch.from_numpy(x),
        torch.from_numpy(lens),
        **kw,
    )
    return (pj, np.asarray(aj), int(ij), int(sj)), (pt, at.numpy(), it, st)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reg_mode", ["lstsq", "ridge"])
def test_train_em_markov_matches_jax(seed, reg_mode):
    z, x, lens, labels = _two_cluster_data(seed)
    rng = np.random.default_rng(100 + seed)
    assign0 = np.where(rng.uniform(size=labels.size) < 0.3, 1 - labels, labels)
    params0 = _init_params(seed, 2, z.shape[2], x.shape[2])
    (pj, aj, ij, sj), (pt, at, it, st) = _fit_both(
        params0, assign0, z, x, lens, n_steps=50, reg_mode=reg_mode,
        alpha=0.5 if reg_mode == "ridge" else 0.0,
    )
    assert (it, st) == (ij, sj)
    assert st == tem.STATUS_CONVERGED and it > 1
    np.testing.assert_array_equal(at, aj)
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_em_markov_precompute_off_matches_jax(seed):
    """``precompute=False``: every iteration rebuilds Φ from the packed
    batch (K4a in the port, ``markov_em_fused_packed`` in JAX)."""
    z, x, lens, labels = _two_cluster_data(seed)
    rng = np.random.default_rng(200 + seed)
    assign0 = np.where(rng.uniform(size=labels.size) < 0.3, 1 - labels, labels)
    params0 = _init_params(seed, 2, z.shape[2], x.shape[2])
    (pj, aj, ij, sj), (pt, at, it, st) = _fit_both(
        params0, assign0, z, x, lens, n_steps=50, precompute=False
    )
    assert (it, st) == (ij, sj)
    assert st == tem.STATUS_CONVERGED and it > 1
    np.testing.assert_array_equal(at, aj)
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-10)
    # the same trajectory as with Φ materialized once
    pp, ap, ip, sp = tem.train_em_markov(
        tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0.astype(np.int32)),
        torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(lens), n_steps=50,
    )
    assert (ip, sp) == (it, st)
    np.testing.assert_array_equal(ap.numpy(), at)


def test_train_em_markov_step_budget_matches_jax():
    """A fit cut by ``n_steps`` stops at the same iteration with status
    RUNNING in both packages."""
    z, x, lens, labels = _two_cluster_data(2, n=300)
    assign0 = np.random.default_rng(5).integers(0, 2, size=labels.size)
    params0 = _init_params(2, 2, z.shape[2], x.shape[2])
    (pj, aj, ij, sj), (pt, at, it, st) = _fit_both(
        params0, assign0, z, x, lens, n_steps=2
    )
    assert (it, st) == (ij, sj) == (2, tem.STATUS_RUNNING)
    np.testing.assert_array_equal(at, aj)
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-10)


def test_train_em_markov_init_abort_matches_jax():
    """A cluster with ≤ 3 initial members aborts before training and
    returns the initial parameters untouched."""
    z, x, lens, labels = _two_cluster_data(3, n=100)
    assign0 = np.zeros(labels.size, np.int64)
    assign0[:3] = 1  # cluster 1 has 3 members
    params0 = _init_params(3, 2, z.shape[2], x.shape[2])
    (pj, aj, ij, sj), (pt, at, it, st) = _fit_both(
        params0, assign0, z, x, lens
    )
    assert (it, st) == (ij, sj) == (0, tem.STATUS_INIT_ABORT)
    np.testing.assert_array_equal(at, aj)
    for a, b in zip(tem.mixture_params_to_numpy(pt), params0):
        np.testing.assert_array_equal(a, b)


def test_unported_branches_raise(monkeypatch, tmp_path):
    """What still raises (bfloat16 Φ); what once raised and now runs: the
    data-parallel pool (``mesh=``), here over a one-rank gloo group against
    JAX's pool on a one-device mesh (``test_torch_parallel.py`` holds it on
    two ranks), and ``precompute=False`` past T·s = 512 (kernel K6),
    against JAX."""
    z, x, lens, labels = _two_cluster_data(4, n=50)
    args = (
        tem.mixture_params_from_numpy(_init_params(4, 2, 2, 3), device="cpu"),
        torch.from_numpy(labels),
        torch.from_numpy(z),
        torch.from_numpy(x),
        torch.from_numpy(lens),
    )
    with one_rank_group(str(tmp_path)):
        (got, *_), _stats = tem.train_em_markov_pool(
            [args[0]], [labels], *args[2:], mesh=make_mesh()
        )
    want, = jem.train_em_markov_pool(
        [jem.MixtureParams(*map(jnp.asarray, _init_params(4, 2, 2, 3)))], [labels],
        jnp.asarray(z), jnp.asarray(x), jnp.asarray(lens),
        mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)),
    )
    assert got[2:] == (int(want[2]), int(want[3])) and got[2] >= 1
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, b in zip(tem.mixture_params_to_numpy(got[0]), want[0]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-10)
    monkeypatch.setenv("MTM_MARKOV_PHI", "bf16")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tem.train_em_markov(*args)
    monkeypatch.delenv("MTM_MARKOV_PHI")
    zl, xl, lensl, labelsl = _two_cluster_data(5, n=60, T=70)  # T·s = 560 > 512
    rng = np.random.default_rng(6)
    assign0 = np.where(rng.uniform(size=labelsl.size) < 0.3, 1 - labelsl, labelsl)
    (pj, aj, ij, sj), (pt, at, it, st) = _fit_both(
        _init_params(5, 2, 2, 3), assign0, zl, xl, lensl, n_steps=5, precompute=False
    )
    assert (it, st) == (ij, sj) and it >= 1
    np.testing.assert_array_equal(at, aj)
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-10)
