"""The port's Markov EM kernels (plain versions, on the CPU in float64)
against the JAX package's Pallas kernels run in interpret mode, on the
same seeded numpy inputs.

- K2 (Φ materialization): Φ rows agree to 1e-12 of each row's absmax.
- K1 (EM iteration over Φ), in both assign modes, for wide and int16 Φ:
  assignments, counts and switches identical; statistics and objective
  to 1e-10 relative.
- K3 (K1 for R restarts), K4a and K4b (the EM iteration rebuilding Φ from
  the packed batch, one and R restarts), in both assign modes, with a
  mixed ``force_prev`` mask and with a cluster of NaN weights (the two
  argmax rules): the same tolerances; NaN objectives agree as NaN.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import markov as jmarkov
from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu_torch.ops import markov as tmarkov
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as tmk

SHAPES = [(4, 2, 2, 301), (6, 3, 2, 293)]  # (T, d, l, n)
C = 3


def _batch(T, d, l, n, seed=0):
    """NaN-suffix-padded (T, n, d)/(T, n, l) data, lengths 1..T."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    steps = np.arange(T)[:, None] >= lens[None, :]
    z[steps] = np.nan
    x[steps] = np.nan
    return z, x, lens


def _transposed(a):  # (T, n, k) -> (T·k, n)
    T, n, k = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1).reshape(T * k, n))


def _params(d, l, seed=1):
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


@functools.lru_cache(maxsize=None)
def _jax_phi(T, d, l, n, seed):
    """The JAX kernel's Φ (Fc_pad, n_pad) for ``_batch(T, d, l, n, seed)``."""
    z, x, lens = _batch(T, d, l, n, seed)
    u = jpm.pack_markov_u(
        jnp.asarray(_transposed(z)), jnp.asarray(_transposed(x)),
        T=T, d=d, l=l, pad_to=512,
    )
    return jpm.markov_materialize_features(
        u, jnp.asarray(lens), T=T, d=d, l=l, block_n=512, interpret=True
    )


@pytest.mark.parametrize("T,d,l,n", SHAPES)
def test_pack_u_matches_jax(T, d, l, n):
    z, x, lens = _batch(T, d, l, n)
    u_j = jpm.pack_markov_u(
        jnp.asarray(_transposed(z)), jnp.asarray(_transposed(x)),
        T=T, d=d, l=l,
    )
    u_t = tmk.pack_markov_u(
        torch.from_numpy(_transposed(z)), torch.from_numpy(_transposed(x)),
        T=T, d=d, l=l,
    )
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j)[:, :n])


@pytest.mark.parametrize("T,d,l,n", SHAPES)
def test_materialize_plain_matches_jax_kernel(T, d, l, n):
    z, x, lens = _batch(T, d, l, n)
    phi_j = np.asarray(_jax_phi(T, d, l, n, 0))[:, :n]
    u = tmk.pack_markov_u(
        torch.from_numpy(_transposed(z)), torch.from_numpy(_transposed(x)),
        T=T, d=d, l=l,
    )
    phi_t = tmk.markov_materialize_features(
        u, torch.from_numpy(lens), T=T, d=d, l=l
    ).numpy()
    assert phi_t.shape == phi_j.shape
    bound = 1e-12 * np.maximum(np.abs(phi_j).max(axis=1, keepdims=True), 1.0)
    assert np.all(np.abs(phi_t - phi_j) <= bound)


@pytest.mark.parametrize("T,d,l,n", SHAPES)
def test_materialize_plain_matches_feature_definition(T, d, l, n):
    """Φ read through ``pos`` is the g-layout feature matrix built
    straight from its definition (``ops.markov.markov_em_features``)."""
    z, x, lens = _batch(T, d, l, n, seed=3)
    u = tmk.pack_markov_u(
        torch.from_numpy(_transposed(z)), torch.from_numpy(_transposed(x)),
        T=T, d=d, l=l,
    )
    phi = tmk.markov_materialize_features_plain(
        u, torch.from_numpy(lens), T=T, d=d, l=l
    )
    _Fc_pad, _uniq, pos = tmk.markov_compact_spec(T, d, l)
    g = tmarkov.markov_em_features(
        torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(lens)
    )
    np.testing.assert_allclose(
        phi.numpy()[pos].T, g.numpy(), rtol=1e-12, atol=1e-12
    )


def _weights(d, l, seed):
    m, S, A, G, H, L = _params(d, l, seed)
    log_pi = np.log(np.array([0.5, 0.3, 0.2]))
    Wg_j = jmarkov.markov_em_weights(*map(jnp.asarray, (m, S, A, G, H, L)))
    Wg_j = Wg_j.at[:, -1].add(jnp.asarray(log_pi))
    Wg_t = tmarkov.markov_em_weights(*map(torch.from_numpy, (m, S, A, G, H, L)))
    Wg_t[:, -1] += torch.from_numpy(log_pi)
    return Wg_j, Wg_t


@pytest.mark.parametrize("T,d,l,n", SHAPES)
@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("storage", ["wide", "i16"])
def test_em_from_features_plain_matches_jax_kernel(
    T, d, l, n, assign_mode, storage
):
    _z, _x, lens = _batch(T, d, l, n)
    phi_j = _jax_phi(T, d, l, n, 0)
    Wg_j, Wg_t = _weights(d, l, seed=5)
    rng = np.random.default_rng(6)
    prev = rng.integers(0, C, size=n).astype(np.int32)
    prev[rng.choice(n, size=7, replace=False)] = -1  # rows left out

    phi_t = torch.from_numpy(np.asarray(phi_j)[:, :n].copy())
    if storage == "i16":
        phi_j = jpm.quantize_phi(phi_j)
        phi_t = tmk.quantize_phi(phi_t)
    out_j = jpm.markov_em_from_features(
        phi_j, jnp.asarray(lens), jnp.asarray(prev), Wg_j,
        T=T, d=d, l=l, assign_mode=assign_mode, interpret=True,
    )
    out_t = tmk.markov_em_from_features(
        phi_t, torch.from_numpy(prev), Wg_t,
        T=T, d=d, l=l, assign_mode=assign_mode,
    )
    a_j, c_j, s_j, g_j, o_j = (np.asarray(v) for v in out_j)
    a_t, c_t, s_t, g_t, o_t = (v.numpy() for v in out_t)
    np.testing.assert_array_equal(a_t, a_j)
    assert np.all(a_t[prev < 0] == C)
    np.testing.assert_array_equal(c_t, c_j)
    assert int(s_t) == int(s_j)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(o_t, o_j, rtol=1e-10, atol=1e-10)
    if assign_mode == "argmax":
        assert int(s_t) > 0 and float(o_t) != 0.0


def test_int16_statistics_are_exact_integers():
    """Under int16 Φ the plain K1 sums integers exactly (int64)."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.integers(-32766, 32767, size=(16, 999)).astype(np.int16))
    prev = torch.from_numpy(rng.integers(0, 4, size=999).astype(np.int32))
    wc = torch.zeros((4, 16), dtype=torch.float64)
    _a, counts, _s, macc, _o = tmk.markov_em_compact(
        q, prev, wc, assign_mode="prev"
    )
    assert macc.dtype == torch.int64
    expect = np.zeros((16, 4), np.int64)
    for c in range(4):
        expect[:, c] = q.numpy().astype(np.int64)[:, prev.numpy() == c].sum(1)
    np.testing.assert_array_equal(macc.numpy(), expect)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(prev.numpy(), minlength=4)
    )


MULTI = (6, 2, 3, 300, 4)  # (T, d, l, n, R), tests/test_markov_multi.py
FORCE = np.array([0, 1, 0, 1], np.int32)


def _multi_problem(nan_cluster, seed=11):
    """Stacked weights (R, C, F) for both packages, a prev (R, n) with
    rows left out, and the packed batch of both packages."""
    T, d, l, n, R = MULTI
    z, x, lens = _batch(T, d, l, n, seed=12)
    Wg = np.stack([np.asarray(_weights(d, l, seed + r)[0]) for r in range(R)])
    if nan_cluster is not None:
        Wg[:, nan_cluster] = np.nan  # a degenerate cluster
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, C, size=(R, n)).astype(np.int32)
    prev[:, rng.choice(n, size=5, replace=False)] = -1
    zt, xt = _transposed(z), _transposed(x)
    u_j = jpm.pack_markov_u(jnp.asarray(zt), jnp.asarray(xt), T=T, d=d, l=l, pad_to=512)
    u_t = tmk.pack_markov_u(torch.from_numpy(zt), torch.from_numpy(xt), T=T, d=d, l=l)
    return (T, d, l), lens, Wg, prev, u_j, u_t


def _assert_outputs_match(out_t, out_j):
    a_j, c_j, s_j, g_j, o_j = (np.asarray(v) for v in out_j)
    a_t, c_t, s_t, g_t, o_t = (v.numpy() for v in out_t)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(o_t, o_j, rtol=1e-10, atol=1e-10)
    return a_t, o_t


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("nan_cluster", [None, 0, 1])
def test_fused_packed_multi_plain_matches_jax_kernel(assign_mode, nan_cluster):
    (T, d, l), lens, Wg, prev, u_j, u_t = _multi_problem(nan_cluster)
    force = FORCE if assign_mode == "argmax" else None
    out_j = jpm.markov_em_fused_packed_multi(
        u_j, jnp.asarray(lens), jnp.asarray(prev), jnp.asarray(Wg), T=T, d=d,
        l=l, assign_mode=assign_mode,
        force_prev=None if force is None else jnp.asarray(force), interpret=True,
    )
    out_t = tmk.markov_em_fused_packed_multi(
        u_t, torch.from_numpy(lens), torch.from_numpy(prev), torch.from_numpy(Wg),
        T=T, d=d, l=l, assign_mode=assign_mode, force_prev=force,
    )
    a_t, o_t = _assert_outputs_match(out_t, out_j)
    if assign_mode == "argmax":
        assert np.all(o_t[FORCE == 1] == 0.0)  # forced slots: objective 0
        np.testing.assert_array_equal(
            a_t[FORCE == 1], np.where(prev[FORCE == 1] >= 0, prev[FORCE == 1], C)
        )
        if nan_cluster == 1:  # strict scan: a NaN never wins
            assert not np.any(a_t[FORCE == 0] == 1)
            assert np.all(np.isfinite(o_t))


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("nan_cluster", [None, 1])
def test_fused_packed_plain_matches_jax_kernel(assign_mode, nan_cluster):
    (T, d, l), lens, Wg, prev, u_j, u_t = _multi_problem(nan_cluster)
    for r in range(prev.shape[0]):
        out_j = jpm.markov_em_fused_packed(
            u_j, jnp.asarray(lens), jnp.asarray(prev[r]), jnp.asarray(Wg[r]),
            T=T, d=d, l=l, assign_mode=assign_mode, interpret=True,
        )
        out_t = tmk.markov_em_fused_packed(
            u_t, torch.from_numpy(lens), torch.from_numpy(prev[r]),
            torch.from_numpy(Wg[r]), T=T, d=d, l=l, assign_mode=assign_mode,
        )
        a_t, o_t = _assert_outputs_match(out_t, out_j)
        if nan_cluster is not None and assign_mode == "argmax":
            # first maximum, NaN counted as the maximum (jnp.argmax)
            assert np.all(a_t[prev[r] >= 0] == nan_cluster) and np.isnan(o_t)


@pytest.mark.parametrize("storage", ["wide", "i16"])
@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("nan_cluster", [None, 1])
def test_em_from_features_multi_plain_matches_jax_kernel(storage, assign_mode, nan_cluster):
    (T, d, l), lens, Wg, prev, u_j, u_t = _multi_problem(nan_cluster)
    n = prev.shape[1]
    phi_j = jpm.markov_materialize_features(
        u_j, jnp.asarray(lens), T=T, d=d, l=l, block_n=512, interpret=True
    )
    phi_t = torch.from_numpy(np.asarray(phi_j)[:, :n].copy())
    if storage == "i16":
        phi_j, phi_t = jpm.quantize_phi(phi_j), tmk.quantize_phi(phi_t)
    force = FORCE if assign_mode == "argmax" else None
    out_j = jpm.markov_em_from_features_multi(
        phi_j, jnp.asarray(lens), jnp.asarray(prev), jnp.asarray(Wg), T=T, d=d,
        l=l, assign_mode=assign_mode,
        force_prev=None if force is None else jnp.asarray(force), interpret=True,
    )
    out_t = tmk.markov_em_from_features_multi(
        phi_t, torch.from_numpy(lens), torch.from_numpy(prev), torch.from_numpy(Wg),
        T=T, d=d, l=l, assign_mode=assign_mode, force_prev=force,
    )
    _assert_outputs_match(out_t, out_j)
    # restart by restart, K3's plain version is K1's on the slot's inputs
    # wherever the scores are finite (or the slot takes prev)
    if nan_cluster is None:
        for r in range(prev.shape[0]):
            mode = "prev" if force is not None and FORCE[r] else assign_mode
            one = tmk.markov_em_from_features(
                phi_t, torch.from_numpy(prev[r]), torch.from_numpy(Wg[r]),
                T=T, d=d, l=l, assign_mode=mode,
            )
            for m, o in zip((v[r] for v in out_t[:4]), one[:4]):
                assert torch.equal(m, o)
