"""The plain versions of the dense route's kernels against the JAX
package's Pallas kernels, which run in interpret mode on the CPU, in
float64: K8 (the sorted E step) and K14 (its row-major form) give
identical assignments, counts and switches, K12 and K13 (the (C, n)
log-likelihoods) agree to 1e-10 relative, K9 (the sorted M-step Grams)
and K15 (the Khatri-Rao statistics) to 1e-10.  Gapped trajectories (an
interior missing step, x lost at t=0), segments of every size including
an empty one; and 40 missingness patterns with a ragged segment of every
size for K12-K14."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.ops import gaussian as jg
from multimodal_trajectory_modeling_tpu.ops import pallas_estep as jpe
from multimodal_trajectory_modeling_tpu.ops import pallas_mstep as jpm
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import estep_kernels as tek
from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as tmk


def _sorted_batch(seed, n=1200, T=4, d=2, l=3, C=3):
    """A pattern-sorted gapped batch: ``(v (n, D), pattern_id, patterns,
    sizes, params (numpy), assign (n,))``; ``sizes`` has an empty segment
    appended (a pattern no row has)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * 2.0
    x = z @ rng.normal(size=(d, l)) + rng.normal(size=(T, n, l))
    lens = rng.choice([3, 4], size=n)
    z[np.arange(T)[:, None] >= lens] = np.nan
    x[np.arange(T)[:, None] >= lens] = np.nan
    gap = (rng.uniform(size=n) < 0.3) & (lens == 4)
    tg = rng.integers(1, 3, size=n)
    z[tg[gap], np.where(gap)[0]] = np.nan
    x[tg[gap], np.where(gap)[0]] = np.nan
    x[0, rng.uniform(size=n) < 0.1] = np.nan
    v = np.asarray(jem.pack_joint(jnp.asarray(z), jnp.asarray(x)))
    patterns, pid = jg.pattern_groups(v)
    order = np.argsort(pid, kind="stable")
    extra = ~patterns[:1]  # observed nowhere: an empty segment
    patterns = np.concatenate([patterns, extra])
    sizes = tuple(int(s) for s in np.bincount(pid, minlength=patterns.shape[0]))
    params = (
        np.full(C, 1.0 / C),
        rng.normal(size=(C, d)),
        np.stack([np.eye(d)] * C),
        rng.normal(scale=0.4, size=(C, d, d)),
        np.stack([np.eye(d)] * C),
        rng.normal(size=(C, d, l)),
        np.stack([np.eye(l)] * C),
    )
    assign = rng.integers(0, C, size=n).astype(np.int32)
    return v[order], pid[order], patterns, sizes, params, assign, (T, d, l)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estep_sorted_plain_matches_jax(seed):
    v, _pid, patterns, sizes, params, prev, (T, _d, _l) = _sorted_batch(seed)
    assert sizes[-1] == 0 and len(sizes) <= 9
    prev = prev.copy()
    prev[::37] = -1  # rows left out
    aj, cj, sj = jem.estep_assign_sorted(
        jem.MixtureParams(*map(jnp.asarray, params)), jnp.asarray(v),
        jnp.asarray(patterns), jnp.asarray(prev), sizes=sizes, T=T,
        interpret=True, v_sorted_t=jnp.asarray(v.T),
    )
    at, ct, st = tem.estep_assign_sorted(
        tem.mixture_params_from_numpy(params, device="cpu"), torch.from_numpy(v),
        torch.from_numpy(patterns), torch.from_numpy(prev), sizes=sizes, T=T,
    )
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(st) == int(sj)
    assert at.dtype == ct.dtype == st.dtype == torch.int32


def test_estep_kernel_plain_matches_jax_kernel():
    """The two kernels' own signatures, on the same inverses."""
    v, _pid, patterns, sizes, params, prev, (T, _d, _l) = _sorted_batch(3)
    means, covs = tem.cluster_joint_moments(tem.mixture_params_from_numpy(params, device="cpu"), T)
    minv, const = tek.precompute_cluster_pattern_inverses(means, covs, torch.from_numpy(patterns))
    logpi = torch.log(torch.from_numpy(params[0]))
    got = tek.estep_assign_pattern_sorted_t_plain(
        torch.from_numpy(v.T.copy()), torch.from_numpy(prev), means, minv, const, logpi,
        torch.from_numpy(patterns), sizes=sizes,
    )
    want = jpe.estep_assign_pattern_sorted_t(
        jnp.asarray(v.T), jnp.asarray(prev), *(jnp.asarray(a.numpy()) for a in (means, minv, const, logpi)),
        jnp.asarray(patterns), sizes=sizes, interpret=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_estep_scores_are_the_grouped_logpdf():
    """K8's plain version takes the argmax of log π + the grouped masked
    log-density (the oracle), here on random clusters."""
    v, pid, patterns, sizes, params, prev, (T, _d, _l) = _sorted_batch(4)
    tp = tem.mixture_params_from_numpy(params, device="cpu")
    args = (torch.from_numpy(v), torch.from_numpy(patterns[:-1]), torch.from_numpy(pid))
    ll = tem.estep_logliks(tp, *args, T=T, method="inverse")
    want = tem.assignments_from_logliks(tp.pi, ll)
    got = tem.estep_assign_sorted(tp, args[0], torch.from_numpy(patterns), torch.from_numpy(prev),
                                  sizes=sizes, T=T)[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_mstep_gram_plain_matches_jax(seed):
    v, _pid, patterns, sizes, params, assign, (T, d, l) = _sorted_batch(seed)
    C = params[0].shape[0]
    assign[5] = C  # a row of no cluster, as JAX's padded rows
    got = tmk.mstep_stats_gram_sorted(
        torch.from_numpy(v), torch.from_numpy(assign), torch.from_numpy(patterns),
        sizes=sizes, T=T, d=d, l=l, n_clusters=C,
    )
    want = jpm.mstep_stats_gram_sorted(
        jnp.asarray(v), jnp.asarray(assign), jnp.asarray(patterns),
        sizes=sizes, T=T, d=d, l=l, n_clusters=C, interpret=True,
    )
    flat_g = [f for stats in got[:3] for f in stats] + [got[3]]
    flat_w = [f for stats in want[:3] for f in stats] + [want[3]]
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


def test_mstep_sorted_equals_dense_mstep():
    """The Gram route's parameters equal the time-batched M step's on the
    same rows (the any-NaN pair drops become block selections)."""
    v, _pid, patterns, sizes, params, assign, (T, d, l) = _sorted_batch(5)
    C = params[0].shape[0]
    vt = torch.from_numpy(v)
    n = v.shape[0]
    z = vt[:, : T * d].reshape(n, T, d).permute(1, 0, 2)
    x = vt[:, T * d :].reshape(n, T, l).permute(1, 0, 2)
    a = torch.from_numpy(assign)
    sorted_p = tem.mstep_sorted(vt, a, torch.from_numpy(patterns), sizes=sizes, T=T, d=d, l=l, n_clusters=C)
    for impl in ("xla", "gram"):
        dense_p = tem.mstep(z, x, a, n_clusters=C, impl=impl)
        for s, w in zip(sorted_p, dense_p):
            np.testing.assert_allclose(s.numpy(), w.numpy(), rtol=1e-10, atol=1e-10)


def test_segment_table_covers_segments():
    sizes = (5, 0, 17, 1, 32)
    table, first = tek.segment_table(sizes, 8, torch.device("cpu"))
    table, first = table.numpy(), first.numpy()
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for p, s in enumerate(sizes):
        blocks = table[first[p] : first[p + 1]]
        assert (blocks[:, 0] == p).all() and (blocks[:, 2] <= 8).all()
        assert blocks[:, 2].sum() == s
        if s:
            assert blocks[0, 1] == starts[p]
            np.testing.assert_array_equal(blocks[1:, 1], blocks[:-1, 1] + blocks[:-1, 2])
    assert first[-1] == table.shape[0]


def test_wrappers_reject_bad_arguments():
    v, _pid, patterns, sizes, params, assign, (T, d, l) = _sorted_batch(6, n=200)
    C = params[0].shape[0]
    tv, ta, tp = torch.from_numpy(v), torch.from_numpy(assign), torch.from_numpy(patterns)
    with pytest.raises(ValueError, match="sum"):
        tmk.mstep_stats_gram_sorted(tv, ta, tp, sizes=sizes[:-2] + (sizes[-2] + 1, 0),
                                    T=T, d=d, l=l, n_clusters=C)
    with pytest.raises(ValueError, match="T·"):
        tmk.mstep_stats_gram_sorted(tv, ta, tp, sizes=sizes, T=T, d=d + 1, l=l, n_clusters=C)
    means = torch.zeros((C, v.shape[1]), dtype=torch.float64)
    minv = torch.zeros((C, len(sizes), v.shape[1], v.shape[1]), dtype=torch.float64)
    const = torch.zeros((C, len(sizes)), dtype=torch.float64)
    with pytest.raises(ValueError, match="segment sizes"):
        tek.estep_assign_pattern_sorted_t(tv.T, ta, means, minv, const, const[:, 0], tp,
                                          sizes=sizes[:-1])
    with pytest.raises(ValueError, match="device"):
        tek.estep_assign_pattern_sorted_t(tv.T.to("meta"), ta.to("meta"), *(
            t.to("meta") for t in (means, minv, const, const[:, 0], tp)), sizes=sizes)


# ----------------------------------------------------------------------
# K12-K15 on 40 patterns
# ----------------------------------------------------------------------

REL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def pattern_case():
    """2003 rows of D = 25 (T=5, d=2, l=3), each missing the coordinates
    of one of 40 random masks (one fully observed), rows in random order:
    segments of ragged sizes; 3 random clusters and their inverses."""
    rng = np.random.default_rng(40)
    T, d, l, C, n = 5, 2, 3, 3, 2003
    z = rng.normal(size=(T, n, d)) * 2.0
    x = z @ rng.normal(size=(d, l)) + rng.normal(size=(T, n, l))
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    pool = rng.uniform(size=(40, v.shape[1])) > 0.3
    pool[0] = True
    v[~pool[rng.integers(0, 40, size=n)]] = np.nan
    patterns, pid = jg.pattern_groups(v)
    params = (np.full(C, 1.0 / C), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
              rng.normal(scale=0.4, size=(C, d, d)), np.stack([np.eye(d)] * C),
              rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C))
    tp = tem.mixture_params_from_numpy(params, device="cpu")
    means, covs = tem.cluster_joint_moments(tp, T)
    minv, const = tek.precompute_cluster_pattern_inverses(means, covs, torch.from_numpy(patterns))
    order = np.argsort(pid, kind="stable")
    prev = rng.integers(0, C, size=n).astype(np.int32)
    prev[::37] = -1
    assign = rng.integers(0, C, size=n).astype(np.int32)
    assign[5], assign[6] = C, -1  # rows of no cluster
    return dict(
        v=v, pid=pid, patterns=patterns, order=order, params=params, tp=tp, T=T, d=d, l=l, C=C,
        sizes=tuple(int(c) for c in np.bincount(pid, minlength=patterns.shape[0])),
        ops=(means, minv, const), covs=covs, prev=prev, assign=assign,
    )


def _jnp(*tensors):
    return tuple(jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t) for t in tensors)


def test_pattern_case_is_ragged(pattern_case):
    sizes = pattern_case["sizes"]
    assert len(sizes) == 40 and min(sizes) > 0 and len(set(sizes)) > 10
    assert pattern_case["v"].shape[1] <= 40


def test_estep_logliks_plain_matches_jax_kernel(pattern_case):
    """K12: rows in any order, each under its own pattern."""
    c = pattern_case
    got = tek.estep_logliks_pallas(torch.from_numpy(c["v"]), torch.from_numpy(c["pid"]), *c["ops"])
    want = jpe.estep_logliks_pallas(*_jnp(c["v"], c["pid"], *c["ops"]), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REL)


def test_estep_logliks_sorted_plain_matches_jax_kernel(pattern_case):
    """K13 on the sorted batch: JAX's kernel, and K12's columns in sorted
    order."""
    c = pattern_case
    vs = c["v"][c["order"]]
    got = tek.estep_logliks_pattern_sorted(torch.from_numpy(vs), *c["ops"], sizes=c["sizes"])
    want = jpe.estep_logliks_pattern_sorted(*_jnp(vs, *c["ops"]), sizes=c["sizes"], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REL)
    k12 = tek.estep_logliks_pallas(torch.from_numpy(c["v"]), torch.from_numpy(c["pid"]), *c["ops"])
    np.testing.assert_array_equal(got.numpy(), k12.numpy()[:, c["order"]])


def test_estep_logliks_sorted_entry_matches_jax(pattern_case):
    c = pattern_case
    vs = c["v"][c["order"]]
    got = tem.estep_logliks_sorted(c["tp"], torch.from_numpy(vs), torch.from_numpy(c["patterns"]),
                                   sizes=c["sizes"], T=c["T"])
    want = jem.estep_logliks_sorted(jem.MixtureParams(*_jnp(*c["params"])), *_jnp(vs, c["patterns"]),
                                    sizes=c["sizes"], T=c["T"], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REL)


def test_estep_assign_row_major_matches_jax_and_k8(pattern_case):
    """K14 on the row-major sorted batch: JAX's row-major kernel (its
    expanded form, in float64) and K8 on the transposed copy give the same
    assignments, counts and switches; through ``em.estep_assign_sorted``
    without ``v_sorted_t`` too."""
    c = pattern_case
    vs = c["v"][c["order"]]
    prev = c["prev"][c["order"]]
    logpi = torch.log(c["tp"].pi)
    args = (torch.from_numpy(prev), *c["ops"], logpi, torch.from_numpy(c["patterns"]))
    got = tek.estep_assign_pattern_sorted(torch.from_numpy(vs), *args, sizes=c["sizes"])
    jitted = jax.jit(functools.partial(jpe.estep_assign_pattern_sorted, sizes=c["sizes"], interpret=True))
    want = jitted(*_jnp(vs, *args))
    k8 = tek.estep_assign_pattern_sorted_t(torch.from_numpy(vs.T.copy()), *args, sizes=c["sizes"])
    entry = tem.estep_assign_sorted(c["tp"], torch.from_numpy(vs), torch.from_numpy(c["patterns"]),
                                    torch.from_numpy(prev), sizes=c["sizes"], T=c["T"])
    for g, w, k, e in zip(got, want, k8, entry):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, k) and torch.equal(g, e) and g.dtype == torch.int32


def test_estep_assign_bf16_is_bit_identical(pattern_case):
    """``bf16=True`` computes what ``bf16=False`` does, as the JAX
    kernel's toolchain makes it."""
    c = pattern_case
    vs = torch.from_numpy(c["v"][c["order"]])
    kw = dict(sizes=c["sizes"], T=c["T"])
    args = (c["tp"], vs, torch.from_numpy(c["patterns"]), torch.from_numpy(c["prev"][c["order"]]))
    for a, b in zip(tem.estep_assign_sorted(*args, bf16=True, **kw), tem.estep_assign_sorted(*args, **kw)):
        assert torch.equal(a, b)


def test_estep_logliks_fused_chunks_equal_unchunked(pattern_case, monkeypatch):
    """With the inverses' budget at 7 patterns, the 40 patterns go in 6
    chunks; the result is the unchunked one."""
    c = pattern_case
    args = (*c["ops"][:1], c["covs"], torch.from_numpy(c["v"]), torch.from_numpy(c["patterns"]),
            torch.from_numpy(c["pid"]))
    whole = tek.estep_logliks_fused(*args)
    D = c["v"].shape[1]
    monkeypatch.setattr(tek, "_INVERSE_BYTES", 7 * c["C"] * D * D * 8)
    calls = []
    monkeypatch.setattr(tek, "estep_logliks_pallas", lambda *a: calls.append(a) or tek.estep_logliks_pallas_plain(*a))
    chunked = tek.estep_logliks_fused(*args)
    assert len(calls) == 6
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(whole.numpy(), tek.estep_logliks_pallas(torch.from_numpy(c["v"]),
                               torch.from_numpy(c["pid"]), *c["ops"]).numpy(), rtol=0, atol=0)


def test_mstep_stats_plain_matches_jax_kernel(pattern_case):
    """K15 and its unpacking on the unsorted batch, rows of no cluster
    included; and ``em.mstep(impl="pallas")`` against JAX's."""
    c = pattern_case
    T, d, l, C = c["T"], c["d"], c["l"], c["C"]
    kw = dict(T=T, d=d, l=l, n_clusters=C)
    got = tmk.mstep_stats_pallas(torch.from_numpy(c["v"]), torch.from_numpy(c["assign"]), **kw)
    want = jpm.mstep_stats_pallas(*_jnp(c["v"], c["assign"]), interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REL)
    flat = [f for st in tmk.unpack_mstep_stats(got, d, l, C) for f in st]
    flat_w = [f for st in jpm.unpack_mstep_stats(want, d, l, C) for f in st]
    for g, w in zip(flat, flat_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REL)
    n = c["v"].shape[0]
    vt = torch.from_numpy(c["v"])
    z = vt[:, : T * d].reshape(n, T, d).permute(1, 0, 2)
    x = vt[:, T * d :].reshape(n, T, l).permute(1, 0, 2)
    a = torch.from_numpy(c["assign"])
    pallas = tem.mstep(z, x, a, n_clusters=C, impl="pallas")
    want_p = jem.mstep(*_jnp(z.contiguous(), x.contiguous(), a), n_clusters=C, impl="pallas")
    xla = tem.mstep(z, x, a, n_clusters=C)
    for g, w, e in zip(pallas, want_p, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REL)
        np.testing.assert_allclose(g.numpy(), e.numpy(), **REL)
