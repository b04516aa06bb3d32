"""The plain versions of kernels K8 (the sorted E step) and K9 (the
sorted M-step Grams) against the JAX package's Pallas kernels, which run
in interpret mode on the CPU as ``em.train_em_sorted`` runs them, in
float64: K8 gives identical assignments, counts and switches, K9 its
statistics to 1e-10.  Gapped trajectories (an interior missing step, x
lost at t=0), segments of every size including an empty one."""

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
