"""K9's piece plan (``ops/mstep_kernels.py:gram_plan``) and the sums over
its pieces, on the CPU.

On the card K9 lists the rows of each (segment, cluster) in row order and
cuts each list into pieces of at most R rows; a block sums one piece's
``U Uᵀ`` and the pieces of a (segment, cluster) are added in piece order.
Here the plan's plain version is held to that contract (every row with an
assignment in ``[0, C)`` exactly once, in row order, no piece crossing a
(segment, cluster) or longer than R), and the Grams summed piece by piece
in that order are held to ``_grams_plain`` in float64 (1e-12: the order
of the sums) and, through ``_select_stats``, to the JAX package's
``mstep_stats_gram_sorted`` run in interpret mode (1e-10, as
``test_torch_dense_kernels.py`` holds K9's plain version).  The
wrapper's gathered selection ``_select_stats`` is also held to the plain
version's block-by-block ``_select_stats_plain`` on random, unsymmetric
``G`` (1e-12: the order of the sums).  The CUDA test
``test_mstep_gram_plan_matches_plain`` holds the kernel's own plan to the
plain version bit for bit.  Data: gapped trajectories (an interior
missing step, x lost at t=0, one +Inf entry, a row with no state: a
one-row segment, an empty segment appended), from numpy seeds, at
D = T(d+l) = 20 and 9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import pallas_mstep as jpm
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as tmk

C = 5
SHAPES = {"D20": (4, 2, 3, 1200), "D9": (3, 2, 1, 900)}
CASES = ("random", "ninety", "one", "empty_clusters", "outside")


def _batch(shape, seed):
    """A pattern-sorted gapped batch in float64: ``(v (n, D), sizes,
    patterns (P, D) bool, (T, d, l))``."""
    T, d, l, n = SHAPES[shape]
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * 2.0
    x = z @ rng.normal(size=(d, l)) + rng.normal(size=(T, n, l))
    lens = rng.choice([max(1, T // 2), T - 1, T], size=n)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    gap = np.where((rng.uniform(size=n) < 0.3) & (lens >= 3))[0]
    tg = rng.integers(1, lens[gap] - 1)
    z[tg, gap] = np.nan
    x[tg, gap] = np.nan
    x[0, rng.uniform(size=n) < 0.1] = np.nan
    z[0, 3, 0] = np.inf
    z[:, -1] = np.nan  # row n-1: no state at all, a segment of its own
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    patterns, pid = gops.pattern_groups(v)
    order = np.argsort(pid, kind="stable")
    patterns = np.concatenate([patterns, ~patterns[:1]])  # no row: empty
    sizes = tuple(int(s) for s in np.bincount(pid, minlength=patterns.shape[0]))
    assert 0 in sizes and 1 in sizes
    return torch.from_numpy(v[order]), sizes, torch.from_numpy(patterns), (T, d, l)


def _assign(case, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, C, size=n)
    if case == "ninety":
        a = np.where(rng.uniform(size=n) < 0.9, 2, a)
    elif case == "one":
        a = np.full(n, C - 1)
    elif case == "empty_clusters":
        a = rng.choice([0, 2, 3], size=n)
    elif case == "outside":  # K8 marks rows with no previous cluster C
        u = rng.uniform(size=n)
        a = np.where(u < 0.1, C, np.where(u < 0.2, -1, a))
    return torch.from_numpy(a.astype(np.int32))


def _piece_grams(v, assign, sizes, rows):
    """``G (P, C, u, u)`` summed as the kernel sums it: each piece's
    ``U Uᵀ``, the pieces of a (segment, cluster) added in piece order."""
    idx, list_start, piece_start = tmk.gram_plan(assign, sizes, C, rows)
    n = v.shape[0]
    U = torch.cat([torch.where(torch.isfinite(v), v, 0.0), torch.ones((n, 1), dtype=v.dtype)], 1)
    u = U.shape[1]
    G = torch.zeros((len(sizes) * C, u, u), dtype=v.dtype)
    for pc in range(len(sizes) * C):
        for j in range(int(piece_start[pc + 1] - piece_start[pc])):
            lo = int(list_start[pc]) + j * rows
            r = idx[lo : min(lo + rows, int(list_start[pc + 1]))].long()
            G[pc] += U[r].T @ U[r]
    return G.reshape(len(sizes), C, u, u)


@pytest.mark.parametrize("rows", [1, 7, 1024])
@pytest.mark.parametrize("case", CASES)
def test_plan_lists_each_row_once_in_row_order(case, rows):
    v, sizes, _pat, _shape = _batch("D20", seed=1)
    n = v.shape[0]
    assign = _assign(case, n, seed=2)
    idx, list_start, piece_start = tmk.gram_plan(assign, sizes, C, rows)
    assert idx.dtype == list_start.dtype == piece_start.dtype == torch.int32
    assert idx.shape == (n,) and list_start.shape == piece_start.shape == (len(sizes) * C + 1,)
    valid = (assign >= 0) & (assign < C)
    total = int(list_start[-1])
    assert total == int(valid.sum())
    assert torch.equal(torch.sort(idx[:total]).values, torch.nonzero(valid).squeeze(1).to(torch.int32))
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    for pc in range(len(sizes) * C):
        p, c = divmod(pc, C)
        lst = idx[list_start[pc] : list_start[pc + 1]].long()
        assert bool((assign[lst] == c).all())
        assert bool(((lst >= bounds[p]) & (lst < bounds[p + 1])).all())  # within its segment
        assert bool((lst[1:] > lst[:-1]).all())  # row order
        # the pieces: ceil(len / rows) of them, rows each but the last
        assert int(piece_start[pc + 1] - piece_start[pc]) == -(-lst.shape[0] // rows)


@pytest.mark.parametrize("rows", [1, 7, 1024])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("case", CASES)
def test_piece_sums_equal_the_grams(case, shape, rows):
    v, sizes, _pat, _shape = _batch(shape, seed=3)
    assign = _assign(case, v.shape[0], seed=4)
    got = _piece_grams(v, assign, sizes, rows)
    want = tmk._grams_plain(v, assign, sizes, C)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    # the member counts come from the ones column, exact
    ok = (assign >= 0) & (assign < C)
    np.testing.assert_array_equal(got[:, :, -1, -1].sum(0).numpy(),
                                  torch.bincount(assign[ok].long(), minlength=C).double().numpy())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("case", CASES)
def test_piece_sums_match_jax(case, shape):
    v, sizes, pat, (T, d, l) = _batch(shape, seed=5)
    assign = _assign(case, v.shape[0], seed=6)
    got = tmk._select_stats(_piece_grams(v, assign, sizes, 7), pat, T, d, l)
    want = jpm.mstep_stats_gram_sorted(
        jnp.asarray(v.numpy()), jnp.asarray(assign.numpy()), jnp.asarray(pat.numpy()),
        sizes=sizes, T=T, d=d, l=l, n_clusters=C, interpret=True,
    )
    flat_g = [f for stats in got[:3] for f in stats] + [got[3]]
    flat_w = [f for stats in want[:3] for f in stats] + [want[3]]
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [7, 8])
def test_gathered_selection_matches_the_plain_one(shape, seed):
    T, d, l, _n = SHAPES[shape]
    rng = np.random.default_rng(seed)
    P, u = 6, T * (d + l) + 1
    G = torch.from_numpy(rng.normal(size=(P, C, u, u)))  # no symmetry to hide a transpose
    pat = torch.from_numpy(rng.uniform(size=(P, u - 1)) < 0.9)
    pat[0] = True  # every step valid
    pat[1, :d] = False  # no first state
    got = tmk._select_stats(G, pat, T, d, l)
    want = tmk._select_stats_plain(G, pat, T, d, l)
    flat_g = [f for stats in got[:3] for f in stats] + [got[3]]
    flat_w = [f for stats in want[:3] for f in stats] + [want[3]]
    assert len(flat_g) == len(flat_w) == 16
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)
