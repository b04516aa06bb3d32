"""The arithmetic and the host plan of K4b's float32 body
(``csrc/markov_em_packed_mma.cu``), emulated on the CPU.

The body builds each tile's Φ with ``acc_row_tile``: the terms of
``csrc/markov_common.cuh:acc_row`` (K2's and K4a's row build) in the same
order, each loop's trip count computed first; the emulation below holds
the two loop forms to the same list of terms for every row kind, shift,
row, length and step count.  It sums the statistics per block of
instances: each tile's instances sorted by cluster, stably (a counting
sort on 32-lane ballots, emulated here and held to a stable argsort),
then each cluster's instances added in instance order into a float32 sum
that goes into the block's running float32 sum at the cluster's end; the
blocks' partials are added in block order.

Tolerance: the statistics' float32 rule of ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py`` phase 6, 2e-5 of the same sums over |Φ|.  Data: an
unstandardized (|x| ~ 50) NaN-suffix batch from a numpy seed; the JAX
package's K4b (``pallas_markov.py:898``, interpret mode, float32) gives
the assignments and the statistics the emulation is held to.

The plan (``markov_kernels.packed_mma_plan``) must find a block within the
card's 232 448 bytes for every shape the header's float32 body
(``csrc/markov_em_multi.cuh``: 128 threads, one instance's Φ column a
thread in a tile of Fcp × 129 floats, weights and statistics of one
restart at least) took, so that the new body refuses nothing it took."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import markov as jmarkov
from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

REL = 2e-5
MAX_SMEM = 232448
NONE = 32  # the sort's key of an instance in no cluster


def _terms_acc_row(kind, k, r, length, steps, s):
    """The (u row, u row) products or u rows that acc_row adds, in order."""
    Ts = steps * s
    if kind == 0:  # A
        return [(t * s + r, t * s + r + k) for t in range(steps) if t * s + r + k < Ts]
    if kind == 1:  # B
        out, t = [], 0
        while t + 1 < length and t < steps:
            out.append((t * s + r, t * s + r + k))
            t += 1
        return out
    if kind == 3:  # AID
        return [(t * s + r,) for t in range(steps)]
    if kind == 4:  # AVM
        out, t = [], 0
        while t + 1 < length and t < steps:
            out.append((t * s + r,))
            t += 1
        return out
    raise ValueError(kind)


def _terms_acc_row_tile(kind, k, r, length, steps, s):
    """The same from acc_row_tile's precomputed trip counts."""
    Ts = steps * s
    tm = (max(length - 1, 0)) if length - 1 < steps else steps
    if kind == 0:
        room = Ts - k - r
        tn = (room + s - 1) // s if room > 0 else 0
        return [(t * s + r, t * s + r + k) for t in range(tn)]
    if kind == 1:
        return [(t * s + r, t * s + r + k) for t in range(tm)]
    if kind == 3:
        return [(t * s + r,) for t in range(steps)]
    if kind == 4:
        return [(t * s + r,) for t in range(tm)]
    raise ValueError(kind)


@pytest.mark.parametrize("s", [8, 16, 24])
def test_row_build_adds_acc_rows_terms_in_order(s):
    """For every row of the compact layouts at this s (any shift k and row
    r of the table), length 0..T and T with T·s ≤ 512: the same terms."""
    for steps in sorted({1, 2, 3, 512 // s // 2, 512 // s}):
        for kind in (0, 1, 3, 4):
            for k in range(0, 2 * s):
                for r in range(s):
                    for length in range(0, steps + 2):
                        want = _terms_acc_row(kind, k, r, length, steps, s)
                        got = _terms_acc_row_tile(kind, k, r, length, steps, s)
                        assert got == want, (kind, k, r, length, steps, s)


def sort_tile(na, C):
    """The body's stable counting sort of a tile's assignments ``na``
    (-1: none): 32-lane chunks in order, a lane's rank among the lanes
    below it with its key (a ballot per cluster), running counts, offsets
    by an exclusive scan over the clusters.  Returns (perm of the valid
    instances, counts)."""
    NT = na.shape[0]
    key = np.where(na >= 0, na, NONE)
    seen = np.zeros(NONE + 1, np.int64)
    pos = np.zeros(NT, np.int64)
    for q in range(NT // 32):
        chunk = key[q * 32 : (q + 1) * 32]
        for lane in range(32):
            pos[q * 32 + lane] = seen[chunk[lane]] + int((chunk[:lane] == chunk[lane]).sum())
        for c in range(C):
            seen[c] += int((chunk == c).sum())
    counts = seen[:C].copy()
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    perm = np.full(int(counts.sum()), -1, np.int64)
    for j in range(NT):
        if key[j] != NONE:
            perm[first[key[j]] + pos[j]] = j
    return perm, counts


@pytest.mark.parametrize("NT,C", [(128, 16), (128, 1), (64, 32), (32, 17)])
def test_counting_sort_is_a_stable_sort(NT, C):
    rng = np.random.default_rng(NT + C)
    for trial in range(20):
        na = rng.integers(-1, C, size=NT)
        if trial == 0:
            na[:] = 0  # every instance in one cluster
        if trial == 1:
            na[:] = -1  # none valid
        perm, counts = sort_tile(na, C)
        valid = np.where(na >= 0)[0]
        assert np.array_equal(perm, valid[np.argsort(na[valid], kind="stable")])
        assert np.array_equal(counts, np.bincount(na[valid], minlength=C))


def emulate_statistics(phi, na, C, chunk, tile=128):
    """The body's statistics of float32 ``phi (F, n)`` under ``na (n,)``:
    per block of ``chunk`` instances, tile by tile, each cluster's
    instances (the sorted tile's segment) in instance order into a float32
    sum, added into the block's running float32 sum at the segment's end;
    blocks' partials added in block order.  ``(F, C)`` float32."""
    F, n = phi.shape
    total = torch.zeros((F, C), dtype=torch.float32)
    for b0 in range(0, n, chunk):
        st = torch.zeros((F, C), dtype=torch.float32)
        for i0 in range(b0, min(b0 + chunk, n), tile):
            tile_na = na[i0 : min(i0 + tile, b0 + chunk, n)].numpy()
            perm, counts = sort_tile(np.pad(tile_na, (0, tile - tile_na.shape[0]), constant_values=-1), C)
            k = 0
            for c in range(C):
                if counts[c]:
                    run = torch.zeros(F, dtype=torch.float32)
                    for j in perm[k : k + counts[c]]:
                        run += phi[:, i0 + j]
                    st[:, c] += run
                k += counts[c]
        total = total + st
    return total


@functools.lru_cache(maxsize=None)
def _wide_problem(T=10, d=5, l=3, n=3000, R=3, C=4, seed=7):
    """The JAX kernel's K4b outputs (float32, interpret mode) on a wide
    (|x| ~ 50) NaN-suffix batch, and the port's float32 Φ of the batch."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(T, n, d)) * 25 + rng.normal(scale=25, size=d)).astype(np.float32)
    x = (rng.normal(size=(T, n, l)) * 25 + rng.normal(scale=25, size=l)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    zt = np.ascontiguousarray(z.transpose(0, 2, 1).reshape(T * d, n))
    xt = np.ascontiguousarray(x.transpose(0, 2, 1).reshape(T * l, n))

    def spd(k):
        M = rng.normal(size=(C, k, k))
        return M @ M.transpose(0, 2, 1) / k + 25.0 * np.eye(k)

    Wg = np.stack([
        np.asarray(jmarkov.markov_em_weights(*map(jnp.asarray, (
            rng.normal(scale=25, size=(C, d)), spd(d), rng.normal(scale=0.3, size=(C, d, d)), spd(d),
            rng.normal(size=(C, d, l)), spd(l)))))
        for _ in range(R)
    ]).astype(np.float32)
    prev = rng.integers(0, C, size=(R, n)).astype(np.int32)
    prev[:, ::37] = -1
    u_j = jpm.pack_markov_u(jnp.asarray(zt), jnp.asarray(xt), T=T, d=d, l=l, pad_to=512)
    a, _c, _s, g, _o = jpm.markov_em_fused_packed_multi(
        u_j, jnp.asarray(lens), jnp.asarray(prev), jnp.asarray(Wg), T=T, d=d, l=l, interpret=True)
    u = mk.pack_markov_u(torch.from_numpy(zt), torch.from_numpy(xt), T=T, d=d, l=l)
    phi = mk.markov_materialize_features_plain(u, torch.from_numpy(lens), T=T, d=d, l=l)
    return (T, d, l, C), np.array(a), np.array(g), phi


def test_sorted_sums_give_the_cluster_sums():
    """The emulated body's statistics, under the JAX kernel's assignments,
    against the float64 sums and the JAX kernel's float32 statistics; in
    blocks of 1024 instances (the chunk at R ≤ 4) and of all of them."""
    (T, d, l, C), a, g_j, phi = _wide_problem()
    assert phi.dtype == torch.float32 and float(phi.abs().max()) > 1e4
    pos = torch.from_numpy(mk.markov_compact_spec(T, d, l)[2])
    for r in range(a.shape[0]):
        na = torch.from_numpy(np.where(a[r] < C, a[r], -1).astype(np.int64))
        hot = torch.nn.functional.one_hot(na + 1, C + 1)[:, 1:].double()
        exact = phi.double() @ hot
        mag = phi.double().abs() @ hot
        for chunk in (1024, phi.shape[1]):
            got = emulate_statistics(phi, na, C, chunk).double()
            assert bool(((got - exact).abs() <= REL * mag + 1e-30).all())
            g = torch.from_numpy(g_j[r]).double()
            assert bool(((got[pos] - g).abs() <= REL * mag[pos] + 1e-30).all())


def _old_body_takes(Fcp, C, argmax):
    """Whether the header's float32 body took this shape: its block of 128
    threads (markov_em_multi.cuh multi_smem, one restart a block) fits."""
    cb = (8 if C <= 8 else 16 if C <= 16 else 32) if argmax else 0
    nt, nw = 128, 4
    return 4 * (nw + Fcp * (nt + 1) + nt + Fcp * cb + Fcp * (C | 1)) + 4 * (C + nt + nw + nt) <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def _plan(Fcp, Ts, cb, R, argmax):
    return mk.packed_mma_plan(Fcp, Ts, cb, R, argmax=argmax)


def test_plan_fits_every_shape_the_header_body_took():
    """Every (T, d, l) with T·s ≤ 512 (d ≤ 16, l ≤ 16), C in 1..32, both
    modes: where the header's body took the shape, the plan finds a block
    within 232 448 bytes, with the most restarts a block that fits."""
    shapes = taken = 0
    for d in range(1, 17):
        for l in range(0, 17):
            s = 8 * ((d + l + 7) // 8)
            Fcp = mk.markov_compact_spec(1, d, l)[0]
            for T in range(1, 512 // s + 1):
                for C in range(1, 33):
                    cb = 8 if C <= 8 else 16 if C <= 16 else 32
                    for argmax in (True, False):
                        shapes += 1
                        if not _old_body_takes(Fcp, C, argmax):
                            continue
                        taken += 1
                        plan = _plan(Fcp, T * s, cb, 64, argmax)
                        assert plan is not None, (T, d, l, C, argmax)
                        assert plan.smem <= MAX_SMEM
                        assert plan.smem == mk.packed_mma_smem(Fcp, T * s, C, plan.rg, plan.nt, argmax=argmax)
                        # the plan depends on C only through its block of 8, 16 or 32
                        assert plan == mk.packed_mma_plan(Fcp, T * s, C, 64, argmax=argmax)
    assert taken > shapes // 2


@pytest.mark.parametrize("R", list(range(1, 65)))
def test_plan_restart_groups(R):
    """At the bench shape (Fcp = 112, T·s = 80, C = 16) the block holds
    min(R, 8) restarts and a 128-instance tile, and a cluster as many of a
    chunk's restart groups as divide them; at the largest Φ the header's
    body took per C, a plan exists for every R."""
    plan = mk.packed_mma_plan(112, 80, 16, R)
    assert plan.nt == 128 and plan.rg == min(R, 8) and plan.smem <= MAX_SMEM
    groups = -(-R // plan.rg)
    assert groups == -(-R // 8) and groups % plan.cs == 0 and 1 <= plan.cs <= 8
    assert plan.cs == max(q for q in range(1, 9) if groups % q == 0)
    for Fcp, Ts, C in ((296, 512, 32), (352, 512, 16), (392, 504, 8), (416, 512, 1)):
        assert _old_body_takes(Fcp, C, True)
        plan = mk.packed_mma_plan(Fcp, Ts, C, R)
        assert plan is not None and 1 <= plan.rg <= min(R, 8) and plan.smem <= MAX_SMEM


def test_plan_at_the_bench_shape():
    """R = 32, C = 16, Fcp = 112, T·s = 80: 8 restarts a block,
    128-instance tiles in 232 416 bytes (227 KB less 32 bytes), the
    chunk's 4 restart groups one cluster, so each Φ tile is built once."""
    assert mk.packed_mma_plan(112, 80, 16, 32) == mk.PackedPlan(128, 8, 4, 232416)
    assert mk.packed_mma_plan(112, 80, 16, 32, argmax=False).smem < 232416
    assert mk.packed_mma_plan(112, 80, 32, 32).rg == 4  # weights and statistics twice as wide
