"""The host plan and the arithmetic of K1's int16 body
(``csrc/markov_em_one.cu``), emulated on the CPU.

The plan (``markov_kernels.k1_plan``, a function of Fcp, C, the weights'
dtype and n) sends int16 Φ to the new body where a block of 128-instance
Φ tiles fits the card's 232 448 bytes of shared memory, and otherwise to
the atomics body of ``csrc/markov_em.cu``: every shape that body took
still has a route, and its shared memory fits.

The statistics: each int16 entry splits exactly into a hi byte (Φ >> 8,
s8) and a lo byte (Φ & 0xFF, u8); the tensor-core products of each plane
with the u8 one-hot of the assignments, summed per 128-instance tile in
int32 and into the block's int32 sums as 256 · hi + lo, equal the int64
sums for up to 65 536 instances a block (the plan keeps every block at
that or fewer), at the int16 extremes too.

The objective: the reduce sums each instance's entry (its best score, or
0 for a row left out) in the order of ``csrc/markov_em.cu``'s 256-thread
blocks (``k1_objective_in_order`` below, emulated in torch): bit
for bit the order of those blocks, emulated here scalar by scalar, with
NaN, ±Inf and -0.0 among the scores; within 1e-6 of Σ|best| of the plain
version's objective (another summation order) on K1's int16 inputs; and
within 1e-10 of the JAX package's K1 objective (``pallas_markov.py:1464``,
interpret mode, float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import markov as jmarkov
from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu_torch.ops import markov as tmarkov
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

MAX_SMEM = 232448


def _old_body_smem(Fcp, C, wsize, argmax):
    """Shared memory of a block of ``csrc/markov_em.cu`` under int16 Φ
    (``smem_bytes``): block sum scratch and weights (Fcp, CB) in the
    weights' type, int32 statistics (Fcp, C), counts and scratch ints."""
    cb = (8 if C <= 8 else 16 if C <= 16 else 32) if argmax else 0
    return wsize * (8 + Fcp * cb) + 4 * Fcp * C + 4 * (C + 8)


@pytest.mark.parametrize("argmax", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_routes_every_shape_the_atomics_body_took(dtype, argmax):
    """Every (Fcp, C) with C in 1..32 that ``csrc/markov_em.cu`` took under
    int16 Φ has a route whose block fits 232 448 bytes: the new body (a
    ring of one or two tiles, its shared memory the CUDA source's sum) or
    the atomics body itself; the new body takes every shape up to the
    canonical Φ's rows with a ring of two."""
    wsize = dtype.itemsize
    taken = new = 0
    for Fcp in range(1, 2000):
        for C in range(1, 33):
            if _old_body_smem(Fcp, C, wsize, argmax) > MAX_SMEM:
                continue
            taken += 1
            plan = mk.k1_plan(Fcp, C, dtype, 10**6, argmax=argmax)
            if plan is None:
                assert mk.k1_smem(Fcp, C, dtype, 1, argmax=argmax) > MAX_SMEM
                continue
            new += 1
            assert plan.ring in (1, 2) and plan.smem <= MAX_SMEM
            assert plan.smem == mk.k1_smem(Fcp, C, dtype, plan.ring, argmax=argmax)
            if plan.ring == 1:
                assert mk.k1_smem(Fcp, C, dtype, 2, argmax=argmax) > MAX_SMEM
            assert plan.blocks_per_sm == min(233472 // (plan.smem + 1024), 16)
            if Fcp <= 144:
                assert plan.ring == 2 and plan.blocks_per_sm >= 1
    assert taken > 10000 and new > taken // 5


def test_plan_at_the_bench_and_canonical_shapes():
    """The bench shape (Fcp = 112, C = 16, float32): two tiles in 71 936
    bytes, three blocks an SM, 16-byte copies at n = 1e6, plain loads at
    1e6+37, 4-byte copies at an even n; the canonical Φ's 144 rows two
    blocks an SM; one tile where two do not fit; the atomics body where
    one does not fit either; wide Φ's weights' types only."""
    n = 10**6
    assert mk.k1_plan(112, 16, torch.float32, n) == mk.K1Plan(2, 71936, 3, 16, 16)
    assert mk.k1_plan(112, 16, torch.float32, n + 37).copy == 2
    assert mk.k1_plan(112, 16, torch.float32, n + 2).copy == 4
    canon = mk.k1_plan(mk._canonical_rows(5, 3), 16, torch.float32, 250_000)
    assert (canon.ring, canon.smem, canon.blocks_per_sm) == (2, 92416, 2)
    assert mk.k1_plan(300, 32, torch.float64, n).ring == 1
    assert mk.k1_plan(700, 32, torch.float32, n) is None
    assert _old_body_smem(700, 32, 4, True) <= MAX_SMEM
    assert mk.k1_plan(112, 16, torch.int16, n) is None
    assert mk.k1_plan(112, 33, torch.float32, n) is None


@pytest.mark.parametrize("n,grid", [(1, 1), (65536, 1), (65537, 2), (10**8, 1526)])
def test_plan_keeps_every_block_at_65536_instances(n, grid):
    """``min_grid`` blocks over tiles b, b + G, ... give no block more than
    512 tiles of 128 instances: the int32 sums stay exact."""
    plan = mk.k1_plan(112, 16, torch.float32, n)
    assert plan.min_grid == grid
    ntiles = -(-n // 128)
    assert -(-ntiles // plan.min_grid) * 128 <= 65536


def test_scratch_parts_do_not_overlap():
    """The launch's partials in one allocation: each part's address 16-byte
    aligned, inside the allocation and apart from the others."""
    parts = ((11, torch.int32), (9, torch.float32), (1, torch.int64), (5, torch.float64))
    buf, addrs = mk._scratch(torch.device("cpu"), parts)
    spans = sorted((a, a + k * dt.itemsize) for a, (k, dt) in zip(addrs, parts))
    base = buf.data_ptr()
    assert buf.dtype == torch.uint8 and spans[0][0] == base and spans[-1][1] <= base + buf.numel()
    assert all(a % 16 == 0 for a, _ in spans)
    assert all(spans[k][1] <= spans[k + 1][0] for k in range(len(spans) - 1))


def test_byte_planes_split_every_int16():
    """For all 65 536 int16 values, Φ = 256 · (Φ >> 8) + (Φ & 0xFF) with
    Φ >> 8 an s8 and Φ & 0xFF a u8, and the two bytes are those that
    ``split4``'s byte permutes pick (the odd and the even bytes of the
    little-endian row)."""
    v = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    hi = (v >> 8).astype(np.int8)
    lo = (v & 0xFF).astype(np.uint8)
    assert np.array_equal(256 * hi.astype(np.int32) + lo.astype(np.int32), v.astype(np.int32))
    raw = v.view(np.uint8)
    assert np.array_equal(raw[1::2].view(np.int8), hi) and np.array_equal(raw[0::2], lo)


def _plane_sums_int32(phi, na, C):
    """The body's statistics for one block, in int32 arithmetic that wraps:
    per 128-instance tile the hi and lo plane products with the u8 one-hot
    (0xFF matches no cluster), then 256 · hi + lo added to the block's
    sums."""
    F, n = phi.shape
    hi = (phi >> 8).astype(np.int8).astype(np.int32)
    lo = (phi & 0xFF).astype(np.uint8).astype(np.int32)
    acc = np.zeros((F, C), np.int32)
    for t0 in range(0, n, 128):
        hot = (na[t0 : t0 + 128, None] == np.arange(C)[None, :]).astype(np.int32)
        h = hi[:, t0 : t0 + 128] @ hot
        l_ = lo[:, t0 : t0 + 128] @ hot
        acc = acc + h * np.int32(256) + l_
    return acc


@pytest.mark.parametrize("case", ["random", "all_min", "all_max", "extremes"])
def test_plane_products_sum_exactly_in_int32(case):
    """65 536 instances a block, every instance in cluster 0 (or spread
    over 32 clusters, some left out): the int32 plane sums equal the int64
    sums, -2^31 and 65 536 · 32 767 included."""
    rng = np.random.default_rng(3)
    n, F, C = 65536, 8, 32
    if case == "random":
        phi = rng.integers(-32768, 32768, size=(F, n)).astype(np.int16)
        na = rng.integers(0, C, size=n).astype(np.int64)
        na[::7] = 0xFF
    else:
        fill = {"all_min": -32768, "all_max": 32767}.get(case)
        phi = np.full((F, n), fill if fill is not None else 0, np.int16)
        if fill is None:
            phi[0::2] = -32768
            phi[1::2] = 32767
        na = np.zeros(n, np.int64)
    with np.errstate(over="ignore"):
        got = _plane_sums_int32(phi, na, C)
    hot = (na[:, None] == np.arange(C)[None, :]).astype(np.int64)
    want = phi.astype(np.int64) @ hot
    assert np.array_equal(got.astype(np.int64), want)
    if case == "all_min":
        assert want[0, 0] == -(2**31)


def k1_objective_in_order(best, valid, chunk=mk._EM_CHUNK):
    """K1's objective Σ_valid best summed in its kernels' order, in
    ``best``'s dtype: per ``chunk`` instances, slot j < 256 adds the
    entries j, j + 256, ... in order from 0 (an invalid instance's entry
    is 0), each warp of 32 slots reduces by ``block_sum``'s shuffle tree
    (``csrc/markov_common.cuh``), the 8 warps' results are added in order
    from 0, and the chunks' results in order from 0.  Every addition is
    one rounded sum, so on the same best scores this is the kernels'
    objective bit for bit."""
    dt = best.dtype
    n = best.shape[0]
    nsub = -(-n // chunk)
    e = torch.zeros((nsub * chunk,), dtype=dt, device=best.device)
    e[:n] = torch.where(valid, best, torch.zeros((), dtype=dt, device=best.device))
    e = e.view(nsub, chunk // 256, 256)
    slots = torch.zeros((nsub, 256), dtype=dt, device=best.device)
    for k in range(chunk // 256):
        slots = slots + e[:, k]
    lanes = slots.view(nsub, 8, 32)
    for o in (16, 8, 4, 2, 1):
        # a lane whose source is out of range adds its own value, as
        # __shfl_down_sync returns it; lane 0 reads in-range lanes only
        lanes = torch.cat([lanes[..., : 32 - o] + lanes[..., o:], lanes[..., 32 - o :] + lanes[..., 32 - o :]], dim=-1)
    subs = torch.zeros((nsub,), dtype=dt, device=best.device)
    for w in range(8):
        subs = subs + lanes[:, w, 0]
    total = torch.zeros((), dtype=dt)
    for v in subs.cpu():
        total = total + v
    return total.to(best.device)


def _block_sum(slots):
    """mtm::block_sum over 256 slot sums: each warp's shuffle tree, then
    the warps in order from 0."""
    tot = torch.zeros((), dtype=slots[0].dtype)
    for w in range(8):
        lanes = list(slots[32 * w : 32 * w + 32])
        for o in (16, 8, 4, 2, 1):
            lanes = [lanes[k] + (lanes[k + o] if k + o < 32 else lanes[k]) for k in range(32)]
        tot = tot + lanes[0]
    return tot


def _objective_atomics_body(best, valid, chunk=1024):
    """``csrc/markov_em.cu``'s blocks: one of 256 threads per chunk;
    thread j adds the best scores of its valid instances j, j + 256, ... in
    order; block_sum; one thread adds the chunks' partials in order."""
    n = best.shape[0]
    total = torch.zeros((), dtype=best.dtype)
    for s0 in range(0, n, chunk):
        end = min(s0 + chunk, n)
        slots = [torch.zeros((), dtype=best.dtype) for _ in range(256)]
        for i0 in range(s0, end, 256):
            for j in range(256):
                if i0 + j < end and valid[i0 + j]:
                    slots[j] = slots[j] + best[i0 + j]
        total = total + _block_sum(slots)
    return total


@pytest.mark.parametrize("n", [1, 300, 1024, 2049, 4100])
def test_objective_order_is_the_atomics_bodys(n):
    """``k1_objective_in_order`` (the new body's reduce) equals the atomics
    body's order bit for bit on scores of mixed magnitude and sign, with
    rows left out and -0.0 among them, then with +Inf, -Inf (a NaN sum)
    and a NaN."""
    rng = np.random.default_rng(n)
    best = torch.from_numpy((rng.normal(size=n) * 10 ** rng.uniform(-3, 6, size=n)).astype(np.float32))
    best[::7] = -0.0
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1)
    got, want = k1_objective_in_order(best, valid), _objective_atomics_body(best, valid)
    assert got.view(torch.int32) == want.view(torch.int32)
    if n > 3:
        odd = best.clone()
        odd[1], odd[2] = float("inf"), float("-inf")
        valid[1] = valid[2] = True
        g, w = k1_objective_in_order(odd, valid), _objective_atomics_body(odd, valid)
        assert bool(torch.isnan(g)) and bool(torch.isnan(w))
        odd[2] = 5.0
        g, w = k1_objective_in_order(odd, valid), _objective_atomics_body(odd, valid)
        assert g.view(torch.int32) == w.view(torch.int32) and float(g) == float("inf")


def _k1_inputs(n, C=16, Fcp=112, seed=5):
    """int16 Φ (quantized normal features with a constant row), float32
    weights of score magnitude, prev with rows left out."""
    rng = np.random.default_rng(seed)
    phi = torch.from_numpy(rng.normal(size=(Fcp, n)) * rng.uniform(0.1, 10.0, size=(Fcp, 1)))
    phi[-1] = 1.0
    pq = mk.quantize_phi(phi.float())
    wc = torch.from_numpy(rng.normal(size=(C, Fcp)) * 1e-3).float() - 0.01
    prev = torch.from_numpy(rng.integers(0, C, size=n).astype(np.int32))
    prev[::97] = -1
    return pq.q, prev, wc


@pytest.mark.parametrize("n", [1, 255, 1024, 1025, 5121, 20037])
def test_objective_emulation_matches_the_plain_objective(n):
    """On K1's int16 inputs with float32 weights, the emulated kernel order
    of the plain scores' best values is within 1e-6 of Σ|best| of
    ``markov_em_compact``'s CPU objective, and takes its assignment's
    scores."""
    q, prev, wc = _k1_inputs(n)
    a, _c, _s, _m, obj = mk.markov_em_compact(q, prev, wc)
    best, na = mk._argmax_first(wc @ q.float())
    valid = prev >= 0
    assert torch.equal(torch.where(valid, na, wc.shape[0]), a)
    got = k1_objective_in_order(best, valid)
    assert got.dtype == torch.float32
    mag = float(torch.where(valid, best, 0.0).abs().double().sum())
    assert abs(float(got) - float(obj)) <= 1e-6 * mag


def _weights(d, l, seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(3, d))
    S = np.stack([np.eye(d)] * 3) * rng.uniform(0.5, 2.0, size=(3, 1, 1))
    A = rng.normal(scale=0.4, size=(3, d, d))
    G = np.stack([np.eye(d)] * 3)
    H = rng.normal(size=(3, d, l))
    L = np.stack([np.eye(l)] * 3)
    Wg_j = jmarkov.markov_em_weights(*map(jnp.asarray, (m, S, A, G, H, L)))
    Wg_t = tmarkov.markov_em_weights(*map(torch.from_numpy, (m, S, A, G, H, L)))
    return Wg_j, Wg_t


@pytest.mark.parametrize("storage", ["wide", "i16"])
def test_objective_emulation_matches_the_jax_kernel(storage):
    """The emulated order over the plain float64 best scores (the port's
    Φ and folded weights) agrees with the JAX package's K1 objective
    (interpret mode, float64) to 1e-10 relative, with rows left out."""
    T, d, l, n = 4, 2, 2, 301
    rng = np.random.default_rng(9)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    steps = np.arange(T)[:, None] >= lens[None, :]
    z[steps] = np.nan
    x[steps] = np.nan
    zt = np.ascontiguousarray(z.transpose(0, 2, 1).reshape(T * d, n))
    xt = np.ascontiguousarray(x.transpose(0, 2, 1).reshape(T * l, n))
    u_j = jpm.pack_markov_u(jnp.asarray(zt), jnp.asarray(xt), T=T, d=d, l=l, pad_to=512)
    phi_j = jpm.markov_materialize_features(u_j, jnp.asarray(np.pad(lens, (0, 512 - n))), T=T, d=d, l=l,
                                            interpret=True)
    Wg_j, Wg_t = _weights(d, l, seed=4)
    prev = rng.integers(0, 3, size=n).astype(np.int32)
    prev[rng.choice(n, size=9, replace=False)] = -1
    phi_t = torch.from_numpy(np.asarray(phi_j)[:, :n].copy())
    scale = None
    if storage == "i16":
        phi_j = jpm.quantize_phi(phi_j)
        pq = mk.quantize_phi(phi_t)
        phi_t, scale = pq.q, pq.scale
    o_j = jpm.markov_em_from_features(phi_j, jnp.asarray(lens), jnp.asarray(prev), Wg_j, T=T, d=d, l=l,
                                      interpret=True)[4]
    wc = mk.fold_weights(Wg_t, T=T, d=d, l=l, scale=scale)
    best, _na = mk._argmax_first(wc @ phi_t.to(wc.dtype))
    got = k1_objective_in_order(best, torch.from_numpy(prev) >= 0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(o_j), rtol=1e-10)
