"""K2's staged float32 body (``csrc/markov_features.cu``) emulated on the
CPU, and its host plan.

The body: persistent blocks take the tiles b, b + G, ... of NT instances;
a tile's u (T·s rows × NT) and lengths are copied into a ring of two
slots (zero past n: the tail tile is masked), the next tile's copies
issued before this tile's build; q parts an instance, part p owning the
rows f ≡ p (mod q).  At (d, l) = (5, 3) and
(2, 4) a part keeps a step's s values of u and the next step's in
registers and adds each owned row's term for that step (the step-outer
build of ``csrc/markov_step_rows.cuh``); at any other (d, l) it builds each
row with ``acc_row_tile``, ``acc_row``'s terms from the staged tile.  Each
row is then stored to Φ; the pad rows get zeros.

The emulation below walks that loop in numpy float32 (a product and a sum
contracted as the card's fused multiply-add, a plain sum as a float32
add) and is held bit for bit to ``csrc/markov_common.cuh:acc_row``'s terms
in order (the term lists of ``tests/test_torch_packed_body.py``) on the
packed batch in device memory, as the row-at-a-time body sums them: every
entry written exactly once, every instance past n untouched.  Against the
JAX package's K2 (``pallas_markov.py:1314``, interpret mode, float32) on
an unstandardized (|x| ~ 50) NaN-suffix batch from a numpy seed: within
1e-5 of each row's max |Φ| (``chip_smoke.py``'s K2 rule; the JAX kernel
takes the masked rows as A minus the last step's products).

The plan (``markov_kernels.k2_plan``) must fit a block within the card's
232 448 bytes for every (T, d, l) with T·s ≤ 512; where it finds none,
the wrapper routes the shape to the row-at-a-time body."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from tests.test_torch_packed_body import A, AID, AVM, B, F0, U0, _terms_acc_row

MAX_SMEM = 232448
LEN, ONE, ZERO = 6, 7, 8
TABLES = ((5, 3), (2, 4))  # the (d, l) with a compile-time table


def fma32(a, b, c):
    """The card's float32 fused multiply-add: the exact product (float64
    holds it) plus c, rounded once to float32 (through float64: the same
    function on both sides of every comparison)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _packed(T, d, l, n, seed, scale=1.0):
    """The packed batch (float32 numpy, NaN -> 0) and lengths 0..T, from a
    numpy seed, with (z, x) in the (T·d, n), (T·l, n) layout."""
    rng = np.random.default_rng(seed)
    z = ((rng.normal(size=(T, n, d)) + rng.normal(size=d)) * scale).astype(np.float32)
    x = ((rng.normal(size=(T, n, l)) + rng.normal(size=l)) * scale).astype(np.float32)
    lens = rng.integers(0, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    zt = np.ascontiguousarray(z.transpose(0, 2, 1).reshape(T * d, n))
    xt = np.ascontiguousarray(x.transpose(0, 2, 1).reshape(T * l, n))
    u = mk.pack_markov_u(torch.from_numpy(zt), torch.from_numpy(xt), T=T, d=d, l=l).numpy()
    return u, lens, zt, xt


def _rows(T, d, l):
    Fcp, uniq, _pos = mk.markov_compact_spec(T, d, l)
    return Fcp, mk._acc_row_table(d, l)[uniq]


def _eval_terms(terms, col):
    """acc_row's terms on one instance's values (any leading shape):
    ("set", a, b) a rounded product, ("set", a) a value, ("add", a, b) a
    fused multiply-add, ("add", a) a float32 add, from 0."""
    acc = np.zeros(col.shape[1:], np.float32)
    for term in terms:
        if term[0] == "set":
            acc = col[term[1]] * col[term[2]] if len(term) == 3 else col[term[1]].copy()
        elif len(term) == 3:
            acc = fma32(col[term[1]], col[term[2]], acc)
        else:
            acc = acc + col[term[1]]
    return acc


def acc_rows_reference(u, lens, T, d, l):
    """Φ as the row-at-a-time body sums it: each row acc_row's terms in
    order on the packed batch, the instances grouped by length."""
    s = u.shape[0] // T
    Fcp, rows = _rows(T, d, l)
    n = u.shape[1]
    phi = np.zeros((Fcp, n), np.float32)
    for f, (kind, k, r) in enumerate(rows):
        if kind in (LEN, ONE, ZERO):
            phi[f] = {LEN: lens.astype(np.float32), ONE: 1.0, ZERO: 0.0}[kind]
            continue
        for length in range(T + 1):
            at = lens == length
            if at.any():
                phi[f, at] = _eval_terms(_terms_acc_row(kind, k, r, length, T, s), u[:, at])
    return phi


def _step_outer(su, sl, rows, part, q, T, s):
    """Part ``part``'s rows of a staged tile by the step-outer build:
    {f: its column over the tile's lanes}.  Each row's value before step 0
    (Part::init), its term at each step t from that step's values and the
    next step's (Part::step), then the value stored (Part::put)."""
    mine = [(f, *rows[f]) for f in range(part, rows.shape[0], q)]
    acc = {}
    for f, kind, k, r in mine:
        acc[f] = (su[r] * su[r + k] if kind == F0 else su[r].copy() if kind == U0
                  else np.zeros(su.shape[1], np.float32))
    for t in range(T):
        more, on = t + 1 < T, t + 1 < sl
        cur = su[t * s:(t + 1) * s]
        nxt = su[(t + 1) * s:(t + 2) * s] if more else np.zeros_like(cur)
        for f, kind, k, r in mine:
            if kind == A:
                if r + k < s:
                    acc[f] = fma32(cur[r], cur[r + k], acc[f])
                elif more:
                    acc[f] = fma32(cur[r], nxt[r + k - s], acc[f])
            elif kind == B:
                acc[f] = np.where(on, fma32(cur[r], cur[r + k], acc[f]), acc[f])
            elif kind == AID:
                acc[f] = acc[f] + cur[r]
            elif kind == AVM:
                acc[f] = np.where(on, acc[f] + cur[r], acc[f])
    for f, kind, _k, _r in mine:
        if kind in (LEN, ONE, ZERO):
            acc[f] = {LEN: sl.astype(np.float32), ONE: np.ones(su.shape[1], np.float32),
                      ZERO: np.zeros(su.shape[1], np.float32)}[kind]
    return acc


def _row_tile(su, sl, rows, part, q, T, s):
    """Part ``part``'s rows of a staged tile by acc_row_tile: acc_row's
    terms, in order, on the tile's lanes, the lanes grouped by length."""
    out = {}
    for f in range(part, rows.shape[0], q):
        kind, k, r = rows[f]
        if kind in (LEN, ONE, ZERO):
            out[f] = {LEN: sl.astype(np.float32), ONE: np.ones(su.shape[1], np.float32),
                      ZERO: np.zeros(su.shape[1], np.float32)}[kind]
            continue
        v = np.zeros(su.shape[1], np.float32)
        for length in np.unique(sl):
            at = sl == length
            v[at] = _eval_terms(_terms_acc_row(kind, k, r, int(length), T, s), su[:, at])
        out[f] = v
    return out


def stage_tile(u, lens, i0, nt):
    """A tile's copies (16 bytes where n % 4 == 0 and u, lens are aligned,
    else 4: the same values), zero past n: (u tile (Ts, nt), lengths)."""
    Ts, n = u.shape
    m = min(nt, n - i0)
    su, sl = np.zeros((Ts, nt), np.float32), np.zeros(nt, np.int32)
    su[:, :m], sl[:m] = u[:, i0:i0 + m], lens[i0:i0 + m]
    return su, sl


def emulate_staged(u, lens, T, d, l, nt, q, ring, grid, table=True):
    """The staged body's walk: (Φ with NaN where nothing was stored, the
    number of stores of each entry)."""
    Ts, n = u.shape
    s = Ts // T
    Fcp, rows = _rows(T, d, l)
    fixed = table and (d, l) in TABLES
    phi = np.full((Fcp, n), np.nan, np.float32)
    stores = np.zeros((Fcp, n), np.int64)
    ntiles = -(-n // nt)
    for b in range(grid):
        slots = [None] * ring

        def issue(tile, slot):
            slots[slot] = (tile, *stage_tile(u, lens, tile * nt, nt))

        if b < ntiles:  # the block's first tile into slot 0
            issue(b, 0)
        for it, tile in enumerate(range(b, ntiles, grid)):
            if ring == 2 and tile + grid < ntiles:  # the next tile before this one's build
                issue(tile + grid, (it + 1) % 2)
            staged_tile, su, sl = slots[it % ring]
            assert staged_tile == tile
            lanes = np.arange(nt)[tile * nt + np.arange(nt) < n]  # threads past n return
            for part in range(q):
                built = (_step_outer if fixed else _row_tile)(su[:, lanes], sl[lanes], rows, part, q, T, s)
                for f in list(built) + list(range(rows.shape[0] + part, Fcp, q)):
                    val = built.get(f, np.zeros(lanes.shape[0], np.float32))
                    phi[f, tile * nt + lanes] = val
                    stores[f, tile * nt + lanes] += 1
            if ring == 1 and tile + grid < ntiles:
                issue(tile + grid, 0)
    return phi, stores


def _same_bits(p, q):
    return np.array_equal(np.asarray(p, np.float32).view(np.int32), np.asarray(q, np.float32).view(np.int32))


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1037, 1038, 1039])
@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (3, 2)])
def test_staged_walk_is_acc_rows_order(d, l, n):
    """The wrapper's plan and three others (tiles of 128, 64, 32, rings of
    1 and 2, grids of 1-5 blocks), n of every residue mod 4: every Φ entry
    of the n instances stored once, equal to acc_row's sum bit for bit,
    the pad rows zero; lengths 0..T, so the masks run from no step to
    every step."""
    T = 10
    u, lens, _zt, _xt = _packed(T, d, l, n, seed=n + 10 * d + l)
    want = acc_rows_reference(u, lens, T, d, l)
    plan = mk.k2_plan(T, d, l)
    Fc = _rows(T, d, l)[1].shape[0]
    for nt, ring, grid in ((plan.nt, plan.ring, 3), (128, 1, 2), (64, 2, 5), (32, 1, 4)):
        got, stores = emulate_staged(u, lens, T, d, l, nt, plan.q, ring, grid)
        assert (stores == 1).all(), (nt, ring, grid)
        assert _same_bits(got, want), (nt, ring, grid)
        assert (got[Fc:] == 0).all()


@pytest.mark.parametrize("d,l", TABLES)
def test_general_build_is_the_tables(d, l):
    """At the shapes with a table, the acc_row_tile build (the body forced
    to "general") stores the same bits as the step-outer build."""
    T, n = 10, 300
    u, lens, _zt, _xt = _packed(T, d, l, n, seed=31, scale=50.0)
    plan = mk.k2_plan(T, d, l)
    fixed, _ = emulate_staged(u, lens, T, d, l, plan.nt, plan.q, plan.ring, 2)
    general, _ = emulate_staged(u, lens, T, d, l, plan.nt, plan.q, plan.ring, 2, table=False)
    assert _same_bits(fixed, general) and _same_bits(fixed, acc_rows_reference(u, lens, T, d, l))


@functools.lru_cache(maxsize=None)
def _jax_phi(T, d, l, n, seed):
    """The JAX package's K2 (interpret mode, float32) on a wide NaN-suffix
    batch, and the batch."""
    u, lens, zt, xt = _packed(T, d, l, n, seed, scale=50.0)
    u_j = jpm.pack_markov_u(jnp.asarray(zt), jnp.asarray(xt), T=T, d=d, l=l, pad_to=2048)
    phi = jpm.markov_materialize_features(u_j, jnp.asarray(lens), T=T, d=d, l=l, interpret=True)
    return u, lens, np.asarray(phi)[:, :n]


@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (3, 2)])
def test_staged_body_matches_the_jax_kernel(d, l):
    """The emulated body against the JAX kernel within 1e-5 of each row's
    max |Φ| on an unstandardized (|x| ~ 50) NaN-suffix batch."""
    T, n = 10, 2100
    u, lens, want = _jax_phi(T, d, l, n, 41)
    plan = mk.k2_plan(T, d, l)
    got, _ = emulate_staged(u, lens, T, d, l, plan.nt, plan.q, plan.ring, 7)
    assert np.abs(got).max() > 1e3 and want.dtype == np.float32
    bound = 1e-5 * np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= bound).all()


def _old_body_takes(T, d, l):
    """The row-at-a-time body takes every shape; the compact layout exists
    where T·s ≤ 512."""
    return mk.markov_packed_ok(T, d, l)


@pytest.mark.parametrize("d", range(1, 17))
def test_k2_plan_fits_every_packed_shape(d):
    """Every (T, l) with T·s ≤ 512 (l ≤ 16): a block within 232 448 bytes,
    32, 64 or 128 instances a tile, four threads an instance, a ring of
    one or two tiles, at most 512 threads, its shared memory the CUDA source's
    sum; the wrapper takes the staged body there in float32."""
    for l in range(0, 17):
        s = 8 * ((d + l + 7) // 8)
        for T in range(1, 512 // s + 1):
            assert _old_body_takes(T, d, l)
            plan = mk.k2_plan(T, d, l)
            assert plan is not None, (T, d, l)
            Fcp = mk.markov_compact_spec(T, d, l)[0]
            assert plan.smem == mk.k2_smem(Fcp, T * s, plan.nt, plan.ring) <= MAX_SMEM
            assert plan.nt in (32, 64, 128) and 1 <= plan.ring <= 2 and plan.q == 4
            assert plan.threads == plan.nt * plan.q <= 512 and plan.blocks_per_sm >= 1
            assert mk._k2_body(torch.float32, T, d, l) == "staged"
            assert mk._k2_body(torch.float64, T, d, l) == "rows"


def test_k2_plan_none_routes_the_rows_body():
    """Past what a block holds (T·s · 32 · 4 bytes > 232 448) the plan is
    None and the shape goes to the row-at-a-time body in both types."""
    assert mk.k2_plan(220, 5, 3) is not None
    for T in (230, 400):
        assert mk.k2_plan(T, 5, 3) is None
        assert mk._k2_body(torch.float32, T, 5, 3) == "rows"


def test_k2_plan_at_the_bench_and_adni_shapes():
    """(T, d, l) = (10, 5, 3) and ADNI's (10, 2, 4): 128-instance tiles,
    four threads an instance, a ring of two tiles (2 × 40 KB of u), two
    blocks an SM by shared memory (the registers allow one at the bench
    shape); at T·s = 512 one slot of 32 instances, three blocks an SM."""
    assert mk.k2_plan(10, 5, 3) == mk.K2Plan(128, 4, 2, 83392, 512, 2)
    assert mk.k2_plan(10, 2, 4) == mk.K2Plan(128, 4, 2, 83136, 512, 2)
    assert mk.k2_plan(32, 9, 4) == mk.K2Plan(32, 4, 1, mk.k2_smem(296, 512, 32, 1), 128, 3)
