"""The arithmetic, the compile-time row tables and the host plan of float32
K4a's staged body (``csrc/markov_em_packed_one.cu``), emulated on the CPU.

The body builds an instance's Φ rows step-outer: for each step t a thread
holds the step's s values of u (and the next step's) and adds each of its
rows' term for that step (``Part::step``); F0 and U0 rows take their value
from step 0 alone (``Part::init``).  The emulation below holds that loop to
``csrc/markov_common.cuh:acc_row``'s list of terms, in order, for every
row kind, shift and row the compile-time asserts admit, every length 0..T
and every T with T·s ≤ 512.  The compile-time tables
(``csrc/markov_acc_table.cuh``, plain C++) are compiled with the host
compiler and held to the layout's (``markov_compact_spec``,
``_acc_row_table``).

Its statistics: persistent blocks take the tiles b, b + G, ... of NT
instances; each tile sorted by cluster, stably, and each cluster's
instances added in instance order into a float32 sum that goes into the
block's running float32 sum; the blocks' partials are added one warp an
output (lane k the blocks k, k + 32, ... in order, then a shuffle tree).
Tolerance: 2e-5 of the same sums over |Φ| (the float32 rule of
``tests/test_torch_cuda_kernels.py``), against float64 and against the JAX
package's K4a (``pallas_markov.py:727``, interpret mode, float32) on an
unstandardized (|x| ~ 50) NaN-suffix batch from a numpy seed.

Its objective: each valid instance's best score (0 for the others) in a
row of n floats, summed per 1024-instance sub into 128 slots (instance j
to slot j % 128, in order), the slots through the shuffle tree of
``csrc/markov_common.cuh:block_sum`` and its warp order, the subs in order
— emulated bit for bit against the header's 128-thread blocks.

The plan (``markov_kernels.packed_one_plan``) must find a block within the
card's 232 448 bytes for every shape the header's float32 body took for
K4a, so that the new body refuses nothing the old one took."""

import functools
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import markov as jmarkov
from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

REL = 2e-5
MAX_SMEM = 232448
CSRC = Path(mk.__file__).resolve().parent.parent / "csrc"
A, B, F0, AID, AVM, U0 = range(6)


def _terms_acc_row(kind, k, r, length, steps, s):
    """acc_row's operations, in order: ("set", ...) for a value taken as
    it is (F0's product, U0's value), ("add", ...) for a term summed."""
    Ts = steps * s
    if kind == A:
        return [("add", t * s + r, t * s + r + k) for t in range(steps) if t * s + r + k < Ts]
    if kind == B:
        out, t = [], 0
        while t + 1 < length and t < steps:
            out.append(("add", t * s + r, t * s + r + k))
            t += 1
        return out
    if kind == F0:
        return [("set", r, r + k)]
    if kind == AID:
        return [("add", t * s + r) for t in range(steps)]
    if kind == AVM:
        out, t = [], 0
        while t + 1 < length and t < steps:
            out.append(("add", t * s + r))
            t += 1
        return out
    return [("set", r)]  # U0


def _terms_step_outer(kind, k, r, length, steps, s):
    """The body's Part::init, then Part::step at t = 0, 1, ..., T - 1 (cur
    the step's rows t·s.., nxt the next step's, `more` = t + 1 < T, `on` =
    t + 1 < len), as u row indices."""
    out = []
    if kind == F0:
        out.append(("set", r, r + k))
    elif kind == U0:
        out.append(("set", r))
    for t in range(steps):
        more, on = t + 1 < steps, t + 1 < length
        cur = lambda i: t * s + i  # noqa: E731
        nxt = lambda i: (t + 1) * s + i  # noqa: E731
        if kind == A:
            if r + k < s:
                out.append(("add", cur(r), cur(r + k)))
            elif more:
                out.append(("add", cur(r), nxt(r + k - s)))
        elif kind == B and on:
            out.append(("add", cur(r), cur(r + k)))
        elif kind == AID:
            out.append(("add", cur(r)))
        elif kind == AVM and on:
            out.append(("add", cur(r)))
    return out


@pytest.mark.parametrize("s", [8, 16, 24])
def test_step_outer_build_adds_acc_rows_terms_in_order(s):
    """Every row kind, every shift and row the body's static asserts admit
    (A: r + k < 2s, B and F0: r + k < s), lengths 0..T + 1, T with
    T·s ≤ 512: the same operations on the same u rows in the same order."""
    for steps in sorted({1, 2, 3, 512 // s // 2, 512 // s}):
        for kind in (A, B, F0, AID, AVM, U0):
            for r in range(s):
                for k in range(2 * s - r if kind == A else s - r if kind in (B, F0) else 1):
                    for length in range(0, steps + 2):
                        want = _terms_acc_row(kind, k, r, length, steps, s)
                        assert _terms_step_outer(kind, k, r, length, steps, s) == want, (kind, k, r, length, steps)


def _layout_rows_admitted(d, l):
    """Every row of the compact layout passes the body's static asserts."""
    s = 8 * ((d + l + 7) // 8)
    _Fcp, uniq, _pos = mk.markov_compact_spec(10, d, l)
    for kind, k, r in mk._acc_row_table(d, l)[uniq]:
        if kind == A:
            assert r + k < 2 * s
        if kind in (B, F0):
            assert r + k < s


_SHAPES = [(5, 3), (2, 4), (1, 1), (3, 3), (4, 4), (6, 2), (2, 6), (1, 7)]


@pytest.fixture(scope="module")
def host_tables(tmp_path_factory):
    """The compile-time tables of _SHAPES, from markov_acc_table.cuh built
    with the host's C++ compiler: {(d, l): (fc, rows)}."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    work = tmp_path_factory.mktemp("acc_table")
    src = work / "tables.cpp"
    calls = "\n".join(
        f"  {{ constexpr mtm::AccTable t = mtm::make_acc_table({d}, {l}); emit({d}, {l}, t); }}" for d, l in _SHAPES)
    src.write_text(f"""#include <cstdio>
#include "markov_acc_table.cuh"
static void emit(int d, int l, const mtm::AccTable& t) {{
  std::printf("%d %d %d", d, l, t.fc);
  for (int f = 0; f < t.fc; ++f) std::printf(" %d %d %d", t.kind[f], t.k[f], t.r[f]);
  std::printf("\\n");
}}
int main() {{
{calls}
  return 0;
}}
""")
    exe = work / "tables"
    subprocess.run([cxx, "-std=c++17", "-O1", f"-I{CSRC}", str(src), "-o", str(exe)], check=True,
                   capture_output=True)
    out = {}
    for line in subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.splitlines():
        v = [int(x) for x in line.split()]
        out[(v[0], v[1])] = (v[2], np.array(v[3:], np.int64).reshape(-1, 3))
    return out


@pytest.mark.parametrize("d,l", _SHAPES)
def test_compile_time_table_is_the_layouts(host_tables, d, l):
    """make_acc_table(d, l) lists markov_compact_spec's rows in order, each
    as _acc_row_table's (kind, k, r); every row passes the static asserts."""
    _Fcp, uniq, _pos = mk.markov_compact_spec(10, d, l)
    want = mk._acc_row_table(d, l)[uniq]
    fc, rows = host_tables[(d, l)]
    assert fc == want.shape[0]
    assert np.array_equal(rows, want)
    _layout_rows_admitted(d, l)


def sort_tile(na, C):
    """A stable sort of a tile's assignments by cluster (the body's ballot
    sort, held to a stable argsort in tests/test_torch_packed_multi_body.py):
    (the valid instances in cluster order, counts)."""
    valid = np.where(na >= 0)[0]
    return valid[np.argsort(na[valid], kind="stable")], np.bincount(na[valid], minlength=C)


def warp_total(parts):
    """mtm::warp_total over a (nblocks, ...) float32 array: lane k sums the
    blocks k, k + 32, ... in order, then the shuffle tree (lane l adds lane
    l + o for o = 16, 8, 4, 2, 1; lanes past 31 add their own value)."""
    lanes = []
    for k in range(32):
        a = torch.zeros(parts.shape[1:], dtype=torch.float32)
        for b in range(k, parts.shape[0], 32):
            a = a + parts[b]
        lanes.append(a)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[k] + (lanes[k + o] if k + o < 32 else lanes[k]) for k in range(32)]
    return lanes[0]


def emulate_statistics(phi, na, C, nt, grid):
    """The body's statistics of float32 ``phi (F, n)`` under ``na (n,)``
    (-1: none): block b takes the tiles b, b + grid, ...; each tile sorted,
    each cluster's instances in instance order into a float32 sum, added
    into the block's running sum; the blocks' partials through
    warp_total.  ``(F, C)`` float32."""
    F, n = phi.shape
    ntiles = -(-n // nt)
    parts = torch.zeros((grid, F, C), dtype=torch.float32)
    for b in range(grid):
        for tile in range(b, ntiles, grid):
            i0 = tile * nt
            perm, counts = sort_tile(na[i0 : i0 + nt].numpy(), C)
            k = 0
            for c in range(C):
                if counts[c]:
                    run = torch.zeros(F, dtype=torch.float32)
                    for j in perm[k : k + counts[c]]:
                        run = run + phi[:, i0 + j]
                    parts[b, :, c] = parts[b, :, c] + run
                k += counts[c]
    return warp_total(parts)


@functools.lru_cache(maxsize=None)
def _wide_problem(T=10, d=5, l=3, n=3000, C=4, seed=14):
    """The JAX kernel's K4a outputs (float32, interpret mode) on a wide
    (|x| ~ 50) NaN-suffix batch, the port's float32 Φ of the batch, and Φ
    of |u| with every step unmasked (the masked rows' magnitude where the
    JAX kernel takes them as A minus the last step's products)."""
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

    Wg = np.asarray(jmarkov.markov_em_weights(*map(jnp.asarray, (
        rng.normal(scale=25, size=(C, d)), spd(d), rng.normal(scale=0.3, size=(C, d, d)), spd(d),
        rng.normal(size=(C, d, l)), spd(l))))).astype(np.float32)
    prev = rng.integers(0, C, size=n).astype(np.int32)
    prev[::37] = -1
    u_j = jpm.pack_markov_u(jnp.asarray(zt), jnp.asarray(xt), T=T, d=d, l=l, pad_to=2048)
    a, c, _s, g, _o = jpm.markov_em_fused_packed(
        u_j, jnp.asarray(lens), jnp.asarray(prev), jnp.asarray(Wg), T=T, d=d, l=l, interpret=True)
    u = mk.pack_markov_u(torch.from_numpy(zt), torch.from_numpy(xt), T=T, d=d, l=l)
    phi = mk.markov_materialize_features_plain(u, torch.from_numpy(lens), T=T, d=d, l=l)
    unmasked = mk.markov_materialize_features_plain(u.abs().double(), torch.full((n,), T, dtype=torch.int32),
                                                    T=T, d=d, l=l)
    return (T, d, l, C), np.array(a)[:n], np.array(c), np.array(g), phi, unmasked


@pytest.mark.parametrize("nt,grid", [(128, 3), (64, 5), (32, 1), (128, 40)])
def test_emulated_statistics_match_the_jax_kernel(nt, grid):
    """The emulated body's statistics, under the JAX kernel's assignments,
    against the float64 sums (each entry within 2e-5 of the same sums over
    |Φ|) and the JAX kernel's float32 statistics (within 2e-5 of the same
    sums over unmasked |Φ|: the JAX kernel's masked rows, A minus the last
    step, cancel to a few ulps of A); the counts exact."""
    (T, d, l, C), a, c_j, g_j, phi, unmasked = _wide_problem()
    assert phi.dtype == torch.float32 and float(phi.abs().max()) > 1e4
    na = torch.from_numpy(np.where(a < C, a, -1).astype(np.int64))
    hot = torch.nn.functional.one_hot(na + 1, C + 1)[:, 1:].double()
    exact, mag = phi.double() @ hot, phi.double().abs() @ hot
    got = emulate_statistics(phi, na, C, nt, grid).double()
    assert bool(((got - exact).abs() <= REL * mag + 1e-30).all())
    pos = torch.from_numpy(mk.markov_compact_spec(T, d, l)[2])
    g = torch.from_numpy(g_j).double()
    assert bool(((got[pos] - g).abs() <= REL * (unmasked @ hot)[pos] + 1e-30).all())
    assert np.array_equal(np.asarray(c_j).reshape(-1), hot.sum(dim=0).numpy().astype(np.int64))


def block_sum_order(slots):
    """mtm::block_sum over 128 float32 slot sums: each warp's shuffle tree,
    then the warps in order from 0."""
    tot = torch.zeros((), dtype=torch.float32)
    for w in range(4):
        lanes = list(slots[32 * w : 32 * w + 32])
        for o in (16, 8, 4, 2, 1):
            lanes = [lanes[k] + (lanes[k + o] if k + o < 32 else lanes[k]) for k in range(32)]
        tot = tot + lanes[0]
    return tot


def objective_header(best, valid, sub=1024):
    """The header's body: a block of 128 threads per sub; thread j adds the
    best scores of its valid instances j, j + 128, ... in order, then
    block_sum; the subs' partials added in order."""
    n = best.shape[0]
    total = torch.zeros((), dtype=torch.float32)
    for s0 in range(0, n, sub):
        slots = [torch.zeros((), dtype=torch.float32) for _ in range(128)]
        for i0 in range(s0, min(s0 + sub, n), 128):
            for j in range(128):
                if i0 + j < min(s0 + sub, n) and valid[i0 + j]:
                    slots[j] = slots[j] + best[i0 + j]
        total = total + block_sum_order(slots)
    return total


def objective_staged(best, valid, sub=1024):
    """The staged body: each instance's entry (its best score, or 0 for an
    invalid one) in a row of n floats; the reduce's warp per sub sums slot
    j's entries j, j + 128, ... in order, the four warps' trees in order;
    the objective kernel adds the subs' partials in order."""
    n = best.shape[0]
    entry = torch.where(valid, best, torch.zeros((), dtype=torch.float32))
    total = torch.zeros((), dtype=torch.float32)
    for s0 in range(0, n, sub):
        s1 = min(s0 + sub, n)
        slots = []
        for j in range(128):
            v = torch.zeros((), dtype=torch.float32)
            for i in range(s0 + j, s1, 128):
                v = v + entry[i]
            slots.append(v)
        total = total + block_sum_order(slots)
    return total


@pytest.mark.parametrize("n", [1, 127, 1024, 1025, 2500, 5121])
def test_objective_order_is_the_headers(n):
    """The staged body's objective equals the header's bit for bit, on
    scores of mixed magnitude and sign, with invalid rows, a NaN, ±Inf and
    -0.0 among them (the NaN and Inf in a copy)."""
    rng = np.random.default_rng(n)
    best = torch.from_numpy((rng.normal(size=n) * 10 ** rng.uniform(-3, 6, size=n)).astype(np.float32))
    best[:: 7] = -0.0
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1)
    want, got = objective_header(best, valid), objective_staged(best, valid)
    assert got.view(torch.int32) == want.view(torch.int32)
    if n > 3:
        odd = best.clone()
        odd[1], odd[2] = float("inf"), float("-inf")
        valid[1] = valid[2] = True
        w, g = objective_header(odd, valid), objective_staged(odd, valid)
        assert g.view(torch.int32) == w.view(torch.int32) and bool(torch.isnan(g))
        odd[2] = float("nan")
        w, g = objective_header(odd, valid), objective_staged(odd, valid)
        assert bool(torch.isnan(w)) and bool(torch.isnan(g))


def _old_body_takes(Fcp, C, argmax):
    """Whether the header's float32 body took K4a at this shape: its block
    of 128 threads (markov_em_multi.cuh multi_smem, one restart) fits."""
    cb = (8 if C <= 8 else 16 if C <= 16 else 32) if argmax else 0
    nt, nw = 128, 4
    return 4 * (nw + Fcp * (nt + 1) + nt + Fcp * cb + Fcp * (C | 1)) + 4 * (C + nt + nw + nt) <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def _plan(T, d, l, cb, argmax):
    return mk.packed_one_plan(T, d, l, cb, argmax=argmax)


@pytest.mark.parametrize("argmax", [True, False])
def test_plan_fits_every_shape_the_header_body_took(argmax):
    """Every (T, d, l) with T·s ≤ 512 (d ≤ 16, l ≤ 16) and C in 1..32:
    where the header's body took the shape, the plan finds a block within
    232 448 bytes: 32, 64 or 128 instances a tile, four threads an
    instance, a ring of one or two tiles, at most 512 threads, its shared
    memory the CUDA source's sum."""
    shapes = taken = rings = 0
    for d in range(1, 17):
        for l in range(0, 17):
            s = 8 * ((d + l + 7) // 8)
            Fcp = mk.markov_compact_spec(1, d, l)[0]
            for T in range(1, 512 // s + 1):
                for C in range(1, 33):
                    shapes += 1
                    if not _old_body_takes(Fcp, C, argmax):
                        continue
                    taken += 1
                    cb = 8 if C <= 8 else 16 if C <= 16 else 32
                    plan = _plan(T, d, l, cb, argmax)
                    assert plan is not None, (T, d, l, C)
                    assert plan.smem <= MAX_SMEM and plan.nt in (32, 64, 128) and 1 <= plan.ring <= 2
                    assert plan.q == 4 and plan.threads == plan.nt * plan.q <= 512
                    assert plan.smem == mk.packed_one_smem(Fcp, T * s, C, plan.nt, plan.ring, argmax=argmax)
                    rings += plan.ring > 1
    assert taken > shapes // 2 and rings > 0.9 * taken


def test_plan_at_the_bench_and_adni_shapes():
    """(T, d, l) = (10, 5, 3), C = 16: 128-instance tiles, four threads an
    instance, a ring of two tiles in 157 384 bytes, one block (16 warps)
    an SM; ADNI's (2, 4) the same tile and ring; C = 32 and the "prev"
    mode fit the same tile; at T·s = 512 and C = 32 one slot of 32."""
    assert mk.packed_one_plan(10, 5, 3, 16) == mk.PackedOnePlan(128, 4, 2, 157384, 512, 1)
    adni = mk.packed_one_plan(10, 2, 4, 16)
    assert (adni.nt, adni.q, adni.ring) == (128, 4, 2)
    for kw in (dict(C=32), dict(C=16, argmax=False)):
        plan = mk.packed_one_plan(10, 5, 3, **kw)
        assert plan.nt == 128 and plan.ring == 2
    wide = mk.packed_one_plan(32, 9, 4, 32)
    assert (wide.nt, wide.ring) == (32, 1) and wide.smem == mk.packed_one_smem(296, 512, 32, 32, 1, argmax=True)
