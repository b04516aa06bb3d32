"""The CUDA kernels K1-K16 against their plain torch versions on the
card.  Without a card every test here skips; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports jax, which the card's
machine does not have; this file imports only torch and numpy.)

Tolerances: K2 differs from its plain version only in summation order and
in summing the masked rows directly, so each row agrees to 1e-5 (float32)
or 1e-12 (float64) of its absmax; its staged float32 body gives the
row-at-a-time body's Φ bit for bit (acc_row's terms in its order).  K1 under int16 Φ sums integers, so its
statistics are exact; its float32 scores may flip an argmax only where the
float64 top-2 gap is below 1e-4·(1 + |score|); its int16 body
(``csrc/markov_em_one.cu``) equals the atomics body (``csrc/markov_em.cu``,
which keeps wide Φ and the tallest int16 Φ) bit for bit in all five
outputs, at its edges (copy widths, n, C, float64 weights, one cluster, a
NaN cluster, the canonical Φ's rows, one tile of ring).  K3 is K1 for R restarts:
slot r equals a K1 call on slot r's weights bit for bit (assignments,
counts, switches, int16 statistics, objective), and its int16 body is
held so at its edges (one cluster, int16 extremes, n around a chunk and a
tile, R and C from 1 to 32, the canonical Φ's 144 rows).
K4a/K4b rebuild Φ from the packed batch in f32/f64: their objectives agree
with the plain versions to 1e-5 (f32) or 1e-10 (f64) relative.  Float32
K4b runs its own tensor-core body: slot r equals a K4a call on slot r's
inputs bit for bit in assignments, counts, switches and the objective
where the scores are finite (K1's FMA chain, K4a's objective order); its
statistics (float32 sums in instance order within each block) agree to
2e-5 of the same sums over |u| of the plain version in float64, and where
its own Φ overflows, the same NaN, +Inf or -Inf; its assignments flip
only at float64 near ties (1e-4·(1 + |score|)), at most 1e-4 of the rows.
Float32 K4a runs its own staged body: its assignments, counts and
switches equal K1's on K2's float32 Φ bit for bit (the same Φ entries, K1's
FMA chain), its objective float32 K4b's at R = 1 bit for bit (the header's
summation order) and K1's to 2e-6 of Σ|best score| (K1 sums in its own
order), its statistics within 2e-5 of the same sums over |u|.  K8 (the
sorted E step) may flip an assignment only where the float64 top-2 score
gap is below 1e-4·(1 + |score|) in float32 (1e-9 in float64); its counts
and switches are exact for its own assignments.  K9 (the sorted M-step
Grams) agrees with the plain version in float64 to 1e-4 (float32) or
1e-11 (float64) of the same sums over |v|: summation order; its member
counts are exact, at D = 80, 512 and 9 on random, 90%-one-cluster,
one-cluster, sparse and out-of-range assignments, a one-row segment's
lone cluster and lists many pieces long; its row lists equal a stable
argsort bit for bit, and its wrapper reads nothing back to the host.  K5 (the
canonical Φ at any T) rounds every product and sum on its own, in the
plain version's order, so it equals the plain version bit for bit; its
staged body gives its global-memory body's Φ bit for bit.  K7
(the masked Kalman filter) agrees with the plain version over all T to
1e-10 relative in float64 and to 1e-4·(1 + |ll|) in float32 (rsqrtf,
fused multiply-adds, the order of the step's sums, one log of the
pivots' product) with each row stopped at its extent, on the planned
batch, on the caller's order with a plan built per call, and with
extents that vary inside a tile; a row with no finite entry gives
exactly 0.0, and a zero, negative, infinite or NaN pivot the plain
version's class.  K6, K10 and K11 (the raw-batch EM passes)
build K5's Φ column and run K1's step on it: float32 assignments may
flip only at near ties of the float64 scores, objectives and statistics
agree to 1e-4 (float32) or 1e-10 (float64) relative, and K6 equals K5
then K1 to 1e-12 in float64.  K12 and K13 (the dense (C, n)
log-likelihoods) agree with their plain versions to 1e-4·(1 + |ll|)
(float32) or 1e-10 relative (float64): the order of the quadratic
form's sums; K13 equals K12's columns in sorted order bit for bit (one
body); K14 (K8 on the row-major batch) equals K8 bit for bit.  K15 (the
Khatri-Rao statistics) agrees with its plain version to 1e-4 (float32)
or 1e-11 (float64) of the same sums over |v| on the packed batch, and on
the masked trainer's (T, n, ·) tensors, in both its bodies, to 1e-6
(float32: float64 sums, each output rounded once) or 1e-11; its strided
and packed forms give the same bits.  The dense quadratic
forms' edges (``_QUAD_CASES``: D = 8, 25, 120 and 512, C = 1 and 32, one-row
segments, a ragged n, |x| ~ 50, NaN and Inf means, a failed
factorization, rows with no finite value, a float32 overflow), in both
types for K8, K14, K12 and K13: the log-likelihoods within 2e-5 (float32:
the TF32 split's ~2⁻²¹ a product and float32 sums) or 1e-12 (float64) of
``chip_smoke.py`` phase 20's magnitude ``½ aᵀ|M|a + |const|``, and where
the plain version in the kernel's type is not finite, the same NaN, +Inf
or −Inf; K8 flipping only at near ties (1e-4 / 1e-9) of the float64
scores, and taking the plain version's cluster where the plain scores in
the kernel's type peak at a non-finite value (a NaN wins).  K16 (the Φ
stream sum) equals its plain version in int16 (both wrap modulo 2³²) and
agrees to 2e-6·Σ|φ| in float32 and bfloat16 (float sums in another
order).  Every kernel gives the same bits from run to run, float
statistics included.
"""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import estep_kernels as ek
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk
from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as msk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(T, d, l, n, seed, dtype, device):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    steps = np.arange(T)[:, None] >= lens[None, :]
    z[steps] = np.nan
    x[steps] = np.nan
    z_t = torch.tensor(z.transpose(0, 2, 1).reshape(T * d, n), dtype=dtype, device=device)
    x_t = torch.tensor(x.transpose(0, 2, 1).reshape(T * l, n), dtype=dtype, device=device)
    u = mk.pack_markov_u(z_t, x_t, T=T, d=d, l=l)
    return u, torch.tensor(lens, device=device)


@pytest.mark.parametrize("T,d,l,n", [(10, 5, 3, 20037), (4, 2, 4, 571)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_materialize_kernel_matches_plain(cuda, T, d, l, n, dtype, rel):
    u, lens = _batch(T, d, l, n, 0, dtype, cuda)
    before = mk.markov_materialize_features.launches
    phi_k = mk.markov_materialize_features(u, lens, T=T, d=d, l=l)
    assert mk.markov_materialize_features.launches == before + 1
    phi_p = mk.markov_materialize_features_plain(u, lens, T=T, d=d, l=l)
    bound = rel * phi_p.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    assert bool(((phi_k - phi_p).abs() <= bound).all())


# K2's staged float32 body (csrc/markov_features.cu) at its edges: n
# around a tile (32, 64 or 128 instances by the plan) and a round of
# persistent blocks, n % 4 != 0 (4-byte copies), lengths 0..T, |x| ~ 50,
# the compile-time tables of (5, 3) and (2, 4), shapes without one (the
# acc_row_tile build), a ring of one tile (T = 64), the tallest packed
# batch (T·s = 512) and the smallest shape (d, l) = (1, 0)
_K2_CASES = {
    "n=1": (10, 5, 3, 1), "n=31": (10, 5, 3, 31), "n=32": (10, 5, 3, 32), "n=33": (10, 5, 3, 33),
    "n=127": (10, 5, 3, 127), "n=128": (10, 5, 3, 128), "n=129": (10, 5, 3, 129), "n=1037": (10, 5, 3, 1037),
    "n=20000": (10, 5, 3, 20000), "n=20037": (10, 5, 3, 20037), "n=rounds+5": (10, 5, 3, 3 * 32 * 8 * 132 + 5),
    "adni": (10, 2, 4, 5003), "adni-aligned": (10, 2, 4, 20000), "no-table": (10, 3, 2, 5003),
    "no-table-wide": (10, 6, 2, 2051), "ring1": (64, 5, 3, 3001), "Ts512": (32, 9, 4, 1500), "d1l0": (7, 1, 0, 777),
}


def _k2_batch(T, d, l, n, seed, dtype, device, scale=1.0):
    """The packed batch with lengths 0..T (NaN past each), values N(0, 1)
    times ``scale`` plus a per-coordinate offset of the same size."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(T, n, d)) + rng.normal(size=d)) * scale
    x = (rng.normal(size=(T, n, l)) + rng.normal(size=l)) * scale
    lens = rng.integers(0, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    z_t = torch.tensor(z.transpose(0, 2, 1).reshape(T * d, n), dtype=dtype, device=device)
    x_t = torch.tensor(x.transpose(0, 2, 1).reshape(T * l, n), dtype=dtype, device=device)
    return mk.pack_markov_u(z_t, x_t, T=T, d=d, l=l), torch.tensor(lens, device=device)


@pytest.mark.parametrize("scale", [1.0, 50.0])
@pytest.mark.parametrize("case", list(_K2_CASES))
def test_k2_staged_body_is_the_rows_body(cuda, case, scale):
    """Float32 K2: the staged body (the wrapper's choice) and its
    acc_row_tile build at any shape ("general") give the row-at-a-time
    body's Φ bit for bit, pad rows zero; two calls the same bits; one
    launch counted a call."""
    T, d, l, n = _K2_CASES[case]
    u, lens = _k2_batch(T, d, l, n, 17, torch.float32, cuda, scale)
    assert mk.k2_plan(T, d, l) is not None
    before = mk.markov_materialize_features.launches
    phi = mk.markov_materialize_features(u, lens, T=T, d=d, l=l)
    assert mk.markov_materialize_features.launches == before + 1
    rows = mk._features_kernel(u, lens, T=T, d=d, l=l, body="rows")
    general = mk._features_kernel(u, lens, T=T, d=d, l=l, body="general")
    again = mk.markov_materialize_features(u, lens, T=T, d=d, l=l)
    bits = lambda p: p.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(phi), bits(rows)) and torch.equal(bits(general), bits(rows))
    assert torch.equal(bits(again), bits(phi))
    Fc = mk.markov_compact_spec(T, d, l)[1].shape[0]
    assert bool((phi[Fc:] == 0).all())
    if scale == 1.0:
        plain = mk.markov_materialize_features_plain(u, lens, T=T, d=d, l=l)
        bound = 1e-5 * plain.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
        assert bool(((phi - plain).abs() <= bound).all())


@pytest.mark.parametrize("n", [20000, 20037, 20038])
def test_k2_staged_body_on_unaligned_storage(cuda, n):
    """u and lens one element into their storage (not 16-byte aligned: the
    rows staged by 4-byte copies, the lengths too): the rows body's Φ bit
    for bit."""
    T, d, l = 10, 5, 3
    u, lens = _k2_batch(T, d, l, n, 20, torch.float32, cuda)
    u1 = torch.empty(u.numel() + 1, dtype=u.dtype, device=cuda)[1:].view(u.shape).copy_(u)
    l1 = torch.empty(n + 1, dtype=lens.dtype, device=cuda)[1:].copy_(lens)
    assert u1.data_ptr() % 16 and l1.data_ptr() % 16 and u1.is_contiguous()
    got = mk.markov_materialize_features(u1, l1, T=T, d=d, l=l)
    rows = mk._features_kernel(u, lens, T=T, d=d, l=l, body="rows")
    assert torch.equal(got.view(torch.int32), rows.view(torch.int32))


def test_k2_float64_stays_on_the_rows_body(cuda):
    """Float64 K2 is the row-at-a-time body's Φ bit for bit; the staged
    body refuses float64."""
    T, d, l = 10, 5, 3
    u, lens = _k2_batch(T, d, l, 20037, 18, torch.float64, cuda)
    phi = mk.markov_materialize_features(u, lens, T=T, d=d, l=l)
    rows = mk._features_kernel(u, lens, T=T, d=d, l=l, body="rows")
    assert torch.equal(phi.view(torch.int64), rows.view(torch.int64))
    with pytest.raises(ValueError):
        mk._features_kernel(u, lens, T=T, d=d, l=l, body="staged")


def test_k2_plan_matches_the_kernel(cuda):
    """The host plan's shared memory is the CUDA source's, its launch fits
    the card, and the fixed shapes' build spills nothing."""
    for T, d, l in ((10, 5, 3), (10, 2, 4), (10, 3, 2), (64, 5, 3), (32, 9, 4), (7, 1, 0), (1, 8, 8)):
        plan = mk.k2_plan(T, d, l)
        for table in (True, False):
            launch = mk._k2_config(cuda.index or 0, T, d, l, table)
            assert launch.smem == plan.smem and launch.threads == plan.threads and launch.blocks_per_sm >= 1
            if table and (d, l) in ((5, 3), (2, 4)):
                assert launch.local_bytes == 0


def test_k2_launches_after_a_smaller_plan_is_queried(cuda):
    """The occupancy query of a plan with less shared memory does not lower
    the limit a larger plan of the same body launches with."""
    mk._k2_config.cache_clear()
    big = (32, 9, 4)
    u, lens = _k2_batch(*big, 1500, 19, torch.float32, cuda)
    mk._k2_config(cuda.index or 0, *big, False)
    mk._k2_config(cuda.index or 0, 1, 8, 8, False)
    rows = mk._features_kernel(u, lens, T=32, d=9, l=4, body="rows")
    got = mk._features_kernel(u, lens, T=32, d=9, l=4, body="general")
    assert torch.equal(got.view(torch.int32), rows.view(torch.int32))


def _em_inputs(cuda, C=16, n=20037, seed=1):
    T, d, l = 10, 5, 3
    u, lens = _batch(T, d, l, n, seed, torch.float32, cuda)
    pq = mk.quantize_phi(mk.markov_materialize_features(u, lens, T=T, d=d, l=l))
    rng = np.random.default_rng(seed)
    wc = torch.tensor(rng.normal(size=(C, pq.q.shape[0])) * 1e-3, dtype=torch.float32, device=cuda)
    prev = torch.tensor(rng.integers(0, C, size=n).astype(np.int32), device=cuda)
    prev[::97] = -1  # rows left out
    return pq, wc, prev


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
def test_em_kernel_int16_matches_plain(cuda, assign_mode):
    pq, wc, prev = _em_inputs(cuda)
    C = wc.shape[0]
    a, c, s, macc, obj = mk.markov_em_compact(pq.q, prev, wc, assign_mode=assign_mode)
    valid = prev >= 0
    assert bool((a[~valid] == C).all())
    if assign_mode == "prev":
        assert bool((a[valid] == prev[valid]).all()) and int(s) == 0
    else:
        scores = wc.double() @ pq.q.double()
        top2 = scores.topk(2, dim=0).values
        gap = top2[0] - top2[1]
        near_tie = gap < 1e-4 * (1 + top2[0].abs())
        plain_a = scores.argmax(dim=0).to(torch.int32)
        assert bool(((a == plain_a) | near_tie | ~valid).all())
        assert int(s) == int(((a != prev) & valid).sum())
        best = scores.gather(0, a.clamp_max(C - 1).long()[None])[0]
        ref_obj = float(torch.where(valid, best, 0.0).sum())
        assert abs(float(obj) - ref_obj) <= 1e-5 * abs(ref_obj)
    counts_ref = torch.bincount(a[valid].long(), minlength=C)
    assert torch.equal(c.long(), counts_ref)
    # statistics: bit-equal to the exact plain sums under the kernel's own
    # assignments
    _a, c_p, _s, macc_p, _o = mk.markov_em_compact_plain(
        pq.q, torch.where(valid, a, -1), wc, assign_mode="prev"
    )
    assert macc.dtype == torch.int64 and torch.equal(macc, macc_p)
    assert torch.equal(c, c_p)


def test_em_kernel_is_deterministic(cuda):
    pq, wc, prev = _em_inputs(cuda, seed=2)
    out1 = mk.markov_em_compact(pq.q, prev, wc)
    out2 = mk.markov_em_compact(pq.q, prev, wc)
    for x1, x2 in zip(out1, out2):
        assert torch.equal(x1, x2)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("C", [3, 16, 32])
def test_em_kernel_wide_matches_plain(cuda, dtype, rel, C):
    pq, wc, prev = _em_inputs(cuda, C=C, seed=3)
    phi = mk.dequantize_phi(pq).to(dtype)
    wc = wc.to(dtype)
    a, c, s, macc, obj = mk.markov_em_compact(phi, prev, wc)
    valid = prev >= 0
    _a, c_p, _s, macc_p, _o = mk.markov_em_compact_plain(
        phi, torch.where(valid, a, -1), wc, assign_mode="prev"
    )
    assert torch.equal(c, c_p)
    scale = macc_p.abs().amax().clamp_min(1.0)
    assert float((macc - macc_p).abs().max()) <= rel * float(scale)


def test_em_kernel_refuses_bad_arguments(cuda):
    pq, wc, prev = _em_inputs(cuda, C=4, n=1000)
    with pytest.raises(ValueError):
        mk.markov_em_compact(pq.q, prev.long(), wc)
    with pytest.raises(ValueError):
        mk.markov_em_compact(pq.q.float(), prev, wc.double())
    with pytest.raises(ValueError):
        mk.markov_em_compact(pq.q[:, ::2], prev[::2], wc)
    wide = torch.zeros((33, pq.q.shape[0]), device=cuda)
    with pytest.raises(ValueError, match="at most"):
        mk.markov_em_compact(pq.q, prev, wide)


def _k1_case_inputs(cuda, C=16, n=20037, Fcp=None, wdtype=torch.float32, one_cluster=False, nan_cluster=None,
                    seed=13):
    """K1's inputs for the int16 body's edges: the bench Φ (Fcp = 112) or a
    random int16 Φ of ``Fcp`` rows (rows at -32768 and 32767 among them),
    weights of score magnitude (``one_cluster``: every cluster the same
    weights, so every instance takes cluster 0; ``nan_cluster``: that
    cluster's weights NaN, so it wins every instance), prev with rows left
    out."""
    rng = np.random.default_rng(seed)
    if Fcp is None:
        q = _em_inputs(cuda, C=C, n=n, seed=seed)[0].q
    else:
        qn = rng.integers(-32768, 32768, size=(Fcp, n)).astype(np.int16)
        qn[0], qn[1] = -32768, 32767
        q = torch.tensor(qn, device=cuda)
    wc = torch.tensor(rng.normal(size=(C, q.shape[0])) * 1e-3, dtype=wdtype, device=cuda)
    if Fcp is not None:
        wc = wc * 1e-3
    if one_cluster:
        wc = wc[:1].expand(C, -1).contiguous()
    if nan_cluster is not None:
        wc[nan_cluster] = float("nan")
    prev = torch.tensor(rng.integers(0, C, size=n).astype(np.int32), device=cuda)
    prev[::97] = -1
    return q, prev, wc


# K1's int16 body (csrc/markov_em_one.cu) at its edges: n a multiple of 8
# (16-byte copies), even (4-byte copies) and odd (plain loads), one tile
# or less, ragged tiles; C from 1 to 32; float64 weights; every instance in
# one cluster; a NaN cluster; the canonical Φ's 144 rows; one tile of
# ring where two do not fit; the bench shape at n = 1e6 and 1e6+37
_K1_CASES = {
    "aligned": dict(n=20480), "unaligned": dict(n=20037), "even": dict(n=20482), "n=1": dict(n=1),
    "n=129": dict(n=129), "C1": dict(C=1), "C3": dict(C=3), "C32": dict(C=32),
    "f64": dict(wdtype=torch.float64), "f64-C32-aligned": dict(C=32, n=20480, wdtype=torch.float64),
    "one-cluster": dict(one_cluster=True), "nan-cluster": dict(nan_cluster=1),
    "Fcp144": dict(Fcp=144, n=20000), "Fcp144-C32-odd": dict(Fcp=144, C=32, n=20001),
    "Fcp300-ring1-f64": dict(Fcp=300, C=32, n=8296, wdtype=torch.float64),
    "bench-1e6": dict(n=1_000_000), "bench-1e6+37": dict(n=1_000_037),
}


def _k1_both(monkeypatch, q, prev, wc, assign_mode):
    """K1 through the int16 body (its route asserted, its launch counted),
    then through the atomics body (``k1_plan`` patched to send the shape
    there)."""
    argmax = assign_mode == "argmax"
    assert mk.k1_plan(q.shape[0], wc.shape[0], wc.dtype, q.shape[1], argmax=argmax) is not None
    before = mk.markov_em_compact.launches
    new = mk.markov_em_compact(q, prev, wc, assign_mode=assign_mode)
    assert mk.markov_em_compact.launches == before + 1
    with monkeypatch.context() as m:
        m.setattr(mk, "k1_plan", lambda *a, **k: None)
        old = mk.markov_em_compact(q, prev, wc, assign_mode=assign_mode)
    return new, old


def _same_bits_any(p, q):
    """Bit equality of two tensors (floats through their integer view)."""
    if p.is_floating_point():
        iv = torch.int32 if p.dtype == torch.float32 else torch.int64
        return p.dtype == q.dtype and torch.equal(p.view(iv), q.view(iv))
    return p.dtype == q.dtype and torch.equal(p, q)


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("case", list(_K1_CASES))
def test_em_one_body_is_the_atomics_body(cuda, monkeypatch, case, assign_mode):
    """The int16 body's five outputs equal the atomics body's bit for bit
    (objective included, NaN bits too), and two calls give the same bits;
    against the plain version: counts and int64 statistics exact under the
    body's own assignments, rows left out at C, switches counted from the
    assignments, the argmax flipping only at float64 near ties (1e-4 ·
    (1 + |score|)) and, with a NaN cluster, the plain version's first NaN
    for every row."""
    kw = _K1_CASES[case]
    q, prev, wc = _k1_case_inputs(cuda, **kw)
    C = wc.shape[0]
    new, old = _k1_both(monkeypatch, q, prev, wc, assign_mode)
    for x_n, x_o in zip(new, old):
        assert _same_bits_any(x_n, x_o)
    again = mk.markov_em_compact(q, prev, wc, assign_mode=assign_mode)
    for x_n, x_a in zip(new, again):
        assert _same_bits_any(x_n, x_a)
    a, c, s, macc, obj = new
    valid = prev >= 0
    assert bool((a[~valid] == C).all())
    _a, c_p, _s, macc_p, _o = mk.markov_em_compact_plain(q, torch.where(valid, a, -1), wc, assign_mode="prev")
    assert macc.dtype == torch.int64 and torch.equal(macc, macc_p) and torch.equal(c, c_p)
    if assign_mode == "prev":
        assert bool((a[valid] == prev[valid]).all()) and int(s) == 0 and float(obj) == 0.0
        return
    assert int(s) == int(((a != prev) & valid).sum())
    if kw.get("nan_cluster") is not None:
        _b, na_p = mk._argmax_first(wc @ q.to(wc.dtype))
        assert bool((a[valid] == na_p[valid]).all()) and bool(torch.isnan(obj))
        return
    if kw.get("one_cluster"):
        assert bool((a[valid] == 0).all()) and int(c[0]) == int(valid.sum())
    scores = wc.double() @ q.double()
    top2 = scores.topk(min(2, C), dim=0).values
    near = (top2[0] - top2[-1]) < 1e-4 * (1 + top2[0].abs())  # C = 1: every row
    assert bool(((a == scores.argmax(dim=0).to(torch.int32)) | near | ~valid).all())


def test_em_one_body_refers_the_tallest_phi_to_the_atomics_body(cuda):
    """The largest Fcp the atomics body took at C = 32 with float32 weights
    (907 rows: no tile of the int16 body fits) goes there, and agrees with
    the plain version: counts and statistics exact."""
    Fcp = max(f for f in range(1, 2000) if 4 * (8 + f * 32) + 4 * f * 32 + 4 * 40 <= 232448)
    q, prev, wc = _k1_case_inputs(cuda, C=32, n=3001, Fcp=Fcp)
    assert mk.k1_plan(Fcp, 32, wc.dtype, 3001) is None
    a, c, s, macc, _obj = mk.markov_em_compact(q, prev, wc)
    valid = prev >= 0
    _a, c_p, _s, macc_p, _o = mk.markov_em_compact_plain(q, torch.where(valid, a, -1), wc, assign_mode="prev")
    assert torch.equal(macc, macc_p) and torch.equal(c, c_p)
    assert int(s) == int(((a != prev) & valid).sum())


@pytest.mark.parametrize("Fcp,C,dtype,argmax", [(112, 16, torch.float32, True), (112, 32, torch.float32, False),
                                                (144, 16, torch.float32, True), (300, 32, torch.float64, True)])
def test_em_one_body_plan_matches_the_kernel(cuda, Fcp, C, dtype, argmax):
    """The plan's shared memory is the kernel's, a block is 128 threads,
    at least one block an SM runs, nothing spills; the bench shape runs
    three blocks an SM."""
    plan = mk.k1_plan(Fcp, C, dtype, 10**6, argmax=argmax)
    launch = mk._k1_config(torch.cuda.current_device(), Fcp, C, mk._W_KINDS[dtype], argmax, plan.ring)
    assert launch.smem == plan.smem and launch.threads == 128
    assert 1 <= launch.blocks_per_sm <= plan.blocks_per_sm and launch.local_bytes == 0
    if (Fcp, C, dtype, argmax) == (112, 16, torch.float32, True):
        assert launch.blocks_per_sm == 3


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4a", "K4b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_float_statistics_are_deterministic(cuda, kernel, dtype):
    """Two identical calls give identical outputs, bit for bit, where the
    statistics are float sums (wide Φ, or Φ rebuilt from the packed
    batch)."""
    if kernel in ("K1", "K3"):
        pq, wc, prev, force = _multi_inputs(cuda, R=3, seed=12)
        phi, wc = mk.dequantize_phi(pq).to(dtype), wc.to(dtype)
        if kernel == "K1":
            call = lambda: mk.markov_em_compact(phi, prev[0].contiguous(), wc[0].contiguous())  # noqa: E731
        else:
            call = lambda: mk.markov_em_compact_multi(phi, prev, wc, force)  # noqa: E731
    else:
        (T, d, l), u, lens, Wg, prev = _packed_inputs(cuda, dtype, seed=12)
        if kernel == "K4a":
            call = lambda: mk.markov_em_fused_packed(u, lens, prev[0], Wg[0], T=T, d=d, l=l)  # noqa: E731
        else:
            call = lambda: mk.markov_em_fused_packed_multi(u, lens, prev, Wg, T=T, d=d, l=l)  # noqa: E731
    for x1, x2 in zip(call(), call()):
        assert torch.equal(x1, x2)


def test_train_em_markov_cuda_f64_matches_cpu(cuda):
    """The whole fit on the card in float64 (wide Φ) lands where the CPU
    fit does."""
    rng = np.random.default_rng(4)
    T, n, d, l, C = 5, 3000, 2, 3, 2
    labels = rng.integers(0, C, size=n)
    z = rng.normal(size=(T, n, d)) + 4.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l)) - 3.0 * labels[None, :, None]
    lens = rng.integers(2, T + 1, size=n).astype(np.int32)
    steps = np.arange(T)[:, None] >= lens[None, :]
    z[steps] = np.nan
    x[steps] = np.nan
    assign0 = np.where(rng.uniform(size=n) < 0.2, 1 - labels, labels)
    params0 = (
        np.full(C, 0.5), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
        np.zeros((C, d, d)), np.stack([np.eye(d)] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C),
    )
    fits = []
    for dev in ("cpu", "cuda"):
        t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        fits.append(
            tem.train_em_markov(
                tem.mixture_params_from_numpy(params0, device=dev, dtype=torch.float64),
                t(assign0, torch.int32), t(z), t(x), t(lens, torch.int32),
            )
        )
    (p_c, a_c, i_c, s_c), (p_g, a_g, i_g, s_g) = fits
    assert (i_g, s_g) == (i_c, s_c) and s_c == tem.STATUS_CONVERGED
    assert torch.equal(a_g.cpu(), a_c)
    for x_c, x_g in zip(p_c, p_g):
        np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-8, atol=1e-8)


def _multi_inputs(cuda, C=16, R=5, n=20037, seed=5, Fcp=None, one_cluster=False,
                  extremes=False, wdtype=torch.float32):
    """K3's inputs: the bench Φ (Fcp = 112), or with ``Fcp`` a random int16
    Φ (``extremes``: rows and a whole tile at ±32767 and −32768);
    ``one_cluster`` gives every cluster the same weights, so the strict
    argmax sends every instance to cluster 0."""
    rng = np.random.default_rng(seed)
    if Fcp is None:
        pq, _wc, _prev = _em_inputs(cuda, C=C, n=n, seed=seed)
        Fcp = pq.q.shape[0]
    else:
        q = rng.integers(-32768, 32768, size=(Fcp, n)).astype(np.int16)
        if extremes:
            q[0], q[1], q[2] = -32768, 32767, -32767
            q[3, ::2], q[3, 1::2] = 32767, -32768
            q[:, :256] = -32768
            q[:, 256:512] = 32767
        pq = mk.PhiQuant(torch.tensor(q, device=cuda), torch.ones(Fcp, device=cuda))
    wc = torch.tensor(rng.normal(size=(R, C, Fcp)) * 1e-3, dtype=wdtype, device=cuda)
    if one_cluster:
        wc = wc[:, :1].expand(R, C, Fcp).contiguous()
    prev = torch.tensor(rng.integers(0, C, size=(R, n)).astype(np.int32), device=cuda)
    prev[:, ::89] = -1
    force = torch.tensor([i % 2 for i in range(R)], dtype=torch.int32, device=cuda)
    return pq, wc, prev, force


# K3's int16 body at its edges: C (one n = 8 tile to four), every instance
# in one cluster, int16 extremes (the hi/lo split), n at a chunk multiple
# (R = 5: 2048), ±1 (odd n: the unaligned load) and a ragged tile (n % 256
# != 0), R = 1 and R not a multiple of the restart group, the canonical
# Φ's 144 rows, float64 weights; Φ too tall for a whole tile at one
# restart a block (the row-strip blocks): 200 rows (strips of 168, or of
# 168 in groups of 4 at C = 16), 256, 592 (strips of 72) and 3371 (strips
# of 8) rows, the last two at the largest Fcp the header's int16 body took
# at C = 32 and C = 1 with float64 weights
_MULTI_CASES = {
    "C3": dict(C=3), "C16": dict(C=16), "C32": dict(C=32), "C1": dict(C=1), "C17": dict(C=17),
    "one-cluster": dict(R=32, one_cluster=True), "extremes": dict(Fcp=112, extremes=True),
    "n=chunk": dict(n=8192), "n=chunk-1": dict(n=8191), "n=chunk+1": dict(n=8193),
    "ragged-tile": dict(n=8296), "R1": dict(R=1), "R13": dict(R=13), "R32": dict(R=32),
    "Fcp144": dict(Fcp=144, R=8, n=20000), "Fcp144-C32": dict(Fcp=144, C=32, R=13, n=20001),
    "f64-weights": dict(wdtype=torch.float64),
    "Fcp200-C32-f64": dict(Fcp=200, C=32, R=5, n=8297, wdtype=torch.float64),
    "Fcp200-C16": dict(Fcp=200, C=16, R=13, n=8296),
    "Fcp200-extremes": dict(Fcp=200, C=17, R=3, extremes=True, wdtype=torch.float64),
    "Fcp200-one-cluster": dict(Fcp=200, C=32, R=4, one_cluster=True, wdtype=torch.float64),
    "Fcp256-C32-f64": dict(Fcp=256, C=32, R=3, n=4099, wdtype=torch.float64),
    "Fcp592-C32-f64": dict(Fcp=592, C=32, R=2, n=3001, wdtype=torch.float64),
    "Fcp3371-C1-f64": dict(Fcp=3371, C=1, R=2, n=1500, wdtype=torch.float64),
}


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("case", list(_MULTI_CASES))
def test_em_multi_kernel_matches_plain_and_k1(cuda, assign_mode, case):
    pq, wc, prev, force = _multi_inputs(cuda, **_MULTI_CASES[case])
    R, C, _F = wc.shape
    before = mk.markov_em_compact_multi.launches
    a, c, s, macc, obj = mk.markov_em_compact_multi(pq.q, prev, wc, force, assign_mode=assign_mode)
    assert mk.markov_em_compact_multi.launches == before + 1
    again = mk.markov_em_compact_multi(pq.q, prev, wc, force, assign_mode=assign_mode)
    for x1, x2 in zip((a, c, s, macc, obj), again):
        assert torch.equal(x1, x2)
    _a, c_p, s_p, macc_p, _o = mk.markov_em_compact_multi_plain(
        pq.q, torch.where(prev >= 0, a, -1), wc, torch.ones_like(force), assign_mode="argmax"
    )
    assert macc.dtype == torch.int64 and torch.equal(macc, macc_p)
    assert torch.equal(c, c_p)
    for r in range(R):
        forced = assign_mode == "argmax" and int(force[r]) == 1
        k1 = mk.markov_em_compact(pq.q, prev[r].contiguous(), wc[r].contiguous(),
                                  assign_mode="prev" if forced else assign_mode)
        for x_m, x_1 in zip((a[r], c[r], s[r], macc[r]), k1[:4]):
            assert torch.equal(x_m, x_1), r
        if forced or assign_mode == "prev":
            assert float(obj[r]) == 0.0 and int(s[r]) == 0
        elif _MULTI_CASES[case].get("one_cluster"):
            assert bool((a[r][prev[r] >= 0] == 0).all()) and int(c[r][0]) == int((prev[r] >= 0).sum())
        # the objective too: partials per 1024 instances, as K1's blocks
        assert torch.equal(obj[r], k1[4])


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 2e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("C", [3, 32])
def test_em_multi_kernel_wide_matches_plain(cuda, dtype, rel, C):
    """K3 on a wide Φ: counts and switches exact, statistics within the
    summation-order bound, slot by slot as K1 gives them."""
    pq, wc, prev, force = _multi_inputs(cuda, C=C, R=3, seed=9)
    phi = mk.dequantize_phi(pq).to(dtype)
    wc = wc.to(dtype)
    a, c, s, macc, obj = mk.markov_em_compact_multi(phi, prev, wc, force)
    valid = prev >= 0
    _a, c_p, _s, macc_p, _o = mk.markov_em_compact_multi_plain(
        phi, torch.where(valid, a, -1), wc, assign_mode="prev"
    )
    assert torch.equal(c, c_p)
    scale = macc_p.abs().amax().clamp_min(1.0)
    assert float((macc - macc_p).abs().max()) <= rel * float(scale)
    for r in range(3):
        k1 = mk.markov_em_compact(phi, prev[r].contiguous(), wc[r].contiguous(),
                                  assign_mode="prev" if int(force[r]) else "argmax")
        assert torch.equal(a[r], k1[0]) and torch.equal(c[r], k1[1]) and torch.equal(s[r], k1[2])
        assert float((macc[r] - k1[3]).abs().max()) <= rel * float(scale)
        assert abs(float(obj[r]) - float(k1[4])) <= rel * abs(float(k1[4])) + 1e-30


def _packed_inputs(cuda, dtype, C=16, R=4, n=20037, seed=6, nan_cluster=None, T=10, d=5, l=3,
                   scale=1.0):
    u, lens = _batch(T, d, l, n, seed, dtype, cuda)
    u = u * scale
    rng = np.random.default_rng(seed)
    F = mops.markov_em_feature_dim(d, l)
    params = [
        tem.mixture_params_from_numpy(
            (np.full(C, 1.0 / C), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
             rng.normal(scale=0.3, size=(C, d, d)), np.stack([np.eye(d)] * C),
             rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C)),
            device=cuda, dtype=dtype,
        )
        for _ in range(R)
    ]
    Wg = torch.stack([mops.markov_em_weights(p.m, p.S, p.A, p.G, p.H, p.L) for p in params])
    assert Wg.shape == (R, C, F)
    if nan_cluster is not None:
        Wg[:, nan_cluster] = torch.nan
    prev = torch.tensor(rng.integers(0, C, size=(R, n)).astype(np.int32), device=cuda)
    prev[:, ::101] = -1
    return (T, d, l), u, lens, Wg, prev


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("nan_cluster", [None, 1])
def test_em_packed_kernels_match_plain(cuda, dtype, rel, nan_cluster):
    (T, d, l), u, lens, Wg, prev = _packed_inputs(cuda, dtype, nan_cluster=nan_cluster)
    R, C, _F = Wg.shape
    force = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=cuda)
    cases = [
        (mk.markov_em_fused_packed, mk.markov_em_fused_packed_plain, (u, lens, prev[0], Wg[0]), {}),
        (mk.markov_em_fused_packed_multi, mk.markov_em_fused_packed_multi_plain,
         (u, lens, prev, Wg), {"force_prev": force}),
    ]
    for kern, plain, args, kw in cases:
        before = kern.launches
        a, c, s, g, obj = kern(*args, T=T, d=d, l=l, **kw)
        assert kern.launches == before + 1
        a_p, c_p, s_p, g_p, obj_p = plain(*args, T=T, d=d, l=l, **kw)
        if nan_cluster is not None and kern is mk.markov_em_fused_packed:
            # first maximum with NaN as the maximum: every valid row goes
            # to the NaN cluster, and the objective is NaN
            assert bool((a[args[2] >= 0] == nan_cluster).all()) and bool(torch.isnan(obj))
            assert torch.equal(a, a_p) and torch.equal(c, c_p)
            continue
        if nan_cluster is not None:
            # strict: a NaN never wins (a forced slot keeps prev)
            assert not bool((a[force == 0] == nan_cluster).any())
        assert bool(torch.isfinite(obj).all())
        assert bool(((obj - obj_p).abs() <= rel * obj_p.abs()).all())
        # statistics under the kernel's own assignments, each entry within
        # 2e-5 (f32) of the same sums over |u|: K1's wide-Φ bound
        a_in = torch.where(args[2] >= 0, a, -1)
        _a, c_q, _s, g_q, _o = plain(u, lens, a_in, args[3], T=T, d=d, l=l, assign_mode="prev")
        _a, _c, _s, g_abs, _o = plain(u.abs(), lens, a_in, args[3], T=T, d=d, l=l, assign_mode="prev")
        assert torch.equal(c, c_q)
        bound = (2e-5 if dtype == torch.float32 else 1e-10) * g_abs + 1e-30
        assert bool(((g - g_q).abs() <= bound).all())


# K4b's float32 tensor-core body (csrc/markov_em_packed_mma.cu) at its
# edges: R around its restart group of 8 (1, 7, 8, 9, 32, 33), C from one
# n = 8 tile to four (1, 8, 16, 17, 32), n around a 128-instance tile and
# a chunk (1024 instances at R = 4, 8192 at R = 32), n % 4 == 0 (the
# cp.async copies) and not, no slot, some and every slot forced, every
# instance in one cluster, a NaN cluster's weights, |x| ~ 50, a batch whose
# Φ overflows to +Inf, and the largest Φ the header's float32 body took at
# C = 32 and C = 16 (T·s = 512, tiles of 32 instances, one restart a block)
_PACKED_CASES = {
    "R1": dict(R=1), "R7": dict(R=7), "R8": dict(R=8), "R9": dict(R=9, n=9001),
    "R32": dict(R=32, n=8193), "R33": dict(R=33, n=8191),
    "C1": dict(C=1), "C8": dict(C=8), "C17": dict(C=17), "C32": dict(C=32, R=9),
    "n=tile": dict(n=128), "n=tile-1": dict(n=127), "n=tile+1": dict(n=129),
    "n=chunk": dict(n=1024), "n=chunk+1": dict(n=1025), "n=4k": dict(n=20040),
    "R32-n=chunk": dict(R=32, n=8192),
    "no-forced-slot": dict(force="none"), "all-forced": dict(force="all"),
    "one-cluster": dict(R=8, one_cluster=True), "nan-cluster": dict(R=8, nan_cluster=1),
    "wide": dict(R=8, scale=50.0), "overflow": dict(R=8, overflow=True),
    "Fcp296-C32": dict(T=32, d=9, l=4, C=32, R=3, n=3001),
    "Fcp352-C16": dict(T=32, d=10, l=4, C=16, R=9, n=2050),
}


def _k4b_case(cuda, R=4, force="some", one_cluster=False, overflow=False, **kw):
    (T, d, l), u, lens, Wg, prev = _packed_inputs(cuda, torch.float32, R=R, **kw)
    if one_cluster:
        Wg = Wg[:, :1].expand(Wg.shape).contiguous()
    if overflow:  # u products past float32's range: Φ rows of ±Inf
        lens[5::997] = T
        lens[700::1999] = T
        u[:, 5::997] = 3e20
        u[1::2, 700::1999] = -3e20
        prev[:, 5::997] = 0
    forced = {"none": [0] * R, "some": [int(r % 3 == 1) for r in range(R)], "all": [1] * R}[force]
    return (T, d, l), u, lens, Wg, prev, torch.tensor(forced, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("case", list(_PACKED_CASES))
def test_em_packed_multi_f32_body_at_its_edges(cuda, case, assign_mode):
    kw = _PACKED_CASES[case]
    (T, d, l), u, lens, Wg, prev, force = _k4b_case(cuda, **kw)
    R, C, _F = Wg.shape
    args = (u, lens, prev, Wg)
    opts = dict(T=T, d=d, l=l, assign_mode=assign_mode, force_prev=force)
    before = mk.markov_em_fused_packed_multi.launches
    out = mk.markov_em_fused_packed_multi(*args, **opts)
    assert mk.markov_em_fused_packed_multi.launches == before + 1
    for x1, x2 in zip(out, mk.markov_em_fused_packed_multi(*args, **opts)):
        if x1.is_floating_point():  # bit for bit, NaN included
            x1, x2 = x1.view(torch.int32), x2.view(torch.int32)
        assert torch.equal(x1, x2)
    a, c, s, g, obj = out
    valid = prev >= 0
    assert bool((a[~valid] == C).all())
    # counts and statistics under the kernel's own assignments: counts
    # exact; statistics within 2e-5 of the same sums over |u| of the plain
    # version in float64 (in float32 its masked rows, A minus the last
    # step, cancel to a few ulps of A, which a cluster of a few short
    # trajectories shows); where the float32 Φ (K2's, the kernel's bit for
    # bit) summed per instance in float64 is not finite, the same NaN, +Inf
    # or -Inf
    a_in = torch.where(valid, a, -1)
    plain = mk.markov_em_fused_packed_multi_plain
    _a, c_q, _s, _g, _o = plain(u, lens, a_in, Wg, T=T, d=d, l=l, assign_mode="prev")
    assert torch.equal(c, c_q)
    W64 = Wg.double()
    _a, _c, _s, g_q, _o = plain(u.double(), lens, a_in, W64, T=T, d=d, l=l, assign_mode="prev")
    _a, _c, _s, g_abs, _o = plain(u.abs().double(), lens, a_in, W64, T=T, d=d, l=l, assign_mode="prev")
    phi = mk.markov_materialize_features(u, lens, T=T, d=d, l=l).double()
    pos = torch.as_tensor(mk.markov_compact_spec(T, d, l)[2], device=cuda)
    own = torch.stack([
        torch.zeros((C + 1, phi.shape[0]), dtype=torch.float64, device=cuda)
        .index_add_(0, torch.where(a_in[r] >= 0, a_in[r], C).long(), phi.T)[:C].T[pos]
        for r in range(R)
    ])
    fin = torch.isfinite(own)
    assert bool(((g.double() - g_q).abs()[fin] <= 2e-5 * g_abs[fin] + 1e-30).all())
    for cls in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(cls(g), cls(own))
    if kw.get("overflow"):
        assert bool(torch.isposinf(g).any())
    # scores in float64 from the plain Φ: a flip only at a near tie, on the
    # rows whose float32 Φ is finite
    acc, rows = mk._packed_acc(u, lens, torch.float64, T=T, d=d, l=l)
    fin32 = torch.isfinite(mk._packed_acc(u, lens, torch.float32, T=T, d=d, l=l)[0]).all(dim=0)
    wacc = mk._fold_acc(Wg.double(), rows, acc.shape[0])
    for r in range(R):
        takes_prev = assign_mode == "prev" or bool(force[r])
        vr = valid[r]
        if takes_prev:
            assert bool((a[r][vr] == prev[r][vr]).all()) and int(s[r]) == 0 and float(obj[r]) == 0.0
            continue
        assert int(s[r]) == int(((a[r] != prev[r]) & vr).sum())
        if kw.get("one_cluster"):
            assert bool((a[r][vr] == 0).all())
        if kw.get("nan_cluster") is not None:
            assert not bool((a[r] == kw["nan_cluster"]).any())
        sc = wacc[r] @ acc
        if kw.get("nan_cluster") is not None:
            sc[kw["nan_cluster"]] = -torch.inf  # the strict rule: a NaN never wins
        ok = fin32 & vr
        top2 = sc.topk(min(2, C), dim=0).values
        near = (top2[0] - top2[-1]) < 1e-4 * (1 + top2[0].abs()) if C > 1 else torch.zeros_like(ok)
        mism = (a[r] != sc.argmax(dim=0).to(torch.int32)) & ok
        assert bool((~mism | near).all()) and int(mism.sum()) <= max(1, 1e-4 * int(ok.sum()))
        if kw.get("overflow"):
            continue
        best = sc.gather(0, a[r].clamp_max(C - 1).long()[None])[0]
        ref = float(torch.where(vr, best, 0.0).sum())
        assert abs(float(obj[r]) - ref) <= 1e-5 * abs(ref) + 1e-30
    # slot r against a K4a call on slot r's inputs (finite scores: the two
    # argmax rules agree): assignments, counts, switches and the objective
    # bit for bit
    if kw.get("nan_cluster") is not None or kw.get("overflow"):
        return
    for r in range(R):
        takes_prev = assign_mode == "prev" or bool(force[r])
        k4a = mk.markov_em_fused_packed(u, lens, prev[r].contiguous(), Wg[r], T=T, d=d, l=l,
                                        assign_mode="prev" if takes_prev else "argmax")
        for x_b, x_a in zip((a[r], c[r], s[r], obj[r]), (k4a[0], k4a[1], k4a[2], k4a[4])):
            assert torch.equal(x_b, x_a), r
        assert bool(((g[r] - k4a[3]).abs() <= 4e-5 * g_abs[r] + 1e-30).all())  # each within 2e-5


def test_em_packed_multi_f32_plan_matches_the_kernel(cuda):
    """The host plan's shared memory is the CUDA source's, and a block fits."""
    lib = _build.library()
    for Fcp, Ts, C, R in ((112, 80, 16, 32), (112, 512, 16, 32), (112, 80, 32, 9), (296, 512, 32, 3),
                          (416, 512, 1, 2), (8, 8, 1, 1)):
        for argmax in (True, False):
            plan = mk.packed_mma_plan(Fcp, Ts, C, R, argmax=argmax)
            assert plan.smem == lib.mtm_markov_em_packed_mma_smem(Fcp, Ts, C, plan.rg, plan.nt,
                                                                  int(argmax))
            assert plan.smem <= torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin


# Float32 K4a's staged body (csrc/markov_em_packed_one.cu) at its edges:
# C from one 8-wide score block to four (1, 8, 16, 17, 32), n around a
# 128-instance tile, the objective's 1024-instance sub, the persistent
# grid's first round of tiles (132 SMs) and three rounds (the ring's slots
# reused), n % 4 != 0 (4-byte copies), every instance in one cluster, a NaN
# cluster's weights, rows with prev < 0 (every case), |x| ~ 50, a batch
# whose Φ overflows to +Inf, ADNI's shape (2, 4) (the generic build,
# 128-instance tiles, two slots), and the largest Φ the header's float32
# body took at C = 32 and C = 16 (T·s = 512: the generic build,
# 32-instance tiles, one slot at C = 32, two at C = 16)
_K4A_CASES = {
    "C1": dict(C=1), "C8": dict(C=8), "C16": dict(C=16), "C17": dict(C=17), "C32": dict(C=32),
    "n=tile-1": dict(n=127), "n=tile": dict(n=128), "n=tile+1": dict(n=129),
    "n=sub": dict(n=1024), "n=sub+1": dict(n=1025), "n%4": dict(n=20037),
    "n=round": dict(n=128 * 132), "n=round+1": dict(n=128 * 132 + 1), "n=3rounds+5": dict(n=3 * 128 * 132 + 5),
    "one-cluster": dict(one_cluster=True), "nan-cluster": dict(nan_cluster=1),
    "wide": dict(scale=50.0), "overflow": dict(overflow=True), "adni-shape": dict(d=2, l=4, n=5003),
    "Fcp296-C32": dict(T=32, d=9, l=4, C=32, n=3001), "Fcp352-C16": dict(T=32, d=10, l=4, C=16, n=2050),
}


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("case", list(_K4A_CASES))
def test_em_packed_f32_body_at_its_edges(cuda, case, assign_mode):
    """Float32 K4a: assignments, counts and switches bit for bit K1's on
    K2's float32 Φ with the same folded weights; its objective bit for bit
    float32 K4b's at R = 1 (the header's order) where the scores are
    finite, within 2e-6 of the same sum over |best score| of K1's (K1 sums
    in its own order); statistics within 2e-5 of the plain version's sums
    over |u| in float64 (the same NaN, +Inf or -Inf where the float32 Φ
    summed per instance in float64 is not finite); the same bits on two
    calls."""
    kw = _K4A_CASES[case]
    (T, d, l), u, lens, Wg, prev, _force = _k4b_case(cuda, R=1, **kw)
    Wg, prev = Wg[0], prev[0].contiguous()
    C = Wg.shape[0]
    opts = dict(T=T, d=d, l=l, assign_mode=assign_mode)
    before = mk.markov_em_fused_packed.launches
    out = mk.markov_em_fused_packed(u, lens, prev, Wg, **opts)
    assert mk.markov_em_fused_packed.launches == before + 1
    for x1, x2 in zip(out, mk.markov_em_fused_packed(u, lens, prev, Wg, **opts)):
        if x1.is_floating_point():  # bit for bit, NaN included
            x1, x2 = x1.view(torch.int32), x2.view(torch.int32)
        assert torch.equal(x1, x2)
    a, c, s, g, obj = out
    valid = prev >= 0
    assert bool((a[~valid] == C).all())
    phi = mk.markov_materialize_features(u, lens, T=T, d=d, l=l)
    wc = mk.fold_weights(Wg, T=T, d=d, l=l)
    a1, c1, s1, _m1, o1 = mk.markov_em_compact(phi, prev, wc, assign_mode=assign_mode)
    assert torch.equal(a, a1) and torch.equal(c, c1) and torch.equal(s, s1)
    if assign_mode == "prev":
        assert bool((a[valid] == prev[valid]).all()) and int(s) == 0 and float(obj) == 0.0
    elif kw.get("nan_cluster") is not None:  # the first maximum, NaN counted as the maximum
        assert bool((a[valid] == kw["nan_cluster"]).all()) and bool(torch.isnan(obj)) and bool(torch.isnan(o1))
    elif not kw.get("overflow"):
        best = (wc.double() @ phi.double()).gather(0, a.clamp_max(C - 1).long()[None])[0]
        mag = float(torch.where(valid, best.abs(), 0.0).sum())
        assert abs(float(obj) - float(o1)) <= 2e-6 * mag + 1e-30
        k4b = mk.markov_em_fused_packed_multi(u, lens, prev[None], Wg[None], T=T, d=d, l=l)
        assert torch.equal(k4b[0][0], a) and obj.view(torch.int32) == k4b[4][0].view(torch.int32)
    if kw.get("one_cluster") and assign_mode == "argmax":
        assert bool((a[valid] == 0).all())
    a_in = torch.where(valid, a, -1)
    plain = mk.markov_em_fused_packed_plain
    _a, c_q, _s, _g, _o = plain(u, lens, a_in, Wg, T=T, d=d, l=l, assign_mode="prev")
    assert torch.equal(c, c_q)
    W64 = Wg.double()
    _a, _c, _s, g_q, _o = plain(u.double(), lens, a_in, W64, T=T, d=d, l=l, assign_mode="prev")
    _a, _c, _s, g_abs, _o = plain(u.abs().double(), lens, a_in, W64, T=T, d=d, l=l, assign_mode="prev")
    pos = torch.as_tensor(mk.markov_compact_spec(T, d, l)[2], device=cuda)
    own = torch.zeros((C + 1, phi.shape[0]), dtype=torch.float64, device=cuda).index_add_(
        0, torch.where(a_in >= 0, a_in, C).long(), phi.double().T)[:C].T[pos]
    fin = torch.isfinite(own)
    assert bool(((g.double() - g_q).abs()[fin] <= 2e-5 * g_abs[fin] + 1e-30).all())
    for cls in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(cls(g), cls(own))
    if kw.get("overflow"):
        assert bool(torch.isposinf(g).any())


def test_em_packed_f32_body_plan_matches_the_kernel(cuda):
    """The host plan's shared memory is the CUDA source's, and its launch
    fits the card."""
    lib = _build.library()
    for T, d, l, C in ((10, 5, 3, 16), (10, 2, 4, 16), (10, 5, 3, 32), (64, 5, 3, 32), (32, 9, 4, 32),
                       (32, 10, 4, 16), (1, 1, 0, 1), (63, 4, 4, 8)):
        for argmax in (True, False):
            plan = mk.packed_one_plan(T, d, l, C, argmax=argmax)
            Fcp = mk.markov_compact_spec(T, d, l)[0]
            Ts = T * 8 * ((d + l + 7) // 8)
            assert plan.smem == lib.mtm_markov_em_packed_one_smem(Fcp, Ts, C, plan.nt, plan.ring, int(argmax))
            launch = mk._packed_one_config(cuda.index or 0, T, d, l, C, argmax)
            assert launch.smem == plan.smem and launch.blocks_per_sm >= 1 and launch.threads == plan.threads


def test_pool_cuda_f64_matches_sequential(cuda):
    """The slot pool on the card in float64 (wide Φ, K3 every pass):
    every candidate as its own ``train_em_markov`` run gives it."""
    rng = np.random.default_rng(7)
    T, n, d, l, C = 5, 4000, 2, 3, 3
    labels = rng.integers(0, C, size=n)
    z = rng.normal(size=(T, n, d)) + 4.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l)) - 3.0 * labels[None, :, None]
    lens = rng.integers(2, T + 1, size=n).astype(np.int32)
    steps = np.arange(T)[:, None] >= lens[None, :]
    z[steps] = np.nan
    x[steps] = np.nan
    t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    zd, xd, ld = t(z), t(x), t(lens, torch.int32)
    plist, alist = [], []
    for k in range(5):
        plist.append(tem.mixture_params_from_numpy(
            (np.full(C, 1.0 / C), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
             np.zeros((C, d, d)), np.stack([np.eye(d)] * C), rng.normal(size=(C, d, l)),
             np.stack([np.eye(l)] * C)), device=cuda, dtype=torch.float64))
        a0 = np.where(rng.uniform(size=n) < 0.1 * (k + 1), rng.integers(0, C, size=n), labels)
        alist.append(a0.astype(np.int32))
    alist[2] = np.zeros(n, np.int32)
    alist[2][:2] = [1, 2]  # init abort
    got, _stats = tem.train_em_markov_pool(plist, alist, zd, xd, ld, R=2, n_steps=50)
    for k, (p0, a0) in enumerate(zip(plist, alist)):
        p_s, a_s, i_s, s_s = tem.train_em_markov(p0, t(a0, torch.int32), zd, xd, ld, n_steps=50)
        p_g, a_g, i_g, s_g = got[k]
        assert (i_g, s_g) == (i_s, s_s), k
        assert torch.equal(a_g, a_s), k
        for x_g, x_s in zip(p_g, p_s):
            np.testing.assert_allclose(x_g.cpu().numpy(), x_s.cpu().numpy(), rtol=1e-10, atol=1e-10)
    assert got[2][3] == tem.STATUS_INIT_ABORT


def _dense_inputs(cuda, T, n, seed, C=16, d=5, l=3):
    """A gapped batch sorted by pattern, on the card in float64: ``(v (n,
    D), sizes, patterns, E-step operands (means, minv, const, logpi), prev,
    assign)``.  Lengths T//2, T-2 or T; a quarter lose one interior step,
    a tenth x at t=0; an empty segment and a one-row segment appended."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * 2.0
    x = z @ rng.normal(size=(d, l)) + rng.normal(size=(T, n, l))
    lens = rng.choice([T // 2, T - 2, T], size=n)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    gap = np.where(rng.uniform(size=n) < 0.25)[0]
    tg = rng.integers(1, 4, size=gap.size)  # interior for every length ≥ 5
    z[tg, gap] = np.nan
    x[tg, gap] = np.nan
    x[0, rng.uniform(size=n) < 0.1] = np.nan
    z[:, -1] = np.nan  # row n-1: only x observed, its own segment
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    patterns, pid = gops.pattern_groups(v)
    order = np.argsort(pid, kind="stable")
    patterns = np.concatenate([patterns, np.ones((1, v.shape[1]), bool)])  # empty
    sizes = tuple(int(c) for c in np.bincount(pid, minlength=patterns.shape[0]))
    assert 0 in sizes and 1 in sizes
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    params = tem.mixture_params_from_numpy(
        (np.full(C, 1.0 / C), rng.normal(size=(C, d)), eye(d),
         rng.normal(scale=0.3, size=(C, d, d)), eye(d), rng.normal(size=(C, d, l)), eye(l)),
        device=cuda, dtype=torch.float64,
    )
    means, covs = tem.cluster_joint_moments(params, T)
    pat = torch.tensor(patterns, device=cuda)
    minv, const = ek.precompute_cluster_pattern_inverses(means, covs, pat)
    prev = torch.tensor(rng.integers(0, C, size=n).astype(np.int32), device=cuda)
    prev[::53] = -1
    assign = torch.tensor(rng.integers(0, C, size=n).astype(np.int32), device=cuda)
    vd = torch.tensor(v[order], device=cuda)
    return vd, sizes, pat, (means, minv, const, torch.log(params.pi)), prev, assign


@pytest.mark.parametrize("T,n", [(10, 20037), (64, 1500)])
@pytest.mark.parametrize("dtype,tie", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
def test_estep_kernel_matches_plain(cuda, T, n, dtype, tie):
    """K8 at D = 80 and D = 512 (the route's largest)."""
    v, sizes, pat, ops, prev, _assign = _dense_inputs(cuda, T, n, seed=T)
    v_t = v.T.contiguous()
    args = (v_t.to(dtype), prev, *(o.to(dtype) for o in ops), pat)
    before = ek.estep_assign_pattern_sorted_t.launches
    a, c, s = ek.estep_assign_pattern_sorted_t(*args, sizes=sizes)
    assert ek.estep_assign_pattern_sorted_t.launches == before + 1
    valid = prev >= 0
    C = ops[0].shape[0]
    assert bool((a[~valid] == C).all())
    scores = ek.sorted_scores(v_t, *ops, pat, sizes=sizes)  # float64
    top2 = scores.topk(2, dim=0).values
    near = (top2[0] - top2[1]) < tie * (1 + top2[0].abs())
    ref = scores.argmax(dim=0).to(torch.int32)
    assert bool(((a == ref) | near | ~valid).all())
    assert torch.equal(c.long(), torch.bincount(a[valid].long(), minlength=C))
    assert int(s) == int(((a != prev) & valid).sum())
    for x1, x2 in zip((a, c, s), ek.estep_assign_pattern_sorted_t(*args, sizes=sizes)):
        assert torch.equal(x1, x2)


# K9's shapes: D = T(d+l) = 80 (the bench), 512 (the sorted route's
# widest) and 9 (a row of 36 bytes: copies of one element)
_GRAM_SHAPES = {"D80": (10, 5, 3, 20037), "D512": (64, 5, 3, 1500), "D9": (3, 2, 1, 20037)}
_GRAM_CASES = ("random", "ninety", "one", "empty_clusters", "outside", "one_row_segment", "many_pieces")


def _gram_inputs(cuda, shape, case, C=16, seed=11):
    """A gapped batch sorted by pattern, on the card in float64, and an
    int32 assignment: ``(v (n, D), sizes, patterns, (T, d, l), assign)``.
    Lengths T//2, T-1 or T; a quarter lose one interior step, a tenth x at
    t=0; one +Inf entry; row n-1 has no state (a one-row segment); an
    empty segment appended.  ``case``: uniformly random; 90% in one
    cluster; every row in one cluster (also ``many_pieces``); three
    clusters, the rest empty; a tenth C and a tenth -1 (no cluster);
    every row in cluster 0 but the one-row segment's, alone in C-1."""
    T, d, l, n = _GRAM_SHAPES[shape]
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * 2.0
    x = z @ rng.normal(size=(d, l)) + rng.normal(size=(T, n, l))
    lens = rng.choice([max(1, T // 2), T - 1, T], size=n)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    gap = np.where((rng.uniform(size=n) < 0.25) & (lens >= 3))[0]
    tg = rng.integers(1, lens[gap] - 1)
    z[tg, gap] = np.nan
    x[tg, gap] = np.nan
    x[0, rng.uniform(size=n) < 0.1] = np.nan
    z[0, 3, 0] = np.inf
    z[:, -1] = np.nan
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    patterns, pid = gops.pattern_groups(v)
    order = np.argsort(pid, kind="stable")
    patterns = np.concatenate([patterns, np.ones((1, v.shape[1]), bool)])  # empty
    sizes = tuple(int(c) for c in np.bincount(pid, minlength=patterns.shape[0]))
    assert 0 in sizes and 1 in sizes
    a = rng.integers(0, C, size=n)
    if case == "ninety":
        a = np.where(rng.uniform(size=n) < 0.9, 3, a)
    elif case in ("one", "many_pieces"):
        a = np.full(n, 5)
    elif case == "empty_clusters":
        a = rng.choice([0, 7, 15], size=n)
    elif case == "outside":
        u = rng.uniform(size=n)
        a = np.where(u < 0.1, C, np.where(u < 0.2, -1, a))
    elif case == "one_row_segment":
        a = np.zeros(n)
        a[order == n - 1] = C - 1
    return (torch.tensor(v[order], device=cuda), sizes, torch.tensor(patterns, device=cuda), (T, d, l),
            torch.tensor(a.astype(np.int32), device=cuda))


@pytest.mark.parametrize("case", _GRAM_CASES)
@pytest.mark.parametrize("shape", sorted(_GRAM_SHAPES))
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
def test_mstep_gram_kernel_matches_plain(cuda, monkeypatch, case, shape, dtype, rel):
    """K9 at D = 80, 512 and 9 on every assignment case; an assignment
    outside [0, C) counts nowhere; ``many_pieces`` cuts the lists into
    pieces of 32 rows (hundreds a segment at D = 80)."""
    v, sizes, pat, (T, d, l), assign = _gram_inputs(cuda, shape, case)
    if case == "many_pieces":
        monkeypatch.setattr(msk, "_PIECE_ROWS", 32)
    C = 16
    kw = dict(sizes=sizes, T=T, d=d, l=l, n_clusters=C)
    before = msk.mstep_stats_gram_sorted.launches
    got = msk.mstep_stats_gram_sorted(v.to(dtype), assign, pat, **kw)
    assert msk.mstep_stats_gram_sorted.launches == before + 1
    want = msk.mstep_stats_gram_sorted_plain(v, assign, pat, **kw)
    mag = msk.mstep_stats_gram_sorted_plain(v.abs(), assign, pat, **kw)
    flat = lambda out: [f for st in out[:3] for f in st] + [out[3]]  # noqa: E731
    for g, w, m in zip(flat(got), flat(want), flat(mag)):
        assert g.dtype == dtype
        assert bool(((g.double() - w).abs() <= rel * m + 1e-30).all())
    valid = (assign >= 0) & (assign < C)
    # the member counts, exact
    assert torch.equal(got[3].double(), torch.bincount(assign[valid].long(), minlength=C).double())
    for x1, x2 in zip(flat(got), flat(msk.mstep_stats_gram_sorted(v.to(dtype), assign, pat, **kw))):
        assert torch.equal(x1, x2)


@pytest.mark.parametrize("C", [16, 5000])
@pytest.mark.parametrize("rows", [1, 32, 1024])
@pytest.mark.parametrize("case", _GRAM_CASES)
def test_mstep_gram_plan_matches_plain(cuda, case, rows, C):
    """K9's row lists and pieces (``mtm_mstep_gram_plan``) against a stable
    argsort of segment·C + assign, bit for bit; at C = 5000 most of a
    chunk's clusters are empty."""
    _v, sizes, _pat, _shape, assign = _gram_inputs(cuda, "D80", case, C=C)
    idx, list_start, piece_start = msk.gram_plan(assign, sizes, C, rows)
    idx_p, list_start_p, piece_start_p = msk.gram_plan_plain(assign, sizes, C, rows)
    total = int(list_start_p[-1])
    assert torch.equal(list_start, list_start_p)
    assert torch.equal(piece_start, piece_start_p)
    assert torch.equal(idx[:total], idx_p[:total])


def test_mstep_gram_kernel_many_clusters(cuda):
    """K9 at C = 5000 (more clusters than a chunk's rows), D = 9: the plain
    version's statistics in float64 to 1e-11, exact counts."""
    C = 5000
    v, sizes, pat, (T, d, l), assign = _gram_inputs(cuda, "D9", "outside", C=C)
    kw = dict(sizes=sizes, T=T, d=d, l=l, n_clusters=C)
    got = msk.mstep_stats_gram_sorted(v, assign, pat, **kw)
    want = msk.mstep_stats_gram_sorted_plain(v, assign, pat, **kw)
    mag = msk.mstep_stats_gram_sorted_plain(v.abs(), assign, pat, **kw)
    flat = lambda out: [f for st in out[:3] for f in st] + [out[3]]  # noqa: E731
    for g, w, m in zip(flat(got), flat(want), flat(mag)):
        assert bool(((g - w).abs() <= 1e-11 * m + 1e-30).all())
    valid = (assign >= 0) & (assign < C)
    assert torch.equal(got[3], torch.bincount(assign[valid].long(), minlength=C).double())


def test_mstep_gram_adds_no_host_sync(cuda):
    """After a warm-up call (which caches the chunk table), K9's wrapper
    reads nothing back to the host."""
    v, sizes, pat, (T, d, l), assign = _gram_inputs(cuda, "D80", "ninety")
    v = v.float()
    kw = dict(sizes=sizes, T=T, d=d, l=l, n_clusters=16)
    want = msk.mstep_stats_gram_sorted(v, assign, pat, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = msk.mstep_stats_gram_sorted(v, assign, pat, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    flat = lambda out: [f for st in out[:3] for f in st] + [out[3]]  # noqa: E731
    assert all(torch.equal(x1, x2) for x1, x2 in zip(flat(got), flat(want)))


def test_dense_kernels_refuse_bad_arguments(cuda):
    v, sizes, pat, ops, prev, assign = _dense_inputs(cuda, 10, 2000, seed=3)
    v_t = v.T.contiguous()
    with pytest.raises(ValueError, match="int32"):
        ek.estep_assign_pattern_sorted_t(v_t, prev.long(), *ops, pat, sizes=sizes)
    with pytest.raises(ValueError, match="float32 or float64"):
        ek.estep_assign_pattern_sorted_t(v_t.half(), prev, *ops, pat, sizes=sizes)
    with pytest.raises(ValueError, match="contiguous"):
        ek.estep_assign_pattern_sorted_t(v.T, prev, *ops, pat, sizes=sizes)
    kw = dict(sizes=sizes, T=10, d=5, l=3, n_clusters=16)
    with pytest.raises(ValueError, match="int32"):
        msk.mstep_stats_gram_sorted(v, assign.long(), pat, **kw)
    with pytest.raises(ValueError, match="float32 or float64"):
        msk.mstep_stats_gram_sorted(v.half(), assign, pat, **kw)
    with pytest.raises(ValueError):
        msk.mstep_stats_gram_sorted(v[:-1], assign[:-1], pat, **kw)


def _perm(n, device):
    """The fixed row permutation that :func:`_unsorted` applies."""
    return torch.as_tensor(np.random.default_rng(0).permutation(n), device=device)


def _unsorted(v, sizes):
    """The sorted rows of ``v`` shuffled (row j is row ``_perm[j]``), with
    their pattern ids."""
    pid = torch.as_tensor(np.repeat(np.arange(len(sizes)), sizes).astype(np.int32), device=v.device)
    perm = _perm(v.shape[0], v.device)
    return v[perm], pid[perm]


def _assert_logliks_close(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float64:
        assert bool(((got - want).abs() <= 1e-10 * want.abs().clamp_min(1.0)).all())
    else:
        assert bool(((got.double() - want).abs() <= 1e-4 * (1 + want.abs())).all())


@pytest.mark.parametrize("T,n", [(10, 20037), (64, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_estep_logliks_kernels_match_plain(cuda, T, n, dtype):
    """K12 on shuffled rows and K13 on the sorted batch at D = 80 and
    D = 512, an empty and a one-row segment among them."""
    v, sizes, pat, (means, minv, const, _logpi), _prev, _assign = _dense_inputs(cuda, T, n, seed=T + 2)
    ops = tuple(o.to(dtype) for o in (means, minv, const))
    want = ek.estep_logliks_pattern_sorted_plain(v, means, minv, const, sizes=sizes)
    before = ek.estep_logliks_pattern_sorted.launches
    got = ek.estep_logliks_pattern_sorted(v.to(dtype), *ops, sizes=sizes)
    assert ek.estep_logliks_pattern_sorted.launches == before + 1
    _assert_logliks_close(got, want, dtype)
    assert torch.equal(got, ek.estep_logliks_pattern_sorted(v.to(dtype), *ops, sizes=sizes))
    vu, pid = _unsorted(v, sizes)
    before = ek.estep_logliks_pallas.launches
    got12 = ek.estep_logliks_pallas(vu.to(dtype).contiguous(), pid, *ops)
    assert ek.estep_logliks_pallas.launches == before + 1
    _assert_logliks_close(got12, ek.estep_logliks_pallas_plain(vu, pid, means, minv, const), dtype)
    assert torch.equal(got12, got[:, _perm(v.shape[0], cuda)])


def test_estep_logliks_fused_chunks_on_the_card(cuda, monkeypatch):
    """The chunked K12 (5 patterns a chunk, one launch for each chunk
    with rows) equals the unchunked call."""
    v, sizes, pat, _ops, _prev, _assign = _dense_inputs(cuda, 10, 5003, seed=5)
    vu, pid = _unsorted(v, sizes)
    rng = np.random.default_rng(5)
    C = 16
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    params = tem.mixture_params_from_numpy(
        (np.full(C, 1.0 / C), rng.normal(size=(C, 5)), eye(5), rng.normal(scale=0.3, size=(C, 5, 5)),
         eye(5), rng.normal(size=(C, 5, 3)), eye(3)), device=cuda, dtype=torch.float64)
    means, covs = tem.cluster_joint_moments(params, 10)
    whole = ek.estep_logliks_fused(means, covs, vu, pat, pid)
    D = v.shape[1]
    monkeypatch.setattr(ek, "_INVERSE_BYTES", 5 * C * D * D * 8)
    before = ek.estep_logliks_pallas.launches
    chunked = ek.estep_logliks_fused(means, covs, vu, pat, pid)
    chunks = sum(1 for k in range(0, len(sizes), 5) if sum(sizes[k : k + 5]) > 0)
    assert ek.estep_logliks_pallas.launches - before == chunks > 1
    assert bool(((chunked - whole).abs() <= 1e-12 * whole.abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_estep_logliks_at_the_dense_multistart_s_clusters(cuda, dtype):
    """K12 as the ADNI multistart's stacked E step calls it: 256
    candidates' random initial parameters (R·C = 768 clusters), D = 24, the
    data's 3 patterns, n = 571; one launch through ``estep_logliks_fused``,
    against the plain version."""
    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable
    from multimodal_trajectory_modeling_tpu_torch.utils import adni, state_space

    z, x, _d, _ids, _time = adni.get_trajectories()
    np.random.seed(0)
    model = MMLinGaussSS_marginalizable(3, state_space.standardize(z), x, device="cpu")
    cands = [model._candidate(100 + i) for i in range(256)]
    stacked = MMLinGaussSS_marginalizable._stack_candidates(cands, device=cuda, dtype=torch.float64)
    params = tem.MixtureParams(*(p.reshape(768, *p.shape[2:]) for p in stacked))
    _T0, _z, _x, v, pat, pid = model._packed()
    v, pat, pid = v.to(cuda), pat.to(cuda), torch.as_tensor(pid, device=cuda)
    assert pat.shape == (3, 24) and v.shape == (571, 24)
    means, covs = tem.cluster_joint_moments(params, 4)
    # the fused call takes its inverses in its own type: held against the
    # plain version on those inverses
    md, cd, vd = means.to(dtype), covs.to(dtype), v.to(dtype)
    before = ek.estep_logliks_pallas.launches
    got = ek.estep_logliks_fused(md, cd, vd, pat, pid)
    assert ek.estep_logliks_pallas.launches == before + 1
    assert got.shape == (768, 571)
    minv_d, const_d = ek.precompute_cluster_pattern_inverses(md, cd, pat)
    _assert_logliks_close(got, ek.estep_logliks_pallas_plain(vd, pid, md, minv_d, const_d).double(), dtype)
    minv, const = ek.precompute_cluster_pattern_inverses(means, covs, pat)
    ops = tuple(o.to(dtype) for o in (means, minv, const))
    got = ek.estep_logliks_pallas(v.to(dtype), pid, *ops)
    _assert_logliks_close(got, ek.estep_logliks_pallas_plain(v, pid, means, minv, const), dtype)
    assert torch.equal(got, ek.estep_logliks_pallas(v.to(dtype), pid, *ops))


@pytest.mark.parametrize("T,n", [(10, 20037), (64, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_estep_assign_rows_kernel_is_k8(cuda, T, n, dtype):
    """K14 on the row-major sorted batch gives K8's outputs bit for bit;
    ``bf16=True`` changes nothing."""
    v, sizes, pat, ops, prev, _assign = _dense_inputs(cuda, T, n, seed=T + 3)
    args = (prev, *(o.to(dtype) for o in ops), pat)
    k8 = ek.estep_assign_pattern_sorted_t(v.T.contiguous().to(dtype), *args, sizes=sizes)
    before = ek.estep_assign_pattern_sorted.launches
    k14 = ek.estep_assign_pattern_sorted(v.to(dtype), *args, sizes=sizes)
    assert ek.estep_assign_pattern_sorted.launches == before + 1
    k14_bf16 = ek.estep_assign_pattern_sorted(v.to(dtype), *args, sizes=sizes, bf16=True)
    for a, b, c in zip(k14, k8, k14_bf16):
        assert torch.equal(a, b) and torch.equal(a, c)


def _quad_inputs(cuda, T, n, seed, C=16, d=5, l=3, scale=1.0, one_rows=0, nan_rows=0, huge_rows=0):
    """A gapped batch sorted by pattern for the dense quadratic forms (K8,
    K12-K14), on the card in float64: ``(v (n, D), sizes, patterns,
    [means, minv, const, logpi], prev)``.  ``scale`` multiplies the data
    and shifts it by N(0, scale²) per coordinate, with means and noise of
    the same scale (|x| ~ 50 at 25); ``one_rows`` rows each lose a
    distinct prefix of z at t=0 (one-row segments); the last ``nan_rows``
    rows have no finite value (their own segment); ``huge_rows`` rows from
    n // 2 on hold 1e20 in their first coordinate (a float32 form that
    overflows to +Inf in every cluster, finite in float64)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * 2.0
    x = z @ rng.normal(size=(d, l)) + rng.normal(size=(T, n, l))
    z = scale * z + rng.normal(scale=scale, size=d)
    x = scale * x + rng.normal(scale=scale, size=l)
    lens = rng.choice([max(T // 2, 1), max(T - 2, 1), T], size=n)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    if T > 2:
        gap = np.where(rng.uniform(size=n) < 0.25)[0]
        tg = rng.integers(1, min(4, T - 1), size=gap.size)
        z[tg, gap] = np.nan
        x[tg, gap] = np.nan
    x[0, rng.uniform(size=n) < 0.1] = np.nan
    for i in range(one_rows):
        z[0, i, : i % d + 1] = np.nan
        x[0, i, : i // d] = np.nan
    z[0, n // 2 : n // 2 + huge_rows, 0] = 1e20
    if nan_rows:
        z[:, n - nan_rows :] = np.nan
        x[:, n - nan_rows :] = np.nan
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    patterns, pid = gops.pattern_groups(v)
    sizes = tuple(int(c) for c in np.bincount(pid, minlength=patterns.shape[0]))
    eye = lambda k: np.stack([np.eye(k)] * C) * scale**2  # noqa: E731
    params = tem.mixture_params_from_numpy(
        (rng.dirichlet(np.ones(C)), rng.normal(scale=scale, size=(C, d)), eye(d),
         rng.normal(scale=0.3, size=(C, d, d)), eye(d), rng.normal(size=(C, d, l)), eye(l)),
        device=cuda, dtype=torch.float64,
    )
    means, covs = tem.cluster_joint_moments(params, T)
    pat = torch.tensor(patterns, device=cuda)
    minv, const = ek.precompute_cluster_pattern_inverses(means, covs, pat)
    prev = torch.tensor(rng.integers(0, C, size=n).astype(np.int32), device=cuda)
    prev[::53] = -1
    vd = torch.tensor(v[np.argsort(pid, kind="stable")], device=cuda)
    return vd, sizes, pat, [means, minv, const, torch.log(params.pi)], prev


def _loglik_magnitude(v, means, minv, const, sizes):
    """½ aᵀ|M|a + |const| per cluster and row of a sorted batch, a = |v| +
    |m| at the finite coordinates (``chip_smoke.py`` phase 20's)."""
    fin = torch.isfinite(v)
    out = torch.empty((const.shape[0], v.shape[0]), dtype=torch.float64, device=v.device)
    off = 0
    for p, s in enumerate(sizes):
        for c in range(const.shape[0]):
            a = torch.where(fin[off : off + s], v[off : off + s].abs() + means[c].abs(), 0.0)
            out[c, off : off + s] = 0.5 * ((a @ minv[c, p].abs()) * a).sum(1) + const[c, p].abs()
        off += s
    return out


def _same_bits(p, q):
    """Equal, NaNs in the same places."""
    if p.is_floating_point():
        return bool((p.isnan() == q.isnan()).all()) and torch.equal(p.nan_to_num(), q.nan_to_num())
    return torch.equal(p, q)


def _same_class(got, want):
    """Where ``want`` is not finite, ``got`` is the same NaN, +Inf or −Inf."""
    bad = ~torch.isfinite(want)
    g, w = got[bad], want[bad]
    return bool((g.isnan() == w.isnan()).all()) and bool((g[~w.isnan()] == w[~w.isnan()]).all())


# the tensor-core body's edges (float32) and the same cases for the
# CUDA-core body (float64): widths, cluster counts, segment shapes, data
# range and non-finite inputs
_QUAD_CASES = {
    "D8": dict(T=1, n=2000),
    "D25": dict(T=5, d=3, l=2, n=3001),
    "D120": dict(T=15, n=3000),
    "D512": dict(T=64, n=700),
    "C1": dict(T=10, n=3000, C=1),
    "C32": dict(T=10, n=5000, C=32),
    "one-row-segments": dict(T=10, n=2000, one_rows=12),
    "ragged": dict(T=10, n=20000 + 37),
    "wide-range": dict(T=10, n=6000, scale=25.0),
    "nan-mean-observed": dict(T=10, n=3000, poison=("means", 3, 0, float("nan"))),
    "nan-mean-missing": dict(T=10, n=3000, poison=("means", 5, -1, float("nan"))),
    "inf-mean": dict(T=10, n=3000, poison=("means", 7, 1, float("inf"))),
    "failed-factorization": dict(T=10, n=3000, poison=("inverse", 2)),
    "all-nan-rows": dict(T=10, n=3000, nan_rows=3),
    "overflow": dict(T=10, n=3000, huge_rows=2),
}


def _quad_case(cuda, name):
    kw = dict(_QUAD_CASES[name])
    poison = kw.pop("poison", None)
    v, sizes, pat, ops, prev = _quad_inputs(cuda, kw.pop("T"), kw.pop("n"), sum(map(ord, name)), **kw)
    if poison and poison[0] == "means":
        _, c, j, val = poison
        ops[0] = ops[0].clone()
        ops[0][c, j] = val
    elif poison:
        c, p = poison[1], int(np.argmax(sizes))  # the largest segment
        ops[1], ops[2] = ops[1].clone(), ops[2].clone()
        ops[1][c, p] = float("nan")  # as precompute_cluster_pattern_inverses gives it
        ops[2][c, p] = float("nan")
    return v, sizes, pat, ops, prev


@pytest.mark.parametrize("name", list(_QUAD_CASES))
@pytest.mark.parametrize("dtype,rel,tie", [(torch.float32, 2e-5, 1e-4), (torch.float64, 1e-12, 1e-9)])
def test_dense_quadratic_form_kernels_edges(cuda, name, dtype, rel, tie):
    """K12 and K13 within ``rel`` of the float64 plain version's magnitude
    (non-finite values in the plain version's class in ``dtype``), K8
    flipping only at near ties of the float64 scores, and where the plain
    scores in ``dtype`` peak at a non-finite value (a NaN wins) taking the
    plain version's cluster; K14 equal to K8 and K12 to K13's columns bit
    for bit, two calls the same bits; rows with no finite value give
    exactly ``const``."""
    v, sizes, pat, (means, minv, const, logpi), prev = _quad_case(cuda, name)
    C = const.shape[0]
    ops = tuple(o.to(dtype) for o in (means, minv, const))
    vk = v.to(dtype)
    # K13 and K12
    want = ek.estep_logliks_pattern_sorted_plain(v, means, minv, const, sizes=sizes)
    plain = ek.estep_logliks_pattern_sorted_plain(vk, *ops, sizes=sizes)
    mag = _loglik_magnitude(v, means, minv, const, sizes)
    got = ek.estep_logliks_pattern_sorted(vk, *ops, sizes=sizes)
    assert got.dtype == dtype and _same_bits(got, ek.estep_logliks_pattern_sorted(vk, *ops, sizes=sizes))
    assert _same_class(got, plain)
    fin = torch.isfinite(plain)
    assert bool(torch.isfinite(got[fin]).all())
    assert bool(((got.double() - want).abs()[fin] <= rel * mag[fin]).all())
    vu, pid = _unsorted(vk, sizes)
    got12 = ek.estep_logliks_pallas(vu.contiguous(), pid, *ops)
    assert _same_bits(got12, got[:, _perm(v.shape[0], cuda)])
    if _QUAD_CASES[name].get("nan_rows"):
        (p0,) = torch.nonzero(~pat.any(1)).flatten().tolist()  # the all-missing pattern
        assert sizes[p0] == _QUAD_CASES[name]["nan_rows"]
        off = sum(sizes[:p0])
        assert bool((got[:, off : off + sizes[p0]] == ops[2][:, p0 : p0 + 1]).all())
    # K8 and K14
    args = (prev, *ops, logpi.to(dtype), pat)
    a, c, s = ek.estep_assign_pattern_sorted_t(vk.T.contiguous(), *args, sizes=sizes)
    for x1, x2 in zip((a, c, s), ek.estep_assign_pattern_sorted_t(vk.T.contiguous(), *args, sizes=sizes)):
        assert torch.equal(x1, x2)
    for x1, x2 in zip((a, c, s), ek.estep_assign_pattern_sorted(vk, *args, sizes=sizes)):
        assert torch.equal(x1, x2)
    valid = prev >= 0
    assert bool((a[~valid] == C).all())
    scores = ek.sorted_scores(v.T, means, minv, const, logpi, pat, sizes=sizes)  # float64
    ref = mk._argmax_first(scores)[1]
    best_k, ref_k = mk._argmax_first(ek.sorted_scores(vk.T, *ops, logpi.to(dtype), pat, sizes=sizes))
    exact = ~torch.isfinite(best_k)
    if C > 1:
        top2 = torch.where(scores.isnan(), -torch.inf, scores).topk(2, dim=0).values
        near = (top2[0] - top2[1]) < tie * (1 + top2[0].abs())
    else:
        near = torch.zeros_like(valid)
    assert bool((torch.where(exact, a == ref_k, (a == ref) | near) | ~valid).all())
    assert torch.equal(c.long(), torch.bincount(a[valid].long(), minlength=C))
    assert int(s) == int(((a != prev) & valid).sum())


@pytest.mark.parametrize("T,n", [(10, 20037), (64, 1500), (1, 700)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
def test_mstep_stats_kernel_matches_plain(cuda, T, n, dtype, rel):
    """K15 at D = 80, D = 512 and T = 1 (no transition pair) on gapped
    rows in any order; an assignment outside [0, C) counts nowhere."""
    if T > 1:
        v, *_rest, assign = _dense_inputs(cuda, T, n, seed=T + 4)
    else:
        v, assign = _one_step_inputs(cuda, n)
    v, _pid = _unsorted(v, (v.shape[0],))
    C = 16
    assign[7], assign[8] = C, -1
    kw = dict(T=T, d=5, l=3, n_clusters=C)
    before = msk.mstep_stats_pallas.launches
    got = msk.mstep_stats_pallas(v.to(dtype), assign, **kw)
    assert msk.mstep_stats_pallas.launches == before + 1
    want = msk.mstep_stats_pallas_plain(v, assign, **kw)
    mag = msk.mstep_stats_pallas_plain(v.abs(), assign, **kw)
    for g, w, m in zip(got, want, mag):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(((g.double() - w).abs() <= rel * m + 1e-30).all())
    for x1, x2 in zip(got, msk.mstep_stats_pallas(v.to(dtype), assign, **kw)):
        assert torch.equal(x1, x2)


def _zx_inputs(cuda, T, n, d, l, C, seed, p=0.05):
    """States and observations ``(T, n, ·)`` on the card in float64, every
    coordinate missing with probability p and trajectories cut at random
    lengths, |x| up to ~50, and an assignment with rows outside [0, C)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * rng.uniform(0.5, 20.0, size=(1, n, 1))
    x = rng.normal(size=(T, n, l)) * 10.0
    z[rng.uniform(size=z.shape) < p] = np.nan
    x[rng.uniform(size=x.shape) < p] = np.nan
    past = np.arange(T)[:, None] >= rng.integers(1, T + 1, size=n)[None, :]
    z[past] = np.nan
    x[past] = np.nan
    a = rng.integers(0, C, size=n).astype(np.int32)
    a[::101] = C
    a[7::103] = -1
    return torch.tensor(z, device=cuda), torch.tensor(x, device=cuda), torch.tensor(a, device=cuda)


def _assert_stats_close(got, z, x, a, C, dtype, rel):
    """K15's statistics within ``rel`` of the plain version's float64 sums
    over |z|, |x| (float32: each output rounded once from a float64 sum)."""
    want = msk.mstep_stats_zx_plain(z.double(), x.double(), a, n_clusters=C)
    mag = msk.mstep_stats_zx_plain(z.double().abs(), x.double().abs(), a, n_clusters=C)
    for g, w, m in zip(got, want, mag):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(((g.double() - w).abs() <= rel * m + 1e-30).all())


_ZX_RELS = [(torch.float32, 1e-6), (torch.float64, 1e-11)]


def _zx(z, x, a, C, body):
    """K15 through its wrapper ("auto": the body the shape takes) or with
    the general body forced (the private ``_stats_kernel``)."""
    if body == "auto":
        return msk.mstep_stats_zx(z, x, a, n_clusters=C)
    return msk._stats_kernel(z, x, a, C, body)


@pytest.mark.parametrize("T", [10, 110, 128])
@pytest.mark.parametrize("n", [1037, 40037])
@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (2, 3), (3, 2)])
@pytest.mark.parametrize("body", ["auto", "general"])
@pytest.mark.parametrize("dtype,rel", _ZX_RELS)
def test_mstep_stats_zx_kernel_matches_plain(cuda, T, n, d, l, body, dtype, rel):
    """K15 on the (T, n, ·) tensors the masked trainer holds, both bodies
    ((3, 2) has no fast body: "auto" takes the general one), at the route's
    T (10, and 110 and 128 in chunks of steps), one tile a block and many;
    two calls bit-identical, one launch each."""
    C = 16 if n > 2000 else 3
    z, x, a = _zx_inputs(cuda, T, n, d, l, C, seed=T + n + d)
    z, x = z.to(dtype), x.to(dtype)
    before = msk.mstep_stats_pallas.launches
    got = _zx(z, x, a, C, body)
    assert msk.mstep_stats_pallas.launches == before + 1
    _assert_stats_close(got, z, x, a, C, dtype, rel)
    for x1, x2 in zip(got, _zx(z, x, a, C, body)):
        assert torch.equal(x1, x2)


@pytest.mark.parametrize("C", [1, 3, 16, 300])
@pytest.mark.parametrize("body", ["auto", "general"])
@pytest.mark.parametrize("dtype,rel", _ZX_RELS)
def test_mstep_stats_zx_clusters(cuda, C, body, dtype, rel):
    """One cluster, a few, the bench's 16, and 300, whose tables need the
    clusters in groups: each group reads the batch again."""
    z, x, a = _zx_inputs(cuda, 10, 30011, 5, 3, C, seed=C)
    z, x = z.to(dtype), x.to(dtype)
    got = _zx(z, x, a, C, body)
    _assert_stats_close(got, z, x, a, C, dtype, rel)
    if C == 300:
        plan = msk._stats_plan(z.device.index or 0, msk._KINDS[dtype], msk._BODIES[body], True, True,
                               10, 5, 3, C, z.shape[1])[1]
        assert plan[3] < C  # clusters a group


@pytest.mark.parametrize("body", ["auto", "general"])
def test_mstep_stats_zx_one_cluster_and_no_cluster(cuda, body):
    """Every row in one cluster (its table takes every row, the others stay
    zero), and every row outside [0, C) (every statistic zero)."""
    z, x, _a = _zx_inputs(cuda, 10, 20000, 5, 3, 4, seed=5)
    for fill in (2, 4, -1):
        a = torch.full((z.shape[1],), fill, dtype=torch.int32, device=cuda)
        got = _zx(z, x, a, 4, body)
        _assert_stats_close(got, z, x, a, 4, torch.float64, 1e-11)
        for g, u in zip(got, msk._stats_widths(5, 3)):
            blocks = g.reshape(u, 4, u)
            for c in range(4):
                assert bool((blocks[:, c] == 0).all()) == (c != fill)


@pytest.mark.parametrize("T", [1, 10, 128])
@pytest.mark.parametrize("body", ["auto", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mstep_stats_strided_equals_packed(cuda, T, body, dtype):
    """The (T, n, ·) tensors, the packed batch's views and a layout that
    needs a copy give the same bits (one plan, one summation order)."""
    z, x, a = _zx_inputs(cuda, T, 9001, 5, 3, 16, seed=T)
    z, x = z.to(dtype), x.to(dtype)
    n = z.shape[1]
    v = torch.cat([z.permute(1, 0, 2).reshape(n, -1), x.permute(1, 0, 2).reshape(n, -1)], 1).contiguous()
    got = _zx(z, x, a, 16, body)
    zv, xv = msk._joint_views(v, T, 5, 3)
    odd = z.transpose(1, 2).contiguous().transpose(1, 2)
    for other in (_zx(zv, xv, a, 16, body), _zx(odd, x, a, 16, body)):
        for g, o in zip(got, other):
            assert torch.equal(g, o)
    if body == "auto":
        for g, o in zip(got, msk.mstep_stats_pallas(v, a, T=T, d=5, l=3, n_clusters=16)):
            assert torch.equal(g, o)


def test_train_em_masked_kalman_launches_k15(cuda):
    """The masked fit on the card in float64: K7 per E step, K15 per M step
    (the initial one included), the CPU fit's iterations, status and
    assignment."""
    rng = np.random.default_rng(16)
    T, n, d, l, C = 8, 3000, 5, 3, 2
    labels = np.arange(n) % C
    z = rng.normal(size=(T, n, d)) + 3.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l))
    z[rng.uniform(size=z.shape) < 0.05] = np.nan
    x[rng.uniform(size=x.shape) < 0.05] = np.nan
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    p0 = (np.full(C, 0.5), rng.normal(size=(C, d)), eye(d), 0.3 * eye(d), eye(d), rng.normal(size=(C, d, l)), eye(l))
    a0 = np.where(rng.uniform(size=n) < 0.3, 1 - labels, labels)
    fits = {}
    for dev in ("cpu", cuda):
        k7, k15 = kk.kalman_masked_logliks_packed.launches, msk.mstep_stats_pallas.launches
        fits[str(dev)] = tem.train_em_masked_kalman(
            tem.mixture_params_from_numpy(p0, device=dev, dtype=torch.float64), torch.tensor(a0, device=dev),
            torch.tensor(z, device=dev), torch.tensor(x, device=dev), n_steps=50)
        launches = (kk.kalman_masked_logliks_packed.launches - k7, msk.mstep_stats_pallas.launches - k15)
    _p, a_g, iters, status = fits[str(cuda)]
    assert launches == (iters, 1 + iters - (status != tem.STATUS_RUNNING))
    _pc, a_c, iters_c, status_c = fits["cpu"]
    assert (iters, status) == (iters_c, status_c) and status == tem.STATUS_CONVERGED
    assert torch.equal(a_g.cpu(), a_c)


def _one_step_inputs(cuda, n):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(n, 8))
    v[rng.uniform(size=n) < 0.2, 2] = np.nan
    assign = rng.integers(0, 16, size=n).astype(np.int32)
    return torch.tensor(v, device=cuda), torch.tensor(assign, device=cuda)


def test_mstep_pallas_cuda_f64_matches_cpu(cuda):
    """``em.mstep(impl="pallas")`` (K15) on the card equals the CPU's and
    the plain ``impl="xla"`` in float64."""
    v, _sizes, _pat, _ops, _prev, assign = _dense_inputs(cuda, 10, 5000, seed=8)
    n = v.shape[0]
    z = v[:, :50].reshape(n, 10, 5).permute(1, 0, 2)
    x = v[:, 50:].reshape(n, 10, 3).permute(1, 0, 2)
    got = tem.mstep(z, x, assign, n_clusters=16, impl="pallas")
    for a, b, c in zip(got, tem.mstep(z.cpu(), x.cpu(), assign.cpu(), n_clusters=16, impl="pallas"),
                       tem.mstep(z, x, assign, n_clusters=16)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_new_dense_kernels_refuse_bad_arguments(cuda):
    v, sizes, pat, (means, minv, const, logpi), prev, assign = _dense_inputs(cuda, 10, 2000, seed=3)
    with pytest.raises(ValueError, match="float32 or float64"):
        ek.estep_logliks_pattern_sorted(v.half(), means, minv, const, sizes=sizes)
    with pytest.raises(ValueError, match="contiguous"):
        ek.estep_logliks_pattern_sorted(v.T.contiguous().T, means, minv, const, sizes=sizes)
    with pytest.raises(ValueError, match="sizes"):
        ek.estep_logliks_pattern_sorted(v, means, minv, const, sizes=sizes[:-1])
    vu, pid = _unsorted(v, sizes)
    with pytest.raises(ValueError, match="outside"):
        ek.estep_logliks_pallas(vu, pid + len(sizes), means, minv, const)
    with pytest.raises(ValueError, match="int32"):
        ek.estep_assign_pattern_sorted(v, prev.long(), means, minv, const, logpi, pat, sizes=sizes)
    kw = dict(T=10, d=5, l=3, n_clusters=16)
    with pytest.raises(ValueError, match="int32"):
        msk.mstep_stats_pallas(v, assign.long(), **kw)
    with pytest.raises(ValueError, match="T·"):
        msk.mstep_stats_pallas(v, assign, T=10, d=4, l=3, n_clusters=16)
    z, x = msk._joint_views(v, 10, 5, 3)
    with pytest.raises(ValueError, match="no plan"):  # no fast body at d=4
        msk._stats_kernel(z[..., :4], x, assign, 16, "fast")
    with pytest.raises(ValueError, match="float32 or float64"):
        msk.mstep_stats_zx(z, x.float(), assign, n_clusters=16)
    with pytest.raises(ValueError, match="assign must be"):
        msk.mstep_stats_zx(z, x, assign[1:], n_clusters=16)


def test_train_em_sorted_cuda_f64_matches_cpu(cuda):
    """The sorted dense fit on the card in float64 (K8 and K9 every
    iteration) lands where the CPU fit does."""
    rng = np.random.default_rng(9)
    T, n, d, l, C = 5, 4000, 2, 3, 2
    labels = rng.integers(0, C, size=n)
    z = rng.normal(size=(T, n, d)) + 4.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l)) - 3.0 * labels[None, :, None]
    z[2, ::5] = np.nan  # interior gaps
    x[2, ::5] = np.nan
    x[0, ::7] = np.nan
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    patterns, pid = gops.pattern_groups(v)
    order = np.argsort(pid, kind="stable")
    sizes = tuple(int(c) for c in np.bincount(pid))
    assign0 = np.where(rng.uniform(size=n) < 0.2, 1 - labels, labels)[order]
    params0 = (
        np.full(C, 0.5), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
        np.zeros((C, d, d)), np.stack([np.eye(d)] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C),
    )
    fits = []
    for dev in ("cpu", "cuda"):
        t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        fits.append(tem.train_em_sorted(
            tem.mixture_params_from_numpy(params0, device=dev, dtype=torch.float64),
            t(assign0, torch.int32), t(z[:, order]), t(x[:, order]), t(v[order]),
            t(patterns, torch.bool), sizes=sizes,
        ))
    (p_c, a_c, i_c, s_c), (p_g, a_g, i_g, s_g) = fits
    assert (i_g, s_g) == (i_c, s_c) and s_c == tem.STATUS_CONVERGED
    assert torch.equal(a_g.cpu(), a_c)
    for x_c, x_g in zip(p_c, p_g):
        np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-8, atol=1e-8)


# ----------------------------------------------------------------------
# K7: the masked Kalman filter; K5: the canonical Φ at any T
# ----------------------------------------------------------------------


def _masked_inputs(device, dtype, T, n, d, l, C, seed):
    """Per-coordinate NaNs (30%), row 0 all NaN, and C parameter rows."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[rng.random(z.shape) < 0.3] = np.nan
    x[rng.random(x.shape) < 0.3] = np.nan
    z[:, 0] = np.nan
    x[:, 0] = np.nan
    params = (
        rng.normal(size=(C, d)), np.stack([np.eye(d) * 0.8] * C),
        rng.normal(scale=0.3, size=(C, d, d)), np.stack([np.eye(d) * 0.5] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l) * 0.4 + 0.1] * C),
    )
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (*kk.pack_masked_kalman(t(z), t(x)), *map(t, params))


def _assert_masked_close(got, want, dtype):
    rel = 1e-10 if dtype == torch.float64 else 1e-4
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= rel * (1 + want.abs())).all()), float((got - want).abs().max())


@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (2, 3), (1, 1), (4, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_kalman_kernel_matches_plain(cuda, d, l, dtype):
    """The instantiated shapes and, at (4, 3), the general one."""
    args = _masked_inputs(cuda, dtype, 9, 2053, d, l, 3, seed=d * 10 + l)
    before = kk.kalman_masked_logliks_packed.launches
    got = kk.kalman_masked_logliks_packed(*args)
    assert kk.kalman_masked_logliks_packed.launches == before + 1
    _assert_masked_close(got, kk.kalman_masked_logliks_packed_plain(*args), dtype)
    assert bool((got[:, 0] == 0.0).all())  # the all-NaN row
    assert torch.equal(got, kk.kalman_masked_logliks_packed(*args))


def test_masked_kalman_kernel_takes_pool_rows(cuda):
    """R·C = 512 parameter rows in one launch."""
    args = _masked_inputs(cuda, torch.float64, 6, 777, 5, 3, 512, seed=3)
    _assert_masked_close(
        kk.kalman_masked_logliks_packed(*args), kk.kalman_masked_logliks_packed_plain(*args),
        torch.float64,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_kalman_overflow_stays_finite(cuda, dtype):
    """An expansive A over a long unobserved tail overflows the state in
    float32; the observed prefix's log-density stays finite."""
    rng = np.random.default_rng(11)
    T, n, d, l = 40, 300, 5, 3
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[2:], x[2:] = np.nan, np.nan
    z[0, ::3, 1] = np.nan
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    eye = lambda k: np.eye(k)[None]  # noqa: E731
    params = (np.zeros((1, d)), eye(d), 30.0 * eye(d), eye(d), rng.normal(size=(1, d, l)), eye(l))
    args = (*kk.pack_masked_kalman(t(z), t(x)), *map(t, params))
    _assert_masked_close(kk.kalman_masked_logliks_packed(*args), kk.kalman_masked_logliks_packed_plain(*args), dtype)


def test_masked_kalman_kernel_refuses_bad_arguments(cuda):
    args = list(_masked_inputs(cuda, torch.float32, 3, 100, 2, 3, 2, seed=1))
    with pytest.raises(ValueError, match="float32 or float64"):
        kk.kalman_masked_logliks_packed(args[0].half(), args[1].half(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        kk.kalman_masked_logliks_packed(args[0].mT.contiguous().mT, *args[1:])
    big = _masked_inputs(cuda, torch.float32, 2, 50, 9, 1, 1, seed=2)
    with pytest.raises(ValueError, match="at most 8"):
        kk.kalman_masked_logliks_packed(*big)


def _planned_inputs(device, dtype, T, n, d, l, C, seed, suffix=True, p=0.3):
    """Per-coordinate NaNs (p), lengths drawn from 0..T (``suffix``), rows
    0 and 7 all NaN; returns ``(z, x)`` on the device and C parameter
    rows."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[rng.random(z.shape) < p] = np.nan
    x[rng.random(x.shape) < p] = np.nan
    if suffix:
        past = np.arange(T)[:, None] >= rng.integers(0, T + 1, size=n)[None, :]
        z[past], x[past] = np.nan, np.nan
    z[:, [0, 7]] = np.nan
    x[:, [0, 7]] = np.nan
    params = (
        rng.normal(size=(C, d)), np.stack([np.eye(d) * 0.8] * C),
        rng.normal(scale=0.3, size=(C, d, d)), np.stack([np.eye(d) * 0.5] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l) * 0.4 + 0.1] * C),
    )
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return t(z), t(x), [t(a) for a in params]


def _hold_planned(zt, xt, params, dtype, plan=None):
    """K7 on the planned batch (or on ``plan`` with the batch in the
    caller's order) against the plain version in the caller's order: the
    tolerance, all-NaN rows exactly 0.0, two calls the same bits, one
    launch a call; returns the kernel's output."""
    zc, xc = kk.pack_masked_kalman(zt, xt)
    if plan is None:
        zp, xp, plan = kk.plan_masked_batch(zt, xt)
    else:
        zp, xp = zc, xc
    before = kk.kalman_masked_logliks_packed.launches
    got = kk.kalman_masked_logliks_packed(zp, xp, *params, plan=plan)
    assert kk.kalman_masked_logliks_packed.launches == before + 1
    assert torch.equal(got, kk.kalman_masked_logliks_packed(zp, xp, *params, plan=plan))
    _assert_masked_close(got, kk.kalman_masked_logliks_packed_plain(zc, xc, *params), dtype)
    assert bool((got[:, [0, 7]] == 0.0).all())
    return got


@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (2, 3), (3, 2), (1, 3), (1, 1), (4, 3), (8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_kalman_kernel_planned_batch(cuda, d, l, dtype):
    """Every instantiated shape and the general one ((4, 3), (8, 8)) on
    the trainers' planned batch, rows of every extent 0..T: the plain
    version over all T, and the unplanned call's bits."""
    zt, xt, params = _planned_inputs(cuda, dtype, 9, 2053, d, l, 3, seed=d * 10 + l)
    got = _hold_planned(zt, xt, params, dtype)
    assert torch.equal(got, kk.kalman_masked_logliks_packed(*kk.pack_masked_kalman(zt, xt), *params))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_kalman_kernel_extents_vary_inside_a_tile(cuda, dtype):
    """The caller's own order with each row's true extent (no sort): every
    tile mixes extents 0..T."""
    zt, xt, params = _planned_inputs(cuda, dtype, 12, 1500, 5, 3, 4, seed=5)
    rows, extent = kk.masked_plan(*kk.pack_masked_kalman(zt, xt))
    by_row = torch.empty_like(extent)
    by_row[rows.long()] = extent
    plan = kk.MaskedPlan(torch.arange(zt.shape[1], dtype=torch.int32, device=cuda), by_row)
    assert len(set(by_row[:128].tolist())) > 5
    _hold_planned(zt, xt, params, dtype, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_kalman_kernel_rows_of_one_extent(cuda, dtype):
    """No suffix: every row but the all-NaN ones runs all T steps."""
    zt, xt, params = _planned_inputs(cuda, dtype, 10, 3001, 5, 3, 3, seed=6, suffix=False, p=0.05)
    plan = kk.plan_masked_batch(zt, xt).plan
    assert set(plan.extent.tolist()) == {0, 10}
    _hold_planned(zt, xt, params, dtype)


@pytest.mark.parametrize("T,n,C", [(10, 1_000_037, 4), (128, 5000, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_kalman_kernel_large_n_and_long_T(cuda, T, n, C, dtype):
    zt, xt, params = _planned_inputs(cuda, dtype, T, n, 5, 3, C, seed=T, p=0.05)
    _hold_planned(zt, xt, params, dtype)


_ODD_PIVOTS = {  # parameter row: (S, L, H edits) that make a pivot odd
    0: "S00 = 0", 1: "S11 < 0", 2: "S00 = inf", 3: "S22 = nan", 4: "L00 < 0", 5: "L11 = inf",
    6: "L22 = nan", 7: "L0 = 0, H0 = 0", 8: "S00 subnormal",
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_kalman_nonfinite_pivots_keep_the_plain_class(cuda, dtype):
    """A pivot that is zero, negative, infinite, NaN or subnormal: where
    the plain version is NaN, +Inf or -Inf the kernel is too, elsewhere
    within the tolerance."""
    zt, xt, params = _planned_inputs(cuda, dtype, 6, 700, 5, 3, len(_ODD_PIVOTS), seed=9, suffix=False, p=0.2)
    m, S, A, G, H, L = params
    S[0, 0, 0] = 0.0
    S[1, 1, 1] = -1.0
    S[2, 0, 0] = float("inf")
    S[3, 2, 2] = float("nan")
    L[4, 0, 0] = -5.0
    L[5, 1, 1] = float("inf")
    L[6, 2, 2] = float("nan")
    L[7, 0, :], L[7, :, 0], H[7, :, 0] = 0.0, 0.0, 0.0
    S[8, 0, 0] = 1e-40 if dtype == torch.float32 else 1e-310
    zp, xp, plan = kk.plan_masked_batch(zt, xt)
    got = kk.kalman_masked_logliks_packed(zp, xp, *params, plan=plan)
    want = kk.kalman_masked_logliks_packed_plain(*kk.pack_masked_kalman(zt, xt), *params)

    def cls(v):
        return torch.where(v.isnan(), 2, torch.where(v.isinf(), v.sign().long(), 0))

    assert torch.equal(cls(got), cls(want))
    assert bool((~torch.isfinite(want)).any(1)[:8].all())  # each odd row reaches the log-density
    fin = torch.isfinite(want)
    rel = 1e-10 if dtype == torch.float64 else 1e-4
    assert bool(((got - want).abs()[fin] <= rel * (1 + want.abs()[fin])).all())


@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (4, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_longT_features_kernel_is_the_plain_version(cuda, d, l, dtype):
    T, n = 70, 2053
    rng = np.random.default_rng(d + l)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    z_t = torch.tensor(z.transpose(0, 2, 1).reshape(T * d, n), dtype=dtype, device=cuda)
    x_t = torch.tensor(x.transpose(0, 2, 1).reshape(T * l, n), dtype=dtype, device=cuda)
    lens_d = torch.tensor(lens, device=cuda)
    before = mk.markov_materialize_features_longT.launches
    phi = mk.markov_materialize_features_longT(z_t, x_t, lens_d, T=T, d=d, l=l)
    assert mk.markov_materialize_features_longT.launches == before + 1
    assert torch.equal(phi, mk.markov_materialize_features_longT_plain(z_t, x_t, lens_d, T=T, d=d, l=l))
    assert torch.equal(phi, mk.markov_materialize_features_longT(z_t, x_t, lens_d, T=T, d=d, l=l))


# K5's staged body (csrc/markov_features_longT.cu, the wrapper's route)
# at its edges: n around a tile and a round of persistent blocks, n % 16
# != 0 (rows off their 16-byte lines: one copy more a row), T = 1 and 2, a
# part-filled last stage, ADNI's (2, 4), the generic instantiation's (4,
# 4) and (8, 8), lengths 0..T, |x| ~ 50
_K5_CASES = {
    "n=1": (9, 5, 3, 1), "n=127": (9, 5, 3, 127), "n=128": (9, 5, 3, 128), "n=129": (9, 5, 3, 129),
    "n=2053": (70, 5, 3, 2053), "n=20000": (128, 5, 3, 20000), "n=20037": (128, 5, 3, 20037),
    "n=rounds+5": (6, 5, 3, 4 * 128 * 132 + 5), "T=1": (1, 5, 3, 301), "T=2": (2, 5, 3, 301),
    "adni": (70, 2, 4, 2053), "adni-aligned": (70, 2, 4, 4000), "generic": (33, 4, 4, 1037),
    "generic-8x8": (5, 8, 8, 130), "d1l1": (12, 1, 1, 4001),
}


def _k5_batch(T, d, l, n, seed, dtype, device, scale=1.0):
    """(z_t, x_t, lens) with lengths 0..T (NaN past each), values N(0, 1)
    times ``scale`` plus a per-coordinate offset of the same size."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(T, n, d)) + rng.normal(size=d)) * scale
    x = (rng.normal(size=(T, n, l)) + rng.normal(size=l)) * scale
    lens = rng.integers(0, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    # contiguous: at T = 1 numpy's reshape is a strided view, which
    # torch.tensor would keep
    z_t = torch.tensor(np.ascontiguousarray(z.transpose(0, 2, 1).reshape(T * d, n)), dtype=dtype, device=device)
    x_t = torch.tensor(np.ascontiguousarray(x.transpose(0, 2, 1).reshape(T * l, n)), dtype=dtype, device=device)
    return z_t, x_t, torch.tensor(lens, device=device)


def _bits(p):
    return p.view(torch.int32 if p.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("scale", [1.0, 50.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(_K5_CASES))
def test_k5_staged_body_is_the_global_body(cuda, case, dtype, scale):
    """K5: the staged body (the wrapper's choice) gives the global-memory
    body's Φ and the plain version's bit for bit, pad rows zero; two calls
    the same bits; one launch counted a call."""
    T, d, l, n = _K5_CASES[case]
    z_t, x_t, lens = _k5_batch(T, d, l, n, 23, dtype, cuda, scale)
    assert mk._k5_body(d, l, dtype) == "staged"
    before = mk.markov_materialize_features_longT.launches
    phi = mk.markov_materialize_features_longT(z_t, x_t, lens, T=T, d=d, l=l)
    assert mk.markov_materialize_features_longT.launches == before + 1
    glob = mk._features_longT_kernel(z_t, x_t, lens, T=T, d=d, l=l, body="global")
    plain = mk.markov_materialize_features_longT_plain(z_t, x_t, lens, T=T, d=d, l=l)
    again = mk.markov_materialize_features_longT(z_t, x_t, lens, T=T, d=d, l=l)
    assert torch.equal(_bits(phi), _bits(glob)) and torch.equal(_bits(phi), _bits(plain))
    assert torch.equal(_bits(again), _bits(phi))
    assert bool((phi[mk._canonical_offsets(d, l)["F"]:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [20000, 20037])
def test_k5_staged_body_on_unaligned_storage(cuda, n, dtype):
    """z_t one value and x_t three values into their storage (off their
    16-byte lines: every row copied from its aligned start): the global
    body's Φ bit for bit."""
    T, d, l = 40, 5, 3
    z_t, x_t, lens = _k5_batch(T, d, l, n, 24, dtype, cuda, 50.0)
    z1 = torch.empty(z_t.numel() + 1, dtype=dtype, device=cuda)[1:].view(z_t.shape).copy_(z_t)
    x1 = torch.empty(x_t.numel() + 3, dtype=dtype, device=cuda)[3:].view(x_t.shape).copy_(x_t)
    assert z1.data_ptr() % 16 and x1.data_ptr() % 16 and z1.is_contiguous() and x1.is_contiguous()
    got = mk.markov_materialize_features_longT(z1, x1, lens, T=T, d=d, l=l)
    glob = mk._features_longT_kernel(z_t, x_t, lens, T=T, d=d, l=l, body="global")
    assert torch.equal(_bits(got), _bits(glob))


def test_k5_plan_matches_the_kernel(cuda):
    """The host plan's shared memory is the CUDA source's, its launch fits
    the card, and the compiled float32 shapes' build spills nothing."""
    for dtype in (torch.float32, torch.float64):
        for d, l in ((5, 3), (2, 4), (2, 3), (3, 2), (1, 3), (1, 1), (4, 4), (8, 8), (1, 8)):
            plan = mk.k5_plan(d, l, dtype)
            launch = mk._k5_config(cuda.index or 0, d, l, dtype)
            assert launch.smem == plan.smem and launch.threads == plan.threads and launch.blocks_per_sm >= 1
            if dtype == torch.float32 and plan.q == 1:
                assert launch.local_bytes == 0


def test_train_em_masked_kalman_cuda_f64_matches_cpu(cuda):
    """The masked-filter fit on the card in float64 (K7 every E step)
    lands where the CPU fit does."""
    rng = np.random.default_rng(12)
    T, n, d, l, C = 6, 3000, 2, 3, 2
    labels = rng.integers(0, C, size=n)
    z = rng.normal(size=(T, n, d)) + 4.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l)) - 3.0 * labels[None, :, None]
    z[rng.random(z.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = np.nan
    assign0 = np.where(rng.uniform(size=n) < 0.2, 1 - labels, labels)
    params0 = (
        np.full(C, 0.5), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
        np.zeros((C, d, d)), np.stack([np.eye(d)] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C),
    )
    fits = []
    for dev in ("cpu", "cuda"):
        t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        fits.append(tem.train_em_masked_kalman(
            tem.mixture_params_from_numpy(params0, device=dev, dtype=torch.float64),
            t(assign0, torch.int32), t(z), t(x),
        ))
    (p_c, a_c, i_c, s_c), (p_g, a_g, i_g, s_g) = fits
    assert (i_g, s_g) == (i_c, s_c) and s_c == tem.STATUS_CONVERGED
    assert torch.equal(a_g.cpu(), a_c)
    for x_c, x_g in zip(p_c, p_g):
        np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-8, atol=1e-8)


def test_train_em_markov_longT_cuda_f64_matches_cpu(cuda):
    """The long-T Markov fit on the card in float64 (K5 once, K1 on the
    canonical Φ every iteration) lands where the CPU fit does."""
    rng = np.random.default_rng(13)
    T, n, d, l, C = 80, 2000, 3, 2, 2
    labels = rng.integers(0, C, size=n)
    z = rng.normal(size=(T, n, d)) + 2.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l)) - 1.0 * labels[None, :, None]
    lens = rng.integers(4, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    assign0 = np.where(rng.uniform(size=n) < 0.2, 1 - labels, labels)
    params0 = (
        np.full(C, 0.5), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
        np.zeros((C, d, d)), np.stack([np.eye(d)] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C),
    )
    fits = []
    for dev in ("cpu", "cuda"):
        t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        before = mk.markov_materialize_features_longT.launches
        fits.append(tem.train_em_markov(
            tem.mixture_params_from_numpy(params0, device=dev, dtype=torch.float64),
            t(assign0, torch.int32), t(z), t(x), t(lens, torch.int32),
        ))
        assert mk.markov_materialize_features_longT.launches == before + (dev == "cuda")
    (p_c, a_c, i_c, s_c), (p_g, a_g, i_g, s_g) = fits
    assert (i_g, s_g) == (i_c, s_c) and s_c == tem.STATUS_CONVERGED
    assert torch.equal(a_g.cpu(), a_c)
    for x_c, x_g in zip(p_c, p_g):
        np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("wide", [False, True])
def test_em_multi_kernel_on_canonical_phi_at_pool_width(cuda, wide):
    """K3 on K5's canonical Φ (144 rows at d=5, l=3) at R=32, C=16, the
    pool's width: int16 statistics bit-equal to the plain sums and slot by
    slot to K1; a wide float32 Φ (the objectives' Φ) within 2e-5."""
    T, d, l, n, R, C = 70, 5, 3, 4099, 32, 16
    rng = np.random.default_rng(14)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)  # noqa: E731
    phi = mk.markov_materialize_features_longT(
        f32(z.transpose(0, 2, 1).reshape(T * d, n)), f32(x.transpose(0, 2, 1).reshape(T * l, n)),
        torch.tensor(lens, device=cuda), T=T, d=d, l=l,
    )
    assert phi.shape == (144, n)
    pq = mk.quantize_phi(phi)
    payload = phi if wide else pq.q
    wc = f32(rng.normal(size=(R, C, 144)) * 1e-3)
    prev = torch.tensor(rng.integers(0, C, size=(R, n)).astype(np.int32), device=cuda)
    prev[:, ::89] = -1
    force = torch.tensor([r % 3 == 0 for r in range(R)], dtype=torch.int32, device=cuda)
    a, c, s, macc, obj = mk.markov_em_compact_multi(payload, prev, wc, force)
    _a, c_p, _s, macc_p, _o = mk.markov_em_compact_multi_plain(
        payload, torch.where(prev >= 0, a, -1), wc, assign_mode="prev"
    )
    assert torch.equal(c, c_p)
    if wide:
        scale = macc_p.abs().amax().clamp_min(1.0)
        assert float((macc - macc_p).abs().max()) <= 2e-5 * float(scale)
    else:
        assert macc.dtype == torch.int64 and torch.equal(macc, macc_p)
    for r in (0, 1, 31):
        k1 = mk.markov_em_compact(payload, prev[r].contiguous(), wc[r].contiguous(),
                                  assign_mode="prev" if int(force[r]) else "argmax")
        assert torch.equal(a[r], k1[0]) and torch.equal(c[r], k1[1]) and torch.equal(s[r], k1[2])


def _raw_batch_inputs(cuda, dtype, T, d, l, n, C=16, seed=20, nan_cluster=False):
    """Suffix data as the transposed batch, ``prev`` with lanes left out,
    and random mixture weights, grouped and canonical, log π folded (one
    cluster's NaN under ``nan_cluster``), on the card in ``dtype``."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    params = tem.mixture_params_from_numpy(
        (np.full(C, 1.0 / C), rng.normal(size=(C, d)), eye(d), rng.normal(scale=0.3, size=(C, d, d)),
         eye(d), rng.normal(size=(C, d, l)), eye(l)), device="cpu")
    W1, W2, W3 = tem._grouped_weights(params)
    if nan_cluster:
        W1[2] = torch.nan
    W = [w.to(dtype=dtype, device=cuda) for w in (W1, W2, W3)]
    Wg = mops.canonical_weights(*W, d=d, l=l)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    prev = torch.tensor(rng.integers(0, C, size=n).astype(np.int32), device=cuda)
    prev[::97] = -1
    return (t(z.transpose(0, 2, 1).reshape(T * d, n)), t(x.transpose(0, 2, 1).reshape(T * l, n)),
            torch.tensor(lens, device=cuda), prev, W, Wg)


def _raw_batch_call(kernel, inputs, T, d, l, assign_mode="argmax", plain=False):
    z_t, x_t, lens, prev, W, Wg = inputs
    kw = dict(T=T, d=d, l=l)
    if kernel == "K10":
        fn = mk.markov_assign_suffix_plain if plain else mk.markov_assign_suffix
        return fn(z_t, x_t, lens, prev, *W, **kw)
    if kernel == "K6":
        fn = mk.markov_em_fused_longT_plain if plain else mk.markov_em_fused_longT
        return fn(z_t, x_t, lens, prev, *W, assign_mode=assign_mode, **kw)
    fn = mk.markov_em_fused_plain if plain else mk.markov_em_fused
    return fn(z_t, x_t, lens, prev, Wg, assign_mode=assign_mode, **kw)


@pytest.mark.parametrize("kernel,assign_mode", [("K6", "argmax"), ("K6", "prev"), ("K10", "argmax"),
                                                ("K11", "argmax"), ("K11", "prev")])
@pytest.mark.parametrize("T,d,l", [(70, 5, 3), (10, 2, 4), (12, 4, 3)])
@pytest.mark.parametrize("dtype,tie,rel", [(torch.float32, 1e-4, 1e-4), (torch.float64, 1e-9, 1e-10)])
def test_raw_batch_kernels_match_plain(cuda, kernel, assign_mode, T, d, l, dtype, tie, rel):
    """K6, K10 and K11 against their plain versions at a ragged n: the
    first-max assignments off the float64 scores only at near ties, prev
    mode keeping prev, left-out lanes marked C, counts and switches those
    of the assignment, the objective within ``rel`` of the float64 scores'
    sum, the statistics (under the kernel's assignment) within ``rel`` of
    the plain version's largest; two calls bit-identical."""
    n, C = 4099, 16
    inputs = _raw_batch_inputs(cuda, dtype, T, d, l, n, C)
    z_t, x_t, lens, prev, W, Wg = inputs
    launches = {"K6": mk.markov_em_fused_longT, "K10": mk.markov_assign_suffix, "K11": mk.markov_em_fused}[kernel]
    before = launches.launches
    out = _raw_batch_call(kernel, inputs, T, d, l, assign_mode)
    assert launches.launches == before + 1
    again = _raw_batch_call(kernel, inputs, T, d, l, assign_mode)
    assert all(torch.equal(p, q) for p, q in zip(out, again))
    a, c, s = out[:3]
    valid = prev >= 0
    assert bool((a[~valid] == C).all())
    assert torch.equal(c.long(), torch.bincount(a[valid].long(), minlength=C))
    phi64 = mk.markov_materialize_features_longT_plain(z_t.double(), x_t.double(), lens, T=T, d=d, l=l)
    scores = Wg.double() @ phi64[: Wg.shape[1]]
    if assign_mode == "prev":
        assert bool((a[valid] == prev[valid]).all()) and int(s) == 0
    else:
        top2 = scores.topk(2, dim=0).values
        near = (top2[0] - top2[1]) < tie * (1 + top2[0].abs())
        assert bool(((a == scores.argmax(dim=0).to(torch.int32)) | near | ~valid).all())
        assert int(s) == int(((a != prev) & valid).sum())
    if kernel == "K10":
        return
    g, obj = out[3], out[4]
    if assign_mode == "argmax":
        ref = float(torch.where(valid, scores.gather(0, a.clamp_max(C - 1).long()[None])[0], 0.0).sum())
        assert abs(float(obj) - ref) <= rel * abs(ref)
    else:
        assert float(obj) == 0.0
    want = _raw_batch_call("K6", (z_t, x_t, lens, torch.where(valid, a, -1), W, Wg), T, d, l, "prev", plain=True)
    assert torch.equal(c, want[1])
    scale = want[3].abs().amax().clamp_min(1.0)
    assert float((g - want[3]).abs().max()) <= rel * float(scale)


def _raw_batch_edges(inputs, T, d, l):
    """``_raw_batch_inputs``'s batch with the plan's edges: every 53rd row
    all NaN (extent 0), every 31st with finite values for three steps past
    its length, one +Inf and one -Inf entry."""
    z_t, x_t, lens = (a.clone() for a in inputs[:3])
    n = lens.shape[0]
    z3, x3 = z_t.view(T, d, n), x_t.view(T, l, n)
    t = torch.arange(T, device=lens.device)[:, None]
    past = (t >= lens[None, :]) & (t < lens[None, :] + 3)
    past &= (torch.arange(n, device=lens.device) % 31 == 0)[None, :]
    z3.copy_(torch.where(past[:, None, :], 0.5, z3))
    x3.copy_(torch.where(past[:, None, :], -0.25, x3))
    z_t[:, ::53], x_t[:, ::53] = torch.nan, torch.nan
    z_t[0, 7], x_t[1, 11] = torch.inf, -torch.inf
    return (z_t, x_t, lens, *inputs[3:])


@pytest.mark.parametrize("kernel,assign_mode", [("K6", "argmax"), ("K6", "prev"), ("K10", "argmax"),
                                                ("K11", "argmax"), ("K11", "prev")])
@pytest.mark.parametrize("T,d,l", [(70, 5, 3), (12, 4, 3)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_raw_batch_kernels_planned_match_unplanned(cuda, kernel, assign_mode, T, d, l, dtype, rel):
    """K6, K10 and K11 on the planned batch (rows by extent, each stopping
    at its extent; n = 4099, neither a multiple of the tile nor of 4;
    extent-0 rows, finite values past a row's length, ±Inf): the
    assignments scattered back equal the unplanned call's bit for bit (the
    skip is exact, so every score is), counts and switches too, and the
    objective and statistics within ``rel`` of the unplanned call's
    (another summation order); two planned calls bit-identical.  The
    plain version under the plan is the plain version without one, bit
    for bit."""
    n = 4099
    inputs = _raw_batch_edges(_raw_batch_inputs(cuda, dtype, T, d, l, n, 16, seed=23), T, d, l)
    z_t, x_t, lens, prev, W, Wg = inputs
    plan = mk.raw_batch_plan(z_t, x_t, T=T, d=d, l=l)
    assert int(plan.extent.min()) == 0 and bool((plan.extent[:-1] >= plan.extent[1:]).all())
    rows = plan.rows.long()
    planned = (z_t.index_select(1, plan.rows), x_t.index_select(1, plan.rows), lens[rows], prev[rows], W, Wg)
    kw = dict(T=T, d=d, l=l, plan=plan)
    if kernel == "K10":
        call = lambda fn=mk.markov_assign_suffix: fn(*planned[:4], *W, **kw)  # noqa: E731
    elif kernel == "K6":
        call = lambda fn=mk.markov_em_fused_longT: fn(*planned[:4], *W, assign_mode=assign_mode, **kw)  # noqa: E731
    else:
        call = lambda fn=mk.markov_em_fused: fn(*planned[:4], Wg, assign_mode=assign_mode, **kw)  # noqa: E731
    out = call()
    assert all(torch.equal(p, q) for p, q in zip(out, call()))
    ref = _raw_batch_call(kernel, inputs, T, d, l, assign_mode)
    assert torch.equal(torch.empty_like(out[0]).index_copy_(0, rows, out[0]), ref[0])
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
    plain = call({"K6": mk.markov_em_fused_longT_plain, "K10": mk.markov_assign_suffix_plain,
                  "K11": mk.markov_em_fused_plain}[kernel])
    plain_ref = _raw_batch_call(kernel, inputs, T, d, l, assign_mode, plain=True)
    assert torch.equal(torch.empty_like(plain[0]).index_copy_(0, rows, plain[0]), plain_ref[0])
    assert all(torch.equal(p, q) for p, q in zip(plain[1:], plain_ref[1:]))
    if kernel != "K10":
        scale = ref[3].abs().amax().clamp_min(1.0)
        assert float((out[3] - ref[3]).abs().max()) <= rel * float(scale)
        assert abs(float(out[4]) - float(ref[4])) <= rel * max(abs(float(ref[4])), 1.0)


def test_k6_planned_statistics_equal_k5_then_k1(cuda):
    """K6 on a planned batch with extent-0 rows and values past a row's
    length equals K5 then K1 on the same (permuted) batch: assignments,
    counts and switches exactly, statistics and objective to 1e-12
    relative (float64)."""
    T, d, l, n, C = 70, 5, 3, 8197, 16
    z_t, x_t, lens, prev, W, Wg = _raw_batch_edges(
        _raw_batch_inputs(cuda, torch.float64, T, d, l, n, C, seed=24), T, d, l)
    plan = mk.raw_batch_plan(z_t, x_t, T=T, d=d, l=l)
    z_t, x_t, lens, prev = (a.index_select(-1, plan.rows).contiguous() for a in (z_t, x_t, lens, prev))
    phi = mk.markov_materialize_features_longT(z_t, x_t, lens, T=T, d=d, l=l)
    k1 = mk.markov_em_from_features(phi, prev, Wg, T=T, d=d, l=l)
    k6 = mk.markov_em_fused_longT(z_t, x_t, lens, prev, *W, T=T, d=d, l=l, plan=plan)
    for p, q in zip(k1[:3], k6[:3]):
        assert torch.equal(p, q)
    assert float((k1[3] - k6[3]).abs().max()) <= 1e-12 * float(k1[3].abs().amax())
    assert abs(float(k1[4]) - float(k6[4])) <= 1e-12 * abs(float(k1[4]))


def test_raw_batch_kernels_nan_cluster(cuda):
    """A cluster with NaN weights takes every valid row (the first NaN
    score wins, as ``jnp.argmax``), and the objective is NaN."""
    T, d, l = 10, 5, 3
    inputs = _raw_batch_inputs(cuda, torch.float32, T, d, l, 2053, nan_cluster=True)
    valid = inputs[3] >= 0
    for kernel in ("K6", "K10", "K11"):
        out = _raw_batch_call(kernel, inputs, T, d, l)
        assert bool((out[0][valid] == 2).all()), kernel
        if kernel != "K10":
            assert bool(torch.isnan(out[4]))


def test_k6_statistics_equal_k5_then_k1(cuda):
    """K6 builds K5's Φ column in shared memory and runs K1's step on it:
    its assignments, counts and switches equal K1's on K5's canonical Φ,
    its statistics and objective to 1e-12 relative (float64)."""
    T, d, l, n, C = 70, 5, 3, 8197, 16
    z_t, x_t, lens, prev, W, Wg = _raw_batch_inputs(cuda, torch.float64, T, d, l, n, C, seed=21)
    phi = mk.markov_materialize_features_longT(z_t, x_t, lens, T=T, d=d, l=l)
    k1 = mk.markov_em_from_features(phi, prev, Wg, T=T, d=d, l=l)
    k6 = mk.markov_em_fused_longT(z_t, x_t, lens, prev, *W, T=T, d=d, l=l)
    for p, q in zip(k1[:3], k6[:3]):
        assert torch.equal(p, q)
    scale = k1[3].abs().amax()
    assert float((k1[3] - k6[3]).abs().max()) <= 1e-12 * float(scale)
    assert abs(float(k1[4]) - float(k6[4])) <= 1e-12 * abs(float(k1[4]))


def test_raw_batch_kernels_refuse_bad_arguments(cuda):
    T, d, l = 10, 5, 3
    z_t, x_t, lens, prev, W, Wg = _raw_batch_inputs(cuda, torch.float32, T, d, l, 1000, C=4)
    kw = dict(T=T, d=d, l=l)
    with pytest.raises(ValueError):
        mk.markov_em_fused_longT(z_t, x_t.double(), lens, prev, *W, **kw)
    with pytest.raises(ValueError):
        mk.markov_em_fused_longT(z_t, x_t, lens.long(), prev, *W, **kw)
    with pytest.raises(ValueError):
        mk.markov_em_fused(z_t[:, ::2], x_t[:, ::2], lens[::2], prev[::2], Wg, **kw)
    with pytest.raises(ValueError, match="at most"):
        mk.markov_em_fused(z_t, x_t, lens, prev, torch.zeros((33, Wg.shape[1]), device=cuda), **kw)
    big = _raw_batch_inputs(cuda, torch.float32, 2, 9, 1, 100, C=2)
    with pytest.raises(ValueError, match="at most"):
        mk.markov_assign_suffix(*big[:4], *big[4], T=2, d=9, l=1)


def test_train_em_markov_precompute_off_longT_cuda_f64_matches_cpu(cuda):
    """The long-T fit without Φ on the card in float64 (K6 every
    iteration) lands where the CPU fit does, and where the fit through Φ
    does."""
    rng = np.random.default_rng(15)
    T, n, d, l, C = 80, 2000, 3, 2, 2
    labels = rng.integers(0, C, size=n)
    z = rng.normal(size=(T, n, d)) + 2.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l)) - 1.0 * labels[None, :, None]
    lens = rng.integers(4, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    assign0 = np.where(rng.uniform(size=n) < 0.2, 1 - labels, labels)
    params0 = (
        np.full(C, 0.5), rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
        np.zeros((C, d, d)), np.stack([np.eye(d)] * C),
        rng.normal(size=(C, d, l)), np.stack([np.eye(l)] * C),
    )
    fits = []
    for dev, precompute in (("cpu", False), ("cuda", False), ("cuda", True)):
        t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        before = mk.markov_em_fused_longT.launches
        fits.append(tem.train_em_markov(
            tem.mixture_params_from_numpy(params0, device=dev, dtype=torch.float64),
            t(assign0, torch.int32), t(z), t(x), t(lens, torch.int32), precompute=precompute,
        ))
        launched = mk.markov_em_fused_longT.launches - before
        assert launched == (fits[-1][2] + 1 if dev == "cuda" and not precompute else 0)
    (p_c, a_c, i_c, s_c) = fits[0]
    assert s_c == tem.STATUS_CONVERGED
    for p_g, a_g, i_g, s_g in fits[1:]:
        assert (i_g, s_g) == (i_c, s_c)
        assert torch.equal(a_g.cpu(), a_c)
        for x_c, x_g in zip(p_c, p_g):
            np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_statespace_api_and_the_lg_component_launch_k12(cuda, dtype):
    """The function API's hot kernel and the linear-Gaussian component's
    score take K12 once a call on the card, with the CPU's grouped form's
    values (float64 1e-10 relative, float32 1e-4·(1 + |ll|))."""
    from multimodal_trajectory_modeling_tpu_torch.models import statespace_api as ssapi
    from multimodal_trajectory_modeling_tpu_torch.models.linear_gaussian import StateSpaceLinearGaussian

    rng = np.random.default_rng(20)
    T, n, d, l = 4, 571, 2, 4
    z, x = rng.normal(size=(T, n, d)), rng.normal(size=(T, n, l))
    z[rng.random(z.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = np.nan
    x[0, 3, 1] = np.inf
    on_card = StateSpaceLinearGaussian(alpha=1.0, device="cuda", dtype=dtype).fit((z, x))
    on_cpu = StateSpaceLinearGaussian(alpha=1.0, device="cpu", dtype=dtype).fit((z, x))
    before = ek.estep_logliks_pallas.launches
    got = on_card.score()
    assert ek.estep_logliks_pallas.launches == before + 1
    want = on_cpu.score()
    tol = 1e-10 * np.maximum(np.abs(want), 1.0) if dtype == torch.float64 else 1e-4 * (1 + np.abs(want))
    assert np.isfinite(got).all() and (np.abs(got - want) <= tol).all()
    got_alt = on_card.score_alt()
    assert ek.estep_logliks_pallas.launches == before + 2
    np.testing.assert_array_equal(got_alt.astype(float), got)
    v, mean, cov = ssapi._pack(z, x), *on_card._moments(T)
    p = np.empty(n)
    ssapi.multivariate_normal_log_likelihood(v, mean, cov, p, device="cuda", dtype=dtype)
    assert ek.estep_logliks_pallas.launches == before + 3
    np.testing.assert_array_equal(p, got)


@pytest.mark.parametrize("stream_threshold", [10**9, 300])
def test_knn_device_paths_on_the_card(cuda, monkeypatch, stream_threshold):
    """``KNNRegressor`` past its work threshold on the card (dense, or
    streaming past 300 training rows): float64 within 1e-9 of the host
    path, and on duplicated training rows the lower training index."""
    from multimodal_trajectory_modeling_tpu_torch.ops import knn

    monkeypatch.setattr(knn, "_DEVICE_WORK_THRESHOLD", 1)
    monkeypatch.setattr(knn, "_STREAM_TRAIN_THRESHOLD", stream_threshold)
    rng = np.random.default_rng(21)
    X, Y, Q = rng.normal(size=(1000, 5)), rng.normal(size=(1000, 3)), rng.normal(size=(300, 5))
    got = knn.KNNRegressor(10, device="cuda", dtype=torch.float64).fit(X, Y).predict(Q)
    np.testing.assert_allclose(got, knn._knn_predict_np(X, Y, Q, 10), rtol=1e-9, atol=1e-9)
    base = X[:400]
    Xd = np.concatenate([base, base, base])
    Yd = rng.normal(size=(1200, 3))
    Qd = base[:100] + 0.0
    d2 = ((Qd[:, None, :] - Xd[None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")
    for k in (1, 2, 5):
        got = knn.KNNRegressor(k, device="cuda", dtype=torch.float64).fit(Xd, Yd).predict(Qd)
        np.testing.assert_allclose(got, Yd[order[:, :k]].mean(1), rtol=1e-12, atol=1e-12)


# K16 (csrc/phi_stream.cu): seed·0 + Σφ over the whole buffer.  int16 wraps
# modulo 2³² and equals the plain version exactly; float32 and bfloat16 sum
# as float and agree with the float64 sum to 2e-6·Σ|φ|; two calls give the
# same bits; a NaN seed gives NaN.  n covers a tail shorter than a vector,
# one vector, and sizes past one block's loads and past the persistent grid;
# the tile is the default (1024 vectors: one pass of a block's loop a tile)
# and bench_phi_floor's 8192 and 16384 elements (two to four passes).
@pytest.mark.parametrize("tile", [None, 8192, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int16])
@pytest.mark.parametrize("shape", [(1, 3), (8, 5000), (7, 20011), (112, 100_003)])
def test_phi_stream_matches_plain(cuda, dtype, shape, tile):
    from multimodal_trajectory_modeling_tpu_torch.ops import phi_stream as ps

    rng = np.random.default_rng(16)
    base = rng.normal(size=shape).astype(np.float32)
    if dtype == torch.int16:
        phi = torch.tensor(np.clip(base * 1000, -32000, 32000).astype(np.int16), device=cuda)
    else:
        phi = torch.tensor(base, device=cuda).to(dtype)
    seed = torch.zeros((), dtype=ps.accumulator_dtype(dtype), device=cuda)
    before = ps.phi_stream_sum.launches
    got = ps.phi_stream_sum(phi, seed, tile=tile)
    again = ps.phi_stream_sum(phi, got, tile=tile)
    assert ps.phi_stream_sum.launches == before + 2
    want = ps.phi_stream_sum_plain(phi, seed)
    assert got.dtype == ps.accumulator_dtype(dtype)
    if dtype == torch.int16:
        assert int(got) == int(want) == int(again)
    else:
        scale = float(phi.double().abs().sum())
        assert abs(float(got) - float(want)) <= 2e-6 * scale
        assert got.view(torch.int32).item() == again.view(torch.int32).item()
    if dtype != torch.int16:
        nan = ps.phi_stream_sum(phi, torch.tensor(float("nan"), device=cuda), tile=tile)
        assert bool(torch.isnan(nan))


def test_phi_stream_wraps_and_refuses(cuda):
    from multimodal_trajectory_modeling_tpu_torch.ops import phi_stream as ps

    big = torch.full((4, 1 << 20), 32767, dtype=torch.int16, device=cuda)
    seed = torch.zeros((), dtype=torch.int32, device=cuda)
    assert int(ps.phi_stream_sum(big, seed)) == int(ps.phi_stream_sum_plain(big, seed))
    with pytest.raises(ValueError):
        ps.phi_stream_sum(big[:, 1:], seed)  # not contiguous
    flat = torch.zeros(1 << 12, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        ps.phi_stream_sum(flat[1:], torch.zeros((), device=cuda))  # 4-byte aligned only
    with pytest.raises(ValueError):
        ps.phi_stream_sum(flat, seed)  # int32 seed for float Φ
