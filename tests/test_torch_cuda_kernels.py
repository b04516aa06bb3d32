"""The CUDA kernels K1, K2, K3, K4a and K4b against their plain torch
versions on the card.  Without a card every test here skips; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports jax, which the card's
machine does not have; this file imports only torch and numpy.)

Tolerances: K2 differs from its plain version only in summation order and
in summing the masked rows directly, so each row agrees to 1e-5 (float32)
or 1e-12 (float64) of its absmax.  K1 under int16 Φ sums integers, so its
statistics are exact; its float32 scores may flip an argmax only where the
float64 top-2 gap is below 1e-4·(1 + |score|).  K3 is K1 for R restarts:
slot r equals a K1 call on slot r's weights bit for bit (assignments,
counts, switches, int16 statistics, objective).
K4a/K4b rebuild Φ from the packed batch in f32/f64: their objectives agree
with the plain versions to 1e-5 (f32) or 1e-10 (f64) relative.  Every
kernel gives the same bits from run to run, float statistics included.
"""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

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


def _multi_inputs(cuda, C=16, R=5, n=20037, seed=5):
    pq, _wc, _prev = _em_inputs(cuda, C=C, n=n, seed=seed)
    rng = np.random.default_rng(seed)
    wc = torch.tensor(rng.normal(size=(R, C, pq.q.shape[0])) * 1e-3, dtype=torch.float32, device=cuda)
    prev = torch.tensor(rng.integers(0, C, size=(R, n)).astype(np.int32), device=cuda)
    prev[:, ::89] = -1
    force = torch.tensor([i % 2 for i in range(R)], dtype=torch.int32, device=cuda)
    return pq, wc, prev, force


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("C", [3, 16, 32])
def test_em_multi_kernel_matches_plain_and_k1(cuda, assign_mode, C):
    pq, wc, prev, force = _multi_inputs(cuda, C=C)
    R, C, _F = wc.shape
    before = mk.markov_em_compact_multi.launches
    a, c, s, macc, obj = mk.markov_em_compact_multi(pq.q, prev, wc, force, assign_mode=assign_mode)
    assert mk.markov_em_compact_multi.launches == before + 1
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


def _packed_inputs(cuda, dtype, C=16, R=4, n=20037, seed=6, nan_cluster=None):
    T, d, l = 10, 5, 3
    u, lens = _batch(T, d, l, n, seed, dtype, cuda)
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
