"""The CUDA kernels K1 and K2 against their plain torch versions on the
card.  Without a card every test here skips; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports jax, which the card's
machine does not have; this file imports only torch and numpy.)

Tolerances: K2 differs from its plain version only in summation order and
in summing the masked rows directly, so each row agrees to 1e-5 (float32)
or 1e-12 (float64) of its absmax.  K1 under int16 Φ sums integers, so its
statistics are exact; its float32 scores may flip an argmax only where the
float64 top-2 gap is below 1e-4·(1 + |score|).
"""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu_torch.models import em as tem
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
