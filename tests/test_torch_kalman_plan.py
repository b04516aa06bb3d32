"""K7's plan and its one log a step, on the CPU.

K7 takes the rows in a plan's order (``ops/kalman_kernels.py:
masked_plan``): each row's extent (1 + its last step with a finite z or
x entry, 0 for none) and the rows ordered by extent, longest first, ties
in row order; each row stops at its extent.  Here the plan is held to a
numpy reference (all-NaN rows, a row whose only finite entry is x at the
last step or z at t = 0, ties), the planned batch to the caller's batch
permuted, and the skip to the plain version: the plain filter with each
row stopped at its extent (``masked_filter_scan(..., extent=)``) equals
the plain filter over all T bit for bit (``torch.equal``) in float64 and
float32, on suffix and per-coordinate missingness and on an expansive
transition whose state overflows after t = 2; it also equals the JAX
package's Pallas kernel in interpret mode within 1e-10 relative.  The
kernel's log of the product of the pivots (``pivot_log_sum``, its
arithmetic in torch) is held to the sum of the logs in float64 within
1e-12 (mantissa products round once a factor), and where a pivot is
zero, negative, infinite or NaN to the plain version's class: ``log s``
for a z pivot, ``2 log(s rsqrt s)`` for an x pivot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops.pallas_kalman import (
    kalman_masked_logliks_pallas as jax_pallas,
)
from multimodal_trajectory_modeling_tpu_torch.ops import kalman as tk
from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk


def _data(seed, T, n, d, l, kind):
    """``suffix``: NaN past a length drawn from 0..T; ``per-coordinate``:
    30% of the entries NaN as well.  Either way rows 0-1 are all NaN, row
    2 is finite only in x at the last step, row 3 only in z at t = 0."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    past = np.arange(T)[:, None] >= rng.integers(0, T + 1, size=n)[None, :]
    z[past] = np.nan
    x[past] = np.nan
    if kind == "per-coordinate":
        z[rng.random(z.shape) < 0.3] = np.nan
        x[rng.random(x.shape) < 0.3] = np.nan
    z[:, :4] = np.nan
    x[:, :4] = np.nan
    x[T - 1, 2, l - 1] = 1.5
    z[0, 3, 0] = -0.5
    return z, x, rng


def _params(rng, C, d, l, a_scale=0.3):
    return (
        rng.normal(size=(C, d)),
        np.stack([np.eye(d) * 0.8 + 0.05] * C),
        rng.normal(scale=a_scale, size=(C, d, d)),
        np.stack([np.eye(d) * 0.5] * C),
        rng.normal(size=(C, d, l)),
        np.stack([np.eye(l) * 0.4 + 0.1] * C),
    )


def _numpy_plan(z, x):
    T = z.shape[0]
    seen = np.isfinite(z).any(2) | np.isfinite(x).any(2)  # NaN is the only non-finite here
    extent = np.where(seen, np.arange(1, T + 1)[:, None], 0).max(0)
    order = np.argsort(T - extent, kind="stable")
    return order, extent[order]


@pytest.mark.parametrize("kind", ["suffix", "per-coordinate"])
@pytest.mark.parametrize("T,n", [(7, 300), (1, 50), (12, 129)])
def test_plan_matches_numpy(T, n, kind):
    z, x, _rng = _data(T * 100 + n, T, n, 3, 2, kind)
    rows, extent = kk.masked_plan(*kk.pack_masked_kalman(torch.from_numpy(z), torch.from_numpy(x)))
    order, ext = _numpy_plan(z, x)
    assert rows.dtype == extent.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), order)
    np.testing.assert_array_equal(extent.numpy(), ext)
    by_row = dict(zip(order.tolist(), ext.tolist()))
    assert by_row[0] == by_row[1] == 0 and by_row[2] == T and by_row[3] == 1
    assert (np.diff(ext) <= 0).all()
    for e in np.unique(ext):  # ties keep the rows' order
        assert (np.diff(order[ext == e]) > 0).all()


def test_planned_batch_is_the_batch_in_plan_order():
    z, x, _rng = _data(5, 6, 200, 4, 3, "per-coordinate")
    zt, xt = torch.from_numpy(z), torch.from_numpy(x)
    zp, xp, plan = kk.plan_masked_batch(zt, xt)
    zc, xc = kk.pack_masked_kalman(zt, xt)
    assert zp.is_contiguous() and xp.is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(plan, kk.masked_plan(zc, xc)))
    rows = plan.rows.long()
    assert torch.equal(zp.nan_to_num(7.0), zc[:, :, rows].nan_to_num(7.0))
    assert torch.equal(xp.nan_to_num(7.0), xc[:, :, rows].nan_to_num(7.0))


def _scan(zp, xp, params, extent=None):
    oz, ox = zp == zp, xp == xp
    dtype = zp.dtype
    return tk.masked_filter_scan(
        torch.where(oz, zp, 0.0), torch.where(ox, xp, 0.0), oz.to(dtype), ox.to(dtype),
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in params), extent=extent,
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["suffix", "per-coordinate"])
@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (1, 1)])
def test_stopping_at_the_extent_is_bit_exact(d, l, kind, dtype):
    """Each row run to its extent gives the same bits as all T steps."""
    z, x, rng = _data(d * 10 + l, 9, 150, d, l, kind)
    params = _params(rng, 3, d, l)
    zp, xp = kk.pack_masked_kalman(torch.from_numpy(z).to(dtype), torch.from_numpy(x).to(dtype))
    rows, extent = kk.masked_plan(zp, xp)
    by_row = torch.empty_like(extent)
    by_row[rows.long()] = extent
    full = _scan(zp, xp, params)
    assert torch.equal(_scan(zp, xp, params, by_row), full)
    assert int(extent.min()) < int(extent.max())  # the data has short rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stopping_at_the_extent_is_bit_exact_when_the_state_overflows(dtype):
    """A = 30 I over 38 unobserved steps (P grows 900-fold a step and
    overflows in float32): the full filter's log-density is the one of
    the first two steps, bit for bit."""
    rng = np.random.default_rng(3)
    T, n, d, l = 40, 40, 5, 3
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[2:], x[2:] = np.nan, np.nan
    z[0, ::3, 1] = np.nan
    eye = lambda k: np.eye(k)[None]  # noqa: E731
    params = (np.zeros((1, d)), eye(d), 30.0 * eye(d), eye(d), rng.normal(size=(1, d, l)), eye(l))
    zp, xp = kk.pack_masked_kalman(torch.from_numpy(z).to(dtype), torch.from_numpy(x).to(dtype))
    _rows, extent = kk.masked_plan(zp, xp)
    assert bool((extent == 2).all())
    full = _scan(zp, xp, params)
    assert bool(torch.isfinite(full).all())
    assert torch.equal(_scan(zp, xp, params, extent), full)


@pytest.mark.parametrize("d,l", [(5, 3), (2, 3)])
def test_stopped_filter_matches_jax_kernel(d, l):
    """The plain filter stopped at each row's extent against the JAX
    Pallas kernel in interpret mode (1e-10 relative)."""
    z, x, rng = _data(d + 11 * l, 8, 90, d, l, "per-coordinate")
    params = _params(rng, 2, d, l)
    want = np.asarray(jax_pallas(*map(jnp.asarray, (z, x, *params)), interpret=True))
    zp, xp, plan = kk.plan_masked_batch(torch.from_numpy(z), torch.from_numpy(x))
    got = torch.empty(want.shape, dtype=torch.float64)
    got[:, plan.rows.long()] = _scan(zp, xp, params, plan.extent)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    assert (got[:, :2] == 0.0).all()


@pytest.mark.parametrize("d,l", [(5, 3), (1, 1)])
def test_k7_plain_takes_a_plan(d, l):
    """The wrapper on CPU tensors with the planned batch gives the
    caller's row order: the values of the unplanned call (1e-12: a row
    may sit in another SIMD lane), and refuses a malformed plan."""
    z, x, rng = _data(d * 7 + l, 6, 120, d, l, "per-coordinate")
    params = [torch.from_numpy(a) for a in _params(rng, 3, d, l)]
    zp, xp, plan = kk.plan_masked_batch(torch.from_numpy(z), torch.from_numpy(x))
    got = kk.kalman_masked_logliks_packed(zp, xp, *params, plan=plan)
    want = kk.kalman_masked_logliks_packed(*kk.pack_masked_kalman(torch.from_numpy(z), torch.from_numpy(x)), *params)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    assert (got[:, :2] == 0.0).all()
    with pytest.raises(ValueError, match="plan"):
        kk.kalman_masked_logliks_packed(zp, xp, *params, plan=kk.MaskedPlan(plan.rows.long(), plan.extent))
    with pytest.raises(ValueError, match="plan"):
        kk.kalman_masked_logliks_packed(zp, xp, *params, plan=kk.MaskedPlan(plan.rows[1:], plan.extent[1:]))


def _sum_of_logs(s_z, obs_z, s_x):
    """The plain version's terms: log s for an observed z pivot, 2 log(s
    rsqrt s) for an x pivot."""
    z = torch.where(obs_z, torch.log(s_z), 0.0).sum(-1)
    return z + (2.0 * torch.log(s_x * torch.rsqrt(s_x))).sum(-1)


def test_pivot_log_sum_matches_the_sum_of_logs():
    rng = np.random.default_rng(0)
    m, d, l = 4000, 5, 3
    s_z = torch.from_numpy(np.exp(rng.uniform(-30, 30, size=(m, d))))
    s_x = torch.from_numpy(np.exp(rng.uniform(-30, 30, size=(m, l))))
    s_z[:5, 0] = torch.tensor([5e-324, 1e-310, 2.2e-308, 1.7e308, 1.0], dtype=torch.float64)  # subnormal and extremes
    s_x[5:8, 1] = torch.tensor([4e-320, 1e-300, 1e300], dtype=torch.float64)
    obs_z = torch.from_numpy(rng.random((m, d)) < 0.7)
    obs_z[:5, 0] = True
    got = kk.pivot_log_sum(s_z, obs_z, s_x)
    want = torch.where(obs_z, torch.log(s_z), 0.0).sum(-1) + torch.log(s_x).sum(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    f32 = kk.pivot_log_sum(s_z[5:].float().clamp(1e-30, 1e30), obs_z[5:], s_x[5:].float().clamp(1e-30, 1e30))
    want32 = _sum_of_logs(s_z[5:].clamp(1e-30, 1e30), obs_z[5:], s_x[5:].clamp(1e-30, 1e30))
    np.testing.assert_allclose(f32.double().numpy(), want32.numpy(), rtol=1e-5, atol=1e-4)


_ODD = {
    "z zero": ([0.0, 2.0], [1.5]),
    "z minus zero": ([-0.0, 2.0], [1.5]),
    "z negative": ([-1.0, 2.0], [1.5]),
    "z inf": ([float("inf"), 2.0], [1.5]),
    "z nan": ([float("nan"), 2.0], [1.5]),
    "z zero and inf": ([0.0, float("inf")], [1.5]),
    "z zero, unobserved": ([2.0, 0.0], [1.5]),
    "z subnormal": ([1e-40, 2.0], [1.5]),
    "x zero": ([1.0, 2.0], [0.0]),
    "x negative": ([1.0, 2.0], [-3.0]),
    "x inf": ([1.0, 2.0], [float("inf")]),
    "x nan": ([1.0, 2.0], [float("nan")]),
    "x subnormal": ([1.0, 2.0], [1e-41]),
}


def _class(v):
    return "nan" if np.isnan(v) else "+inf" if v == np.inf else "-inf" if v == -np.inf else "finite"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(_ODD))
def test_pivot_log_sum_keeps_the_plain_class(case, dtype):
    zs, xs = _ODD[case]
    s_z = torch.tensor([zs], dtype=dtype)
    s_x = torch.tensor([xs], dtype=dtype)
    obs_z = torch.tensor([[True, "unobserved" not in case]])
    got = float(kk.pivot_log_sum(s_z, obs_z, s_x)[0])
    want = float(_sum_of_logs(s_z, obs_z, s_x)[0])
    assert _class(got) == _class(want), (got, want)
    if _class(want) == "finite":
        assert abs(got - want) <= 1e-5 * (1 + abs(want))
