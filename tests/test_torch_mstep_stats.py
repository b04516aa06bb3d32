"""K15's (z, x) form on the CPU, float64: ``mstep_stats_zx`` (the masked M
step's statistics read from the ``(T, n, ·)`` tensors) against the packed
form ``mstep_stats_pallas`` bit for bit and against the JAX package's
``mstep_stats_pallas`` (its Pallas kernel in interpret mode) to 1e-12
relative; the pair rule (one non-finite coordinate drops the whole pair),
rows of no cluster, one cluster and a batch of one step; the views the
card's wrapper hands the kernel; and the masked trainer reaching K15's
wrapper once per M step.  The kernel itself is held against the plain
version on the card (``test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import pallas_mstep as jpm
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as tmk

REL = dict(rtol=1e-12, atol=1e-12)


def _batch(seed, T=6, n=257, d=3, l=2, C=4, p=0.1):
    """Gapped states and observations ``(T, n, ·)`` (each coordinate
    missing with probability p, |x| up to ~50) and an assignment with
    rows of no cluster (C and -1)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * rng.uniform(0.5, 20.0, size=(1, n, 1))
    x = rng.normal(size=(T, n, l)) * 10.0
    z[rng.uniform(size=z.shape) < p] = np.nan
    x[rng.uniform(size=x.shape) < p] = np.nan
    assign = rng.integers(0, C, size=n).astype(np.int32)
    assign[::31] = C
    assign[5::37] = -1
    return z, x, assign


def _pack(z, x):
    T, n, _d = z.shape
    return np.concatenate([z.transpose(1, 0, 2).reshape(n, -1), x.transpose(1, 0, 2).reshape(n, -1)], 1)


def _zx(z, x, assign, C):
    return tmk.mstep_stats_zx(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(assign), n_clusters=C)


_CASES = {
    "gapped": dict(seed=0),
    "one-cluster": dict(seed=1, C=1),
    "one-step": dict(seed=2, T=1),
    "wide": dict(seed=3, d=5, l=3, C=3, T=4),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_zx_plain_equals_packed_plain_bit_for_bit(case):
    kw = _CASES[case]
    C = kw.get("C", 4)
    z, x, assign = _batch(**kw)
    T, _n, d = z.shape
    got = _zx(z, x, assign, C)
    want = tmk.mstep_stats_pallas(torch.from_numpy(_pack(z, x)), torch.from_numpy(assign),
                                  T=T, d=d, l=x.shape[2], n_clusters=C)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_zx_plain_matches_jax_kernel(case):
    kw = _CASES[case]
    C = kw.get("C", 4)
    z, x, assign = _batch(**kw)
    T, _n, d = z.shape
    got = _zx(z, x, assign, C)
    want = jpm.mstep_stats_pallas(jnp.asarray(_pack(z, x)), jnp.asarray(assign), T=T, d=d, l=x.shape[2],
                                  n_clusters=C, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REL)


def test_one_nonfinite_coordinate_drops_the_whole_pair():
    """A NaN or an infinity in one coordinate of z_t counts as z_t missing
    whole: the pairs (t-1, t), (t, t+1) and (z_t, x_t) of that row drop, and
    the statistics equal those with every coordinate of z_t missing."""
    z, x, assign = _batch(4, p=0.0)
    C = 4
    one, whole = z.copy(), z.copy()
    one[2, 10, 1] = np.nan
    one[0, 11, 0] = np.inf  # the first state and the pair (0, 1)
    whole[2, 10, :] = np.nan
    whole[0, 11, :] = np.nan
    x1, xw = x.copy(), x.copy()
    x1[3, 12, 1] = -np.inf  # the measurement pair at t = 3 only
    xw[3, 12, :] = np.nan
    got = _zx(one, x1, assign, C)
    want = _zx(whole, xw, assign, C)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), **REL)
    base = _zx(z, x, assign, C)
    assert not np.allclose(got[0].numpy(), base[0].numpy())


def test_rows_of_no_cluster_count_nowhere():
    z, x, assign = _batch(5)
    C = 4
    keep = (assign >= 0) & (assign < C)
    got = _zx(z, x, assign, C)
    want = _zx(np.ascontiguousarray(z[:, keep]), np.ascontiguousarray(x[:, keep]), assign[keep], C)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **REL)


def test_counts_are_the_valid_pairs():
    """The ones column's entry of each set counts the pairs its rule keeps."""
    z, x, assign = _batch(6)
    C = 4
    S_t, S_m, S_i = _zx(z, x, assign, C)
    d, l = z.shape[2], x.shape[2]
    zf = np.isfinite(z).all(-1)
    xf = np.isfinite(x).all(-1)
    for c in range(C):
        rows = assign == c
        u = 2 * d + 1
        assert S_t[u - 1, c * u + u - 1] == (zf[:-1] & zf[1:])[:, rows].sum()
        u = d + l + 1
        assert S_m[u - 1, c * u + u - 1] == (zf & xf)[:, rows].sum()
        u = d + 1
        assert S_i[u - 1, c * u + u - 1] == zf[0, rows].sum()


def test_joint_views_are_the_batch_in_place():
    """The card's wrapper reads the packed batch through views: no copy, the
    row-major strides the kernel takes, the values of ``pack_joint``'s
    inverse."""
    z, x, _a = _batch(7)
    T, n, d = z.shape
    l = x.shape[2]
    v = torch.from_numpy(_pack(z, x))
    zv, xv = tmk._joint_views(v, T, d, l)
    D = T * (d + l)
    assert zv.shape == (T, n, d) and xv.shape == (T, n, l)
    assert zv.stride() == (d, D, 1) and xv.stride() == (l, D, 1)
    assert zv.data_ptr() == v.data_ptr() and xv.data_ptr() == v.data_ptr() + 8 * T * d
    assert tmk._stats_layout(zv) is zv and tmk._stats_layout(xv) is xv
    np.testing.assert_array_equal(zv.numpy(), z)
    np.testing.assert_array_equal(xv.numpy(), x)
    zt = torch.from_numpy(z)
    assert tmk._time_major(zt) and tmk._stats_layout(zt) is zt
    odd = zt.transpose(1, 2).contiguous().transpose(1, 2)  # inner stride n
    assert tmk._stats_layout(odd).is_contiguous()


def test_entry_table_is_the_unpacked_order():
    """K15's entries, in the kernel's order, are each set's upper triangle
    row by row: where ``unpack_mstep_stats`` finds them."""
    d, l = 5, 3
    ent = tmk._stats_entries(d, l, torch.device("cpu")).numpy()
    widths = tmk._stats_widths(d, l)
    assert ent.shape == (sum(u * (u + 1) // 2 for u in widths), 3)
    off = 0
    for s, u in enumerate(widths):
        block = ent[off : off + u * (u + 1) // 2]
        assert (block[:, 0] == s).all()
        assert [tuple(r) for r in block[:, 1:]] == [(j, k) for j in range(u) for k in range(j, u)]
        off += len(block)


def test_train_em_masked_kalman_reaches_k15_once_per_mstep(monkeypatch):
    """The masked trainer's M step is ``mstep(impl="pallas")``: K15's (z, x)
    wrapper once per M step, the initial one included, on the batch as the
    trainer holds it."""
    rng = np.random.default_rng(8)
    T, n, d, l, C = 6, 240, 3, 2, 2
    labels = np.arange(n) % C
    z = rng.normal(size=(T, n, d)) + 3.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l))
    z[rng.uniform(size=z.shape) < 0.1] = np.nan
    x[rng.uniform(size=x.shape) < 0.1] = np.nan
    calls = []
    real = tmk.mstep_stats_zx

    def spy(zz, xx, a, **kw):
        calls.append((zz.shape, xx.shape, zz.data_ptr(), xx.data_ptr()))
        return real(zz, xx, a, **kw)

    monkeypatch.setattr(tmk, "mstep_stats_zx", spy)
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    p0 = tem.mixture_params_from_numpy(
        (np.full(C, 0.5), rng.normal(size=(C, d)), eye(d), 0.3 * eye(d), eye(d), rng.normal(size=(C, d, l)), eye(l)),
        device="cpu",
    )
    flip = np.where(rng.uniform(size=n) < 0.3, 1 - labels, labels)
    zt, xt = torch.from_numpy(z), torch.from_numpy(x)
    for n_steps in (1, 40):
        calls.clear()
        params, assign, iters, status = tem.train_em_masked_kalman(p0, torch.from_numpy(flip), zt, xt, n_steps=n_steps)
        msteps = 1 + iters - (status != tem.STATUS_RUNNING)
        assert iters >= 1 and len(calls) == msteps
        assert all(c == ((T, n, d), (T, n, l), zt.data_ptr(), xt.data_ptr()) for c in calls)
    assert status == tem.STATUS_CONVERGED and iters > 1
    want = tem.mstep(zt, xt, assign, n_clusters=C)
    for a, b in zip(params, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)
