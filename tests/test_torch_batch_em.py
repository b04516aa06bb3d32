"""The port's raw-batch Markov kernels (K6 ``markov_em_fused_longT``, K10
``markov_assign_suffix``, K11 ``markov_em_fused``), the routes that run
them and the complete-data inference API, against the JAX package,
float64 on the CPU.

JAX runs its Pallas kernels in interpret mode with ``block_n=128``; the
port's wrappers take their plain versions on CPU tensors.  Tolerances:
assignments, counts, switches, iterations, statuses, winners and printed
transcripts identical; statistics to 1e-10 relative, objectives to 1e-12
relative (the same products summed in another order), parameters and
inference outputs to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.ops import markov as jmops
from multimodal_trajectory_modeling_tpu.ops import pallas_markov as jpm
from multimodal_trajectory_modeling_tpu.utils import adni
from multimodal_trajectory_modeling_tpu.utils import state_space as util
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)
from multimodal_trajectory_modeling_tpu_torch.ops import markov as tmops
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as tmk
from multimodal_trajectory_modeling_tpu_torch.utils.trace import EMTrace

TOL = dict(rtol=1e-10, atol=1e-10)


def _suffix(seed, T, n, d, l, C=2):
    """C shifted clusters, NaN past a length in [1, T]."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n) % C
    z = rng.normal(size=(T, n, d)) + 2.0 * labels[None, :, None]
    x = rng.normal(size=(T, n, l)) + 0.7 * z[:, :, :1]
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    return z, x, lens, labels


def _transposed(z, x):
    T, n, d = z.shape
    return z.transpose(0, 2, 1).reshape(T * d, n), x.transpose(0, 2, 1).reshape(T * x.shape[2], n)


def _params(seed, C, d, l):
    rng = np.random.default_rng(seed)

    def spd(k):
        a = rng.normal(scale=0.3, size=(C, k, k))
        return a @ a.transpose(0, 2, 1) + np.eye(k)

    return (rng.dirichlet(np.ones(C)), rng.normal(size=(C, d)), spd(d),
            rng.normal(scale=0.3, size=(C, d, d)), spd(d), rng.normal(size=(C, d, l)), spd(l))


def _jp(params):
    return jem.MixtureParams(*map(jnp.asarray, params))


def _tp(params):
    return tem.mixture_params_from_numpy(params, device="cpu")


def _kernel_case(seed, T, d, l, C=3, n=300, nan_cluster=False):
    """The batch, ``prev`` with every seventh lane left out (-1), and the
    grouped and canonical weights with log π folded (cluster 1's W1 NaN
    under ``nan_cluster``), as numpy arrays."""
    z, x, lens, _labels = _suffix(seed, T, n, d, l)
    z_t, x_t = _transposed(z, x)
    params = _params(seed + 1, C, d, l)
    W1, W2, W3 = (np.asarray(w) for w in jmops.markov_cluster_weights_grouped(*map(jnp.asarray, params[1:])))
    W3 = W3.copy()
    W3[:, -1] += np.log(params[0])
    if nan_cluster:
        W1 = W1.copy()
        W1[1] = np.nan
    Wg = tmops.canonical_weights(*map(torch.from_numpy, (W1, W2, W3)), d=d, l=l).numpy()
    prev = np.random.default_rng(seed + 2).integers(0, C, size=n).astype(np.int32)
    prev[::7] = -1
    return dict(z_t=z_t, x_t=x_t, lens=lens, prev=prev, W=(W1, W2, W3), Wg=Wg, T=T, d=d, l=l)


def _assert_em_equal(got, want):
    """K6/K11 outputs: exact assignments, counts, switches; statistics to
    1e-10 relative, the objective to 1e-12 relative."""
    for k in (0, 1, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    g_want = np.asarray(want[3])
    np.testing.assert_allclose(got[3].numpy(), g_want, rtol=1e-10, atol=1e-10 * np.nanmax(np.abs(g_want)))
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-12, atol=0.0)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


_KERNEL_CASES = [
    pytest.param(6, 3, 2, False, id="T6"),
    pytest.param(6, 3, 2, True, id="T6-nan-cluster"),
    pytest.param(70, 2, 1, False, id="T70"),  # T·s = 560 > 512
]


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("T,d,l,nan_cluster", _KERNEL_CASES)
def test_k6_plain_matches_jax(T, d, l, nan_cluster, assign_mode):
    c = _kernel_case(40 + T, T, d, l, nan_cluster=nan_cluster)
    kw = dict(T=T, d=d, l=l, assign_mode=assign_mode)
    want = jpm.markov_em_fused_longT(
        *_j(c["z_t"], c["x_t"], c["lens"], c["prev"], *c["W"]), block_n=128, interpret=True, **kw
    )
    before = tmk.markov_em_fused_longT.launches
    got = tmk.markov_em_fused_longT(*_t(c["z_t"], c["x_t"], c["lens"], c["prev"], *c["W"]), **kw)
    assert tmk.markov_em_fused_longT.launches == before  # CPU: the plain version
    _assert_em_equal(got, want)
    valid = c["prev"] >= 0
    assert (got[0].numpy()[~valid] == 3).all() and int(got[1].sum()) == int(valid.sum())
    if nan_cluster and assign_mode == "argmax":
        assert (got[0].numpy()[valid] == 1).all() and np.isnan(float(got[4]))


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("nan_cluster", [False, True])
def test_k11_plain_matches_jax(nan_cluster, assign_mode):
    c = _kernel_case(50, 6, 3, 2, nan_cluster=nan_cluster)
    kw = dict(T=6, d=3, l=2, assign_mode=assign_mode)
    want = jpm.markov_em_fused(
        *_j(c["z_t"], c["x_t"], c["lens"], c["prev"], c["Wg"]), block_n=128, interpret=True, **kw
    )
    got = tmk.markov_em_fused(*_t(c["z_t"], c["x_t"], c["lens"], c["prev"], c["Wg"]), **kw)
    _assert_em_equal(got, want)


@pytest.mark.parametrize("nan_cluster", [False, True])
@pytest.mark.parametrize("T,d,l", [(6, 3, 2), (12, 2, 1)])
def test_k10_plain_matches_jax(T, d, l, nan_cluster):
    c = _kernel_case(60 + T, T, d, l, nan_cluster=nan_cluster)
    kw = dict(T=T, d=d, l=l)
    want = jpm.markov_assign_suffix(
        *_j(c["z_t"], c["x_t"], c["lens"], c["prev"], *c["W"]), block_n=128, interpret=True, **kw
    )
    got = tmk.markov_assign_suffix(*_t(c["z_t"], c["x_t"], c["lens"], c["prev"], *c["W"]), **kw)
    for k in (0, 1, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("assign_mode", ["argmax", "prev"])
@pytest.mark.parametrize("T,d,l", [(6, 3, 2), (70, 2, 1)])
def test_fold_through_canonical_phi_matches_k6_and_k11(T, d, l, assign_mode):
    """The CUDA kernel's algorithm in plain torch: K5's canonical Φ, then
    K1's step with the grouped weights folded into the canonical layout.
    It equals K6 on the grouped weights and K11 on the canonical ones
    (the JAX package's ``test_markov_em_fused_longT_matches_small_T_kernel``
    on the port); the statistics drop their padding rows."""
    c = _kernel_case(70 + T, T, d, l)
    z_t, x_t, lens, prev = _t(c["z_t"], c["x_t"], c["lens"], c["prev"])
    W = _t(*c["W"])
    Wg = tmops.canonical_weights(*W, d=d, l=l)
    np.testing.assert_array_equal(Wg.numpy(), c["Wg"])
    phi = tmk.markov_materialize_features_longT(z_t, x_t, lens, T=T, d=d, l=l)
    wc = torch.zeros((Wg.shape[0], phi.shape[0]), dtype=Wg.dtype)
    wc[:, : Wg.shape[1]] = Wg
    via_phi = tmk.markov_em_compact_plain(phi, prev, wc, assign_mode=assign_mode)
    F = Wg.shape[1]
    assert float(via_phi[3][F:].abs().max()) == 0.0
    k6 = tmk.markov_em_fused_longT(z_t, x_t, lens, prev, *W, T=T, d=d, l=l, assign_mode=assign_mode)
    k11 = tmk.markov_em_fused(z_t, x_t, lens, prev, Wg, T=T, d=d, l=l, assign_mode=assign_mode)
    for other in (k6, k11):
        for k in (0, 1, 2):
            np.testing.assert_array_equal(via_phi[k].numpy(), other[k].numpy())
        np.testing.assert_allclose(via_phi[3][:F].numpy(), other[3].numpy(), rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(float(via_phi[4]), float(other[4]), rtol=1e-12)


def test_kernel_wrappers_check_arguments():
    c = _kernel_case(80, 6, 3, 2)
    z_t, x_t, lens, prev = _t(c["z_t"], c["x_t"], c["lens"], c["prev"])
    W = _t(*c["W"])
    with pytest.raises(ValueError, match="z_t must be"):
        tmk.markov_em_fused_longT(z_t[:-1], x_t, lens, prev, *W, T=6, d=3, l=2)
    with pytest.raises(ValueError, match="prev must be"):
        tmk.markov_assign_suffix(z_t, x_t, lens, prev[:-1], *W, T=6, d=3, l=2)
    with pytest.raises(ValueError, match="assign_mode"):
        tmk.markov_em_fused(z_t, x_t, lens, prev, _t(c["Wg"])[0], T=6, d=3, l=2, assign_mode="soft")


# ----------------------------------------------------------------------
# the em routes
# ----------------------------------------------------------------------


def test_emstep_markov_k6_branch_matches_jax():
    """One EM step at long T from the transposed batch (the K6 branch of
    both packages' ``emstep_markov``), in both modes."""
    T, d, l = 70, 2, 1
    z, x, lens, labels = _suffix(81, T, 200, d, l)
    z_t, x_t = _transposed(z, x)
    params = _params(82, 2, d, l)
    prev = labels.astype(np.int32)
    for mode in ("prev", "argmax"):
        pj, aj, cj, sj = jem.emstep_markov(_jp(params), *_j(z_t, x_t, lens, prev), T=T, assign_mode=mode)
        u, phi = tem._markov_features(*_t(z, x, lens), precompute=False)
        assert phi is None and isinstance(u, tmk.RawBatch)
        rows = u.plan.rows.long()  # the K6 branch takes and gives rows in the plan's order
        lens_t, prev_t = _t(lens, prev)
        pt, at, ct, st = tem.emstep_markov(_tp(params), lens_t, prev_t[rows], phi, T=T, u=u, assign_mode=mode)
        np.testing.assert_array_equal(torch.empty_like(at).index_copy_(0, rows, at).numpy(), np.asarray(aj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert int(st) == int(sj)
        for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("reg_mode", ["lstsq", "ridge"])
def test_train_em_markov_precompute_off_long_T_matches_jax(reg_mode):
    T, d, l = 70, 2, 1
    z, x, lens, labels = _suffix(83, T, 200, d, l)
    rng = np.random.default_rng(84)
    assign0 = np.where(rng.uniform(size=labels.size) < 0.2, 1 - labels, labels).astype(np.int32)
    params = _params(85, 2, d, l)
    kw = dict(n_steps=20, reg_mode=reg_mode, alpha=0.5 if reg_mode == "ridge" else 0.0, precompute=False)
    pj, aj, ij, sj = jem.train_em_markov(_jp(params), *_j(assign0, z, x, lens), **kw)
    before = tmk.markov_materialize_features_longT.launches
    pt, at, it, st = tem.train_em_markov(_tp(params), *_t(assign0, z, x, lens), **kw)
    assert tmk.markov_materialize_features_longT.launches == before
    assert (it, st) == (int(ij), int(sj)) and st == tem.STATUS_CONVERGED and it > 1
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # the same trajectory as through Φ
    pp, ap, ip, sp = tem.train_em_markov(_tp(params), *_t(assign0, z, x, lens), **{**kw, "precompute": True})
    assert (ip, sp) == (it, st)
    np.testing.assert_array_equal(ap.numpy(), at.numpy())


# ----------------------------------------------------------------------
# the raw-batch plan: each row's extent, the rows by extent
# ----------------------------------------------------------------------


def _plan_edges(seed, T, n, d, l, big=None):
    """Suffix data with the plan's edges: row 3 all NaN (extent 0), row 5
    NaN but for one +Inf (extent T: a value that is not NaN counts), row 9
    with a -Inf at t = 0, rows 7 and 11 with finite values for two steps
    past their length; with ``big``, rows 13 and 17 scaled by it (their
    products overflow)."""
    z, x, lens, _labels = _suffix(seed, T, n, d, l)
    z[:, 3], x[:, 3] = np.nan, np.nan
    z[:, 5], x[:, 5] = np.nan, np.nan
    z[T - 1, 5, 0] = np.inf
    x[0, 9, 0] = -np.inf
    for i in (7, 11):
        lens[i] = min(lens[i], T - 2)
        z[lens[i] : lens[i] + 2, i] = 0.5
        x[lens[i] : lens[i] + 2, i] = -0.25
    if big is not None:
        z[:, [13, 17]] *= big
        x[:, [13, 17]] *= big
    return z, x, lens


def _extent_reference(z, x):
    """1 + each row's last step with a z or x entry that is not NaN (0:
    none), in numpy."""
    seen = ~np.isnan(z).all(-1) | ~np.isnan(x).all(-1)  # (T, n)
    return np.where(seen.any(0), z.shape[0] - np.argmax(seen[::-1], axis=0), 0).astype(np.int32)


@pytest.mark.parametrize("T,d,l", [(6, 3, 2), (70, 2, 1)])
def test_raw_batch_plan_matches_numpy(T, d, l):
    """The raw-batch plan: each row's extent and the rows in a stable order
    by extent, longest first, against numpy; ``plan_raw_batch`` permutes
    the transposed batch and the lengths into that order."""
    z, x, lens = _plan_edges(86, T, 60, d, l)
    z_t, x_t = _transposed(z, x)
    ext = _extent_reference(z, x)
    order = np.argsort(-ext, kind="stable")
    assert ext[3] == 0 and ext[5] == T and ext[9] >= 1
    plan = tmk.raw_batch_plan(*_t(z_t, x_t), T=T, d=d, l=l)
    np.testing.assert_array_equal(plan.rows.numpy(), order)
    np.testing.assert_array_equal(plan.extent.numpy(), ext[order])
    assert plan.rows.dtype == plan.extent.dtype == torch.int32
    raw = tmk.plan_raw_batch(*_t(z, x, lens))
    np.testing.assert_array_equal(raw.plan.rows.numpy(), order)
    np.testing.assert_array_equal(raw.z_t.numpy(), z_t[:, order])
    np.testing.assert_array_equal(raw.x_t.numpy(), x_t[:, order])
    np.testing.assert_array_equal(raw.lens.numpy(), lens[order])


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32 if a.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel,assign_mode", [("K6", "argmax"), ("K6", "prev"), ("K10", "argmax"),
                                                ("K11", "argmax"), ("K11", "prev")])
def test_plain_versions_under_a_plan_equal_unplanned(kernel, assign_mode, dtype):
    """The plain versions on the planned batch (rows permuted, the
    assignments scattered back) equal the plain versions without a plan
    bit for bit: their sums run over the caller's order either way."""
    T, d, l = 12, 3, 2
    z, x, lens = _plan_edges(87, T, 150, d, l)
    z_t, x_t = _transposed(z, x)
    c = _kernel_case(88, T, d, l, n=150)
    zt, xt, ld, prev = _t(z_t, x_t, lens, c["prev"])
    zt, xt = zt.to(dtype), xt.to(dtype)
    W = [w.to(dtype) for w in _t(*c["W"])]
    Wg = _t(c["Wg"])[0].to(dtype)
    plan = tmk.raw_batch_plan(zt, xt, T=T, d=d, l=l)
    rows = plan.rows.long()
    kw = dict(T=T, d=d, l=l)
    if kernel != "K10":
        kw["assign_mode"] = assign_mode

    def run(zt, xt, ld, prev, **more):
        if kernel == "K10":
            return tmk.markov_assign_suffix_plain(zt, xt, ld, prev, *W, **kw, **more)
        if kernel == "K6":
            return tmk.markov_em_fused_longT_plain(zt, xt, ld, prev, *W, **kw, **more)
        return tmk.markov_em_fused_plain(zt, xt, ld, prev, Wg, **kw, **more)

    want = run(zt, xt, ld, prev)
    got = run(zt[:, rows], xt[:, rows], ld[rows], prev[rows], plan=plan)
    torch.testing.assert_close(torch.empty_like(got[0]).index_copy_(0, rows, got[0]), want[0], rtol=0, atol=0)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(_bits(g) if g.is_floating_point() else g, _bits(w) if w.is_floating_point() else w)


@pytest.mark.parametrize("dtype,big", [(torch.float32, 1e20), (torch.float64, 1e160)])
def test_row_build_stopping_at_extent_is_bit_equal(dtype, big):
    """The canonical Φ built with each row stopping at its extent (the
    raw-batch kernels' build) equals the build over all T bit for bit:
    extent-0 rows, ±Inf entries, finite values past a row's length, and
    rows whose products overflow to ±Inf (and NaN under a zero mask)."""
    T, d, l = 70, 2, 1
    z, x, lens = _plan_edges(89, T, 120, d, l, big=big)
    zt, xt = (a.to(dtype) for a in _t(*_transposed(z, x)))
    ld = _t(lens)[0]
    plan = tmk.raw_batch_plan(zt, xt, T=T, d=d, l=l)
    ext = torch.empty_like(plan.extent).index_copy_(0, plan.rows.long(), plan.extent)
    full = tmk.markov_materialize_features_longT_plain(zt, xt, ld, T=T, d=d, l=l)
    stopped = tmk.markov_materialize_features_longT_plain(zt, xt, ld, T=T, d=d, l=l, extent=ext)
    assert not bool(torch.isfinite(full).all())  # the overflow is there
    assert torch.equal(_bits(stopped), _bits(full))


def test_train_em_markov_long_T_plan_matches_jax(monkeypatch):
    """The long-T fit without Φ keeps its batch and assignment in the
    plan's order (a permutation that is not the identity here) and lands
    where the JAX package's does, the assignment in the caller's order."""
    T, d, l = 70, 2, 1
    z, x, lens, labels = _suffix(90, T, 240, d, l)
    rng = np.random.default_rng(91)
    assign0 = np.where(rng.uniform(size=labels.size) < 0.2, 1 - labels, labels).astype(np.int32)
    params = _params(92, 2, d, l)
    kw = dict(n_steps=20, precompute=False)
    pj, aj, ij, sj = jem.train_em_markov(_jp(params), *_j(assign0, z, x, lens), **kw)
    plans, real = [], tmk.markov_em_fused_longT

    def spy(*a, **k):
        plans.append(k.get("plan"))
        return real(*a, **k)

    monkeypatch.setattr(tmk, "markov_em_fused_longT", spy)
    pt, at, it, st = tem.train_em_markov(_tp(params), *_t(assign0, z, x, lens), **kw)
    assert len(plans) == it + 1 and all(p is not None for p in plans)
    assert not torch.equal(plans[0].rows, torch.arange(labels.size, dtype=torch.int32))
    assert (it, st) == (int(ij), int(sj)) and it > 1
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("T,d,l", [(6, 3, 2), (70, 2, 1)])
def test_complete_data_loglik_markov_matches_jax(T, d, l):
    """K4a below T·s = 512, K6 past it."""
    z, x, lens, _labels = _suffix(86 + T, T, 200, d, l)
    z_t, x_t = _transposed(z, x)
    params = _params(87, 2, d, l)
    want = float(jem.complete_data_loglik_markov(_jp(params), *_j(z_t, x_t, lens), T=T))
    got = float(tem.complete_data_loglik_markov(_tp(params), *_t(z_t, x_t, lens), T=T))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("T,d,l", [(6, 3, 2), (12, 2, 1)])
def test_estep_assign_markov_matches_jax(T, d, l):
    z, x, lens, labels = _suffix(88 + T, T, 250, d, l, C=3)
    z_t, x_t = _transposed(z, x)
    params = _params(89, 3, d, l)
    prev = labels.astype(np.int32)
    want = jem.estep_assign_markov(_jp(params), *_j(z_t, x_t, lens, prev), T=T, interpret=True)
    got = tem.estep_assign_markov(_tp(params), *_t(z_t, x_t, lens, prev), T=T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the argmax of the suffix log-likelihoods plus log π
    ll = tem.suffix_logliks_markov(_tp(params), *_t(z, x, lens))
    np.testing.assert_array_equal(got[0].numpy(), np.argmax(np.log(params[0])[:, None] + ll.numpy(), axis=0))


@pytest.mark.parametrize("T,d,l", [(6, 3, 2), (70, 2, 1)])
def test_suffix_logliks_and_model_loglik_markov_match_jax(T, d, l):
    z, x, lens, _labels = _suffix(90 + T, T, 200, d, l, C=3)
    params = _params(91, 3, d, l)
    zt, xt, lt = _t(z, x, lens)
    want = np.asarray(jem.suffix_logliks_markov(_jp(params), *_j(z, x, lens), via_phi=False))
    xla = tem.suffix_logliks_markov(_tp(params), zt, xt, lt, via_phi=False).numpy()
    phi = tem.suffix_logliks_markov(_tp(params), zt, xt, lt, via_phi=True).numpy()
    assert np.array_equal(tem.suffix_logliks_markov(_tp(params), zt, xt, lt).numpy(), xla)  # CPU default
    scale = np.abs(want).max()
    np.testing.assert_allclose(xla, want, rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(phi, want, rtol=1e-12, atol=1e-12 * scale)
    want_phi = np.asarray(jem.suffix_logliks_markov(_jp(params), *_j(z, x, lens), via_phi=True))
    np.testing.assert_allclose(phi, want_phi, rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(
        float(tem.model_loglik_markov(_tp(params), zt, xt, lt)),
        float(jem.model_loglik_markov(_jp(params), *_j(z, x, lens))), rtol=1e-12,
    )


def test_markov_small_math_matches_jax():
    """``markov_cluster_weights``, ``markov_suffix_logliks``,
    ``suffix_lengths`` and ``is_suffix_mask``."""
    T, d, l, C = 7, 3, 2, 3
    z, x, lens, _labels = _suffix(92, T, 150, d, l)
    params = _params(93, C, d, l)[1:]
    W_j = jmops.markov_cluster_weights(*map(jnp.asarray, params))
    W_t = tmops.markov_cluster_weights(*_t(*params))
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tmops.markov_suffix_logliks(*_t(z, x, lens), W_t).numpy(),
        np.asarray(jmops.markov_suffix_logliks(*_j(z, x, lens), W_j)), rtol=1e-12, atol=1e-9,
    )
    valid = np.isfinite(z).all(-1)
    np.testing.assert_array_equal(
        tmops.suffix_lengths(torch.from_numpy(valid)).numpy(), np.asarray(jmops.suffix_lengths(jnp.asarray(valid)))
    )
    gapped = valid.copy()
    gapped[0, lens > 1] = False
    for mask in (valid, gapped):
        assert tmops.is_suffix_mask(mask) == jmops.is_suffix_mask(mask)
        assert tmops.is_suffix_mask(torch.from_numpy(mask)) == jmops.is_suffix_mask(mask)
    assert tmops.is_suffix_mask(valid) and not tmops.is_suffix_mask(gapped)


# ----------------------------------------------------------------------
# the inference API
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def adni_data():
    z, x, _d, _ids, _time = adni.get_trajectories()
    return util.standardize(z), x


def _long_suffix():
    z, x, _lens, _labels = _suffix(94, 70, 60, 2, 1)  # T(d+l) = 210 ≤ 512 < T·s
    return z, x


def _long_T(gapped):
    """T(d+l) = 560 > 512: suffix data, or the same with interior gaps."""
    z, x, lens, _labels = _suffix(95, 130, 40, 3, 1)
    if gapped:
        z[1, lens > 3] = np.nan
        x[1, lens > 3] = np.nan
    return z, x


def _fitted(z, x, seed=3, C=2, fast=True):
    np.random.seed(seed)
    jm = JaxMixture(n_clusters=C, states=z, observations=x, random_seed=seed)
    np.random.seed(seed)
    tm = TorchMixture(n_clusters=C, states=z, observations=x, random_seed=seed, device="cpu")
    jm.train(fast=fast, n_steps=15)
    tm.train(fast=fast, n_steps=15)
    np.testing.assert_array_equal(tm.cluster_assignment, np.asarray(jm.cluster_assignment))
    return jm, tm


def _assert_inference_equal(jm, tm, **data):
    """Every ported inference method of the two models on the same data
    (the training data unless ``states``/``observations`` are given)."""
    T = jm.n_timesteps
    np.testing.assert_allclose(tm.e_complete_data_log_lik(**data), jm.e_complete_data_log_lik(**data), rtol=1e-12)
    np.testing.assert_allclose(tm.model_log_likelihood(**data), jm.model_log_likelihood(**data), rtol=1e-12)
    args = (data.get("states"), data.get("observations"))
    np.testing.assert_allclose(tm.aic(*args), jm.aic(*args), rtol=1e-12)
    np.testing.assert_allclose(tm.bic(*args), jm.bic(*args), rtol=1e-12)
    got = tm.mle_cluster_assignment(return_probs=True, return_prenormalized_log_probs=True, **data)
    want = jm.mle_cluster_assignment(return_probs=True, return_prenormalized_log_probs=True, **data)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(tm.mle_cluster_assignment(**data), want[0])
    np.testing.assert_array_equal(tm.mle_cluster_assignment(return_probs=True, **data)[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(tm.cluster_assignment_index(cluster="B", **data),
                               jm.cluster_assignment_index(cluster="B", **data), **TOL)
    for T0 in sorted({1, T // 2, T}):
        np.testing.assert_allclose(
            tm.conditional_log_likelihoods_first_T0_steps(1, T0, **data),
            jm.conditional_log_likelihoods_first_T0_steps(1, T0, **data), rtol=1e-10, atol=1e-8,
        )
    np.testing.assert_allclose(tm.conditional_log_likelihoods(0, **data),
                               jm.conditional_log_likelihoods(0, **data), rtol=1e-10, atol=1e-8)
    np.testing.assert_array_equal(tm.initial_full_data_cluster_assignment(**data),
                                  jm.initial_full_data_cluster_assignment(**data))


def test_inference_matches_jax_on_adni(adni_data):
    zs, x = adni_data
    jm, tm = _fitted(zs, x, seed=1, C=3)
    assert tm.n_free_params == jm.n_free_params
    _assert_inference_equal(jm, tm)
    np.testing.assert_allclose(tm.cluster_propensities_over_time(), jm.cluster_propensities_over_time(), **TOL)
    for got, want in zip(tm.predictions_from_initial_data(), jm.predictions_from_initial_data()):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # caller-supplied data: the first 300 trajectories, and a 3-step prefix
    sub = dict(states=zs[:, :300], observations=x[:, :300])
    _assert_inference_equal(jm, tm, **sub)
    np.testing.assert_allclose(tm.cluster_propensities_over_time(**sub), jm.cluster_propensities_over_time(**sub), **TOL)
    pre = dict(states=zs[:3, :300], observations=x[:3, :300])
    np.testing.assert_allclose(tm.e_complete_data_log_lik(**pre), jm.e_complete_data_log_lik(**pre), rtol=1e-12)
    for got, want in zip(tm.one_step_ahead_predictions(**sub), jm.one_step_ahead_predictions(**sub)):
        np.testing.assert_allclose(got, want, **TOL)
    for got, want in zip(tm.one_step_ahead_predictions_no_history(**sub),
                         jm.one_step_ahead_predictions_no_history(**sub)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("gapped", [False, True])
def test_inference_matches_jax_at_long_T(gapped, monkeypatch):
    """Past T(d+l) = 512: suffix data through the Markov factorization,
    gapped data through the masked filter, decided per instance on each
    prefix (JAX decides per pattern of the packed joint: the same)."""
    z, x = _long_T(gapped)
    jm, tm = _fitted(z, x)
    calls = []
    for name in ("suffix_logliks_markov", "masked_logliks_kalman"):
        real = getattr(tem, name)
        monkeypatch.setattr(tem, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k))
    tm._device_cache.clear()
    _assert_inference_equal(jm, tm)
    assert set(calls) == {"masked_logliks_kalman" if gapped else "suffix_logliks_markov"}
    assert {k[1] for k in tm._device_cache if k[0] == "joint"} <= {1, 65}  # only the short prefixes are packed
    if not gapped:
        _assert_inference_equal(jm, tm, states=z[:, :25], observations=x[:, :25])


def test_inference_on_long_T_suffix_data_matches_jax():
    """T·s > 512 with T(d+l) ≤ 512: the dense joint, from a K5-route fit."""
    z, x = _long_suffix()
    jm, tm = _fitted(z, x)
    _assert_inference_equal(jm, tm)


def test_regress_matches_jax(adni_data):
    zs, _x = adni_data
    X, Y = zs[0], zs[1]
    for got, want in zip(TorchMixture.regress(X, Y, device="cpu"), JaxMixture.regress(X, Y)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    for got, want in zip(TorchMixture.regress_alpha(X, Y, 0.3, device="cpu"), JaxMixture.regress_alpha(X, Y, 0.3)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_e_and_m_steps_match_jax(adni_data):
    zs, x = adni_data
    np.random.seed(4)
    jm = JaxMixture(n_clusters=3, states=zs, observations=x, random_seed=4)
    np.random.seed(4)
    tm = TorchMixture(n_clusters=3, states=zs, observations=x, random_seed=4, device="cpu")
    for _ in range(2):
        jm.M_step()
        tm.M_step()
        assert tm.E_step() == jm.E_step()
        np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)
    for name in ("cluster_propensities", "transition_matrices", "measurement_covs"):
        np.testing.assert_allclose(np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)), **TOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_train_verbose_transcript_matches_jax(adni_data, capsys, seed):
    zs, x = adni_data
    np.random.seed(seed)
    jm = JaxMixture(n_clusters=3, states=zs, observations=x, random_seed=seed)
    np.random.seed(seed)
    tm = TorchMixture(n_clusters=3, states=zs, observations=x, random_seed=seed, device="cpu")
    capsys.readouterr()
    jm.train(verbose=True, n_steps=30)
    want = capsys.readouterr().out
    tm.train(verbose=True, n_steps=30, fast=True)  # verbose ignores fast
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 2
    assert isinstance(tm.last_trace, EMTrace) and len(tm.last_trace) == len(jm.last_trace)
    np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)
    for name in ("cluster_propensities", "init_state_means", "transition_covs"):
        np.testing.assert_allclose(np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)), **TOL)


def test_train_verbose_near_empty_cluster_matches_jax(adni_data, capsys):
    zs, x = adni_data
    np.random.seed(0)
    jm = JaxMixture(n_clusters=3, states=zs, observations=x)
    np.random.seed(0)
    tm = TorchMixture(n_clusters=3, states=zs, observations=x, device="cpu")
    a0 = np.zeros(zs.shape[1], np.int64)
    a0[:3] = 1
    a0[3:200] = 2
    jm.cluster_assignment, tm.cluster_assignment = a0.copy(), a0.copy()
    capsys.readouterr()
    jm.train(verbose=True)
    want = capsys.readouterr().out
    tm.train(verbose=True)
    assert capsys.readouterr().out == want == "Encountered near-empty cluster.\n"
    assert len(tm.last_trace) == len(jm.last_trace) == 0


def test_verbose_multistart_matches_jax(adni_data, capsys, tmp_path, monkeypatch):
    """The host-stepped multistart: the same transcript, objectives,
    winner and assignment; with the cache, the reference's cache
    prints."""
    from multimodal_trajectory_modeling_tpu.models import mixture as jmix
    from multimodal_trajectory_modeling_tpu_torch.models import mixture as tmix

    zs, x = adni_data
    zs, x = zs[:, :250], x[:, :250]
    monkeypatch.setattr(jmix, "home_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tmix, "home_dir", str(tmp_path / "torch"))
    kw = dict(n_starts=2, n_steps=20, verbose=True, return_objectives=True)
    runs = {}
    for name, cls, extra in (("jax", JaxMixture, {}), ("torch", TorchMixture, {"device": "cpu"})):
        np.random.seed(11)
        capsys.readouterr()
        best, objs = cls(n_clusters=2, states=zs, observations=x, **extra).train_with_multiple_random_starts(**kw)
        runs[name] = (best, objs, capsys.readouterr().out)
    (jb, jo, jt), (tb, to, tt) = runs["jax"], runs["torch"]
    assert tt == jt and "No model found in cache." in tt
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    assert tb.random_seed == jb.random_seed
    np.testing.assert_array_equal(tb.cluster_assignment, jb.cluster_assignment)
    # a second call loads the winner from the cache
    np.random.seed(11)
    again = TorchMixture(n_clusters=2, states=zs, observations=x, device="cpu").train_with_multiple_random_starts(
        n_starts=2, verbose=True)
    assert capsys.readouterr().out.startswith("Loaded model best_mdl.last_trained=")
    np.testing.assert_array_equal(again.cluster_assignment, tb.cluster_assignment)


@pytest.mark.parametrize("failure", ["degenerate", "kernel"])
def test_verbose_multistart_skips_degenerate_starts_not_kernel_errors(adni_data, monkeypatch, failure):
    """A candidate whose training raises is skipped (the reference's rule
    for a singular solve); a kernel that fails to build or launch is not a
    degenerate start and propagates."""
    from multimodal_trajectory_modeling_tpu_torch.ops._build import KernelError

    zs, x = adni_data
    zs, x = zs[:, :250], x[:, :250]
    real_logliks, real_train, started = tem.estep_logliks, TorchMixture._train_verbose, []

    def train_verbose(self, **kwargs):
        started.append(self)
        return real_train(self, **kwargs)

    def estep_logliks(*args, **kwargs):
        if len(started) == 2:  # the second candidate's training
            if failure == "kernel":
                raise KernelError("estep: CUDA error 700 at launch")
            raise torch.linalg.LinAlgError("singular")
        return real_logliks(*args, **kwargs)

    monkeypatch.setattr(TorchMixture, "_train_verbose", train_verbose)
    monkeypatch.setattr(tem, "estep_logliks", estep_logliks)
    np.random.seed(11)
    model = TorchMixture(n_clusters=2, states=zs, observations=x, device="cpu")
    kw = dict(n_starts=2, n_steps=2, verbose=True, return_objectives=True, use_cache=False)
    if failure == "kernel":
        with pytest.raises(KernelError, match="CUDA error 700"):
            model.train_with_multiple_random_starts(**kw)
    else:
        best, objs = model.train_with_multiple_random_starts(**kw)
        assert len(started) == 3 and len(objs) == 2 and np.all(np.isfinite(objs))


def test_emtrace_records():
    trace = EMTrace()
    trace.record(0, -1.5, -1, 0.01)
    trace.record(1, -1.0, 4, 0.02)
    assert len(trace) == 2 and trace.iterations[1]["n_switches"] == 4
