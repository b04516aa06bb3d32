"""The port's dense joint route against the JAX package, float64 on the
CPU: ``train_em`` (plain torch), ``train_em_sorted`` (the plain versions
of K8 and K9; JAX runs its Pallas kernels in interpret mode), the
objectives and ``train_em_multistart`` on gapped synthetic data; then
``MMLinGaussSS_marginalizable.train()``, ``train(fast=True)`` with an
interior gap, and both multistarts on ADNI.  "Matches" is identical
assignments, iterations, statuses and winners, parameters and objectives
to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.ops import gaussian as jg
from multimodal_trajectory_modeling_tpu.utils import adni
from multimodal_trajectory_modeling_tpu.utils import state_space as util
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)

TOL = dict(rtol=1e-10, atol=1e-10)
_PARAM_LISTS = (
    "cluster_propensities",
    "init_state_means",
    "init_state_covs",
    "transition_matrices",
    "transition_covs",
    "measurement_matrices",
    "measurement_covs",
)


def _gapped_data(seed, n=500, T=4, d=2, l=3):
    """Two LG-SSM clusters, lengths 3 or 4, 30% of the long ones missing
    one interior step (z and x), 10% missing x at t=0."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n)
    z = np.empty((T, n, d))
    x = np.empty((T, n, l))
    for c in range(2):
        sel = labels == c
        k = int(sel.sum())
        A = rng.normal(scale=0.4, size=(d, d))
        H = rng.normal(size=(d, l))
        zc = rng.normal(loc=3.0 * c, size=(k, d))
        for t in range(T):
            z[t, sel] = zc
            x[t, sel] = zc @ H + 0.3 * rng.normal(size=(k, l))
            zc = zc @ A + 0.5 * rng.normal(size=(k, d))
    lens = rng.choice([3, 4], size=n)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    gap = np.where((rng.uniform(size=n) < 0.3) & (lens == 4))[0]
    tg = rng.integers(1, 3, size=gap.size)
    z[tg, gap] = np.nan
    x[tg, gap] = np.nan
    x[0, rng.uniform(size=n) < 0.1] = np.nan
    return z, x, labels


def _init_params(seed, C, d, l):
    rng = np.random.default_rng(seed)
    eye = lambda k: np.stack([np.eye(k)] * C)  # noqa: E731
    return (
        np.full(C, 1.0 / C),
        rng.normal(size=(C, d)),
        eye(d),
        rng.normal(scale=0.3, size=(C, d, d)),
        eye(d),
        rng.normal(size=(C, d, l)),
        eye(l),
    )


def _packed(z, x):
    v = np.array(jem.pack_joint(jnp.asarray(z), jnp.asarray(x)))
    patterns, pid = jg.pattern_groups(v)
    return v, patterns, pid


def _warm(labels, seed, flip=0.3):
    rng = np.random.default_rng(seed)
    return np.where(rng.uniform(size=labels.size) < flip, 1 - labels, labels)


def _assert_fit_equal(jax_fit, torch_fit):
    pj, aj, ij, sj = jax_fit
    pt, at, it, st = torch_fit
    assert (it, st) == (int(ij), int(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_pack_joint_matches_jax():
    z, x, _labels = _gapped_data(0, n=50)
    np.testing.assert_array_equal(
        tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy(),
        np.asarray(jem.pack_joint(jnp.asarray(z), jnp.asarray(x))),
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reg_mode", ["lstsq", "ridge"])
def test_train_em_matches_jax(seed, reg_mode):
    z, x, labels = _gapped_data(seed)
    v, patterns, pid = _packed(z, x)
    params0 = _init_params(seed, 2, z.shape[2], x.shape[2])
    assign0 = _warm(labels, 100 + seed)
    kw = dict(n_steps=50, reg_mode=reg_mode, alpha=0.5 if reg_mode == "ridge" else 0.0)
    jfit = jem.train_em(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        *map(jnp.asarray, (z, x, v, patterns, pid)), **kw,
    )
    tfit = tem.train_em(
        tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0),
        *map(torch.from_numpy, (z, x, v, patterns, pid)), **kw,
    )
    _assert_fit_equal(jfit, tfit)
    assert tfit[3] == tem.STATUS_CONVERGED and tfit[2] > 1


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reg_mode", ["lstsq", "ridge"])
def test_train_em_sorted_matches_jax(seed, reg_mode):
    """The sorted trainer on the pattern-sorted rows, against JAX's and
    against the port's own unsorted ``train_em``."""
    z, x, labels = _gapped_data(seed)
    v, patterns, pid = _packed(z, x)
    order = np.argsort(pid, kind="stable")
    sizes = tuple(int(s) for s in np.bincount(pid, minlength=patterns.shape[0]))
    zs, xs, vs = z[:, order], x[:, order], v[order]
    params0 = _init_params(seed, 2, z.shape[2], x.shape[2])
    assign0 = _warm(labels, 200 + seed)[order]
    kw = dict(n_steps=50, reg_mode=reg_mode, alpha=0.5 if reg_mode == "ridge" else 0.0)
    jfit = jem.train_em_sorted(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        *map(jnp.asarray, (zs, xs, vs, patterns)), sizes=sizes, **kw,
    )
    tfit = tem.train_em_sorted(
        tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0),
        *map(torch.from_numpy, (zs, xs, vs, patterns)), sizes=sizes, **kw,
    )
    _assert_fit_equal(jfit, tfit)
    assert tfit[3] == tem.STATUS_CONVERGED and tfit[2] > 1
    dense = tem.train_em(
        tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0),
        *map(torch.from_numpy, (zs, xs, vs, patterns, pid[order])), **kw,
    )
    assert dense[2:] == tfit[2:]
    np.testing.assert_array_equal(dense[1].numpy(), tfit[1].numpy())


@pytest.mark.parametrize("trainer", ["train_em", "train_em_sorted"])
def test_init_abort_matches_jax(trainer):
    """A cluster with ≤ 3 initial members aborts before training and
    returns the initial parameters untouched."""
    z, x, labels = _gapped_data(3, n=120)
    v, patterns, pid = _packed(z, x)
    order = np.argsort(pid, kind="stable")
    sizes = tuple(int(s) for s in np.bincount(pid, minlength=patterns.shape[0]))
    params0 = _init_params(3, 2, 2, 3)
    assign0 = np.zeros(labels.size, np.int64)
    assign0[:3] = 1
    if trainer == "train_em":
        args, kw = (z, x, v, patterns, pid), {}
    else:
        args, kw = (z[:, order], x[:, order], v[order], patterns), {"sizes": sizes}
    jfit = getattr(jem, trainer)(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        *map(jnp.asarray, args), **kw,
    )
    tfit = getattr(tem, trainer)(
        tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0),
        *map(torch.from_numpy, args), **kw,
    )
    assert tfit[2:] == (0, tem.STATUS_INIT_ABORT)
    _assert_fit_equal(jfit, tfit)
    for a, b in zip(tem.mixture_params_to_numpy(tfit[0]), params0):
        np.testing.assert_array_equal(a, b)


def test_step_budget_matches_jax():
    z, x, labels = _gapped_data(4)
    v, patterns, pid = _packed(z, x)
    params0 = _init_params(4, 2, 2, 3)
    assign0 = np.random.default_rng(5).integers(0, 2, size=labels.size)
    jfit = jem.train_em(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        *map(jnp.asarray, (z, x, v, patterns, pid)), n_steps=2,
    )
    tfit = tem.train_em(
        tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0),
        *map(torch.from_numpy, (z, x, v, patterns, pid)), n_steps=2,
    )
    assert tfit[2:] == (2, tem.STATUS_RUNNING)
    _assert_fit_equal(jfit, tfit)


@pytest.mark.parametrize("name", ["complete_data_loglik", "model_loglik", "estep_logliks"])
@pytest.mark.parametrize("method", ["solve", "inverse", "auto"])
def test_objectives_match_jax(name, method):
    z, x, _labels = _gapped_data(6)
    v, patterns, pid = _packed(z, x)
    params = _init_params(6, 3, 2, 3)
    want = getattr(jem, name)(
        jem.MixtureParams(*map(jnp.asarray, params)), *map(jnp.asarray, (v, patterns, pid)),
        T=z.shape[0], method=method,
    )
    got = getattr(tem, name)(
        tem.mixture_params_from_numpy(params, device="cpu"),
        *map(torch.from_numpy, (v, patterns, pid)), T=z.shape[0], method=method,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-10)


def test_train_em_multistart_matches_jax():
    """Three restarts, one of them an init abort: each as JAX's vmapped
    restart, with its objective."""
    z, x, labels = _gapped_data(7)
    v, patterns, pid = _packed(z, x)
    plist = [_init_params(s, 2, 2, 3) for s in (0, 1, 2)]
    params0 = tuple(np.stack(f) for f in zip(*plist))
    assign0 = np.stack([_warm(labels, 10), _warm(labels, 11, flip=0.45), np.zeros_like(labels)])
    jout = jem.train_em_multistart(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        *map(jnp.asarray, (z, x, v, patterns, pid)), n_steps=30,
    )
    tout = tem.train_em_multistart(
        tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0),
        *map(torch.from_numpy, (z, x, v, patterns, pid)), n_steps=30,
    )
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert int(tout[3][2]) == tem.STATUS_INIT_ABORT
    for a, b in zip(tem.mixture_params_to_numpy(tout[0]), jout[0]):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    np.testing.assert_allclose(tout[4].numpy(), np.asarray(jout[4]), rtol=1e-10)


def test_unported_kernel_options_raise():
    """The kernel options that once raised now run and match JAX (which
    runs its Pallas kernels in interpret mode): ``estep_logliks(method=
    "pallas")`` (K12's plain version, equal to the CPU's default grouped
    form) and ``mstep(impl="pallas")`` (K15's)."""
    z, x, labels = _gapped_data(8, n=60)
    v, patterns, pid = _packed(z, x)
    params_np = _init_params(8, 2, 2, 3)
    params = tem.mixture_params_from_numpy(params_np, device="cpu")
    jparams = jem.MixtureParams(*map(jnp.asarray, params_np))
    got = tem.estep_logliks(params, *map(torch.from_numpy, (v, patterns, pid)), T=4, method="pallas")
    want = jem.estep_logliks(jparams, *map(jnp.asarray, (v, patterns, pid)), T=4, method="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    auto = tem.estep_logliks(params, *map(torch.from_numpy, (v, patterns, pid)), T=4)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), **TOL)
    got = tem.mstep(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(labels),
                    n_clusters=2, impl="pallas")
    want = jem.mstep(jnp.asarray(z), jnp.asarray(x), jnp.asarray(labels), n_clusters=2, impl="pallas")
    for a, b in zip(tem.mixture_params_to_numpy(got), want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


# ----------------------------------------------------------------------
# the API on ADNI
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def adni_data():
    z, x, _d, _ids, _time = adni.get_trajectories()
    return util.standardize(z), x


def _with_gap(zs, x):
    """ADNI with step 1 missing (z and x) in every fourth full-length
    trajectory: interior missingness, a handful of patterns."""
    zg, xg = zs.copy(), x.copy()
    full = np.where(np.isfinite(zs[-1]).all(-1))[0][::4]
    zg[1, full] = np.nan
    xg[1, full] = np.nan
    return zg, xg


def _pair(zs, x, seed, **kw):
    np.random.seed(seed)
    jm = JaxMixture(n_clusters=3, states=zs, observations=x, **kw)
    np.random.seed(seed)
    tm = TorchMixture(n_clusters=3, states=zs, observations=x, device="cpu", **kw)
    return jm, tm


def _assert_models_equal(tm, jm):
    np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)
    for name in _PARAM_LISTS:
        np.testing.assert_allclose(
            np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)), **TOL
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_train_dense_matches_jax_on_adni(adni_data, seed):
    jm, tm = _pair(*adni_data, seed, random_seed=seed)
    jm.train()
    tm.train()
    assert tm.last_status in (tem.STATUS_CONVERGED, tem.STATUS_EMPTY_CLUSTER)
    assert tm.last_iterations > 1 and tm.last_trained is not None
    _assert_models_equal(tm, jm)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_fast_sorted_matches_jax_on_adni_with_gaps(adni_data, seed):
    zg, xg = _with_gap(*adni_data)
    jm, tm = _pair(zg, xg, seed, random_seed=seed)
    assert tm._suffix_instance_lens(zg, xg) is None
    jm.train(fast=True)
    tm.train(fast=True)
    assert tm.last_status in (tem.STATUS_CONVERGED, tem.STATUS_EMPTY_CLUSTER)
    assert tm.last_iterations > 1
    _assert_models_equal(tm, jm)


@pytest.mark.parametrize("fast", [False, True])
def test_multistart_matches_jax_on_adni_with_gaps(adni_data, fast):
    """The dense multistart (``fast=False``) and the sorted branch
    (``fast=True``): the same objectives, winner and assignment."""
    zg, xg = _with_gap(*adni_data)
    kw = dict(n_starts=2, n_steps=30, fast=fast, use_cache=False, return_objectives=True)
    np.random.seed(0)
    jb, jo = JaxMixture(n_clusters=3, states=zg, observations=xg).train_with_multiple_random_starts(**kw)
    np.random.seed(0)
    tb, to = TorchMixture(
        n_clusters=3, states=zg, observations=xg, device="cpu"
    ).train_with_multiple_random_starts(**kw)
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    assert tb.random_seed == jb.random_seed
    _assert_models_equal(tb, jb)
    assert tb.last_multistart["pool"] is None
    assert len(tb.last_multistart["statuses"]) == 3


def test_multistart_default_is_dense_on_the_cpu(adni_data):
    """``fast=None`` on the CPU resolves to the dense multistart, on
    suffix data too, as in JAX off the TPU."""
    zs, x = adni_data
    kw = dict(n_starts=1, n_steps=20, use_cache=False, return_objectives=True)
    np.random.seed(1)
    _jb, jo = JaxMixture(n_clusters=3, states=zs, observations=x).train_with_multiple_random_starts(**kw)
    np.random.seed(1)
    _tb, to = TorchMixture(
        n_clusters=3, states=zs, observations=x, device="cpu"
    ).train_with_multiple_random_starts(**kw)
    np.testing.assert_allclose(to, jo, rtol=1e-10)
