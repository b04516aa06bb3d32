"""The port's multistart engine against the JAX package's, float64 on the
CPU, on numpy-seeded inputs (shapes of ``tests/test_markov_multi.py``):

- ``emstep_markov_multi`` (Φ branch through K3, packed branch through
  K4b), ``train_em_markov_multi`` and ``complete_data_loglik_markov[_multi]``
  against JAX: assignments, counts, switches, iterations and status
  identical; parameters and objectives to 1e-10;
- ``train_em_markov_pool`` against the JAX pool and against the port's own
  sequential ``train_em_markov``, with refills, an init abort and the
  JAX test's edge cases;
- ``train_with_multiple_random_starts(fast=True)`` on ADNI (C=3): the same
  objectives (1e-10 relative), winner, assignment and parameters (1e-10)
  as the JAX package, in the pool at the default R, at
  ``MTM_MULTISTART_FUSE=2`` and sequentially, and in ridge mode at C=4;
  the top two objectives differ by more than 1e-8 relative (checked), so
  the winner is no near tie;
- the gzip-pickle cache: a round trip, and a JAX-written pickle loading
  in the port.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.utils import adni
from multimodal_trajectory_modeling_tpu.utils import state_space as util
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import mixture as tmixture
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)
from multimodal_trajectory_modeling_tpu_torch.parallel.mesh import make_mesh
from jax.sharding import Mesh as JaxMesh

from _torch_parallel_ranks import one_rank_group

_PARAM_LISTS = (
    "cluster_propensities",
    "init_state_means",
    "init_state_covs",
    "transition_matrices",
    "transition_covs",
    "measurement_matrices",
    "measurement_covs",
)


def _mixture_batch(seed, T, n, d, l, min_len=2):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(min_len, T + 1, size=n)
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan
    return z, x, lens.astype(np.int32)


def _params_one(rng, C, d, l):
    def spd(k):
        M = rng.normal(size=(k, k))
        return M @ M.T / k + np.eye(k)

    return (
        rng.dirichlet(np.ones(C)),
        rng.normal(size=(C, d)),
        np.stack([spd(d) for _ in range(C)]),
        rng.normal(scale=0.3, size=(C, d, d)),
        np.stack([spd(d) for _ in range(C)]),
        rng.normal(size=(C, d, l)),
        np.stack([spd(l) for _ in range(C)]),
    )


def _jparams(p):
    return jem.MixtureParams(*map(jnp.asarray, p))


def _jstack(ps):
    return jax.tree.map(lambda *a: jnp.stack(a), *[_jparams(p) for p in ps])


def _tstack(ps):
    return tem.stack_params([tem.mixture_params_from_numpy(p, device="cpu") for p in ps])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_params_close(pt, pj, tol=1e-10):
    for a, b in zip(tem.mixture_params_to_numpy(pt), pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _packed_u(z, x, lens):
    T, n, d = z.shape
    l = x.shape[2]
    zt = np.ascontiguousarray(z.transpose(0, 2, 1).reshape(T * d, n))
    xt = np.ascontiguousarray(x.transpose(0, 2, 1).reshape(T * l, n))
    u_j = jem.pack_markov_batch(jnp.asarray(zt), jnp.asarray(xt), T=T, d=d, l=l)
    u_t = tem.pack_markov_batch(_t(zt), _t(xt), T=T, d=d, l=l)
    return zt, xt, u_j, u_t


@pytest.mark.parametrize("branch", ["phi", "packed"])
def test_emstep_markov_multi_matches_jax(branch):
    rng = np.random.default_rng(0)
    C, T, n, d, l, R = 3, 6, 300, 2, 3, 4
    z, x, lens = _mixture_batch(1, T, n, d, l)
    ps = [_params_one(rng, C, d, l) for _ in range(R)]
    prev = rng.integers(0, C, size=(R, n)).astype(np.int32)
    force = np.array([0, 1, 0, 0], np.int32)
    _zt, _xt, u_j, u_t = _packed_u(z, x, lens)
    phi_j = phi_t = None
    if branch == "phi":
        _u, phi_j, _layout = jem._markov_features(
            jnp.asarray(z), jnp.asarray(x), jnp.asarray(lens), T=T, d=d, l=l
        )
        _u, phi_t = tem._markov_features(_t(z), _t(x), _t(lens))
    out_j = jem.emstep_markov_multi(
        _jstack(ps), jnp.asarray(lens), jnp.asarray(prev), u_j, T=T,
        force_prev=jnp.asarray(force), phi=phi_j,
    )
    out_t = tem.emstep_markov_multi(
        _tstack(ps), _t(lens), _t(prev), u_t, T=T, force_prev=force, phi=phi_t
    )
    for a, b in zip(out_t[1:4], out_j[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(out_t[4].numpy(), np.asarray(out_j[4]), rtol=1e-10)
    assert float(out_t[4][1]) == 0.0  # the forced slot
    _assert_params_close(out_t[0], out_j[0])


def test_train_em_markov_multi_matches_jax():
    """Fixed-chunk multistart, including an init-abort restart frozen at
    its initial parameters."""
    rng = np.random.default_rng(4)
    C, T, n, d, l, R = 2, 5, 240, 2, 2, 3
    z, x, lens = _mixture_batch(5, T, n, d, l)
    ps = [_params_one(rng, C, d, l) for _ in range(R)]
    assigns = rng.integers(0, C, size=(R, n)).astype(np.int32)
    assigns[2, :] = 0
    assigns[2, :2] = 1  # cluster 1 has 2 ≤ min_members members
    pj, aj, ij, sj = jem.train_em_markov_multi(
        _jstack(ps), jnp.asarray(assigns), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(lens), n_steps=50,
    )
    pt, at, it, st = tem.train_em_markov_multi(
        _tstack(ps), _t(assigns), _t(z), _t(x), _t(lens), n_steps=50
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert int(st[2]) == tem.STATUS_INIT_ABORT and int(it[2]) == 0
    _assert_params_close(pt, pj)


def test_complete_data_loglik_markov_matches_jax():
    """The objectives: one restart (K4a), R restarts from the packed batch
    (K4b) and from Φ (K3)."""
    rng = np.random.default_rng(6)
    C, T, n, d, l, R = 3, 6, 180, 2, 3, 2
    z, x, lens = _mixture_batch(7, T, n, d, l)
    ps = [_params_one(rng, C, d, l) for _ in range(R)]
    zt, xt, u_j, u_t = _packed_u(z, x, lens)
    want = jem.complete_data_loglik_markov_multi(_jstack(ps), jnp.asarray(lens), u_j, T=T)
    got = tem.complete_data_loglik_markov_multi(_tstack(ps), _t(lens), u_t, T=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    _u, phi_t = tem._markov_features(_t(z), _t(x), _t(lens))
    got_phi = tem.complete_data_loglik_markov_multi(_tstack(ps), _t(lens), None, T=T, phi=phi_t)
    np.testing.assert_allclose(got_phi.numpy(), np.asarray(want), rtol=1e-10)
    for r in range(R):
        one_j = jem.complete_data_loglik_markov(
            _jparams(ps[r]), jnp.asarray(zt), jnp.asarray(xt), jnp.asarray(lens), T=T
        )
        one_t = tem.complete_data_loglik_markov(
            tem.mixture_params_from_numpy(ps[r], device="cpu"), _t(zt), _t(xt), _t(lens), T=T
        )
        np.testing.assert_allclose(float(one_t), float(one_j), rtol=1e-10)


def _pool_problem():
    rng = np.random.default_rng(3)
    C, T, n, d, l = 3, 6, 240, 2, 2
    z, x, lens = _mixture_batch(5, T, n, d, l)
    n_cand = 9
    ps = [_params_one(rng, C, d, l) for _ in range(n_cand)]
    assigns = [rng.integers(0, C, size=n).astype(np.int32) for _ in range(n_cand)]
    # candidate 2: init abort (one cluster below the member floor)
    assigns[2] = np.zeros(n, np.int32)
    assigns[2][:2] = 1
    assigns[2][2 : n - 2] = np.where(np.arange(n - 4) % 2 == 0, 0, 2)
    return (z, x, lens), ps, assigns


def _assert_results_match(got, want, tol=1e-10):
    assert len(got) == len(want)
    for i, ((pg, ag, ig, sg), (pw, aw, iw, sw)) in enumerate(zip(got, want)):
        assert (ig, sg) == (int(iw), int(sw)), i
        np.testing.assert_array_equal(ag.numpy(), np.asarray(aw), err_msg=f"cand {i}")
        _assert_params_close(pg, pw, tol)


def test_pool_matches_jax_and_sequential():
    """9 candidates through R=3 slots (refills, one init abort, the
    n_steps cap): every candidate as the JAX pool and as the port's own
    sequential ``train_em_markov`` give it."""
    (z, x, lens), ps, assigns = _pool_problem()
    got, stats = tem.train_em_markov_pool(
        [tem.mixture_params_from_numpy(p, device="cpu") for p in ps], assigns,
        _t(z), _t(x), _t(lens), R=3, n_steps=5,
    )
    assert stats.windows >= 3 and stats.status_reads == stats.windows
    assert stats.seconds > 0
    want = jem.train_em_markov_pool(
        [_jparams(p) for p in ps], assigns, jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(lens), R=3, n_steps=5,
    )
    _assert_results_match(got, want)
    assert got[2][3] == tem.STATUS_INIT_ABORT
    seq = [
        tem.train_em_markov(
            tem.mixture_params_from_numpy(p, device="cpu"), _t(a), _t(z), _t(x), _t(lens), n_steps=5
        )
        for p, a in zip(ps, assigns)
    ]
    seq = [(tem.mixture_params_to_numpy(p), a.numpy(), i, s) for p, a, i, s in seq]
    _assert_results_match(got, seq, tol=0.0)


@pytest.mark.parametrize("case", ["fewer_candidates_than_slots", "all_abort"])
def test_pool_edge_cases(case):
    """(a) 2 candidates with R=32 (R clamps to 2); (b) every candidate
    trips the init guard: raw parameters, zero iterations, status 3."""
    rng = np.random.default_rng(11)
    C, T, n, d, l = 3, 6, 200, 2, 2
    z, x, lens = _mixture_batch(13, T, n, d, l)
    ps = [_params_one(rng, C, d, l) for _ in range(2)]
    assigns = [rng.integers(0, C, size=n).astype(np.int32) for _ in range(2)]
    if case == "all_abort":
        bad = np.zeros(n, np.int32)
        bad[0], bad[1] = 1, 2
        ps, assigns = [ps[0]] * 3, [bad] * 3
    R = 32 if case == "fewer_candidates_than_slots" else 2
    got, _stats = tem.train_em_markov_pool(
        [tem.mixture_params_from_numpy(p, device="cpu") for p in ps], assigns,
        _t(z), _t(x), _t(lens), R=R, n_steps=4,
    )
    if case == "all_abort":
        for pg, ag, ig, sg in got:
            assert (ig, sg) == (0, tem.STATUS_INIT_ABORT)
            np.testing.assert_array_equal(ag.numpy(), assigns[0])
            for a, b in zip(tem.mixture_params_to_numpy(pg), ps[0]):
                np.testing.assert_array_equal(a, b)
        return
    want = [
        jem.train_em_markov(_jparams(p), jnp.asarray(a), jnp.asarray(z),
                            jnp.asarray(x), jnp.asarray(lens), n_steps=4)
        for p, a in zip(ps, assigns)
    ]
    _assert_results_match(got, want)


def test_pool_unported_options_raise(tmp_path):
    """The data-parallel pool (``mesh=``), once raising, runs: over a
    one-rank gloo group, 9 candidates through R=3 slots give the JAX
    pool's results on a one-device mesh (its lanes padded to the TPU
    block, the port's not; ``test_torch_parallel.py`` holds two ranks)."""
    (z, x, lens), ps, assigns = _pool_problem()
    with one_rank_group(str(tmp_path)):
        got, _stats = tem.train_em_markov_pool(
            [tem.mixture_params_from_numpy(p, device="cpu") for p in ps], assigns,
            _t(z), _t(x), _t(lens), R=3, n_steps=5, mesh=make_mesh(),
        )
    want = jem.train_em_markov_pool(
        [_jparams(p) for p in ps], assigns, jnp.asarray(z), jnp.asarray(x), jnp.asarray(lens),
        R=3, n_steps=5, mesh=JaxMesh(np.asarray(jax.devices()[:1]), ("data",)),
    )
    _assert_results_match(got, want)


@pytest.fixture(scope="module")
def adni_data():
    z, x, _d, _ids, _time = adni.get_trajectories()
    return util.standardize(z), x


@pytest.mark.parametrize(
    "fuse,C,alpha", [(None, 3, 0.0), ("2", 3, 0.0), ("1", 3, 0.0), (None, 4, 1.0)]
)
def test_multistart_matches_jax_on_adni(adni_data, monkeypatch, fuse, C, alpha):
    """One k-means and four random candidates on ADNI: the pool at the
    default R (all five in one group), the pool at R=2 (refills and three
    objective groups) and the sequential branch, at C=3; and the pool in
    ridge mode at C=4."""
    zs, x = adni_data
    if fuse is not None:
        monkeypatch.setenv("MTM_MULTISTART_FUSE", fuse)
    kw = dict(n_starts=4, fast=True, use_cache=False, return_objectives=True)
    model = dict(n_clusters=C, states=zs, observations=x, alpha=alpha)
    np.random.seed(0)
    jb, jo = JaxMixture(**model).train_with_multiple_random_starts(**kw)
    np.random.seed(0)
    tb, to = TorchMixture(**model, device="cpu").train_with_multiple_random_starts(**kw)
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    top2 = np.sort(jo)[-2:]
    assert (top2[1] - top2[0]) > 1e-8 * abs(top2[1])
    assert int(np.argmax(to)) == int(np.argmax(jo))
    assert tb.random_seed == jb.random_seed and tb.last_trained is not None
    run = tb.last_multistart
    assert len(run["iterations"]) == len(run["statuses"]) == 5
    assert run["kmeans_seconds"] > 0
    assert (run["pool"] is None) == (fuse == "1")
    np.testing.assert_array_equal(tb.cluster_assignment, jb.cluster_assignment)
    for name in _PARAM_LISTS:
        np.testing.assert_allclose(
            np.asarray(getattr(tb, name)), np.asarray(getattr(jb, name)),
            rtol=1e-10, atol=1e-10,
        )


def test_candidate_equals_constructor(adni_data):
    """A multistart candidate is the model the constructor builds with
    the same seed and init, from the same global RNG state."""
    zs, x = adni_data
    np.random.seed(3)
    base = TorchMixture(n_clusters=3, states=zs, observations=x, device="cpu")
    state = np.random.get_state()
    cands = [base._candidate(0, "kmeans"), base._candidate(101)]
    np.random.set_state(state)
    built = [
        TorchMixture(n_clusters=3, states=zs, observations=x, random_seed=0, init="kmeans", device="cpu"),
        TorchMixture(n_clusters=3, states=zs, observations=x, random_seed=101, device="cpu"),
    ]
    for c, b in zip(cands, built):
        assert c.hex_hash == b.hex_hash and c.init == b.init
        np.testing.assert_array_equal(c.cluster_assignment, b.cluster_assignment)
        for name in _PARAM_LISTS:
            np.testing.assert_array_equal(np.asarray(getattr(c, name)), np.asarray(getattr(b, name)))


def test_cache_round_trip(adni_data, tmp_path, monkeypatch):
    """A trained model goes to the cache and comes back from it: the
    second multistart call loads it without training."""
    zs, x = adni_data
    monkeypatch.setattr(tmixture, "home_dir", str(tmp_path))
    np.random.seed(0)
    m = TorchMixture(n_clusters=3, states=zs, observations=x, device="cpu")
    best = m.train_with_multiple_random_starts(n_starts=1, fast=True)
    files = glob.glob(os.path.join(tmp_path, "tmp", f"mmm-{m.hex_hash}-*.p.gz"))
    assert len(files) == 1
    again = TorchMixture(n_clusters=3, states=zs, observations=x, device="cpu")
    loaded = again.train_with_multiple_random_starts(n_starts=1, fast=True)
    assert loaded.last_trained == best.last_trained
    np.testing.assert_array_equal(loaded.cluster_assignment, best.cluster_assignment)
    for name in _PARAM_LISTS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)), np.asarray(getattr(best, name)))
    best.correspondence = {0: "B", 1: "A", 2: "C"}
    best.to_pickle()  # evicts the first file
    files = glob.glob(os.path.join(tmp_path, "tmp", f"mmm-{m.hex_hash}-*.p.gz"))
    assert len(files) == 1
    reloaded = TorchMixture.from_pickle(
        files[0], training_data={"states": zs, "observations": x}, device="cpu"
    )
    assert reloaded.inverse_correspondence == {"B": 0, "A": 1, "C": 2}


def test_jax_pickle_loads_in_port(adni_data, tmp_path):
    zs, x = adni_data
    np.random.seed(1)
    jm = JaxMixture(n_clusters=3, states=zs, observations=x, random_seed=5)
    jm.train(fast=True)
    jm.to_pickle(save_location=str(tmp_path), include_training_data=True)
    (path,) = glob.glob(os.path.join(tmp_path, "mmm-*.p.gz"))
    tm = TorchMixture.from_pickle(path, device="cpu")
    assert tm.hex_hash == jm.hex_hash and tm.last_trained == jm.last_trained
    assert tm.correspondence == jm.correspondence
    np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)
    for name in _PARAM_LISTS:
        np.testing.assert_array_equal(np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)))
