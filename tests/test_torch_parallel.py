"""The port's data-parallel trainers (``parallel/sharded_em.py``,
``parallel/mesh.py``) on gloo process groups of the CPU, float64, against
the JAX package's same trainers on meshes of the same size (the conftest's
virtual host devices).

One module fixture spawns a group of 2 ranks and a 2×2 group of 4
(``torch.distributed`` over gloo, a ``FileStore`` in a temporary
directory, one torch thread a rank); each rank runs every trainer once on
the same numpy inputs (``_torch_parallel_ranks.py``, which imports no JAX)
and sends its results back as numpy.  The JAX
references are computed in this process while the ranks run.  Every test
then holds one trainer: assignments, iterations and statuses exactly,
parameters within 1e-10 relative (1e-9 on the 4-rank grid); every rank's
results equal rank 0's (parameters replicated, assignments gathered).
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from multimodal_trajectory_modeling_tpu import ops as jops
from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.parallel import sharded_em as jsh

from _torch_parallel_ranks import C, _collect, _start_group

T, D_, L_ = 6, 2, 3


# ----------------------------------------------------------------------
# the inputs (numpy, from seeds)
# ----------------------------------------------------------------------


def _clusters(rng, n, T=T, d=D_, l=L_, lengths=(T // 2, T)):
    """n trajectories of C LG-SSM clusters, NaN past a length drawn from
    ``lengths``."""
    z = np.zeros((T, n, d))
    x = np.zeros((T, n, l))
    labels = rng.integers(0, C, size=n)
    for c in range(C):
        idx = labels == c
        k = int(idx.sum())
        A = rng.normal(scale=0.4, size=(d, d))
        H = rng.normal(size=(d, l))
        zc = np.empty((T, k, d))
        zc[0] = 2.0 * rng.normal(size=d) + rng.normal(size=(k, d)) / 2
        for t in range(1, T):
            zc[t] = zc[t - 1] @ A + rng.normal(size=(k, d)) / np.sqrt(2)
        z[:, idx] = zc
        x[:, idx] = zc @ H + rng.normal(size=(T, k, l)) / np.sqrt(3)
    lens = rng.choice(lengths, size=n)
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan
    return z, x, lens.astype(np.int32)


def _params(rng, d=D_, l=L_, C=C):
    return (np.ones(C) / C, rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
            rng.normal(size=(C, d, d)), np.stack([np.eye(d)] * C), rng.normal(size=(C, d, l)),
            np.stack([np.eye(l)] * C))


def _problem():
    rng = np.random.default_rng(0)
    n = 800
    z, x, lens = _clusters(rng, n)
    v = np.concatenate([z.transpose(1, 0, 2).reshape(n, -1), x.transpose(1, 0, 2).reshape(n, -1)], 1)
    patterns, pid = jops.pattern_groups(v)
    zg, xg = z.copy(), x.copy()  # arbitrary missingness for the masked trainer
    zg[rng.uniform(size=z.shape) < 0.2] = np.nan
    xg[rng.uniform(size=x.shape) < 0.2] = np.nan
    zl, xl, lensl = _clusters(rng, 90, T=70, d=3, l=4, lengths=(40, 70))
    return dict(
        z=z, x=x, lens=lens, v=v, patterns=np.asarray(patterns), pid=np.asarray(pid, np.int32),
        params0=_params(rng), assign0=rng.integers(0, C, size=n).astype(np.int32),
        restarts=[_params(rng) for _ in range(4)],
        assigns=rng.integers(0, C, size=(5, n)).astype(np.int32),
        zg=zg, xg=xg, zl=zl, xl=xl, lensl=lensl, params_l=_params(rng, 3, 4, 2),
        assign_l=rng.integers(0, 2, size=90).astype(np.int32),
    )


# ----------------------------------------------------------------------
# the JAX references (this process)
# ----------------------------------------------------------------------


def _jparams(p):
    return jem.MixtureParams(*map(jnp.asarray, p))


def _jax_refs(prob):
    devs = np.asarray(jax.devices())
    mesh = JaxMesh(devs[:2], ("data",))
    j = {k: jnp.asarray(v) for k, v in prob.items() if isinstance(v, np.ndarray)}
    p0 = _jparams(prob["params0"])
    dense = (p0, j["assign0"], j["z"], j["x"], j["v"], j["patterns"], j["pid"])
    restarts = jax.tree.map(lambda *a: jnp.stack(a), *[_jparams(p) for p in prob["restarts"]])
    ref = {}
    ref["shardmap"] = jsh.train_em_shardmap(*dense, mesh=mesh, n_steps=100)
    ref["data_parallel"] = jsh.train_em_data_parallel(*dense, mesh=mesh, n_steps=100)
    ref["multistart_sharded"] = jsh.train_em_multistart_sharded(
        restarts, j["assigns"][:4], *dense[2:], mesh=JaxMesh(devs[:2], ("start",)), n_steps=30)
    ref["multistart_2d"] = jsh.train_em_multistart_2d(
        p0, j["assigns"][:2], *dense[2:], mesh=JaxMesh(devs[:4].reshape(2, 2), ("restart", "data")),
        n_steps=100)
    markov = (p0, j["assign0"], j["z"], j["x"], j["lens"])
    ref["markov"] = jsh.train_em_markov_shardmap(*markov, mesh=mesh, n_steps=50)
    ref["markov_longT"] = jsh.train_em_markov_shardmap(
        _jparams(prob["params_l"]), j["assign_l"], j["zl"], j["xl"], j["lensl"], mesh=mesh, n_steps=12)
    ref["masked"] = jsh.train_em_masked_kalman_shardmap(p0, j["assign0"], j["zg"], j["xg"], mesh=mesh, n_steps=100)
    ref["multi"] = jsh.train_em_markov_multi_shardmap(
        jax.tree.map(lambda a: a[:3], restarts), j["assigns"][:3], j["z"], j["x"], j["lens"], mesh=mesh,
        n_steps=30)
    n_pool = 799
    ref["pool"] = jem.train_em_markov_pool(
        [_jparams(p) for p in prob["restarts"] + [prob["params0"]]], list(prob["assigns"][:, :n_pool]),
        j["z"][:, :n_pool], j["x"][:, :n_pool], j["lens"][:n_pool], R=2, n_steps=20, sync_every=3,
        mesh=mesh)
    for key, (z, x) in {"mixture_pool": ("z", "x"), "mixture_masked": ("zg", "xg")}.items():
        np.random.seed(0)
        best, objs = JaxMixture(n_clusters=C, states=prob[z], observations=prob[x]).train_with_multiple_random_starts(
            n_starts=3, n_steps=30, fast=True, use_cache=False, return_objectives=True)
        ref[key] = (best.cluster_assignment, np.asarray(best.transition_matrices), np.asarray(objs))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port results per rank for world 2 and 4, JAX references, the
    problem)``; the ranks run while this process computes the
    references."""
    prob = _problem()
    ctx = multiprocessing.get_context("spawn")
    base = tmp_path_factory.mktemp("gloo")
    procs = []
    for world in (2, 4):
        q = ctx.Queue()
        procs.append((world, q, _start_group(world, str(base / f"store{world}"), prob, ctx, q)))
    try:
        ref = _jax_refs(prob)
    finally:
        got = {world: _collect(ps, q, world) for world, q, ps in procs}
    for world, res in got.items():
        assert len(res) == world, f"{world} ranks: {len(res)} answered"
        for rank, r in res.items():
            assert isinstance(r, dict), f"rank {rank} of {world} failed:\n{r}"
    return got, ref, prob


def _assert_fit(got, want, rtol=1e-10):
    """``(params, assign, iters, status[, obj])``: exact but the params
    (and objectives), within ``rtol``."""
    pg, ag, ig, sg = got[:4]
    pw, aw, iw, sw = want[:4]
    np.testing.assert_array_equal(np.asarray(ig), np.asarray(iw))
    np.testing.assert_array_equal(np.asarray(sg), np.asarray(sw))
    np.testing.assert_array_equal(np.asarray(ag), np.asarray(aw))
    for a, b in zip(pg, pw):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=rtol)
    if len(want) == 5:
        np.testing.assert_allclose(got[4], np.asarray(want[4]), rtol=rtol)


def _replicated(res, key):
    """Rank 0's results of ``key``, after checking every rank has them."""
    first = res[0][key]
    flat0 = jax.tree.leaves(first)
    for r in range(1, len(res)):
        for a, b in zip(flat0, jax.tree.leaves(res[r][key])):
            np.testing.assert_array_equal(a, b)
    return first


@pytest.mark.parametrize("key", ["shardmap", "data_parallel"])
def test_dense_shardmap_matches_jax(runs, key):
    got, ref, _prob = runs
    out = _replicated(got[2], key)
    assert out[2] > 1
    _assert_fit(out, ref[key])


def test_multistart_sharded_matches_jax(runs):
    got, ref, _prob = runs
    _assert_fit(_replicated(got[2], "multistart_sharded"), ref["multistart_sharded"])


def test_multistart_2d_on_a_2x2_group_matches_jax(runs):
    """The restart × data grid: two restart rows of two data ranks each
    (``dist.new_group`` subgroups), against JAX's 2×2 mesh, 1e-9."""
    got, ref, _prob = runs
    _assert_fit(_replicated(got[4], "multistart_2d"), ref["multistart_2d"], rtol=1e-9)


@pytest.mark.parametrize("key", ["markov", "markov_longT"])
def test_markov_shardmap_matches_jax(runs, key):
    """K2 (at long T K5) once a rank, K1 an iteration."""
    got, ref, _prob = runs
    out = _replicated(got[2], key)
    assert out[2] > 1
    _assert_fit(out, ref[key])


def test_markov_shardmap_routes_agree(runs, monkeypatch):
    """``MTM_MARKOV_PRECOMP=0`` (K4a a rank): the wide-Φ trajectory
    (1e-10).  int16 Φ with global scales: the wide trajectory's
    iterations, status and assignment, and the one-rank int16 fit bit for
    bit (the ranks all-reduce K1's integer sums before unscaling them)."""
    from multimodal_trajectory_modeling_tpu_torch.models import em as tem

    got, _ref, prob = runs
    wide = _replicated(got[2], "markov")
    _assert_fit(_replicated(got[2], "markov_k4a"), wide)
    i16 = _replicated(got[2], "markov_i16")
    np.testing.assert_array_equal(i16[1], wide[1])
    assert (i16[2], i16[3]) == (wide[2], wide[3])
    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    one = tem.train_em_markov(
        tem.mixture_params_from_numpy(prob["params0"], device="cpu"),
        *(torch.from_numpy(prob[k]) for k in ("assign0", "z", "x", "lens")), n_steps=50,
    )
    assert (one[2], one[3]) == (i16[2], i16[3])
    np.testing.assert_array_equal(one[1].numpy(), i16[1])
    for a, b in zip(tem.mixture_params_to_numpy(one[0]), i16[0]):
        np.testing.assert_array_equal(a, b)


def test_int16_shard_scales_equal_one_rank_scales(runs):
    """Each rank's int16 Φ block: scales equal a one-rank
    ``quantize_phi`` of the whole Φ bit for bit, and its payload is that
    quantization's block."""
    from multimodal_trajectory_modeling_tpu_torch.models import em as tem
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    got, _ref, prob = runs
    _u, phi = tem._markov_features(*(torch.from_numpy(prob[k]) for k in ("z", "x", "lens")),
                                   precompute=True, phi_store="wide")
    whole = mk.quantize_phi(phi)
    n = prob["z"].shape[1]
    for rank in (0, 1):
        q, scale = got[2][rank]["i16_block"]
        assert scale.tobytes() == whole.scale.numpy().tobytes()
        np.testing.assert_array_equal(q, whole.q.numpy()[:, rank * n // 2 : (rank + 1) * n // 2])


def test_masked_kalman_shardmap_matches_jax(runs):
    got, ref, _prob = runs
    out = _replicated(got[2], "masked")
    assert out[2] > 1
    _assert_fit(out, ref["masked"])


@pytest.mark.parametrize("key", ["multi", "multi_k4b"])
def test_markov_multi_shardmap_matches_jax(runs, key):
    """K3 a rank (``MTM_MARKOV_PRECOMP=0``: K4b) for three restarts."""
    got, ref, _prob = runs
    _assert_fit(_replicated(got[2], key), ref["multi"])


def test_pool_over_the_group_matches_jax(runs):
    """``em.train_em_markov_pool(mesh=)``: five candidates through two
    slots (refills), n = 799 (a pad lane on the second rank)."""
    got, ref, _prob = runs
    out = _replicated(got[2], "pool")
    assert len(out) == len(ref["pool"]) == 5
    for g, w in zip(out, ref["pool"]):
        _assert_fit(g, w)


@pytest.mark.parametrize("key", ["mixture_pool", "mixture_masked"])
def test_mixture_multichip_matches_jax(runs, key):
    """``MTM_MULTICHIP=1`` in a group of 2: the pool over the group on
    suffix data, the masked trainer over the group for each candidate on
    scattered NaNs; the JAX mixture's winner, assignment, transitions and
    objectives (its one-device routes, which its own tests hold to its
    multichip ones)."""
    got, ref, _prob = runs
    a, A, objs = _replicated(got[2], key)
    a_j, A_j, objs_j = ref[key]
    np.testing.assert_array_equal(a, a_j)
    np.testing.assert_allclose(A, A_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(objs, objs_j, rtol=1e-10)
