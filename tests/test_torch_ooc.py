"""The port's out-of-core Markov trainer against the JAX package's, float64
on the CPU (the shapes of ``tests/test_markov_ooc.py``):

- ``em.train_em_markov_outofcore`` at several chunkings (one chunk, 128
  and a ragged 97) against JAX's in-core ``train_em_markov``, and at 97
  against JAX's own ``train_em_markov_outofcore``: assignments,
  iterations and status exact, parameters within 1e-10 relative;
- the init abort, the long-T canonical layout and the step cap, as in the
  JAX tests;
- ``train(fast=True)`` under ``MTM_MARKOV_OOC=1`` against the JAX
  mixture's, and the fall-through on interior missingness;
- under ``MTM_MARKOV_PHI=i16`` each chunk is quantized by JAX's
  per-chunk rule: the port's quantizer on JAX's chunk Φ gives JAX
  ``_ooc_featurize``'s ``PhiQuant`` bit for bit, the port's own chunks
  its int16 payload bit for bit (scales within 4 ulps), and the int16 fit
  follows JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)

from test_ops_markov import _mixture


def _setup(seed, C, T, n, d, l):
    z, x, lens, (m, S, A, G, H, L) = _mixture(seed, C=C, T=T, n=n, d=d, l=l)
    params0 = tuple(np.asarray(a) for a in (np.ones(C) / C, m, S, A, G, H, L))
    assign0 = np.random.default_rng(seed + 1).integers(0, C, size=n).astype(np.int32)
    return np.asarray(z), np.asarray(x), np.asarray(lens), params0, assign0


def _jax_incore(z, x, lens, params0, assign0, n_steps):
    return jem.train_em_markov(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        jnp.asarray(z), jnp.asarray(x), jnp.asarray(lens), n_steps=n_steps,
    )


def _port_ooc(z, x, lens, params0, assign0, **kw):
    return tem.train_em_markov_outofcore(
        tem.mixture_params_from_numpy(params0, device="cpu"), assign0, z, x, lens, **kw
    )


def _assert_matches(want, got, rtol=1e-10):
    pw, aw, iw, sw = want
    pg, ag, ig, sg = got
    assert (int(iw), int(sw)) == (ig, sg)
    assert isinstance(ag, torch.Tensor) and ag.device.type == "cpu" and ag.dtype == torch.int32
    np.testing.assert_array_equal(ag.numpy(), np.asarray(aw))
    for a, b in zip(tem.mixture_params_to_numpy(pg), pw):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=1e-12)


@pytest.fixture(scope="module")
def problem():
    args = _setup(77, 3, 6, 400, 2, 3)
    want = _jax_incore(*args, n_steps=20)
    assert int(want[2]) > 1  # the comparison exercises real EM steps
    return args, want


@pytest.mark.parametrize("chunk", [400, 128, 97])
def test_ooc_matches_jax_incore_at_every_chunking(problem, chunk):
    """One chunk, four (128 × 3 + 16) and five ragged ones (97 × 4 + 12):
    the in-core trajectory, parameters up to the summation order."""
    args, want = problem
    _assert_matches(want, _port_ooc(*args, n_steps=20, chunk_cols=chunk))


def test_ooc_matches_jax_ooc(problem):
    """The same chunking through both packages' streamed trainers."""
    args, _want = problem
    z, x, lens, params0, assign0 = args
    want = jem.train_em_markov_outofcore(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        z, x, lens, n_steps=20, chunk_cols=97,
    )
    _assert_matches(want, _port_ooc(*args, n_steps=20, chunk_cols=97))


def test_ooc_init_abort():
    """A near-empty initial assignment returns untouched, as in JAX."""
    z, x, lens, params0, _a = _setup(78, 3, 6, 120, 2, 3)
    bad0 = np.zeros(120, np.int32)
    bad0[:2] = 1
    bad0[2:4] = 2
    want = jem.train_em_markov_outofcore(
        jem.MixtureParams(*map(jnp.asarray, params0)), bad0, z, x, lens, n_steps=20, chunk_cols=50,
    )
    got = _port_ooc(z, x, lens, params0, bad0, n_steps=20, chunk_cols=50)
    assert int(want[3]) == tem.STATUS_INIT_ABORT
    _assert_matches(want, got, rtol=0)


def test_ooc_long_T_canonical_layout():
    """Past the packed gate the chunks carry the canonical Φ (K5's plain
    version here); the trajectory is JAX's in-core one."""
    C, T, n, d, l = 2, 70, 90, 3, 4
    assert not tem.markov_packed_ok(T, d, l)
    args = _setup(79, C, T, n, d, l)
    want = _jax_incore(*args, n_steps=12)
    _assert_matches(want, _port_ooc(*args, n_steps=12, chunk_cols=40))


def test_ooc_step_cap(problem):
    """``n_steps`` caps the loop with STATUS_RUNNING."""
    args, _want = problem
    want = _jax_incore(*args, n_steps=2)
    assert int(want[3]) == tem.STATUS_RUNNING and int(want[2]) == 2
    _assert_matches(want, _port_ooc(*args, n_steps=2, chunk_cols=150))


def _suffix_data(seed=5, T=6, n=300, d=2, l=3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(2, T + 1, size=n)
    tmask = np.arange(T)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    return z, x


def test_mixture_train_fast_ooc_route_matches_jax(monkeypatch):
    """``MTM_MARKOV_OOC=1`` routes ``train(fast=True)`` through the
    streamed trainer in both packages: the same assignment and parameters
    (1e-10), the same iterations and status as the port's in-core fit;
    interior missingness falls through to the in-core routes."""
    z, x = _suffix_data()
    incore = TorchMixture(n_clusters=2, states=z, observations=x, random_seed=5, device="cpu")
    incore.train(n_steps=30, fast=True)
    monkeypatch.setenv("MTM_MARKOV_OOC", "1")
    monkeypatch.setenv("MTM_MARKOV_OOC_CHUNK", "100")
    j = JaxMixture(n_clusters=2, states=z, observations=x, random_seed=5).train(n_steps=30, fast=True)
    t = TorchMixture(n_clusters=2, states=z, observations=x, random_seed=5, device="cpu")
    t.train(n_steps=30, fast=True)
    assert t._device_cache == {}  # the batch never went to the device cache
    assert t.last_trained is not None
    assert (t.last_iterations, t.last_status) == (incore.last_iterations, incore.last_status)
    np.testing.assert_array_equal(t.cluster_assignment, j.cluster_assignment)
    np.testing.assert_array_equal(t.cluster_assignment, incore.cluster_assignment)
    for name in ("cluster_propensities", "transition_matrices", "measurement_covs"):
        np.testing.assert_allclose(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)),
                                   rtol=1e-10, atol=1e-12)
    z2 = z.copy()
    z2[1, :10, 0] = np.nan  # a partially observed step: not a pure suffix
    on = TorchMixture(n_clusters=2, states=z2, observations=x, random_seed=5, device="cpu")
    on.train(n_steps=30, fast=True)
    monkeypatch.delenv("MTM_MARKOV_OOC")
    off = TorchMixture(n_clusters=2, states=z2, observations=x, random_seed=5, device="cpu")
    off.train(n_steps=30, fast=True)
    np.testing.assert_array_equal(on.cluster_assignment, off.cluster_assignment)


def test_ooc_int16_chunks_follow_jax_per_chunk_rule(problem, monkeypatch):
    """``MTM_MARKOV_PHI=i16`` in float64: each chunk is quantized with its
    OWN per-row scales (JAX's per-chunk rule; the chunks' scales differ).
    The port's quantizer applied to JAX's wide chunk Φ gives JAX
    ``_ooc_featurize``'s ``PhiQuant`` bit for bit; the port's own chunks
    have JAX's int16 payload bit for bit and its scales within 4 ulps
    (the two packages' Φ agree to 1e-12 of each row's max, not bit for
    bit: another summation order, ``test_torch_markov_kernels.py``).  The
    int16 fit follows JAX's streamed one."""
    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    (z, x, lens, params0, assign0), _want = problem
    T, n, d = z.shape
    l = x.shape[-1]
    scales = []
    for s in range(0, n, 128):
        e = min(s + 128, n)
        zj, xj, lj = jnp.asarray(z[:, s:e]), jnp.asarray(x[:, s:e]), jnp.asarray(lens[s:e])
        want = jem._ooc_featurize(zj, xj, lj, T=T, d=d, l=l, store="i16", interpret=True)
        wide = jem._ooc_featurize(zj, xj, lj, T=T, d=d, l=l, store=None, interpret=True)
        # JAX pads the lanes to its kernel's block: its first e - s lanes
        wide = torch.from_numpy(np.asarray(wide)[:, : e - s].copy())
        q_want, scale_want = np.asarray(want.q)[:, : e - s], np.asarray(want.scale)
        rule = mk.quantize_phi(wide)
        np.testing.assert_array_equal(rule.q.numpy(), q_want)
        np.testing.assert_array_equal(rule.scale.numpy(), scale_want)
        got = tem._ooc_featurize(
            torch.from_numpy(np.ascontiguousarray(z[:, s:e])),
            torch.from_numpy(np.ascontiguousarray(x[:, s:e])),
            torch.from_numpy(lens[s:e]), store="i16",
        )
        assert isinstance(got, mk.PhiQuant)
        np.testing.assert_array_equal(got.q.numpy(), q_want)
        np.testing.assert_array_max_ulp(got.scale.numpy(), scale_want, maxulp=4)
        scales.append(got.scale.numpy())
    assert not all(np.array_equal(scales[0], sc) for sc in scales[1:])
    want = jem.train_em_markov_outofcore(
        jem.MixtureParams(*map(jnp.asarray, params0)), jnp.asarray(assign0),
        z, x, lens, n_steps=20, chunk_cols=128,
    )
    _assert_matches(want, _port_ooc(z, x, lens, params0, assign0, n_steps=20, chunk_cols=128))
