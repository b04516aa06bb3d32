"""``MMLinGaussSS_marginalizable(...).train(fast=True)`` in the port
against the JAX package on the shipped ADNI data (T=4, n=571, d=2, l=4,
NaN-suffix-padded), float64 on the CPU.  ``np.random.seed(k)`` before each
constructor gives both the same random init; the fits must then agree on
assignments and (to 1e-10) on every parameter."""

import contextlib
import io

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.utils import adni
from multimodal_trajectory_modeling_tpu.utils import state_space as util
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)

_PARAM_LISTS = (
    "cluster_propensities",
    "init_state_means",
    "init_state_covs",
    "transition_matrices",
    "transition_covs",
    "measurement_matrices",
    "measurement_covs",
)


@pytest.fixture(scope="module")
def adni_data():
    z, x, _d, _ids, _time = adni.get_trajectories()
    return util.standardize(z), x


def _pair(zs, x, seed, **kw):
    np.random.seed(seed)
    jm = JaxMixture(n_clusters=3, states=zs, observations=x, **kw)
    np.random.seed(seed)
    tm = TorchMixture(n_clusters=3, states=zs, observations=x, device="cpu", **kw)
    return jm, tm


def test_constructor_replicates_rng_and_hash(adni_data):
    zs, x = adni_data
    jm, tm = _pair(zs, x, 7, alpha=0.25)
    assert tm.hex_hash == jm.hex_hash
    np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)
    for name in _PARAM_LISTS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name))
        )
    assert tm.inverse_correspondence == jm.inverse_correspondence
    assert tm.last_trained is None
    assert tm.dtype == torch.float64 and tm.device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_fast_matches_jax_on_adni(adni_data, seed):
    zs, x = adni_data
    # random_seed drives the initial assignment, the global seed the
    # (then overwritten) parameter draws
    jm, tm = _pair(zs, x, seed, random_seed=seed)
    jm.train(fast=True)
    tm.train(fast=True)
    assert tm.last_status in (tem.STATUS_CONVERGED, tem.STATUS_EMPTY_CLUSTER)
    assert tm.last_iterations > 1
    assert tm.last_trained is not None
    np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)
    for name in _PARAM_LISTS:
        np.testing.assert_allclose(
            np.asarray(getattr(tm, name)),
            np.asarray(getattr(jm, name)),
            rtol=1e-10,
            atol=1e-10,
        )


def test_unported_routes_raise(adni_data, monkeypatch):
    """What still raises: out-of-core training.  What once raised and now
    runs: the observed-only inference family (held against JAX here and
    in ``test_torch_observed.py``), ``bic`` (held against JAX),
    ``print_model`` (the same text as JAX's; the other reports in
    ``test_torch_adni.py``), the verbose transcript (its own parity
    tests), the masked-filter route
    (more than 256 patterns, or T(d+l) > 512) and at long T on suffix data
    the routes of kernel K6 (``MTM_MARKOV_PRECOMP=0`` and the sequential
    multistart; their parity tests are in ``test_torch_longT.py``).  A
    name the class does not have is a plain ``AttributeError``."""
    zs, x = adni_data
    jm, tm = _pair(zs, x, 0)
    np.testing.assert_allclose(tm.observed_conditional_log_likelihoods(1),
                               jm.observed_conditional_log_likelihoods(1), rtol=1e-10)
    np.testing.assert_array_equal(tm.observations_mle_cluster_assignment(),
                                  jm.observations_mle_cluster_assignment())
    printed = []
    for m in (tm, jm):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            m.print_model(verbose=True)
        printed.append([ln for ln in out.getvalue().splitlines() if "last_trained" not in ln])
    assert len(printed[0]) > 20 and printed[0] == printed[1]
    np.testing.assert_allclose(tm.bic(), jm.bic(), rtol=1e-12)
    monkeypatch.setenv("MTM_MARKOV_OOC", "1")
    with pytest.raises(NotImplementedError, match="item 9"):
        tm.train(fast=True)
    monkeypatch.delenv("MTM_MARKOV_OOC")
    rng = np.random.default_rng(0)
    zg, xg = zs.copy(), x.copy()  # unstructured missingness
    zg[rng.uniform(size=zg.shape) < 0.3] = np.nan
    xg[rng.uniform(size=xg.shape) < 0.3] = np.nan
    np.random.seed(0)
    scattered = TorchMixture(n_clusters=3, states=zg, observations=xg, device="cpu")
    assert scattered._packed()[4].shape[0] > 256
    long_t = np.random.default_rng(1).normal(size=(90, 40, 3))
    long_t[1, 0] = np.nan  # an interior gap at T(d+l) = 540
    np.random.seed(0)
    long_model = TorchMixture(n_clusters=2, states=long_t, observations=long_t, device="cpu")
    for model in (scattered, long_model):
        assert model._takes_masked_filter_route()
        model.train(fast=True, n_steps=2)
        assert model.last_iterations >= 1
    suffix = long_t.copy()
    suffix[1, 0] = 0.0
    suffix[60:, :5] = np.nan  # T·s = 720 > 512, suffix missingness
    np.random.seed(0)
    suffix_model = TorchMixture(n_clusters=2, states=suffix, observations=suffix, device="cpu")
    monkeypatch.setenv("MTM_MARKOV_PRECOMP", "0")
    suffix_model.train(fast=True, n_steps=2)
    assert suffix_model.last_iterations >= 1
    assert not any(k[0] == "joint" for k in suffix_model._device_cache)
