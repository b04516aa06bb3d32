"""``MMLinGaussSS_marginalizable(...).train(fast=True)`` in the port
against the JAX package on the shipped ADNI data (T=4, n=571, d=2, l=4,
NaN-suffix-padded), float64 on the CPU.  ``np.random.seed(k)`` before each
constructor gives both the same random init; the fits must then agree on
assignments and (to 1e-10) on every parameter."""

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
    tm = TorchMixture(n_clusters=3, states=zs, observations=x, **kw)
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


def test_unported_routes_raise(adni_data):
    zs, x = adni_data
    _jm, tm = _pair(zs, x, 0)
    with pytest.raises(NotImplementedError, match="item 5"):
        tm.train()
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.train(fast=True, verbose=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.train_with_multiple_random_starts(verbose=True)
    with pytest.raises(NotImplementedError, match="item 5"):
        tm.train_with_multiple_random_starts(use_cache=False)  # fast=None on the CPU
    with pytest.raises(NotImplementedError, match="item 5"):
        tm.train_with_multiple_random_starts(fast=False, use_cache=False)
    with pytest.raises(NotImplementedError):
        tm.bic()
    zg = zs.copy()
    zg[0, 0, :] = np.nan  # a gap before observed steps
    xg = x.copy()
    xg[0, 0, :] = np.nan
    np.random.seed(0)
    gapped = TorchMixture(n_clusters=3, states=zg, observations=xg)
    with pytest.raises(NotImplementedError, match="items 5 and 7"):
        gapped.train(fast=True)
    with pytest.raises(NotImplementedError, match="items 5 and 7"):
        gapped.train_with_multiple_random_starts(fast=True, use_cache=False)
