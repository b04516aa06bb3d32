"""The port's k-means (``models/kmeans.py``) against the installed
scikit-learn: ``KMeans(n_clusters, init="k-means++", n_init=10,
random_state=seed).fit_predict(X)``, the call the JAX package makes for its
k-means init, must give identical labels (scikit-learn's own Lloyd run is
threaded, so only the labels, not the inertia, are held bit for bit)."""

import numpy as np
import pytest
from sklearn.cluster import KMeans

from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.utils import adni
from multimodal_trajectory_modeling_tpu.utils import state_space as util
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable as TorchMixture,
)
from multimodal_trajectory_modeling_tpu_torch.models.kmeans import kmeans_labels


def _sklearn(X, C, seed):
    return KMeans(n_clusters=C, init="k-means++", n_init=10, random_state=seed).fit_predict(X)


@pytest.fixture(scope="module")
def adni_states():
    z, x, _d, _ids, _time = adni.get_trajectories()
    return util.standardize(z), x


def _first_state(states):
    """The first fully observed state of each instance (NaN → column
    mean), as the k-means init takes it."""
    t0 = np.argmax(np.isfinite(states).all(axis=2), axis=0)
    fs = states[t0, np.arange(states.shape[1]), :]
    return np.where(np.isfinite(fs), fs, np.nanmean(fs, axis=0, keepdims=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_labels_match_sklearn_on_adni_first_states(adni_states, seed):
    X = _first_state(np.asarray(adni_states[0], float))
    np.testing.assert_array_equal(kmeans_labels(X, 3, random_state=seed), _sklearn(X, 3, seed))


@pytest.mark.parametrize("C,seed", [(3, 1), (5, 4), (8, 7)])
def test_labels_match_sklearn_on_blobs(C, seed):
    rng = np.random.default_rng(seed)
    X = np.concatenate(
        [rng.normal(loc=rng.normal(scale=4.0, size=3), size=(300, 3)) for _ in range(5)]
    )
    labels = kmeans_labels(X, C, random_state=seed)
    assert labels.dtype == np.int32 and labels.shape == (1500,)
    np.testing.assert_array_equal(labels, _sklearn(X, C, seed))


def test_labels_match_sklearn_on_overlapping_clusters():
    """Many Lloyd iterations (one Gaussian cut into 8)."""
    X = np.random.default_rng(9).normal(size=(4000, 4))
    np.testing.assert_array_equal(kmeans_labels(X, 8, random_state=0), _sklearn(X, 8, 0))


@pytest.mark.parametrize("init", ["kmeans", "kmeans-all"])
def test_kmeans_init_matches_jax_constructor(adni_states, init):
    zs, x = adni_states
    if init == "kmeans-all":  # the whole trajectory: complete data only
        rng = np.random.default_rng(2)
        zs, x = rng.normal(size=(4, 400, 2)), rng.normal(size=(4, 400, 3))
    np.random.seed(0)
    jm = JaxMixture(n_clusters=3, states=zs, observations=x, random_seed=1, init=init)
    np.random.seed(0)
    tm = TorchMixture(n_clusters=3, states=zs, observations=x, random_seed=1, init=init, device="cpu")
    np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)


def test_non_finite_input_raises_as_sklearn(adni_states):
    """The whole NaN-padded ADNI trajectory is no k-means input, for
    either package."""
    zs, x = adni_states
    np.random.seed(0)
    with pytest.raises(ValueError):
        JaxMixture(n_clusters=3, states=zs, observations=x, init="kmeans-all")
    np.random.seed(0)
    with pytest.raises(ValueError, match="NaN"):
        TorchMixture(n_clusters=3, states=zs, observations=x, init="kmeans-all", device="cpu")
