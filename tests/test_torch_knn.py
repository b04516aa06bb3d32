"""The port's kNN regression (``ops/knn.py``) against the JAX package's,
float64 on the CPU: the host path bit for bit; the dense and streaming
device paths (here on CPU tensors) within 1e-12 of JAX's kernels, and on
duplicated training rows the same neighbours (the lower training index
among equal distances, which the port enforces and JAX's ``lax.top_k``
keeps); the routing of ``KNNRegressor`` and ``grid_search_knn`` past the
work and streaming thresholds (monkeypatched, as ``tests/test_knn.py``
does) and the same chosen k."""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import knn as jknn
from multimodal_trajectory_modeling_tpu_torch.ops import knn as tknn

TOL = dict(rtol=1e-12, atol=1e-12)


def _rand_problem(rng, m, n, dim, ydim):
    return rng.normal(size=(m, dim)), rng.normal(size=(m, ydim)), rng.normal(size=(n, dim))


def _t(*arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float64) for a in arrays)


def _lower_index_predict(X, Y, Q, k):
    """The rule the device paths keep: the k nearest by (distance, index)."""
    d2 = jknn._sqdist_np(X, Q)
    idx = np.stack([np.lexsort((np.arange(X.shape[0]), row))[:k] for row in d2])
    return Y[idx].mean(axis=1)


def test_host_path_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    X, Y, Q = _rand_problem(rng, 150, 40, 4, 2)
    for k in (1, 5, 150, 300):
        np.testing.assert_array_equal(tknn._knn_predict_np(X, Y, Q, k), jknn._knn_predict_np(X, Y, Q, k))
    got = tknn._knn_predict_np_multi_k(X, Y, Q, [3, 5, 10])
    want = jknn._knn_predict_np_multi_k(X, Y, Q, [3, 5, 10])
    for k in (3, 5, 10):
        np.testing.assert_array_equal(got[k], want[k])
    assert tknn._kfold_bounds(100, 3) == jknn._kfold_bounds(100, 3)


@pytest.mark.parametrize(
    "m,n,dim,k,qc,tc",
    [
        (100, 37, 4, 5, 16, 32),     # non-multiple chunks both axes
        (257, 50, 3, 7, 64, 100),    # ragged train blocks
        (64, 8, 2, 1, 8, 16),        # k = 1
        (20, 10, 3, 20, 4, 8),       # k = m
        (20, 10, 3, 50, 4, 8),       # k > m (clamped)
        (96, 33, 5, 12, 16, 8),      # train_chunk < k
        (8, 5, 2, 5, 4, 2),          # tiny blocks, train_chunk < k
    ],
)
def test_device_paths_match_jax(m, n, dim, k, qc, tc):
    rng = np.random.default_rng(m * 1000 + n)
    X, Y, Q = _rand_problem(rng, m, n, dim, 2)
    want = np.asarray(jknn.knn_predict(X, Y, Q, k=min(k, m)))
    dense = tknn.knn_predict(*_t(X, Y, Q), k=k, query_chunk=qc).numpy()
    stream = tknn.knn_predict_streaming(*_t(X, Y, Q), k=k, query_chunk=qc, train_chunk=tc).numpy()
    np.testing.assert_allclose(dense, want, **TOL)
    np.testing.assert_allclose(stream, want, **TOL)
    np.testing.assert_array_equal(stream, dense)


def test_duplicated_rows_pick_the_lower_index():
    """Exactly equal distances: every path picks the same neighbours as the
    lower-index rule (distinct targets per duplicate, so another pick would
    move the mean by O(1)), as JAX's kernels do."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(20, 3))
    X = np.concatenate([base, base, base])
    Y = rng.normal(size=(60, 2))
    Q = base + 0.0
    for k in (1, 2, 3, 4, 7):
        want = _lower_index_predict(X, Y, Q, k)
        jax_dense = np.asarray(jknn.knn_predict(X, Y, Q, k=k))
        jax_stream = np.asarray(jknn.knn_predict_streaming(X, Y, Q, k=k, query_chunk=8, train_chunk=16))
        dense = tknn.knn_predict(*_t(X, Y, Q), k=k, query_chunk=8).numpy()
        stream = tknn.knn_predict_streaming(*_t(X, Y, Q), k=k, query_chunk=8, train_chunk=16).numpy()
        for got in (jax_dense, jax_stream, dense, stream):
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(stream, dense)


def test_nearest_breaks_ties_to_the_lower_column():
    rng = np.random.default_rng(1)
    d2 = torch.as_tensor(rng.integers(0, 4, size=(50, 30)).astype(np.float64))
    d2[3, :] = 1.0  # a row of one value
    d2[4, 5] = float("nan")  # NaN counts as +inf
    for k in (1, 4, 17, 30):
        dist, cols = tknn._nearest(d2, k)
        a = torch.where(d2.isnan(), float("inf"), d2).numpy()
        want = np.stack([np.lexsort((np.arange(30), row))[:k] for row in a])
        np.testing.assert_array_equal(cols.numpy(), want)
        np.testing.assert_array_equal(dist.numpy(), np.take_along_axis(a, want, 1))


@pytest.mark.parametrize("stream_threshold", [10**9, 50])
def test_regressor_routes_past_the_thresholds(monkeypatch, stream_threshold):
    """The work threshold forced low sends ``predict`` to the device paths
    (dense, or streaming past 50 training rows): JAX within 1e-12."""
    for mod in (jknn, tknn):
        monkeypatch.setattr(mod, "_DEVICE_WORK_THRESHOLD", 1)
        monkeypatch.setattr(mod, "_STREAM_TRAIN_THRESHOLD", stream_threshold)
    rng = np.random.default_rng(11)
    X, Y, Q = _rand_problem(rng, 120, 30, 3, 2)
    got = tknn.KNNRegressor(n_neighbors=6, device="cpu").fit(X, Y).predict(Q)
    want = jknn.KNNRegressor(n_neighbors=6).fit(X, Y).predict(Q)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, tknn._knn_predict_np(X, Y, Q, 6), rtol=1e-9, atol=1e-9)


def test_regressor_host_path_and_state():
    rng = np.random.default_rng(12)
    X, Y, Q = _rand_problem(rng, 80, 20, 3, 1)
    jreg = jknn.KNNRegressor(n_neighbors=4).fit(X, Y[:, 0])
    treg = tknn.KNNRegressor.from_state(jreg.__getstate__(), device="cpu")
    np.testing.assert_array_equal(treg.predict(Q), jreg.predict(Q))
    assert treg.n_neighbors == 4 and treg.device.type == "cpu"


@pytest.mark.parametrize("device_threshold,stream_threshold", [(10**18, 10**9), (1, 10**9), (1, 50)])
def test_grid_search_picks_jax_k(monkeypatch, device_threshold, stream_threshold):
    for mod in (jknn, tknn):
        monkeypatch.setattr(mod, "_DEVICE_WORK_THRESHOLD", device_threshold)
        monkeypatch.setattr(mod, "_STREAM_TRAIN_THRESHOLD", stream_threshold)
    for seed in (13, 14):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(150, 3))
        Y = np.cos(X) @ np.ones((3, 2)) + 0.1 * rng.normal(size=(150, 2))
        grid = [3, 5, 9, 20]
        assert tknn.grid_search_knn(X, Y, grid, n_folds=3, device="cpu") == jknn.grid_search_knn(X, Y, grid, n_folds=3)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tknn.KNNRegressor(3)
    monkeypatch.setattr(tknn, "_DEVICE_WORK_THRESHOLD", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tknn.grid_search_knn(np.zeros((9, 2)), np.zeros(9), [1, 2])
