"""The port's extended framework against the JAX package's, float64 on the
CPU, on the same numpy inputs: the linear-Gaussian, kNN and hybrid
components (their fitted dicts within 1e-10, their scores on the training
and on a test pair), the classifier (classes, propensities, ``predict``,
``predict_proba``), the generic mixture with LG and with kNN components
from the same seeds (assignments, propensities, the winning restart,
``score`` and ``model_log_likelihood`` within 1e-9), a JAX-trained
mixture scored in the port through ``mixture_from_state``, the gzip cache
and its one-file-a-hash rule, the ``hex_hash`` deviation, the kernel error
re-raised through the restart protocol, and the process-parallel
restarts equal to the sequential ones."""

import glob
import hashlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.models import classifier as jclf
from multimodal_trajectory_modeling_tpu.models import hybrid as jhyb
from multimodal_trajectory_modeling_tpu.models import knn_model as jknnm
from multimodal_trajectory_modeling_tpu.models import linear_gaussian as jlg
from multimodal_trajectory_modeling_tpu.models import ssm_mixture as jmix
from multimodal_trajectory_modeling_tpu.models import statespace_api as jssa
from multimodal_trajectory_modeling_tpu_torch.models import classifier as tclf
from multimodal_trajectory_modeling_tpu_torch.models import hybrid as thyb
from multimodal_trajectory_modeling_tpu_torch.models import knn_model as tknnm
from multimodal_trajectory_modeling_tpu_torch.models import linear_gaussian as tlg
from multimodal_trajectory_modeling_tpu_torch.models import ssm_mixture as tmix
from multimodal_trajectory_modeling_tpu_torch.models.state_space_model import component_state
from multimodal_trajectory_modeling_tpu_torch.ops._build import KernelError

TOL = dict(rtol=1e-10, atol=1e-10)
SCORE_TOL = dict(rtol=1e-9, atol=1e-9)
CPU = dict(device="cpu")
LG_HP = {"alpha": 1.0}
KNN_HP = {"n_neighbors": [3, 5]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops per E step; beside the other test workers their
    thread pools contend, so this module runs them on one thread (the
    results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lg_pair(n, seed, T=5, d=2, l=3):
    rng = np.random.default_rng(42)
    A = rng.normal(scale=0.5, size=(d, d))
    H = rng.normal(size=(d, l))
    m = rng.normal(size=d)
    return jssa.sample_trajectory(n, T, m, np.eye(d) / 5.0, A, np.eye(d) / 2.0, H, np.eye(l) / 3.0,
                                  rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def pairs():
    """A training pair with 5% NaNs past the first step (the factorized
    kNN and hybrid scores of either package raise on a NaN initial state)
    and a complete test pair."""
    ztr, xtr = _lg_pair(150, 0)
    ztr[1:][np.random.default_rng(0).random(size=ztr[1:].shape) < 0.05] = np.nan
    xtr[np.random.default_rng(1).random(size=xtr.shape) < 0.05] = np.nan
    return (ztr, xtr), _lg_pair(60, 1)


def _two_cluster_data(seed, n_data, n_timesteps=5):
    rng = np.random.default_rng(seed)
    d_hidden, d_observed = 2, 3
    A = np.stack([rng.normal(scale=0.5, size=(d_hidden, d_hidden)) for _ in range(2)])
    G = np.stack([np.eye(d_hidden) / (c + 2.0) for c in range(2)])
    H = np.stack([rng.normal(size=(d_hidden, d_observed)) for _ in range(2)])
    L = np.stack([(c + 1.0) * np.eye(d_observed) for c in range(2)])
    z = np.empty((n_timesteps, n_data, d_hidden))
    x = np.empty((n_timesteps, n_data, d_observed))
    labels = np.empty(n_data, dtype=int)
    for i in range(n_data):
        c = int(rng.choice(2, p=[0.4, 0.6]))
        labels[i] = c
        zi, xi = jssa.sample_trajectory(1, n_timesteps, np.zeros(d_hidden), G[c], A[c], G[c], H[c], L[c], rng=rng)
        z[:, i], x[:, i] = zi[:, 0], xi[:, 0]
    return z, x, labels


def _assert_same_blocks(got, want):
    """Two components' sub-model dicts (kNN regressors as their state)."""
    got, want = component_state(got), component_state(want)
    for slot in want:
        assert set(got[slot]) == set(want[slot])
        for key, w in want[slot].items():
            g = got[slot][key]
            if isinstance(w, dict):
                assert g["n_neighbors"] == w["n_neighbors"]
                np.testing.assert_array_equal(g["_x"], w["_x"])
                np.testing.assert_allclose(g["_y"], w["_y"], **TOL)
            else:
                np.testing.assert_allclose(g, w, **TOL)


_COMPONENTS = {
    "lg": (jlg.StateSpaceLinearGaussian, tlg.StateSpaceLinearGaussian, LG_HP),
    "lg-eps": (jlg.StateSpaceLinearGaussian, tlg.StateSpaceLinearGaussian, {}),
    "knn": (jknnm.StateSpaceKNN, tknnm.StateSpaceKNN, {"n_neighbors": [3, 5, 10]}),
    "hybrid": (jhyb.StateSpaceHybrid, thyb.StateSpaceHybrid, {"n_neighbors": [3, 5, 10], "alpha": 1.0}),
}


@pytest.mark.parametrize("kind", sorted(_COMPONENTS))
def test_components_match_jax(pairs, kind):
    jcls, tcls, hp = _COMPONENTS[kind]
    train, test = pairs
    jm = jcls(**hp).fit(train)
    tm = tcls(**hp, **CPU).fit(train)
    _assert_same_blocks(tm, jm)
    assert str(tm) == str(jm)
    for data in (train, test):
        np.testing.assert_allclose(tm.score(data), jm.score(data), **TOL)
    if kind.startswith("lg"):
        np.testing.assert_allclose(tm.score(), jm.score(), **TOL)
        np.testing.assert_allclose(tm.score_alt(test), jm.score_alt(test), **TOL)
    # the pickle round trip, and the JAX component's state carried across
    back = tcls(**CPU).from_pickle(tm.to_pickle())
    np.testing.assert_array_equal(back.score(test), tm.score(test))
    carried = tcls.from_state(component_state(jm), **hp, **CPU)
    np.testing.assert_allclose(carried.score(test), jm.score(test), **TOL)


def test_classifier_matches_jax():
    z, x, labels = _two_cluster_data(0, 50, n_timesteps=4)
    z[2:, 30:] = np.nan
    x[2:, 30:] = np.nan
    jc = jclf.StateSpaceModelClassifier(component_model=jlg.StateSpaceLinearGaussian).fit(data=(z, x), labels=labels)
    tc = tclf.StateSpaceModelClassifier(component_model=tlg.StateSpaceLinearGaussian, **CPU).fit(
        data=(z, x), labels=labels)
    np.testing.assert_array_equal(tc.classes, jc.classes)
    np.testing.assert_allclose(tc.propensities, jc.propensities, **TOL)
    zt, xt, _ = _two_cluster_data(1, 30, n_timesteps=4)
    for data in (None, (zt, xt)):
        probs = jc.predict_proba(data)  # JAX's predict is its argmax
        np.testing.assert_allclose(tc.predict_proba(data), probs, **TOL)
        np.testing.assert_array_equal(tc.predict(data), jc.classes[probs.argmax(1)])
        np.testing.assert_allclose(tc.score(data), jc.score(data), rtol=1e-10)


def _fit_both(component, hp, z, x, monkeypatch, tmp_path, **fit_kw):
    for mod in (jmix, tmix):
        monkeypatch.setattr(mod, "home_dir", str(tmp_path))
    jcls, tcls = component
    jm = jmix.StateSpaceMixtureModel(2, (z, x), jcls, component_model_hyperparams=hp).fit(**fit_kw)
    tm = tmix.StateSpaceMixtureModel(2, (z, x), tcls, component_model_hyperparams=hp, **CPU).fit(**fit_kw)
    return jm, tm


def _jax_numbers(jm, data=None):
    """What the port is held to: each of JAX's numbers computed once (its
    component scores recompile at every new shape)."""
    return dict(score=jm.score(data), model_log_likelihood=jm.model_log_likelihood(data),
                predict_proba=jm.predict_proba(data))


def _assert_same_numbers(tm, want, data=None):
    for name, w in want.items():
        np.testing.assert_allclose(getattr(tm, name)(data), w, **SCORE_TOL)
    probs = want["predict_proba"]
    np.testing.assert_array_equal(tm.predict(data=data, letters=False), probs.argmax(1))
    np.testing.assert_allclose(tm.cluster_assignment_index(cluster="B", data=data),
                               tm.predict_proba(data, return_prenormalized_log_probs=True)[1][1], rtol=0)


@pytest.mark.parametrize("kind,hp,seed,n,init", [("lg", LG_HP, 7, 40, "kmeans"), ("knn", KNN_HP, 3, 70, "kmeans-take-finite")])
def test_generic_mixture_matches_jax(kind, hp, seed, n, init, monkeypatch, tmp_path):
    """From a k-means start (the port's own k-means) and the same restart
    seeds: the same restarts and the same winner (its RNG, seeded
    ``default_rng(i)`` and drawn from identically, ends in the same state
    in both packages).  A JAX-trained mixture carried across by
    ``mixture_from_state`` scores the same in the port."""
    z, x, _labels = _two_cluster_data(seed, n, n_timesteps=4)
    z[2, :10] = np.nan
    jm, tm = _fit_both(_COMPONENTS[kind][:2], hp, z, x, monkeypatch, tmp_path, init=init, n_restarts=2,
                       use_cache=False)
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state
    np.testing.assert_array_equal(tm.cluster_assignment, jm.cluster_assignment)
    np.testing.assert_allclose(tm.cluster_propensities, jm.cluster_propensities, **TOL)
    carried = tmix.mixture_from_state(2, (z, x), _COMPONENTS[kind][1], tmix.mixture_state(jm),
                                      component_model_hyperparams=hp, **CPU)
    np.testing.assert_array_equal(carried.cluster_assignment, jm.cluster_assignment)
    zt, xt, _ = _two_cluster_data(4, 40, n_timesteps=4)
    for data in (None, (zt, xt)):
        want = _jax_numbers(jm, data)
        _assert_same_numbers(tm, want, data)
        _assert_same_numbers(carried, want, data if data is not None else (z, x))


def test_cache_round_trip_and_one_file_a_hash(monkeypatch, tmp_path):
    """The fit writes ``tmp/mmm-<hash>-<ts>.p.gz``, a refit loads it, and
    ``to_pickle`` leaves one file a hash; the JAX package's file for the
    same inputs has another hash and survives."""
    for mod in (jmix, tmix):
        monkeypatch.setattr(mod, "home_dir", str(tmp_path))
    z, x, _labels = _two_cluster_data(6, 50, n_timesteps=4)
    jm = jmix.StateSpaceMixtureModel(2, (z, x), jlg.StateSpaceLinearGaussian, component_model_hyperparams=LG_HP)
    jm.to_pickle()
    kw = dict(component_model_hyperparams=LG_HP, **CPU)
    tm = tmix.StateSpaceMixtureModel(2, (z, x), tlg.StateSpaceLinearGaussian, **kw).fit(use_cache=True)
    tm.to_pickle(there_can_only_be_one=False)
    tm.to_pickle(there_can_only_be_one=False)
    tm.to_pickle(there_can_only_be_one=True)
    tdir = os.path.join(str(tmp_path), "tmp")
    assert len(glob.glob(os.path.join(tdir, f"mmm-{tm.hex_hash}*"))) == 1
    assert len(glob.glob(os.path.join(tdir, f"mmm-{jm.hex_hash}*"))) == 1
    again = tmix.StateSpaceMixtureModel(2, (z, x), tlg.StateSpaceLinearGaussian, **kw).fit(use_cache=True)
    np.testing.assert_array_equal(again.cluster_assignment, tm.cluster_assignment)
    assert again.last_trained == tm.last_trained
    np.testing.assert_allclose(again.score(), tm.score(), rtol=1e-12)
    back = tmix.StateSpaceMixtureModel.from_pickle(glob.glob(os.path.join(tdir, f"mmm-{tm.hex_hash}*"))[0],
                                                   training_data={"states": z, "observations": x}, **CPU)
    assert back.correspondence == tm.correspondence and back.device.type == "cpu"


def test_hex_hash_deviates_from_jax_by_the_component_class():
    """The reference's recipe over this package's ``str(component_model)``:
    another hash than JAX's for the same inputs, and the device and dtype
    in neither the hash nor the hyperparameters."""
    z, x, _labels = _two_cluster_data(7, 20)
    tm = tmix.StateSpaceMixtureModel(2, (z, x), tlg.StateSpaceLinearGaussian, component_model_hyperparams=LG_HP, **CPU)
    jm = jmix.StateSpaceMixtureModel(2, (z, x), jlg.StateSpaceLinearGaussian, component_model_hyperparams=LG_HP)
    want = hashlib.md5(
        z.tobytes() + x.tobytes() + b"2" + str(tlg.StateSpaceLinearGaussian).encode("utf-8")
        + json.dumps(LG_HP, sort_keys=True).encode("utf-8")
    ).hexdigest()
    assert tm.hex_hash == want != jm.hex_hash
    f32 = tmix.StateSpaceMixtureModel(2, (z, x), tlg.StateSpaceLinearGaussian, component_model_hyperparams=LG_HP,
                                      device="cpu", dtype=torch.float32)
    assert f32.hex_hash == tm.hex_hash and f32.component_model_hyperparams == LG_HP
    assert f32.cluster_models[0].dtype == torch.float32 and tm.cluster_models[0].dtype == torch.float64


class _Raises:
    def __init__(self, err):
        self.err = err

    def fit(self, **_kw):
        raise self.err


@pytest.mark.parametrize("where", ["em", "restarts", "worker"])
def test_kernel_errors_propagate_and_degenerate_starts_are_skipped(monkeypatch, where):
    z, x, _labels = _two_cluster_data(8, 40)
    mdl = tmix.StateSpaceMixtureModel(2, (z, x), tlg.StateSpaceLinearGaussian, component_model_hyperparams=LG_HP, **CPU)
    for err, propagates in ((KernelError("launch failed"), True), (ValueError("singular"), False)):
        with monkeypatch.context() as mp:
            if where == "restarts":
                mp.setattr(tmix.StateSpaceMixtureModel, "_sibling", lambda self, seed, err=err: _Raises(err))
                run = lambda: mdl.fit(n_restarts=2, use_cache=False)  # noqa: E731
            else:
                def boom(self, err=err):
                    raise err

                mp.setattr(tmix.StateSpaceMixtureModel, "_M_step", boom)
                if where == "em":
                    run = lambda: mdl.fit(use_cache=False)  # noqa: E731
                else:
                    run = lambda: tmix._restart_worker(  # noqa: E731
                        (z, x, 2, tlg.StateSpaceLinearGaussian, LG_HP, [0, 1], 5, "cpu", torch.float64))
            if propagates:
                with pytest.raises(KernelError):
                    run()
            elif where == "worker":
                assert run() == {}
            elif where == "em":
                # the start is skipped; with no restart left the fit fails
                # as the reference's does
                with pytest.raises(Exception, match="training failed"):
                    run()
            else:
                assert run() is mdl


def test_parallel_restarts_match_sequential(monkeypatch, tmp_path):
    """``n_jobs=2`` reproduces the sequential restart protocol (the same
    per-seed models, the same strictly-greater winner); the workers
    themselves complete (the sequential replay is a guard, not the
    expected path)."""
    monkeypatch.setattr(tmix, "home_dir", str(tmp_path))
    z, x, _labels = _two_cluster_data(9, 60, n_timesteps=4)
    kw = dict(n_clusters=2, data=(z, x), component_model=tlg.StateSpaceLinearGaussian,
              component_model_hyperparams=LG_HP, **CPU)
    seq = tmix.StateSpaceMixtureModel(**kw).fit(n_restarts=4, use_cache=False, n_jobs=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        par = tmix.StateSpaceMixtureModel(**kw).fit(n_restarts=4, use_cache=False, n_jobs=2)
    deaths = [str(w.message) for w in caught if "restart worker exited" in str(w.message)]
    assert not deaths, deaths
    np.testing.assert_array_equal(seq.cluster_assignment, par.cluster_assignment)
    np.testing.assert_allclose(seq.score(), par.score(), rtol=1e-12)
