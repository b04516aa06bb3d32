"""The drivers' host layer in the port against the JAX package's: the LME
and survival copies and the state-space helpers (1e-12 relative; figure
functions by the data they draw, and that they draw), the ADNI summary and
the MACC gate, the post-hoc statistics without scikit-learn (ridge
residuals 1e-10; AUCs within 1e-3 where the choice of C agrees; the chosen
C equal wherever scikit-learn's CV scores separate the two best by more
than 1e-3) and the scikit-learn stand-ins (``KFold``/``StratifiedKFold``
folds equal, the t = 0 Gaussian mixture's labels equal on ADNI's fold 0 and
its probabilities within 1e-8).
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from _torch_logit_rule import check_stratified_fold_aucs

from multimodal_trajectory_modeling_tpu.utils import lme as jlme
from multimodal_trajectory_modeling_tpu.utils import post_hoc as jph
from multimodal_trajectory_modeling_tpu.utils import state_space as jssu
from multimodal_trajectory_modeling_tpu.utils import survival as jsurv
from multimodal_trajectory_modeling_tpu_torch.utils import lme as plme
from multimodal_trajectory_modeling_tpu_torch.utils import post_hoc as pph
from multimodal_trajectory_modeling_tpu_torch.utils import skl
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as pssu
from multimodal_trajectory_modeling_tpu_torch.utils import survival as psurv

REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread_each():
    """The fits here are many small torch and numpy operations; beside the
    other test workers their thread pools contend and each slows many
    times over, so this module runs torch and the BLAS on one thread and
    lets scikit-learn's ``n_jobs=-1`` (in the JAX package's post-hoc
    helpers) start no worker processes.  No result depends on these."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp, threadpool_limits(1):
        mp.setenv("LOKY_MAX_CPU_COUNT", "1")
        yield
    torch.set_num_threads(threads)


def _close(a, b, rel=REL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(1.0, float(np.nanmax(np.abs(b)))))


def _lme_frame(seed=0, n_groups=80, per_group=4):
    rng = np.random.default_rng(seed)
    rows = []
    for g in range(n_groups):
        b, cl = rng.normal(scale=0.8), rng.choice(["A", "B", "C"])
        for _ in range(per_group):
            xv = rng.normal()
            y = 1 + 0.5 * xv + {"A": 0, "B": 1, "C": 2}[cl] - 0.7 * (cl == "C") * xv + b + rng.normal(scale=0.5)
            rows.append((g, cl, xv, y))
    return pd.DataFrame(rows, columns=["ids", "cluster", "x", "y"])


def test_lme_matches_jax():
    df = _lme_frame()
    j = jlme.mixedlm("y ~ cluster * x", df, groups=df["ids"].to_numpy()).fit()
    p = plme.mixedlm("y ~ cluster * x", df, groups=df["ids"].to_numpy()).fit()
    _close(p.params.values, j.params.values)
    _close(p.bse.values, j.bse.values)
    _close([p.sigma2, p.tau2], [j.sigma2, j.tau2])
    _close(p.anova().select_dtypes("number").values, j.anova().select_dtypes("number").values)
    for a, b in zip(plme.emtrends(p, "x"), jlme.emtrends(j, "x")):
        _close(a.select_dtypes("number").values, b.select_dtypes("number").values)
    assert list(p.params.index) == list(j.params.index)


def _cox_frame(n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    t = rng.exponential(1.0 / np.exp(X @ np.array([0.8, -0.5])))
    cens = rng.exponential(2.0, size=n)
    return pd.DataFrame({"x0": X[:, 0], "x1": X[:, 1], "dur": np.round(np.minimum(t, cens), 2), "ev": (t <= cens) * 1.0})


def test_survival_matches_jax():
    df = _cox_frame()
    for pen in (0.0, 0.1):
        j = jsurv.CoxPHFitter(penalizer=pen).fit(df, "dur", "ev")
        p = psurv.CoxPHFitter(penalizer=pen).fit(df, "dur", "ev")
        _close(p.params_.values, j.params_.values)
        assert p.score(df, scoring_method="concordance_index") == j.score(df, scoring_method="concordance_index")
    s = np.random.default_rng(1).normal(size=len(df))
    assert psurv.concordance_index(df.dur, s, df.ev) == jsurv.concordance_index(df.dur, s, df.ev)
    _close(
        psurv.k_fold_cross_validation(psurv.CoxPHFitter(penalizer=0.1), df, "dur", "ev", k=4, seed=3),
        jsurv.k_fold_cross_validation(jsurv.CoxPHFitter(penalizer=0.1), df, "dur", "ev", k=4, seed=3),
    )


def test_state_space_helpers_match_jax(capsys):
    rng = np.random.default_rng(5)
    z, x = rng.normal(size=(4, 30, 2)), rng.normal(size=(4, 30, 3))
    z[rng.random(z.shape) < 0.2] = np.nan
    for a, b in zip(pssu.parcellate_arrays(z, x), jssu.parcellate_arrays(z, x)):
        np.testing.assert_array_equal(a, b)
    for s in ("CDR (sum)", "MTM-derived index", "__a  b__"):
        assert pssu.slugify(s) == jssu.slugify(s)
    names = ["adni_mem_init_and_a_long_tail_of_characters_here", "x_y"]
    assert pssu.tidy_labels(names) == jssu.tidy_labels(names)
    assert pssu.today_str() == jssu.today_str()
    metric = rng.normal(size=(60, 2))
    clusters = np.array(list("ABC") * 20)
    jssu.summarize_metric_vs_cluster(metric, clusters, names=["m0", "m1"])
    want = capsys.readouterr().out
    pssu.summarize_metric_vs_cluster(metric, clusters, names=["m0", "m1"])
    assert capsys.readouterr().out == want
    # the figure helpers' data
    mean, cov = np.array([1.0, -0.1]), np.array([[4.0, 0.3], [0.3, 0.5]])
    gx, gy = np.meshgrid(np.linspace(-5, 5, 50), np.linspace(-2, 2, 40))
    dens = pssu._gaussian_density_grid(mean, cov, gx, gy)
    _close(dens, jssu._gaussian_density_grid(mean, cov, gx, gy))
    assert pssu._hpd_threshold(dens, 0.68) == jssu._hpd_threshold(dens, 0.68)
    pts = np.linspace(-3, 3, 11)
    _close(pssu._normal_pdf(pts, 0.5, 2.0), jssu._normal_pdf(pts, 0.5, 2.0))
    w = rng.random(size=(30, 3))
    for soft in (True, False):
        for a, b in zip(
            pssu._weighted_trajectory_stats(z, w, 1, soft, 3), jssu._weighted_trajectory_stats(z, w, 1, soft, 3)
        ):
            _close(a, b)


def test_plotters_draw(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(6)
    metric = rng.normal(size=(4, 40))
    letters = np.array(list("AB") * 20)
    pssu.plot_metric_vs_clusters_over_time(metric, letters, "m", savename=tmp_path / "a.pdf", title="t")
    pssu.histograms_by_cluster(
        savename=tmp_path / "b.pdf", metrics=metric.T[:, :2], metric_names=["u", "v"], clusters=letters
    )
    pssu.histogram(metric.ravel(), savename=tmp_path / "c.pdf")
    pssu.pies_by_cluster(savename=tmp_path / "d.pdf", categories=letters[::-1], clusters=letters)
    pssu.pie(letters, savename=tmp_path / "e.pdf")
    vals = rng.normal(size=(4, 40, 2))
    pssu.plot_weighted_means_2d_trajectories(
        rng.random(size=(40, 2)), vals, ["#0072CE", "#E87722"], tmp_path / "f.pdf",
        xlim=(-3, 3), ylim=(-3, 3), grid_resolution=50,
    )
    import matplotlib.pyplot as plt

    plt.close("all")
    assert all((tmp_path / f"{c}.pdf").stat().st_size > 0 for c in "abcdef")


def test_adni_summary_and_macc_gate_match_jax(capsys):
    from multimodal_trajectory_modeling_tpu.utils import adni as jadni
    from multimodal_trajectory_modeling_tpu.utils import macc as jmacc
    from multimodal_trajectory_modeling_tpu_torch.utils import adni as padni
    from multimodal_trajectory_modeling_tpu_torch.utils import macc as pmacc

    jadni._summary_stats()
    want = capsys.readouterr().out
    padni._summary_stats()
    assert capsys.readouterr().out == want
    assert pmacc.data_available() is jmacc.data_available() is False
    assert pmacc.diagnosis_list == jmacc.diagnosis_list
    assert pmacc.cluster_colors == jmacc.cluster_colors
    np.testing.assert_array_equal(np.array(pmacc.diagnosis_colors), np.array(jmacc.diagnosis_colors))
    d = np.array([[["NCI"], ["CIND"]], [["CIND"], [None]], [["AD"], [None]]], dtype=object)
    np.testing.assert_array_equal(pmacc.get_final_diagnoses(d), jmacc.get_final_diagnoses(d))


def test_ridge_residuals_match_jax():
    rng = np.random.default_rng(7)
    for n, p in ((300, 1), (173, 3)):
        effect = rng.normal(70, 8, size=(n, p))
        y = effect @ rng.normal(size=(p, 1)) * 0.3 + rng.normal(size=(n, 1))
        y[3] = np.nan
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jph.regressed_out_effect_cv(y, effect)
            got = pph.regressed_out_effect_cv(y, effect)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=1e-10 * np.abs(want[fin]).max())


def _logit_data(seed, n=240):
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.normal(size=n), rng.normal(50, 10, size=n)])
    y = ((X[:, 0] + 0.05 * (X[:, 1] - 50) + rng.normal(size=n)) > 0.8).astype(int)
    return X, y


@pytest.mark.parametrize("seed", [0, 1])
def test_logistic_cv_matches_sklearn(seed):
    import sklearn.linear_model as lm
    import sklearn.metrics as mets
    import sklearn.model_selection as ms

    X, y = _logit_data(seed)
    compared = 0
    for tr, te in ms.StratifiedKFold(10, shuffle=True, random_state=42).split(X, y):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = lm.LogisticRegressionCV().fit(X[tr], y[tr])
        got = pph.LogisticRegressionCV().fit(X[tr], y[tr])
        summed = np.sort(ref.scores_[1].sum(axis=0))[::-1]
        if summed[0] - summed[1] > 1e-3:
            assert got.C_ == ref.C_[0]
        if got.C_ == ref.C_[0]:
            compared += 1
            a = mets.roc_auc_score(y[te], ref.predict_proba(X[te])[:, 1])
            b = skl.roc_auc_score(y[te], got.predict_proba(X[te])[:, 1])
            assert abs(a - b) <= 1e-3
    assert compared >= 8


def test_logit_auc_and_stratified_metrics_match_jax():
    X, y = _logit_data(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert abs(pph.logit_cv_auc(X, y) - jph.logit_cv_auc(X, y)) <= 1e-3
        want, want_perf = jph.stratified_logit_cv_metrics(X, y.reshape(-1, 1).copy(), return_perfs=True)
    got, got_perf = pph.stratified_logit_cv_metrics(X, y.reshape(-1, 1).copy(), return_perfs=True)
    check_stratified_fold_aucs(X, y, got, want)
    assert set(got_perf) == set(want_perf)


def test_folds_and_auc_match_sklearn():
    import sklearn.metrics as mets
    import sklearn.model_selection as ms

    rng = np.random.default_rng(8)
    y = (rng.random(157) < 0.3).astype(int)
    s = np.round(rng.normal(size=157), 1)  # ties
    assert abs(skl.roc_auc_score(y, s) - mets.roc_auc_score(y, s)) <= 1e-12
    for ref, got in (
        (ms.KFold(10, shuffle=True, random_state=42), skl.KFold(10, shuffle=True, random_state=42)),
        (ms.KFold(5), skl.KFold(5)),
        (ms.StratifiedKFold(10, shuffle=True, random_state=42), skl.StratifiedKFold(10, shuffle=True, random_state=42)),
        (ms.StratifiedKFold(5), skl.StratifiedKFold(5)),
    ):
        for (a, b), (c, d) in zip(ref.split(s, y), got.split(s, y)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_gaussian_mixture_matches_sklearn_on_adni_fold0():
    import sklearn.mixture as skm

    from multimodal_trajectory_modeling_tpu_torch.utils import adni

    z, x, *_ = adni.get_trajectories()
    train, test = next(iter(skl.KFold(10, shuffle=True, random_state=42).split(z[0])))
    t0 = np.concatenate([z, x], axis=-1)[0]
    kw = dict(covariance_type="full", max_iter=1000, init_params="kmeans", random_state=42)
    ref, got = skm.GaussianMixture(4, **kw), skl.GaussianMixture(4, **kw)
    np.testing.assert_array_equal(got.fit_predict(t0[train]), ref.fit_predict(t0[train]))
    np.testing.assert_array_equal(got.predict(t0[test]), ref.predict(t0[test]))
    np.testing.assert_allclose(got.predict_proba(t0[test]), ref.predict_proba(t0[test]), rtol=0, atol=1e-8)


@pytest.mark.parametrize("seed", [0, 42])
def test_one_run_kmeans_matches_sklearn(seed):
    """``kmeans_labels(n_init=1)``, the Gaussian mixture's start, against
    scikit-learn's ``KMeans(n_init=1)`` from the same seed."""
    import sklearn.cluster as skc

    from multimodal_trajectory_modeling_tpu_torch.models.kmeans import kmeans_labels

    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(loc=c, size=(150, 3)) for c in (-3.0, 0.0, 2.5, 6.0)])
    want = skc.KMeans(n_clusters=4, n_init=1, random_state=seed).fit(X).labels_
    np.testing.assert_array_equal(kmeans_labels(X, 4, random_state=seed, n_init=1), want)
