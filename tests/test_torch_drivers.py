"""The port's experiment drivers (``drivers/``) against the JAX drivers on
the CPU in float64, at 2 restarts:

- the cross-validation's fold 0 through both drivers' fold functions
  (``_standardized_split``, ``_fit_fold_mixture``, ``_gmm_baseline``,
  ``_heldout_variants``): assignments, letters and prevalences equal,
  parameters and scores within 1e-10;
- the collate stage on one set of the port's xval artifacts: every table
  the two drivers build and print equal, every CSV equal, numbers within
  1e-10 (the drivers' ``main`` end to end, figures and the AUC batches
  included, in the slow test: there the AUC batches are held batch by
  batch to the logistic-CV rule of ``_torch_logit_rule.py``, since
  scikit-learn's L-BFGS, stopped at 1e-4, flips the choice among Cs whose
  CV scores lie within 1e-3 in a few batches);
- the model-selection criteria for C ≤ 3;
- the scale sweep at n = 2000, and the MACC driver's gate.

Both packages cache fits under ``<home_dir>/tmp``; each test points both
at its own temporary directory, so no fit is read from an earlier one.
"""

import contextlib
import gzip
import importlib.util
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from _torch_logit_rule import check_stratified_fold_aucs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STARTS = 2


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


def _load_jax_driver(name):
    spec = importlib.util.spec_from_file_location(name.replace("-", "_"), os.path.join(REPO, "drivers", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _caches_in(path):
    from multimodal_trajectory_modeling_tpu.models import mixture as jmix
    from multimodal_trajectory_modeling_tpu_torch.models import mixture as pmix

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmix, "home_dir", str(path / "jax"))
        mp.setattr(pmix, "home_dir", str(path / "port"))
        yield


@pytest.fixture(scope="module")
def xval_artifacts(tmp_path_factory):
    """The port's xval driver at 2 restarts on the CPU: its working
    directory (``results/``, ``posthoc/results/``) and its return."""
    from multimodal_trajectory_modeling_tpu_torch.drivers import inference_adni_xval as pxv

    root = tmp_path_factory.mktemp("xval")
    cwd = os.getcwd()
    with _caches_in(root), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pxv, "N_STARTS", N_STARTS)
        os.chdir(root)
        try:
            out = pxv.run(device="cpu", report=None)
        finally:
            os.chdir(cwd)
    return root, out


def test_xval_fold0_matches_jax(tmp_path, monkeypatch):
    from multimodal_trajectory_modeling_tpu_torch.drivers import inference_adni_xval as pxv
    from multimodal_trajectory_modeling_tpu_torch.utils import adni

    jxv = _load_jax_driver("inference-adni-xval.py")
    monkeypatch.setattr(jxv, "N_STARTS", N_STARTS)
    z, x, d, ids, _t = adni.get_trajectories()
    zd = z.shape[-1]
    markers = np.concatenate([z, x], axis=-1)
    train, test = pxv.fold_masks()[0]
    p_tr, p_te = pxv._standardized_split(markers[:, train], markers[:, test], zd)
    j_tr, j_te = jxv._standardized_split(markers[:, train], markers[:, test], zd)
    np.testing.assert_array_equal(p_tr, j_tr)
    np.testing.assert_array_equal(p_te, j_te)
    with _caches_in(tmp_path):
        np.random.seed(0)
        jm = jxv._fit_fold_mixture(j_tr, zd, d[:, train])
        np.random.seed(0)
        pm = pxv._fit_fold_mixture(p_tr, zd, d[:, train], n_starts=N_STARTS, device="cpu")
    np.testing.assert_array_equal(pm.mle_cluster_assignment(), np.asarray(jm.mle_cluster_assignment()))
    assert pm.correspondence == jm.correspondence
    np.testing.assert_array_equal(np.asarray(pm.cluster_propensities), np.asarray(jm.cluster_propensities))
    for name in ("init_state_means", "init_state_covs", "transition_matrices", "transition_covs",
                 "measurement_matrices", "measurement_covs"):
        np.testing.assert_allclose(np.asarray(getattr(pm, name)), np.asarray(getattr(jm, name)), rtol=1e-10, atol=1e-10)
    pv, jv = pxv._heldout_variants(pm, p_te, zd), jxv._heldout_variants(jm, j_te, zd)
    assert set(pv) == set(jv)
    for key in jv:
        a, b = np.asarray(pv[key]), np.asarray(jv[key])
        if a.dtype.kind in "US":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a.astype(float), b.astype(float), rtol=1e-10, atol=1e-10)
    for a, b in zip(
        pxv._gmm_baseline(z[:, train], x[:, train], z[:, test], x[:, test], d[:, train]),
        jxv._gmm_baseline(z[:, train], x[:, train], z[:, test], x[:, test], d[:, train]),
    ):
        if a.dtype.kind in "US":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


def test_xval_artifacts(xval_artifacts):
    root, out = xval_artifacts
    stem = "ADNI_r7_xval10_4clusters"
    assert len(out["folds"]) == 10
    assert all(f["status"] in (0, 1) for f in out["folds"])
    for f in out["folds"]:
        assert abs(sum(f["prevalence"].values()) - 1.0) < 1e-12
    frame = pd.read_csv(root / "results" / f"{stem}_results.csv")
    assert sorted(frame.split.unique().tolist()) == list(range(10))
    for tag in ("mtm_post", "mtm_init_post", "gmm_init_post"):
        post = pd.read_csv(root / "posthoc" / "results" / f"{stem}_{tag}.csv", index_col="id")
        np.testing.assert_allclose(post.sum(axis=1).values, 1.0, atol=1e-9)
    with gzip.open(root / "results" / f"{stem}_results.p.gz", "rb") as f:
        assert sorted(pickle.load(f)) == list(range(10))


def _collate_tables(mod, root, on_final=None):
    """Every table the collate driver's ``main`` builds, prints or writes,
    in its order, without the figures and the AUC batches: ``(printed
    text, written files)``.  ``on_final(mod, df_final, ids0)``, if given,
    runs in the same directory once the final-visit frame is built."""
    cwd = os.getcwd()
    os.chdir(root)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), pd.option_context(
            "display.width", 79, "display.max_colwidth", 79, "display.max_columns", 1000,
            "display.float_format", "{:,.3f}".format,
        ):
            data = mod.data
            z, x, d, ids, time_, mmse, age = data.get_trajectories(return_mmse=True, return_approx_age=True)
            n_subjects, ids0 = z[0].shape[0], ids[0].ravel()
            d_fin = data.get_final_diagnoses(d)
            df_fin = pd.DataFrame(data=d_fin, index=ids0, columns=["diagnosis"])
            stem = mod.STEM
            df_results = pd.read_csv(mod._newest(os.path.join("results", f"{stem}_results.csv"))).set_index("id")
            with gzip.open(mod._newest(os.path.join("results", f"{stem}_results.p.gz")), "rb") as f:
                d_tr = pickle.load(f)
            os.makedirs(os.path.join("posthoc", "results"), exist_ok=True)
            at_baseline = df_results.our_cluster.to_numpy()[:n_subjects]
            mod._print_demographics(ids0, at_baseline, age[0])
            train_by_split, outcomes_sum = mod._collect_split_tables(d_tr, df_results, df_fin)
            outcomes_sum = outcomes_sum.fillna(0.0)
            mod._print_pooled_outcomes(outcomes_sum)
            mod._print_baseline_composition(df_results, df_fin)
            final_id_ti = mod._final_visits(df_results).set_index("time", append=True).index
            mod._print_stability_reports(df_results, final_id_ti)
            df_bio = pd.DataFrame(
                data={
                    "ids": ids[:-1].ravel(), "amyl_prev": z[:-1, :, 0].ravel(),
                    "gm_diff": np.diff(z[..., -1], axis=0).ravel(), "moca_diff": np.diff(x[..., -1], axis=0).ravel(),
                    "adni_mem_diff": np.diff(x[..., 0], axis=0).ravel(),
                    "cluster": df_results.our_cluster[: ids[:-1].size].to_numpy(), "age": age[:-1].ravel(),
                }
            ).dropna()
            res = mod.lme.mixedlm("gm_diff ~ cluster * amyl_prev", df_bio, groups=df_bio["ids"].to_numpy()).fit()
            print(res.params.to_string(float_format="{:.12e}".format))
            df0 = mod._build_visitwise_frame(df_results, z, x, mmse, age)
            df_final = mod._build_final_visit_frame(df0, final_id_ti)
            if on_final is not None:
                on_final(mod, df_final, ids0)
            df_bio.to_csv(mod._posthoc_csv("biomarkers_by_cluster_over_time.csv"))
            df_final.to_csv(mod._posthoc_csv("prognostics_all.csv"))
            mod._export_mmse_over_time(df0)
            mod._export_survival_frame(df0, ids0)
            mod._report_training_tables(train_by_split)
            mod._report_conversion_pivots(df_results, ids0, d_fin)
            mod._report_length_table(df_final)
    finally:
        os.chdir(cwd)
    files = {p: (root / "posthoc" / "results" / p).read_bytes() for p in (
        "biomarkers_by_cluster_over_time.csv", "prognostics_all.csv", "mmse_by_cluster_over_time.csv",
        "survival_modelling_data.csv")}
    files |= {p: (root / "results" / p).read_bytes() for p in (
        "cluster_rates_training.csv", "outcomes_by_cluster_training.csv")}
    return buf.getvalue(), files


def _copy_tree(src, dst):
    import shutil

    shutil.copytree(src / "results", dst / "results")
    shutil.copytree(src / "posthoc", dst / "posthoc")


def test_collate_tables_match_jax(xval_artifacts, tmp_path):
    from multimodal_trajectory_modeling_tpu_torch.drivers import inference_adni_xval_collate_results as pcol

    jcol = _load_jax_driver("inference-adni-xval-collate-results.py")
    root, _ = xval_artifacts
    outs = []
    for mod, name in ((jcol, "jax"), (pcol, "port")):
        _copy_tree(root, tmp_path / name)
        outs.append(_collate_tables(mod, tmp_path / name))
    (jtext, jfiles), (ptext, pfiles) = outs
    assert ptext == jtext
    assert "maintain labels" in ptext
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name


@pytest.mark.slow
def test_collate_drivers_end_to_end_match(xval_artifacts, tmp_path, monkeypatch):
    """Both collate drivers' ``main`` as scripts on the port's artifacts:
    the same printed report, every CSV byte for byte but the AUC batches,
    which agree in features and batches, and in AUC batch by batch under
    the logistic-CV rule (``_torch_logit_rule.py``), on the feature sets
    the port's driver passes to ``stratified_logit_cv_metrics``."""
    from multimodal_trajectory_modeling_tpu_torch.drivers import inference_adni_xval_collate_results as pcol

    root, _ = xval_artifacts
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    outs = {}
    for name, cmd in (
        ("jax", [sys.executable, os.path.join(REPO, "drivers", "inference-adni-xval-collate-results.py")]),
        ("port", [sys.executable, "-m", "multimodal_trajectory_modeling_tpu_torch.drivers."
                  "inference_adni_xval_collate_results"]),
    ):
        _copy_tree(root, tmp_path / name)
        proc = subprocess.run(cmd, cwd=tmp_path / name, env=env, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[name] = proc.stdout
    assert outs["port"] == outs["jax"]
    results = tmp_path / "jax" / "posthoc" / "results"
    aucs = "paired_prognostic_aucs_from_baseline_meas.csv"
    for path in sorted(results.glob("*.csv")) + sorted((tmp_path / "jax" / "results").glob("*.csv")):
        other = tmp_path / "port" / path.relative_to(tmp_path / "jax")
        if path.name != aucs:
            assert other.read_bytes() == path.read_bytes(), path.name
    a, b = pd.read_csv(results / aucs), pd.read_csv(tmp_path / "port" / "posthoc" / "results" / aucs)
    assert (a[["feature", "batch"]] == b[["feature", "batch"]]).all().all() and len(a) == 120
    fed = []
    real = pcol.util_ph.stratified_logit_cv_metrics

    def spy(X, y, return_perfs=False):
        fed.append((np.array(X), np.array(y)))
        return real(X, y, return_perfs)

    monkeypatch.setattr(pcol.util_ph, "stratified_logit_cv_metrics", spy)
    _copy_tree(root, tmp_path / "spy")
    _collate_tables(pcol, tmp_path / "spy", on_final=lambda mod, df, ids0: mod._export_prognostic_auc_batches(df, ids0))
    assert len(fed) == 12
    for k, (X, y) in enumerate(fed):
        rows = slice(10 * k, 10 * k + 10)
        check_stratified_fold_aucs(X, y, b.auc.to_numpy()[rows], a.auc.to_numpy()[rows])
    assert len(list((tmp_path / "port" / "figures").glob("*.pdf"))) == len(list((tmp_path / "jax" / "figures").glob("*.pdf")))


def test_model_selection_criteria_match_jax(tmp_path, monkeypatch):
    from multimodal_trajectory_modeling_tpu_torch.drivers import model_selection as pms
    from multimodal_trajectory_modeling_tpu_torch.utils import adni
    from multimodal_trajectory_modeling_tpu_torch.utils import state_space as ssu

    jms = _load_jax_driver("model-selection.py")
    for mod in (jms, pms):
        monkeypatch.setattr(mod, "N_STARTS", N_STARTS)
        monkeypatch.setattr(mod, "CLUSTER_COUNTS", range(1, 4))
    z_raw, x, *_ = adni.get_trajectories()
    z = ssu.standardize(z_raw)
    with _caches_in(tmp_path):
        np.random.seed(0)
        jmodels = jms._fit_sweep(z, x)
        np.random.seed(0)
        pmodels = pms._fit_sweep(z, x, device="cpu")
    for jm, pm in zip(jmodels, pmodels):
        np.testing.assert_array_equal(pm.mle_cluster_assignment(), np.asarray(jm.mle_cluster_assignment()))
    got = pms.criteria(pmodels, z, x)
    for label, attr in jms.CRITERIA.items():
        want = [float(getattr(m, attr)(states=z, observations=x)) for m in jmodels]
        np.testing.assert_allclose(got[label], want, rtol=1e-10)


def test_scale_sweep_runs_small():
    from multimodal_trajectory_modeling_tpu_torch.drivers import synthetic_scale_sweep as sweep

    lines = []
    res = sweep.run(2000, device="cpu", report=lines.append)
    assert [r["n_clusters"] for r in res] == list(sweep.CLUSTER_GRID)
    for r in res:
        assert np.isfinite(r["complete_data_loglik"]) and 1 <= r["iterations"] <= sweep.MAX_STEPS
        assert r["status"] in (0, 1, 2)
    assert len(lines) == len(res) + 1 and lines[-1].startswith('{"sweep"')
    z, x, v, patterns, pid = sweep.make_data(500, device="cpu")
    assert v.shape == (500, 80) and patterns.shape == (3, 80)
    np.testing.assert_array_equal(patterns.numpy()[pid.numpy()], np.isfinite(v.numpy()))


def test_macc_driver_gates(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "multimodal_trajectory_modeling_tpu_torch.drivers.inference_train_adni_test_macc"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "not shipped" in proc.stdout


def test_drivers_import_no_jax_sklearn_or_plotting():
    """Every new module of the port imports without JAX, the JAX package,
    scikit-learn, statsmodels, lifelines, matplotlib or seaborn."""
    mods = [
        "drivers", "drivers.bench_phi_floor", "drivers.inference_adni_xval",
        "drivers.inference_adni_xval_collate_results", "drivers.model_selection",
        "drivers.synthetic_scale_sweep", "drivers.inference_train_adni_test_macc", "native", "ops.phi_stream",
        "utils.lme", "utils.survival", "utils.post_hoc", "utils.skl", "utils.macc", "utils.state_space", "utils.adni",
    ]
    code = (
        "import sys\n"
        + "".join(f"import multimodal_trajectory_modeling_tpu_torch.{m}\n" for m in mods)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'sklearn', 'statsmodels', 'lifelines', "
        "'matplotlib', 'seaborn', 'multimodal_trajectory_modeling_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
