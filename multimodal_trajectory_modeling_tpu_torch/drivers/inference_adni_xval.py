"""10-fold cross-validated inference on ADNI with label harmonization
across folds.

Counterpart of ``drivers/inference-adni-xval.py``: per fold, standardize
the hidden states on the training part, fit the 4-cluster LG-SSM mixture
(``MTM_N_RESTARTS`` starts, default 1000: the dense multistart, K12 on the
card; cached by data hash), relabel the clusters by AD rate, score the
held-out part under the full, snapshot, no-hidden and initial-visit input
variants, fit the supervised classifier on LG components, fit the t = 0
Gaussian-mixture baseline (:class:`..utils.skl.GaussianMixture`, the
port's stand-in for scikit-learn's), and write the results CSV, the
posterior CSVs and the per-fold training tables that the collate driver
and the post-hoc stage read, in the working directory, as the JAX driver
writes them.  The folds are :class:`..utils.skl.KFold`'s (scikit-learn's).

Device: the card (float32) unless ``MTM_DEVICE=cpu`` (the CPU in float64,
the JAX driver's default).

Usage::

    python -m multimodal_trajectory_modeling_tpu_torch.drivers.inference_adni_xval
"""

from __future__ import annotations

import gzip
import os
import pickle
import string
import time

import numpy as np
import pandas as pd

from multimodal_trajectory_modeling_tpu_torch.drivers import configure_from_env
from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable
from multimodal_trajectory_modeling_tpu_torch.models.classifier import StateSpaceModelClassifier
from multimodal_trajectory_modeling_tpu_torch.models.linear_gaussian import StateSpaceLinearGaussian
from multimodal_trajectory_modeling_tpu_torch.utils import adni as data
from multimodal_trajectory_modeling_tpu_torch.utils import skl
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as ssu

N_SPLITS = 10
N_CLUSTERS = 4
ALPHA = 1.0
N_STARTS = int(os.environ.get("MTM_N_RESTARTS", "1000"))

CLUSTER_LETTERS = string.ascii_uppercase[:N_CLUSTERS]


def _letters(mdl, assignments):
    """Integer cluster ids → harmonized letters via the correspondence."""
    return np.array([mdl.correspondence[c] for c in assignments])


def _ordered_cluster_indices(mdl):
    """Integer cluster ids in A, B, C, ... letter order."""
    return [mdl.inverse_correspondence[s] for s in CLUSTER_LETTERS]


def _empty_results_frame(ids, time, d):
    """(id, time)-indexed frame holding every per-visit prediction column."""
    idx = pd.MultiIndex.from_arrays(
        [np.vstack(list(ids)).flatten(), np.vstack(list(time)).flatten()],
        names=["id", "time"],
    )
    cols = [
        "split",
        "our_cluster",
        "our_cluster_snapshots",
        "our_cluster_snapshots_no_hidden",
        "our_cluster_no_hidden",
    ]
    frame = pd.DataFrame(index=idx, columns=cols)
    return frame.assign(diagnosis=np.vstack(list(d)).flatten())


def _standardized_split(mtrain, mtest, z_dim):
    """Standardize the hidden block on train stats; apply to test."""
    tr, te = mtrain.copy(), mtest.copy()
    tr[:, :, :z_dim], std_params = ssu.standardize(tr[:, :, :z_dim], return_params=True)
    te[:, :, :z_dim] = ssu.standardize(te[:, :, :z_dim], params=std_params)
    return tr, te


def _fit_fold_mixture(mtrain_ours, z_dim, dtrain, *, n_starts=None, use_cache=True, device=None, dtype=None):
    """Multistart-fit the fold's mixture (``n_starts`` random starts, by
    default ``N_STARTS``) and harmonize its labels; the winner is pickled
    into the cache."""
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=N_CLUSTERS,
        states=mtrain_ours[:, :, :z_dim],
        observations=mtrain_ours[:, :, z_dim:],
        init="k-means",
        alpha=ALPHA,
        device=device,
        dtype=dtype,
    ).train_with_multiple_random_starts(n_starts=N_STARTS if n_starts is None else n_starts, use_cache=use_cache)
    data.set_model_correspondence(mdl, dtrain)
    mdl.to_pickle()
    return mdl


def _heldout_variants(mdl, mtest_ours, z_dim):
    """Score the held-out fold under every input-degradation variant the
    collate stage tabulates: full trajectories, per-visit snapshots,
    observation-only, and initial-visit-only."""
    zt, xt = mtest_ours[:, :, :z_dim], mtest_ours[:, :, z_dim:]
    out = {}

    assignments, probs, prenorm = mdl.mle_cluster_assignment(
        states=zt,
        observations=xt,
        return_probs=True,
        return_prenormalized_log_probs=True,
    )
    order = _ordered_cluster_indices(mdl)
    out["our_cluster"] = _letters(mdl, assignments)
    out["prob_c_all"] = prenorm[assignments, np.arange(assignments.size)]
    out["posterior"] = probs[order].T
    out["our_index"] = mdl.cluster_assignment_index(states=zt, observations=xt)

    _, probs0 = mdl.mle_cluster_assignment(
        states=ssu.mask_all_but_time_i(zt, 0),
        observations=ssu.mask_all_but_time_i(xt, 0),
        return_probs=True,
    )
    out["init_posterior"] = probs0[order].T

    z_parc, x_parc = ssu.parcellate_arrays(zt, xt)
    out["our_cluster_snapshots"] = _letters(mdl, mdl.mle_cluster_assignment(states=z_parc, observations=x_parc))
    out["our_index_snapshots"] = mdl.cluster_assignment_index(states=z_parc, observations=x_parc)
    out["our_cluster_snapshots_no_hidden"] = _letters(
        mdl,
        mdl.mle_cluster_assignment(states=np.nan * np.ones_like(z_parc), observations=x_parc),
    )

    z_blank = np.full_like(zt, np.nan)
    out["our_cluster_no_hidden"] = _letters(mdl, mdl.mle_cluster_assignment(states=z_blank, observations=xt))
    out["our_index_no_hidden"] = mdl.cluster_assignment_index(states=z_blank, observations=xt)
    out["our_index_no_hidden_init"] = mdl.cluster_assignment_index(
        states=ssu.mask_all_but_time_i(z_blank, 0),
        observations=ssu.mask_all_but_time_i(xt, 0),
    )
    return out


def _gmm_baseline(ztrain, xtrain, ztest, xtest, dtrain):
    """t=0 Gaussian-mixture baseline with AD-rate label harmonization."""
    gmm = skl.GaussianMixture(
        n_components=N_CLUSTERS,
        covariance_type="full",
        max_iter=1000,
        init_params="kmeans",
        random_state=42,
    )
    t0_train = np.concatenate([ztrain, xtrain], axis=-1)[0]
    t0_test = np.concatenate([ztest, xtest], axis=-1)[0]
    raw_train = gmm.fit_predict(t0_train)

    finals = data.get_final_diagnoses(dtrain)
    ad_rate = [np.mean(finals[raw_train == c] == "AD") for c in range(N_CLUSTERS)]
    relabel = dict(zip(np.argsort(ad_rate), string.ascii_uppercase))

    train_preds = np.array([relabel[p] for p in raw_train])
    test_preds = np.array([relabel[p] for p in gmm.predict(t0_test)])
    letter_order = sorted(relabel.keys(), key=relabel.__getitem__)
    test_proba = gmm.predict_proba(t0_test)[:, letter_order]
    return train_preds, test_preds, test_proba


def _fold_train_table(idtrain, timetrain, dtrain, ctrain, gmm_train_preds):
    """Per-fold training table consumed by the collate driver."""
    tbl = pd.DataFrame(
        data={
            "idx": idtrain.ravel(),
            "time": timetrain.ravel(),
            "diagnosis": dtrain.ravel(),
        }
    ).set_index("idx")
    ours = dict(zip(idtrain[0].ravel(), ctrain.ravel()))
    tbl["our_cluster"] = tbl.index.to_series().map(ours)
    gmm = dict(zip(idtrain[0].ravel(), gmm_train_preds.ravel()))
    tbl["gmm_init"] = tbl.index.to_series().map(gmm)
    return tbl


def _write_artifacts(df_results, df_posterior, df_init_post, df_gmm, dict_training_results):
    os.makedirs("results", exist_ok=True)
    os.makedirs(os.path.join("posthoc", "results"), exist_ok=True)

    stem = f"ADNI_r7_xval{N_SPLITS}_{N_CLUSTERS}clusters"
    df_results.astype({"split": int}).to_csv(os.path.join("results", f"{stem}_results.csv"))
    posthoc_dir = os.path.join("posthoc", "results")
    for frame, tag in [
        (df_posterior, "mtm_post"),
        (df_init_post, "mtm_init_post"),
        (df_gmm, "gmm_init_post"),
    ]:
        frame.to_csv(os.path.join(posthoc_dir, f"{stem}_{tag}.csv"), index_label="id")
    with gzip.open(os.path.join("results", f"{stem}_results.p.gz"), "wb") as f:
        pickle.dump(dict_training_results, f)


def fold_masks():
    """The ten (train, test) index arrays of the ADNI participants."""
    ids = data.get_trajectories()[3]
    return list(skl.KFold(n_splits=N_SPLITS, shuffle=True, random_state=42).split(ids[0].ravel()))


def run(*, device=None, report=print):
    """The cross-validation: each fold's status, seconds and prevalences
    reported as it ends (``report`` None: nothing printed); writes the
    artifacts and returns ``{"folds": [...], "results": frame}``."""
    z, x, d, ids, time_ = data.get_trajectories()
    z_dim = z.shape[-1]
    markers = np.concatenate([z, x], axis=-1)

    df_results = _empty_results_frame(ids, time_, d)
    post_cols = ["prob_" + s for s in CLUSTER_LETTERS]
    df_posterior = pd.DataFrame(index=ids[0].ravel(), columns=post_cols)
    df_init_post = df_posterior.copy()
    df_gmm = pd.DataFrame(index=ids[0].ravel(), columns=post_cols)
    dict_training_results = dict()
    folds = []

    splitter = skl.KFold(n_splits=N_SPLITS, shuffle=True, random_state=42)
    for i_split, (train_mask, test_mask) in enumerate(splitter.split(ids[0].ravel())):
        t0 = time.perf_counter()
        dtrain, idtrain, timetrain, mtrain, ztrain, xtrain = (
            a[:, train_mask] for a in (d, ids, time_, markers, z, x)
        )
        dtest, idtest, timetest, mtest, ztest, xtest = (a[:, test_mask] for a in (d, ids, time_, markers, z, x))

        heldout_ids = idtest.ravel().tolist()
        df_results.loc[lambda df: df.index.get_level_values("id").isin(heldout_ids), "split"] = i_split

        mtrain_ours, mtest_ours = _standardized_split(mtrain, mtest, z_dim)
        best_mdl = _fit_fold_mixture(mtrain_ours, z_dim, dtrain, device=device)
        fit_s = time.perf_counter() - t0
        ctrain = _letters(best_mdl, best_mdl.mle_cluster_assignment())

        fold = _heldout_variants(best_mdl, mtest_ours, z_dim)
        df_posterior.loc[idtest[0].ravel()] = fold["posterior"]
        df_init_post.loc[idtest[0].ravel()] = fold["init_posterior"]

        clssfr = StateSpaceModelClassifier(
            component_model=StateSpaceLinearGaussian, device=best_mdl.device, dtype=best_mdl.dtype
        ).fit(
            data=(mtrain_ours[:, :, :z_dim], mtrain_ours[:, :, z_dim:]),
            labels=data.get_final_diagnoses(dtrain),
        )
        fold["supervised_classifier_predictions"] = clssfr.predict(
            data=(mtest_ours[:, :, :z_dim], mtest_ours[:, :, z_dim:])
        )

        gmm_train_preds, gmm_test_preds, gmm_proba = _gmm_baseline(ztrain, xtrain, ztest, xtest, dtrain)
        fold["gmm_init_predictions"] = gmm_test_preds
        df_gmm.loc[idtest[0].ravel()] = gmm_proba

        # scatter the per-instance variants into the (id, time) frame
        test_rows = df_results.split == i_split

        def put(col, values):
            lookup = dict(zip(idtest[0].ravel(), np.ravel(values)))
            df_results.loc[test_rows, col] = (
                df_results.loc[test_rows].index.get_level_values("id").to_series().map(lookup).values
            )

        for col in (
            "our_cluster",
            "prob_c_all",
            "our_index",
            "our_cluster_no_hidden",
            "our_index_no_hidden",
            "our_index_no_hidden_init",
            "supervised_classifier_predictions",
            "gmm_init_predictions",
        ):
            put(col, fold[col])

        # snapshot variants index by (id, visit time) directly
        snap_index = list(zip(np.tile(idtest.ravel(), np.max(timetest) + 1), np.ravel(timetest)))
        for col in (
            "our_cluster_snapshots",
            "our_index_snapshots",
            "our_cluster_snapshots_no_hidden",
        ):
            df_results.loc[snap_index, col] = fold[col]

        dict_training_results |= {i_split: _fold_train_table(idtrain, timetrain, dtrain, ctrain, gmm_train_preds)}

        prevalence = {c: float(np.mean(ctrain == c)) for c in CLUSTER_LETTERS}
        record = {
            "fold": i_split,
            "status": best_mdl.last_status,
            "iterations": best_mdl.last_iterations,
            "fit_seconds": round(fit_s, 3),
            "seconds": round(time.perf_counter() - t0, 3),
            "prevalence": prevalence,
        }
        folds.append(record)
        if report is not None:
            report(f"fold {i_split}: status={record['status']} fit {record['fit_seconds']} s, "
                   f"fold {record['seconds']} s, prevalence {prevalence}")

    _write_artifacts(df_results, df_posterior, df_init_post, df_gmm, dict_training_results)
    return {"folds": folds, "results": df_results}


def main():
    configure_from_env()
    run()


if __name__ == "__main__":
    main()
