"""Collate the cross-validation outputs of
:mod:`.inference_adni_xval`.

Counterpart of ``drivers/inference-adni-xval-collate-results.py``: reads
the per-visit results CSV and the per-split training pickle under
``results/`` and emits, in order, the demographic and outcome summary
tables, the label-stability crosstabs, the trajectory and pie figures, the
mixed-model biomarker figures (:mod:`..utils.lme`), the MMSE-change
scatter figures, the CSV exports the post-hoc stage reads
(:mod:`..utils.post_hoc`, without scikit-learn), the training-run summary
tables and the assignment-stability histograms.  It runs on the host
only.  matplotlib and seaborn are imported only where a figure is drawn,
and the pandas display options and matplotlib settings the JAX driver
sets at import apply inside :func:`main`.

Usage::

    python -m multimodal_trajectory_modeling_tpu_torch.drivers.inference_adni_xval_collate_results
"""

import glob
import gzip
import itertools
import os
import pickle
import string

import numpy as np
import pandas as pd

from multimodal_trajectory_modeling_tpu_torch.utils import adni as data
from multimodal_trajectory_modeling_tpu_torch.utils import lme
from multimodal_trajectory_modeling_tpu_torch.utils import post_hoc as util_ph
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as st_sp

# the display options the JAX driver sets globally at import
_DISPLAY = (
    "display.width", 79,
    "display.max_colwidth", 79,
    "display.max_columns", 1000,
    "display.float_format", "{:,.3f}".format,
)

rng = np.random.default_rng(seed=0)


def _pyplot():
    """pyplot under the JAX driver's settings (applied by :func:`main`)."""
    import matplotlib.pyplot as plt

    return plt


N_SPLITS = 10
N_CLUSTERS = 4
LME_ADD_CI = True
STEM = f"ADNI_r7_xval{N_SPLITS}_{N_CLUSTERS}clusters"

CLUSTER_LETTERS = list(string.ascii_uppercase[:N_CLUSTERS])
# every (cluster, diagnosis) cell, in the row order the reference tables use
OUTCOME_ROWS = pd.MultiIndex.from_product(
    [CLUSTER_LETTERS, data.diagnosis_list], names=["cluster", "diagnosis"]
)

# the six test-side outcome tables: short name -> (assignment column,
# whether counted at the subject's final or initial visit)
TEST_TABLE_SPECS = {
    "test": ("our_cluster", "final"),
    "testnh": ("our_cluster_no_hidden", "final"),
    "testsnapshotsinit": ("our_cluster_snapshots", "initial"),
    "testsnapshotsinitnh": ("our_cluster_snapshots_no_hidden", "initial"),
    "testsnapshots": ("our_cluster_snapshots", "final"),
    "testsnapshotsnh": ("our_cluster_snapshots_no_hidden", "final"),
}

_LINESTYLES = (
    "solid", "dashdot", "dashed", "dotted",
    "densely dashdotted", "loosely dashdotted",
)


def _newest(pattern):
    """Most recently written file matching the glob."""
    return max(glob.glob(pattern), key=os.path.getmtime)


def _figure(name):
    return os.path.join("figures", name)


def _posthoc_csv(name):
    return os.path.join("posthoc", "results", name)


# --------------------------------------------------------------------------
# outcome-count table assembly
# --------------------------------------------------------------------------


def _final_visits(df):
    """One row per subject: the last visit carrying a diagnosis."""
    observed = df.loc[df.diagnosis.notna()].sort_values("time")
    return observed.groupby(level=0).last()


def _initial_visits(df, df_fin):
    """One row per subject: the first diagnosed visit, relabelled with the
    subject's final diagnosis (the outcome the snapshot tables predict)."""
    observed = df.loc[df.diagnosis.notna()].sort_values("time")
    first = observed.groupby(level=0).first()
    return first.drop(columns="diagnosis").join(df_fin)


def _outcome_counts(df, col):
    """(cluster, diagnosis) -> count Series over the full OUTCOME_ROWS grid
    (absent cells NaN, to be zero-filled by the caller)."""
    ct = pd.crosstab(df[col], df["diagnosis"])
    ct = ct.rename_axis(index="cluster", columns="diagnosis")
    return ct.stack().reindex(OUTCOME_ROWS)


def _collect_split_tables(d_tr, df_results, df_fin):
    """Walk the CV splits once, accumulating the per-split training outcome
    table and the split-summed test tables for each TEST_TABLE_SPECS entry."""
    train_cols = {}
    test_sums = {name: None for name in TEST_TABLE_SPECS}

    for split in range(N_SPLITS):
        train_final = _final_visits(d_tr[split])
        in_split = df_results.loc[df_results.split == split]
        test_final = _final_visits(in_split)
        test_initial = _initial_visits(in_split, df_fin)

        # the final-visit diagnosis must agree with the precomputed
        # final-diagnosis lookup for every test subject
        final_dx = df_fin.diagnosis.reindex(test_final.index)
        assert test_final.diagnosis.eq(final_dx).all()

        train_cols[split] = _outcome_counts(train_final, "our_cluster")
        for name, (col, visit) in TEST_TABLE_SPECS.items():
            frame = test_final if visit == "final" else test_initial
            counts = _outcome_counts(frame, col).fillna(0.0)
            prior = test_sums[name]
            test_sums[name] = counts if prior is None else prior + counts

    train_by_split = pd.DataFrame(train_cols)
    train_by_split.columns = pd.RangeIndex(N_SPLITS, name="split")
    outcomes_sum = pd.DataFrame(
        {("ours", name): s for name, s in test_sums.items()}
    )
    return train_by_split, outcomes_sum


# --------------------------------------------------------------------------
# printed summary tables
# --------------------------------------------------------------------------


def _print_demographics(ids0, cluster_at_baseline, age_at_baseline):
    demo = data.return_profiling_dataframe(ids0)
    demo = demo.assign(cluster=cluster_at_baseline, age=age_at_baseline)
    demo_cols = ["age", "is_female", "edu_yrs", "apoe4_pos"]
    print(demo.groupby("cluster")[demo_cols].mean())


def _print_pooled_outcomes(outcomes_sum):
    print("outcomes by cluster")
    print(outcomes_sum.groupby(level=0).apply(lambda g: g / g.sum()))
    print("clusters by approach")
    by_cluster = outcomes_sum.groupby(level=0).sum()
    print(by_cluster / by_cluster.sum(axis=0))


def _baseline_rows(df_results, col):
    return df_results.loc[df_results.time == 0, [col]]


def _share_of_population(df_results, df_fin, col):
    """Fraction of diagnosed baseline subjects landing in each cluster."""
    counts = _baseline_rows(df_results, col).join(df_fin).groupby(col)
    counts = counts.diagnosis.count()
    return (counts / counts.sum()).rename(col)


def _share_by_outcome(df_results, df_fin, col):
    """Joint (cluster, final diagnosis) shares at baseline."""
    cells = _baseline_rows(df_results, col).join(df_fin)
    counts = cells.groupby([col, "diagnosis"]).size()
    return (counts / counts.sum()).rename(col)


def _print_baseline_composition(df_results, df_fin):
    approaches = (
        "our_cluster",
        "our_cluster_snapshots",
        "gmm_init_predictions",
    )
    print("population-level cluster prevalences")
    print(
        pd.concat(
            [_share_of_population(df_results, df_fin, c) for c in approaches],
            axis=1,
        )
    )
    print("diagnostic outcomes by cluster")
    joint = pd.concat(
        [_share_by_outcome(df_results, df_fin, c) for c in approaches],
        axis=1,
    )
    dx_rank = {dx: k for k, dx in enumerate(data.diagnosis_list)}
    row_order = sorted(joint.index, key=lambda ix: (ix[0], dx_rank[ix[1]]))
    print(joint.loc[row_order])


# --------------------------------------------------------------------------
# label-stability crosstabs
# --------------------------------------------------------------------------


def _stability(ct):
    """Fraction of subjects on the crosstab diagonal (label maintained)."""
    return np.trace(ct.values) / ct.values.sum()


def _print_crosstab(title, rows, cols):
    print(title)
    ct = pd.crosstab(rows, cols)
    print(ct)
    print("{0:.3f} maintain labels".format(_stability(ct)))
    return ct


def _off_diagonal_band(ct, offset):
    return ct.values.diagonal(offset=offset).sum()


def _print_stability_reports(df_results, final_id_ti):
    at_final = df_results.set_index("time", append=True).loc[final_id_ti]
    _print_crosstab(
        "Our cluster vs. Our snapshot final",
        at_final.our_cluster,
        at_final.our_cluster_snapshots,
    )

    at0 = df_results.loc[df_results.time == 0]
    _print_crosstab(
        "Our cluster vs. Our snapshot init",
        at0.our_cluster,
        at0.our_cluster_snapshots,
    )

    per_subject = df_results.groupby(level=0).first()
    ct = _print_crosstab(
        "Ours using all data vs. missing hidden data",
        per_subject.our_cluster,
        per_subject.our_cluster_no_hidden,
    )
    total = ct.values.sum()
    on_diag = np.trace(ct.values)
    near = _off_diagonal_band(ct, 1) + _off_diagonal_band(ct, -1)
    print(
        "{0:.3f} maintain labels or move 1 label".format(
            (on_diag + near) / total
        )
    )
    print(
        "{0:.3f} of those that do move, move only one label away".format(
            near / (total - on_diag)
        )
    )

    for title, col in (
        ("Our cluster vs. GMM init preds", "our_cluster"),
        ("Our cluster init vs. GMM init preds", "our_cluster_snapshots"),
    ):
        ct = _print_crosstab(title, at0[col], at0.gmm_init_predictions)
        lower = np.tril(ct.values, -1).sum()
        upper = np.triu(ct.values, 1).sum()
        print(
            "of those that move, {0:.3f} are lower triangle".format(
                lower / (lower + upper)
            )
        )


# --------------------------------------------------------------------------
# figures
# --------------------------------------------------------------------------


def _plot_trajectory_figures(z, x, cluster_at_baseline):
    data.plot_2d_trajectories(
        model=None, title="", states=z,
        inferred_clusters=cluster_at_baseline,
        xlabel="β-amyloid burden (centiloid)",
        savename=_figure(
            f"ADNI_r7_xval{N_SPLITS}_our_model_plot{N_CLUSTERS}_results.pdf"
        ),
    )
    adnimem_range = (np.nanmin(x[..., 0]) - 0.2, np.nanmax(x[..., 0]) + 0.2)
    data.plot_2d_trajectories(
        model=None, title="",
        states=np.stack((x[..., 0], z[..., -1]), axis=-1),
        inferred_clusters=cluster_at_baseline,
        xlabel="ADNI-Mem", xlim=adnimem_range,
        ylabel="Gray matter density", arrow_width=0.01,
        savename=_figure(
            f"ADNI_r7_xval{N_SPLITS}_our_model_plot"
            f"{N_CLUSTERS}_results_gm_vs_adnimem.pdf"
        ),
    )


def _plot_summary_figures(mmse, cluster_at_baseline, final_dx_values):
    st_sp.plot_metric_vs_clusters_over_time(
        metric=mmse[:, :, 0], assignments=cluster_at_baseline,
        metric_name="MMSE", title="",
        xticks=np.arange(0, 2 * mmse.shape[0], 2), xlabel="Time (years)",
        legend_loc="upper right", colors=data.cluster_colors,
        savename=_figure(
            f"ADNI_r7_xval10_{N_CLUSTERS}clusterwise_MMSE_o_time.pdf"
        ),
    )
    st_sp.pie(
        assignments=cluster_at_baseline, colors=data.cluster_colors,
        savename=_figure(f"ADNI_r7_xval10_{N_CLUSTERS}_overall_pie_all.pdf"),
    )
    st_sp.pie(
        assignments=final_dx_values, colors=data.diagnosis_colors,
        cluster_ordering=data.diagnosis_list,
        savename=_figure(
            f"ADNI_r7_xval10_{N_CLUSTERS}_overall_pie_all_dx.pdf"
        ),
    )
    legend_anchor = (1.75 + 0.25 * int(N_CLUSTERS == 3), 1)
    st_sp.pies_by_cluster(
        categories=final_dx_values, clusters=cluster_at_baseline,
        halo_colors=data.cluster_colors, slice_colors=data.diagnosis_colors,
        category_ordering=data.diagnosis_list, legend_anchor=legend_anchor,
        fig_length=6.0, fig_width=3.0,
        savename=_figure(f"ADNI_r7_xval10_{N_CLUSTERS}_pie_charts_all.pdf"),
    )
    st_sp.pies_by_cluster(
        categories=cluster_at_baseline, clusters=final_dx_values,
        halo_colors=data.diagnosis_colors, slice_colors=data.cluster_colors,
        cluster_ordering=data.diagnosis_list, legend_anchor=legend_anchor,
        fig_length=6.0, fig_width=3.0,
        savename=_figure(
            f"ADNI_r7_xval10_{N_CLUSTERS}_pie_charts_all_dx.pdf"
        ),
    )


def _lme_scatter_figure(df_biomarkers, xcol, ycol, xlabel, ylabel, savename):
    """Mixed-model fit of ``ycol ~ cluster * xcol`` with per-cluster affine
    overlays and Monte-Carlo CI bands (reference collate:602-787)."""
    res = lme.mixedlm(
        f"{ycol} ~ cluster * {xcol}",
        df_biomarkers,
        groups=df_biomarkers["ids"].to_numpy(),
    ).fit()
    import matplotlib as mpl
    import matplotlib.lines  # noqa: F401  (mpl.lines below)

    plt = _pyplot()

    def coef_pair(table, cluster):
        """(intercept, slope) for one cluster from the treatment coding."""
        if cluster == "A":
            return table["Intercept"], table[xcol]
        return (
            table[f"cluster[T.{cluster}]"],
            table[f"cluster[T.{cluster}]:{xcol}"],
        )

    fig, ax = plt.subplots(layout="constrained")
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)
    color_of = dict(zip(string.ascii_uppercase, data.cluster_colors))
    scatter_frame = df_biomarkers.assign(color=df_biomarkers.cluster.map(color_of))
    scatter_frame.plot.scatter(x=xcol, y=ycol, c="color", ax=ax)
    mn, mx = ax.get_xlim()

    for i, c in enumerate(CLUSTER_LETTERS):
        intercept, slope = coef_pair(res.params, c)
        fit_line = mpl.lines.Line2D(
            [mn, mx], [intercept + mn * slope, intercept + mx * slope],
            color=data.cluster_colors[i], label=c, zorder=5,
            linestyle=_LINESTYLES[i],
        )
        ax.add_artist(fit_line)
        if LME_ADD_CI:
            # Monte-Carlo band: resample the affine fit from the coefficient
            # standard errors and take pointwise quantiles
            intercept_bse, slope_bse = coef_pair(res.bse, c)
            draws_b = rng.normal(intercept, intercept_bse, (10000, 1))
            draws_m = rng.normal(slope, slope_bse, (10000, 1))
            pts = np.linspace(mn, mx, 100).reshape(1, -1)
            band = np.quantile(draws_m * pts + draws_b, [0.275, 0.975], axis=0)
            ax.fill_between(
                x=pts.ravel(), y1=band[0], y2=band[1],
                alpha=0.15, color=data.cluster_colors[i],
            )
    ax.legend(fontsize="large")
    ax.set_xlabel(xlabel, fontsize="large")
    ax.set_ylabel(ylabel, fontsize="large")
    fig.savefig(savename, bbox_inches="tight", transparent=True)
    plt.close(fig)
    return res


def _plot_mmse_change_scatters(df_final):
    """Baseline-measure vs. annualized-MMSE-change scatter figures with a
    pooled regression overlay, one per candidate prognostic measure."""
    drop_outliers = True
    ycol = "ann_mmse_change_age_adjusted"
    yname = "Annualized MMSE change (age adjusted)"
    predictors = [
        ("mmse_init", "MMSE"),
        ("moca_init", "MoCA"),
        ("our_index_snapshot_init", "MTM-derived index"),
    ]
    for xcol, xname in predictors:
        in_col = df_final[xcol].values
        out_col = df_final[ycol].values
        center = np.nanmean(in_col, axis=0, keepdims=True)
        spread = np.nanstd(in_col, axis=0, keepdims=True)
        within_3_sigma = np.abs(in_col - center) < 3 * spread
        both_finite = np.isfinite(in_col) & np.isfinite(out_col)
        keep = both_finite & (within_3_sigma if drop_outliers else True)
        print(
            "{:.2f} kept (μ={:.2f}, σ={:.2f})".format(
                keep.astype(int).mean(), in_col[keep].mean(),
                in_col[keep].std(),
            )
        )
        import seaborn as sns

        plt = _pyplot()
        fig, ax = plt.subplots(layout="constrained")
        ax.spines["right"].set_visible(False)
        ax.spines["top"].set_visible(False)
        kept = df_final[keep]
        sns.regplot(
            data=kept, x=xcol, y=ycol, ax=ax, color="black", scatter=False
        )
        for i, c in enumerate(CLUSTER_LETTERS):
            df_c = kept.loc[kept.our_cluster_snapshot_init == c]
            ax.scatter(
                df_c[xcol].values, df_c[ycol].values, s=2, alpha=0.9,
                color=data.cluster_colors[i], marker="ov^s+x"[i],
                label=f"cluster {c}",
            )
        ax.set_xlabel(f"{xname} (at baseline)", fontsize="large")
        ax.set_ylabel(yname, fontsize="large")
        ax.legend(fontsize="large", loc="lower right")
        suffix = "_no_outliers" if drop_outliers else ""
        fig.savefig(
            _figure(f"{ycol}_vs_{xcol}_bl_{N_CLUSTERS}c{suffix}.pdf"),
            transparent=True,
        )
        plt.close(fig)


def _plot_assignment_stability_histograms(d_tr, df_results):
    """Per cluster: histogram over subjects of how many of the training runs
    they were assigned to that cluster, among subjects the held-out model
    placed there."""
    per_run_labels = [
        df_i.loc[df_i.time == 0, "our_cluster"] for df_i in d_tr.values()
    ]
    baseline_train_labels = pd.concat(per_run_labels, axis=1).fillna("X")
    run_counts = np.column_stack(
        [
            (baseline_train_labels.values == c).sum(axis=1)
            for c in CLUSTER_LETTERS
        ]
    )
    # every subject is in the training fold of exactly N_SPLITS - 1 runs
    assert np.all(run_counts.sum(axis=1) == N_SPLITS - 1)

    test_label = df_results.loc[
        lambda g: g.time == 0, ["our_cluster"]
    ].rename(columns={"our_cluster": "test"})
    labels = baseline_train_labels.join(test_label)

    plt = _pyplot()
    for c in CLUSTER_LETTERS:
        in_c = labels.loc[labels.test == c].drop(columns="test")
        times_in_c = (in_c.values == c).sum(axis=1)
        fig, ax = plt.subplots()
        ax.hist(
            times_in_c, bins=np.arange(-0.5, 10.5), density=True,
            color="black",
        )
        ax.set_xticks(np.arange(10))
        ax.set_ylim((0, 1))
        st_sp._despine(ax)
        xlab = f"Cluster {c} assignment (number of training runs)"
        ax.set_xlabel(xlab, fontsize="large")
        ax.set_ylabel("Frequency", fontsize="large")
        fig.savefig(_figure(f"ADNI_r7_xval{N_SPLITS}_tr_te_cl_{c}_hist.pdf"))
        plt.close(fig)


# --------------------------------------------------------------------------
# per-visit / final-visit analysis frames
# --------------------------------------------------------------------------

_MEASURE_COLS = {
    "mmse": lambda z, x, mmse, age: mmse.ravel(),
    "age": lambda z, x, mmse, age: age.ravel(),
    "amyloid": lambda z, x, mmse, age: z[..., 0].ravel(),
    "gm": lambda z, x, mmse, age: z[..., 1].ravel(),
    "adni_mem": lambda z, x, mmse, age: x[..., 0].ravel(),
    "adni_ef": lambda z, x, mmse, age: x[..., 1].ravel(),
    "adas13": lambda z, x, mmse, age: x[..., 2].ravel(),
    "moca": lambda z, x, mmse, age: x[..., 3].ravel(),
}

_BASELINE_SNAPSHOT_RENAMES = {
    "our_index_snapshots": "our_index_snapshot_init",
    "our_cluster_snapshots": "our_cluster_snapshot_init",
}


def _build_visitwise_frame(df_results, z, x, mmse, approx_age):
    """df_results widened with raw measures plus each subject's baseline
    (`*_init`) values broadcast to every visit row."""
    measures = {
        name: fn(z, x, mmse, approx_age)
        for name, fn in _MEASURE_COLS.items()
    }
    full = df_results.assign(**measures)

    baseline = full.loc[full.time == 0]
    init_renames = {name: f"{name}_init" for name in _MEASURE_COLS}
    init_renames.update(_BASELINE_SNAPSHOT_RENAMES)
    baseline = baseline[list(init_renames)].rename(columns=init_renames)

    # the reference environment's pandas (1.4) regrouped rows by the
    # duplicated id index during this join, leaving the frame id-major (all
    # of a participant's visits contiguous); modern pandas preserves the
    # time-major left order.  The downstream mmse age adjustment is an
    # unshuffled 5-fold cross_val_predict, so the published LME table
    # (posthoc/lme_mmse_adni.R comments: REML criterion 6015.3, interaction
    # F=64.127) depends on this exact ordering — reproduce it.
    return full.join(baseline).sort_index(kind="stable")


def _build_final_visit_frame(df_results0, final_id_ti):
    """One row per subject at the final diagnosed visit, with annualized
    (age-adjusted) MMSE change."""
    visitwise = df_results0.assign(years=2 * df_results0.time)
    df_final = visitwise.set_index("time", append=True).loc[final_id_ti].copy()
    df_final["ann_mmse_change"] = (
        df_final.mmse - df_final.mmse_init
    ) / df_final.years
    df_final["ann_mmse_change_age_adjusted"] = (
        util_ph.regressed_out_effect_cv(
            df_final.ann_mmse_change.values.reshape(-1, 1),
            df_final.age_init.values.reshape(-1, 1),
        )
    )
    return df_final


# --------------------------------------------------------------------------
# post-hoc CSV exports
# --------------------------------------------------------------------------


def _export_mmse_over_time(df_results0):
    long = df_results0.rename(columns={"our_cluster": "cluster"})
    long = long.assign(time_in_years=lambda df: 2 * df.time)
    long = long[["time_in_years", "mmse", "age", "cluster"]].dropna()
    long["mmse_age_adjusted"] = util_ph.regressed_out_effect_cv(
        long.mmse.values.reshape(-1, 1), long.age.values.reshape(-1, 1)
    )
    long.to_csv(_posthoc_csv("mmse_by_cluster_over_time.csv"))


def _export_survival_frame(df_results0, ids0):
    export_cols = [
        "our_index_snapshot_init", "amyloid_init", "gm_init",
        "adni_ef_init", "adas13_init", "moca_init", "adni_mem_init",
        "age_init", "ad_outcome", "days_to_ad_or_last_obs",
    ]
    profiling = data.return_profiling_dataframe(ids0)
    baseline = df_results0.loc[lambda df: df.time == 0]
    joined = baseline.join(profiling[["ad_outcome", "days_to_ad_or_last_obs"]])
    joined[export_cols].to_csv(_posthoc_csv("survival_modelling_data.csv"))


def _export_prognostic_auc_batches(df_final, ids0):
    """Cross-validated logit AUC batches for the baseline-measure feature
    sets the paired R comparison reads."""
    cog_init = [
        "adni_mem_init", "adni_ef_init", "moca_init", "adas13_init",
        "mmse_init",
    ]
    bio_init = ["amyloid_init", "gm_init"]
    outcome_cols = ["ad_outcome", "days_to_ad_or_last_obs"]

    keep_cols = ["our_index_snapshot_init"] + cog_init + bio_init
    frame = df_final[keep_cols + ["diagnosis"]].dropna().reset_index("time")
    frame = frame.join(data.return_profiling_dataframe(ids0)[outcome_cols])
    is_ad = frame[["diagnosis"]].eq("AD").astype(int).values

    feature_sets = [["our_index_snapshot_init"], bio_init]
    feature_sets += [[b, c] for b, c in itertools.product(bio_init, cog_init)]
    records = []
    for cols in feature_sets:
        aucs = util_ph.stratified_logit_cv_metrics(
            frame[cols].values, is_ad
        )
        label = tuple(nm[:6] for nm in cols)
        records.extend(
            (label, batch, auc) for batch, auc in enumerate(aucs)
        )
    pd.DataFrame(records, columns=["feature", "batch", "auc"]).to_csv(
        _posthoc_csv("paired_prognostic_aucs_from_baseline_meas.csv"),
        index=False,
    )


# --------------------------------------------------------------------------
# training-run tables / conversion pivots
# --------------------------------------------------------------------------


def _report_training_tables(train_by_split):
    print("Cluster assignment rates (training)")
    per_cluster = train_by_split.groupby(level=0).sum()
    rates = per_cluster / per_cluster.sum(axis=0)
    print(rates)
    rates.to_csv(os.path.join("results", "cluster_rates_training.csv"))

    print("Outcomes by cluster (training)")
    within_cluster = (
        train_by_split.fillna(0.0)
        .groupby(level=0)
        .apply(lambda g: g / g.sum())
    )
    print(within_cluster)
    within_cluster.to_csv(
        os.path.join("results", "outcomes_by_cluster_training.csv")
    )


def _report_conversion_pivots(df_results, ids0, d_fin):
    print("Conversion rate pivots for ours vs. GMM @ baseline")
    final_dx = pd.DataFrame(index=ids0, data={"final_dx": d_fin})
    approach_cols = [
        "our_cluster_snapshots", "gmm_init_predictions", "our_cluster",
    ]
    xt = df_results.loc[df_results.time == 0, approach_cols].join(final_dx)
    xt["fin_AD"] = (xt.final_dx == "AD").astype(int)
    for c in ("our_cluster", "our_cluster_snapshots"):
        rates = xt.groupby([c, "gmm_init_predictions"]).fin_AD.mean()
        print(rates.unstack("gmm_init_predictions").fillna(0.0))


def _report_length_table(df_final):
    print("Clusters by trajectory length")
    lengths = df_final.reset_index().assign(length=lambda df: df.time + 1)
    counts = lengths.groupby(["our_cluster", "length"]).size()
    print(counts.unstack("length"))


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def main():
    plot_rc = {"figure.autolayout": True, "legend.loc": "upper right", "font.family": "serif"}
    with pd.option_context(*_DISPLAY), _pyplot().rc_context(plot_rc):
        _collate()


def _collate():
    """:func:`main`'s body, in the JAX driver's order."""
    (z, x, d, ids, time, mmse, approx_age) = data.get_trajectories(
        return_mmse=True, return_approx_age=True
    )
    n_subjects = z[0].shape[0]
    ids0 = ids[0].ravel()

    d_fin = data.get_final_diagnoses(d)
    df_fin = pd.DataFrame(data=d_fin, index=ids0, columns=["diagnosis"])

    df_results = pd.read_csv(
        _newest(os.path.join("results", f"{STEM}_results.csv"))
    ).set_index("id")
    with gzip.open(
        _newest(os.path.join("results", f"{STEM}_results.p.gz")), "rb"
    ) as f:
        d_tr = pickle.load(f)

    os.makedirs("figures", exist_ok=True)
    os.makedirs(os.path.join("posthoc", "results"), exist_ok=True)

    cluster_at_baseline = df_results.our_cluster.to_numpy()[:n_subjects]
    _print_demographics(ids0, cluster_at_baseline, approx_age[0])

    train_by_split, outcomes_sum = _collect_split_tables(
        d_tr, df_results, df_fin
    )
    outcomes_sum = outcomes_sum.fillna(0.0)
    assert (outcomes_sum.sum(axis=0) == 571).all()

    _print_pooled_outcomes(outcomes_sum)
    _print_baseline_composition(df_results, df_fin)
    _plot_trajectory_figures(z, x, cluster_at_baseline)

    final_id_ti = _final_visits(df_results).set_index(
        "time", append=True
    ).index

    _print_stability_reports(df_results, final_id_ti)

    pd.crosstab(
        df_results.loc[lambda df: df.time == 0].gmm_init_predictions.values,
        d_fin,
        rownames=["cluster"],
    ).reset_index().to_csv(
        _posthoc_csv("contingency_table_gmm_init.csv"), index=False
    )

    _plot_summary_figures(mmse, cluster_at_baseline, df_fin.values.ravel())

    biomarker_cols = {
        "ids": ids[:-1].ravel(),
        "amyl_prev": z[:-1, :, 0].ravel(),
        "gm_diff": np.diff(z[..., -1], axis=0).ravel(),
        "moca_diff": np.diff(x[..., -1], axis=0).ravel(),
        "adni_mem_diff": np.diff(x[..., 0], axis=0).ravel(),
        "cluster": df_results.our_cluster[: ids[:-1].size].to_numpy(),
        "age": approx_age[:-1].ravel(),
    }
    df_biomarkers = pd.DataFrame(data=biomarker_cols).dropna()

    _lme_scatter_figure(
        df_biomarkers,
        xcol="amyl_prev",
        ycol="gm_diff",
        xlabel="β-amyloid burden (centiloid)",
        ylabel="Grey matter density change",
        savename=_figure(f"gm_diff_vs_amyloid_{N_CLUSTERS}c_affine.pdf"),
    )
    _lme_scatter_figure(
        df_biomarkers,
        xcol="gm_diff",
        ycol="adni_mem_diff",
        xlabel="Grey matter density change",
        ylabel="Change in ADNI-Mem",
        savename=_figure(
            f"adni_mem_diff_vs_gm_diff_{N_CLUSTERS}c_affine.pdf"
        ),
    )

    df_results0 = _build_visitwise_frame(df_results, z, x, mmse, approx_age)
    df_final = _build_final_visit_frame(df_results0, final_id_ti)

    _plot_mmse_change_scatters(df_final)

    # exports for the post-hoc stage
    df_biomarkers.to_csv(
        _posthoc_csv("biomarkers_by_cluster_over_time.csv")
    )
    df_final.to_csv(_posthoc_csv("prognostics_all.csv"))
    _export_mmse_over_time(df_results0)

    ours_test_tbl = outcomes_sum[("ours", "test")].unstack("diagnosis")
    ours_test_tbl.sort_index(axis=1).to_csv(
        _posthoc_csv("contingency_table_ours_test.csv")
    )

    _export_survival_frame(df_results0, ids0)

    print("-" * 79, "Clusters by diagnosis", sep="\n")
    print(
        (ours_test_tbl / ours_test_tbl.sum(axis=0))[data.diagnosis_list]
    )

    _export_prognostic_auc_batches(df_final, ids0)
    _report_training_tables(train_by_split)
    _report_conversion_pivots(df_results, ids0, d_fin)
    _report_length_table(df_final)
    _plot_assignment_stability_histograms(d_tr, df_results)


if __name__ == "__main__":
    main()
