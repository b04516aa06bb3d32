"""ADNI dataset adapter: loading, outcome tables and the trajectory plot.

Counterpart of ``multimodal_trajectory_modeling_tpu/utils/adni.py``, kept
as this package's own copy.  The data ship with the JAX package
(``multimodal_trajectory_modeling_tpu/data/``: ``adni-trajectories.npz``,
571 participants, T ≤ 4 NaN-padded, z = amyloid centiloid and gray-matter
density, x = ADNI_MEM/ADNI_EF/ADAS13/MOCA; ``adni-profiling.csv`` keyed by
RID) and are read there by path.

pandas and matplotlib are imported only inside the functions that print a
table or draw, and their display settings (the JAX module sets them
globally at import) apply only inside those functions.  The numbers of the
outcome table come from :func:`outcome_prevalences`, in numpy alone.
"""

from __future__ import annotations

import functools
import os
import string

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.utils.state_space import PLOT_RC

name = "ADNI"

hidden_columns = ["amyloid_centiloid", "gm_score_standardized"]
observed_columns = ["ADNI_MEM", "ADNI_EF", "ADAS13", "MOCA"]
diagnosis_column = ["diagnosis"]
diagnosis_list = ["CN", "sMCI", "pMCI", "AD"]

cluster_colors = (
    "#0072CE",
    "#E87722",
    "#64A70B",
    "#93328E",
    "#A81538",
    "#4E5B31",
)

_CLUSTER_MARKERS = ("o", "v", "^", "s", "+", "x")

# four shades evenly spaced along reversed cividis (matplotlib's table
# entries 255, 170, 85 and 0), as the JAX module computes them at import
diagnosis_colors = (
    np.array([0.995737, 0.909344, 0.217772]),
    np.array([0.648222, 0.610553, 0.454801]),
    np.array([0.342246, 0.364939, 0.428559]),
    np.array([0.0, 0.135112, 0.304751]),
)

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "multimodal_trajectory_modeling_tpu",
    "data",
)

# pandas' float format of the printed tables (adni.py:20)
_FLOAT_FORMAT = "{:,.3f}".format


def get_final_diagnoses(diagnoses: np.ndarray) -> np.ndarray:
    """Final available diagnosis per participant from the (T, n, 1) object
    array of diagnostic trajectories (``adni.py:63``)."""
    paths = [
        "->".join(traj).replace("->nan", "")
        for traj in diagnoses.squeeze().transpose().astype(str).tolist()
    ]
    return np.array([p.split("->")[-1] for p in paths])


def get_trajectories(
    return_mmse: bool = False, return_approx_age: bool = False
) -> tuple:
    """The standard data pull (``adni.py:73``): ``(z, x, d, ids, time[,
    mmse[, age]])``; age comes only with mmse, as in the JAX package."""
    npz = np.load(
        os.path.join(_DATA_DIR, "adni-trajectories.npz"), allow_pickle=True
    )
    fields = ["z", "x", "d", "ids", "time"]
    if return_mmse:
        fields.append("mmse")
        if return_approx_age:
            fields.append("age")
    return tuple(npz[k] for k in fields)


def return_profiling_dataframe(ids):
    """Demographics and outcome table indexed by RID (``adni.py:91``)."""
    import pandas as pd

    csv = os.path.join(_DATA_DIR, "adni-profiling.csv")
    return pd.read_csv(csv, index_col="RID").loc[np.asarray(ids).ravel()]


def _prevalence_table(key_name, keys, overall, within):
    """The two-level prevalence table (``adni.py:97``): one row per key =
    (key, overall share, per-diagnosis values)."""
    import pandas as pd

    head = [("", key_name), ("overall", "prevalence")]
    head += [("within-cluster", dx) for dx in diagnosis_list]
    records = [(k, o, *w) for k, o, w in zip(keys, overall, within)]
    return pd.DataFrame.from_records(
        records, columns=pd.MultiIndex.from_tuples(head)
    ).fillna("---")


def _print_table(table) -> None:
    import pandas as pd

    with pd.option_context("display.float_format", _FLOAT_FORMAT):
        print(table)


def outcome_prevalences(
    model, cluster_assignments: np.ndarray, final_diagnoses: np.ndarray
):
    """The numbers of the outcome table, in numpy: ``(labels, overall
    (C,), within (C, 4))``, the clusters in letter order, ``within`` the
    share of each diagnosis of :data:`diagnosis_list` in the cluster (NaN
    for an empty cluster)."""
    assert final_diagnoses.size == cluster_assignments.size
    labels = string.ascii_uppercase[: model.n_clusters]
    overall, within = [], []
    for c in labels:
        sel = cluster_assignments == model.inverse_correspondence[c]
        overall.append(np.mean(sel))
        within.append(
            [np.mean(final_diagnoses[sel] == dx) for dx in diagnosis_list]
        )
    return labels, np.array(overall), np.array(within)


def get_outcomes_by_cluster(
    model, cluster_assignments: np.ndarray, final_diagnoses: np.ndarray
) -> None:
    """Print the cluster-vs-outcome prevalence table (``adni.py:218``)."""
    labels, overall, within = outcome_prevalences(
        model, cluster_assignments, final_diagnoses
    )
    _print_table(
        _prevalence_table(
            "cluster", labels, overall.tolist(), [list(w) for w in within]
        )
    )


def generate_outcome_table(model, diagnoses: np.ndarray) -> None:
    """Outcome table of the training assignment (``adni.py:234``)."""
    get_outcomes_by_cluster(
        model, model.cluster_assignment, get_final_diagnoses(diagnoses)
    )


def set_model_correspondence(mdl, diagnoses: np.ndarray) -> None:
    """Relabel the clusters A..Z by ascending AD rate (``adni.py:241``)."""
    finals = get_final_diagnoses(diagnoses)
    ad_rates = [
        np.mean(finals[mdl.cluster_assignment == c] == "AD")
        for c in range(mdl.n_clusters)
    ]
    mdl.correspondence = dict(
        zip(np.argsort(ad_rates), string.ascii_uppercase)
    )


# style blocks for the trajectory quiver and scatter marks
_ARROW_STYLE = dict(
    linestyle="solid", units="xy", angles="xy", scale_units="xy",
    scale=1, headwidth=5, headlength=7, headaxislength=6, alpha=0.5,
)
_POINT_STYLE = dict(s=2, alpha=0.6667)


def plot_2d_trajectories(
    model,
    savename,
    *,
    title: str = "Latent trajectories by cluster (training)",
    states: np.ndarray = None,
    inferred_clusters: np.ndarray = None,
    intensities: np.ndarray = None,
    std_param: dict = None,
    drop_superimposed_model: bool = True,
    cluster_ordering: np.ndarray = None,
    xlabel: str = "β-amyloid",
    ylabel: str = "Gray matter density",
    xlim=(-50.0, 230.0),
    ylim=(-0.275, 0.025),
    arrow_width: float = 0.4,
    show: bool = False,
) -> None:
    """Quiver plot of 2-D latent trajectories coloured by cluster
    (``adni.py:127``)."""
    import matplotlib.pyplot as plt

    if states is None:
        states = model.states
    if inferred_clusters is None:
        inferred_clusters = np.array(
            [model.correspondence[c] for c in model.cluster_assignment]
        )
    if model is None:
        n_clusters = len(set(inferred_clusters) & set(string.ascii_letters))
    else:
        n_clusters = model.n_clusters
    c_labels = cluster_ordering or string.ascii_uppercase[:n_clusters]
    assert states.ndim == 3 and states.shape[-1] == 2
    assert states.shape[1] == len(inferred_clusters)

    def _shade(base, intens):
        return [
            base + hex(round(255 * (2 * w + 1) / 3))[2:].upper().zfill(2)
            for w in intens
        ]

    with plt.rc_context(PLOT_RC):
        fig, ax = plt.subplots()
        for side in ("right", "top"):
            ax.spines[side].set_visible(False)
        for i, c in enumerate(c_labels):
            sel = inferred_clusters == c
            if sel.sum() == 0:
                continue
            x0, y0 = (states[:-1, sel, j].ravel() for j in (0, 1))
            dx, dy = (
                np.diff(states[:, sel, j], axis=0).ravel() for j in (0, 1)
            )
            assert len(x0) == len(y0) == len(dx) == len(dy)
            arrow_color = point_color = cluster_colors[i]
            if intensities is not None:
                w0 = np.tile(intensities[sel], (1, states.shape[0] - 1)).ravel()
                wall = np.tile(intensities[sel], (1, states.shape[0])).ravel()
            keep = functools.reduce(
                np.logical_and, map(np.isfinite, [x0, y0, dx, dy])
            )
            if intensities is not None:
                arrow_color = _shade(cluster_colors[i], w0[keep])
                point_color = _shade(cluster_colors[i], wall)
            ax.quiver(
                x0[keep], y0[keep], dx[keep], dy[keep],
                color=arrow_color, width=arrow_width, zorder=-i, **_ARROW_STYLE,
            )
            ax.scatter(
                states[:, sel, 0].ravel(), states[:, sel, 1].ravel(),
                c=point_color, marker=_CLUSTER_MARKERS[i],
                label=f"cluster {c}" if cluster_ordering is None else c,
                **_POINT_STYLE,
            )
        handles, labels = ax.get_legend_handles_labels()
        uniq = dict(zip(labels, handles))
        ax.legend(
            uniq.values(), uniq.keys(),
            fontsize="large", bbox_to_anchor=(1.3, 1), markerscale=3,
        )
        if title:
            plt.title(title)
        ax.set_xlabel(xlabel, fontsize="large")
        ax.set_ylabel(ylabel, fontsize="large")
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
        plt.tight_layout()
        if std_param is not None and not drop_superimposed_model:
            model.superimpose_model_on_plot(ax, std_param=std_param)
        fig.savefig(savename, bbox_inches="tight", transparent=True)
        if show:
            plt.show()


def _summary_stats() -> None:
    """The data's summary printout (``adni.py:253``): lengths, the
    biomarkers' moments, the outcome shares overall, by length and at the
    first visit, and the profiling table's means and spreads, under the
    JAX module's pandas float format."""
    import pandas as pd

    with pd.option_context("display.float_format", _FLOAT_FORMAT):
        print(f"Generating {name} summary stats...")
        z, x, d, ids, time, mmse = get_trajectories(return_mmse=True)
        length = np.argmin(
            np.all(np.isfinite(np.concatenate([x, z], axis=-1)), axis=-1), axis=0
        )
        length[length == 0] = x.shape[0]
        print("lengths: ", dict(zip(*np.unique(length, return_counts=True))))

        finals = get_final_diagnoses(d).ravel()
        amyloid, gm = np.split(z, 2, axis=-1)
        print(f"{np.nanmean(amyloid)=:.2f}, {np.nanstd(amyloid)=:.2f}")
        print(f"{np.nanmean(gm)=:.3f}, {np.nanstd(gm)=:.2f}")

        print("Breakdown by diagnosis|".ljust(79, "-"))
        print(
            pd.Series(finals, name="diagnosis")
            .value_counts(normalize=True)
            .loc[diagnosis_list]
        )

        ells = sorted(set(length))
        print("Diagnoses by length|".ljust(79, "-"))
        print(
            _prevalence_table(
                "length",
                ells,
                [np.mean(length == ell) for ell in ells],
                [
                    [np.sum(finals[length == ell] == dx) for dx in diagnosis_list]
                    for ell in ells
                ],
            )
        )

        init = pd.DataFrame(
            data={
                "dx": finals,
                "amyloid": z[0, :, 0],
                "gm": z[0, :, 1],
                "adni_mem": x[0, :, 0],
                "adni_ef": x[0, :, 1],
                "adas_13": x[0, :, 2],
                "moca": x[0, :, 3],
            }
        )
        print("init|".ljust(79, "-"))
        print(f"{init.mean(numeric_only=True)}")
        print("init x dx|".ljust(79, "-"))
        dx_list = [dx for dx in diagnosis_list if dx != "MCI_tbd"]
        print(f"{init.groupby('dx').agg('mean').loc[dx_list]}")

        lookup = return_profiling_dataframe(ids[0])
        print("Breakdown by features|".ljust(79, "-"))
        print(lookup.agg(["mean", "std"]).T)


if __name__ == "__main__":
    _summary_stats()
