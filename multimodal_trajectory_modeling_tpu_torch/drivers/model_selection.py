"""Model-selection sweep: the LG-SSM mixture for 1..7 clusters on ADNI,
with elbow curves of Q, AIC and BIC.

Counterpart of ``drivers/model-selection.py``: standardized hidden
states, ``alpha=1.0``, ``MTM_N_RESTARTS`` starts (default 1000) per
cluster count with the data-hash cache (the dense multistart, K12 on the
card), the three criteria printed, the elbow figures into ``figures/``
(matplotlib imported only there; ``--no-figures`` skips them) and the
winners pickled.  Device as in :mod:`.inference_adni_xval`.

Usage::

    python -m multimodal_trajectory_modeling_tpu_torch.drivers.model_selection [--no-figures]
"""

from __future__ import annotations

import argparse
import os

from multimodal_trajectory_modeling_tpu_torch.drivers import configure_from_env
from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable
from multimodal_trajectory_modeling_tpu_torch.utils import adni as data_adni
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as util

ALPHA = 1.0
CLUSTER_COUNTS = range(1, 8)
N_STARTS = int(os.environ.get("MTM_N_RESTARTS", "1000"))

# y-axis label → model criterion method, one elbow figure each
CRITERIA = {
    "Expected complete data log likelihood": "e_complete_data_log_lik",
    "AIC": "aic",
    "BIC": "bic",
}


def _fit_sweep(z, x, *, device=None):
    """One multistart-trained mixture per cluster count, cache-backed."""
    fitted = []
    for k in CLUSTER_COUNTS:
        mix = MMLinGaussSS_marginalizable(
            n_clusters=k,
            states=z,
            observations=x,
            init="k-means",
            alpha=ALPHA,
            device=device,
        )
        fitted.append(
            mix.train_with_multiple_random_starts(n_starts=N_STARTS, use_cache=True)
        )
    return fitted


def criteria(models, z, x) -> dict:
    """label → the criterion of each model, in cluster-count order."""
    return {label: [getattr(m, attr)(states=z, observations=x) for m in models] for label, attr in CRITERIA.items()}


def _elbow_figure(values, ylabel, out_pdf):
    """Open-spine elbow plot of a criterion over the cluster counts."""
    import matplotlib.pyplot as plt

    rc = {"figure.autolayout": True, "legend.loc": "upper right", "font.family": "serif"}
    with plt.rc_context(rc):
        fig, ax = plt.subplots()
        for side in ("right", "top"):
            ax.spines[side].set_visible(False)
        ax.plot(CLUSTER_COUNTS, values, "o-", color="#0072CE", linestyle="solid")
        plt.xticks(ticks=CLUSTER_COUNTS, labels=CLUSTER_COUNTS)
        ax.set_xlabel("Number of clusters")
        ax.set_ylabel(ylabel)
        plt.tight_layout()
        plt.savefig(out_pdf, bbox_inches="tight", transparent=True)
        plt.close(fig)


def run(*, figures=True, device=None):
    """The sweep: prints each criterion's values (rounded as the JAX driver
    prints them), draws the elbows where ``figures``, pickles the winners;
    returns ``(models, criteria)``."""
    z_raw, x, *_ = data_adni.get_trajectories()
    z, _std = util.standardize(z_raw, return_params=True)

    models = _fit_sweep(z, x, device=device)
    values = criteria(models, z, x)
    if figures:
        os.makedirs("figures", exist_ok=True)
    for label, attr in CRITERIA.items():
        if figures:
            _elbow_figure(values[label], label, os.path.join("figures", f"ADNI_elbow_plot_{attr.upper()}.pdf"))
        print(f"{label}: {[round(float(vv), 1) for vv in values[label]]}")

    for m in models:
        m.to_pickle()
    return models, values


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-figures", action="store_true", help="fit and print, draw nothing")
    args = ap.parse_args(argv)
    configure_from_env()
    run(figures=not args.no_figures)


if __name__ == "__main__":
    main()
