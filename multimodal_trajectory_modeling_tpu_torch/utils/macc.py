"""MACC dataset adapter.

This package's own copy of ``multimodal_trajectory_modeling_tpu/utils/
macc.py``.  The MACC trajectories npz is *not shipped* (patient privacy),
so :func:`data_available` is false in this repository and code paths gate
on it.  The data would be read by path from the JAX package's ``data/``
folder, as :mod:`.adni` reads ADNI's.  pandas is imported only inside the
functions that build frames; the diagnosis shades are the four evenly
spaced along reversed cividis that the JAX module computes with
matplotlib at import (the same as :mod:`.adni`'s).
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_trajectory_modeling_tpu_torch.utils.adni import _DATA_DIR
from multimodal_trajectory_modeling_tpu_torch.utils.adni import diagnosis_colors as _adni_shades

name = "MACC"
diagnosis_list = ["NCI", "CIND", "VCIND", "AD"]

cluster_colors = (
    "#0072CE",
    "#E87722",
    "#64A70B",
    "#93328E",
    "#A81538",
    "#4E5B31",
)

diagnosis_colors = tuple(np.array(c) for c in _adni_shades)

# pandas' float format of the printed tables (macc.py:16)
_FLOAT_FORMAT = "{:,.3f}".format


def data_available() -> bool:
    return os.path.exists(os.path.join(_DATA_DIR, "macc-trajectories.npz"))


def get_data() -> tuple:
    """(z, x, d, mmse_cdrsum_cdrglobal, ell, ids, ages) (``macc.py:48``)."""
    npz = np.load(os.path.join(_DATA_DIR, "macc-trajectories.npz"), allow_pickle=True)
    return tuple(npz[k] for k in ["z", "x", "d", "mmse_cdrsum_cdrglobal", "ell", "ids", "ages"])


def get_final_diagnoses(diagnoses: np.ndarray) -> np.ndarray:
    """Final diagnosis per person; MACC pads with ``None`` (``macc.py:60``)."""
    paths = [
        "->".join(traj).replace("->None", "")
        for traj in diagnoses.squeeze().transpose().astype(str).tolist()
    ]
    return np.array([p.split("->")[-1] for p in paths])


def get_annualized_mmse_changes() -> np.ndarray:
    """(MMSE_last − MMSE_first) / (age_last − age_first) per person
    (``macc.py:71``)."""
    *_, scores, ell, _, ages = get_data()
    out = []
    for i, li in enumerate(ell):
        out.append((scores[li - 1, i, 0] - scores[0, i, 0]) / (ages[li - 1, i] - ages[0, i]))
    return np.array(out)


def get_demographics(ids):
    """The profiling table's rows of ``ids`` (``macc.py:84``)."""
    import pandas as pd

    return pd.read_csv(os.path.join(_DATA_DIR, "macc-profiling.csv"), index_col="Harmy_ID").loc[
        np.asarray(ids).ravel()
    ]


def _main() -> None:
    if not data_available():
        print(f"{name} data not shipped (patient privacy); nothing to do.")
        return
    import pandas as pd

    z, x, d, _, length, ids, ages = get_data()
    print("lengths: ", dict(zip(*np.unique(length, return_counts=True))))
    finals = get_final_diagnoses(d).ravel()
    with pd.option_context("display.float_format", _FLOAT_FORMAT):
        print(pd.Series(finals, name="diagnosis").value_counts().loc[diagnosis_list])


if __name__ == "__main__":
    _main()
