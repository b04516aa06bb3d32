"""Host-side state-space utilities: regression MLE wrappers, data
transforms, NaN-shape tooling and weighted moments.

Counterpart of the numpy half of
``multimodal_trajectory_modeling_tpu/utils/state_space.py`` (:28,
:48-230), kept as this package's own copy so that nothing here imports the
JAX package.  The two regression wrappers run :func:`..ops.regression.regress`
in float64 on the CPU.  Nothing here imports pandas or matplotlib; the
plotting half of the JAX module (:247-592) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops

CLUSTER_COLORS = (
    "#0072CE",
    "#E87722",
    "#64A70B",
    "#93328E",
    "#A81538",
    "#4E5B31",
)

# the matplotlib settings the JAX package applies globally at import
# (state_space.py:24-26); this package's plotters apply them inside
# ``plt.rc_context`` only
PLOT_RC = {
    "figure.autolayout": True,
    "legend.loc": "upper right",
    "font.family": "serif",
}


# --------------------------------------------------------------------------
# regression MLE (state_space.py:48-62)
# --------------------------------------------------------------------------


def _regress(X, Y, **kw):
    A, S = rops.regress(
        torch.as_tensor(np.asarray(X, dtype=float)),
        torch.as_tensor(np.asarray(Y, dtype=float)),
        **kw,
    )
    return A.numpy(), S.numpy()


def regress(X: np.ndarray, Y: np.ndarray, eps: float = 1e-6):
    """MLE of ``Y|X ~ N(X A, S)`` with any-NaN rows dropped; solves the
    eps-ridged normal equations (``state_space.py:48``)."""
    return _regress(X, Y, mode="eps", eps=eps)


def regress_alpha(X: np.ndarray, Y: np.ndarray, alpha: float):
    """Ridge variant, as scikit-learn's ``Ridge(fit_intercept=False)``
    (``state_space.py:56``)."""
    return _regress(X, Y, mode="ridge", alpha=alpha)


# --------------------------------------------------------------------------
# shape / NaN tooling (state_space.py:69-206)
# --------------------------------------------------------------------------


def nancat(arr1: np.ndarray, arr2: np.ndarray) -> np.ndarray:
    """Concatenate two ``T × n × dim`` arrays along the instance axis,
    NaN-padding the shorter one in time."""
    assert arr2.shape[2:] == arr1.shape[2:]
    T = max(arr1.shape[0], arr2.shape[0])

    def pad(a):
        if a.shape[0] == T:
            return a
        fill = np.full((T - a.shape[0], *a.shape[1:]), np.nan)
        return np.concatenate([a, fill], axis=0)

    return np.concatenate([pad(arr1), pad(arr2)], axis=1)


def standardize(arr, *, params=None, return_params: bool = False):
    """Scale per feature to [0.1, 1] over the (time, instance) axes.  The
    operation order is the JAX package's, so the standardized bytes (and
    the models' content hashes) are the same."""
    if params is None:
        lo = np.nanmin(arr, axis=(0, 1), keepdims=True)
        hi = np.nanmax(arr, axis=(0, 1), keepdims=True)
    else:
        lo, hi = params["arr_mn"], params["arr_mx"]
    out = 0.9 * np.divide(arr - lo, hi - lo) + 0.1
    if return_params:
        return out, {"arr_mn": lo, "arr_mx": hi}
    return out


def unstandardize(arr, params):
    """Inverse of :func:`standardize`."""
    out = (params["arr_mx"] - params["arr_mn"]) / 0.9 * (arr - 0.1) + params[
        "arr_mn"
    ]
    assert np.allclose(standardize(out, params=params), arr)
    return out


def unstandardize_mean_and_cov(mean, cov, params):
    """Push Gaussian moments through the inverse standardization."""
    mean_u = unstandardize(mean.reshape((1, 1, -1)), params=params).reshape(
        mean.shape
    )
    J = np.diag(((params["arr_mx"] - params["arr_mn"]) / 0.9).ravel())
    return mean_u, J @ cov @ J.T


def unstandardize_mean_and_cov_diffs(mean_diff, cov_diff, params):
    """The same for differences (no offset term)."""
    J = np.diag(((params["arr_mx"] - params["arr_mn"]) / 0.9).ravel())
    return J @ mean_diff, J @ cov_diff @ J.T


def normalize(
    arr, eps=np.finfo(float).eps, *, params=None, return_params=False
):
    """Z-score per feature over the (time, instance) axes."""
    if params is None:
        mu = np.nanmean(arr, axis=(0, 1), keepdims=True)
        sd = np.nanstd(arr, axis=(0, 1), keepdims=True) + eps
    else:
        mu, sd = params["arr_mean"], params["arr_std"]
    out = (arr - mu) / sd
    if return_params:
        return out, {"arr_mean": mu, "arr_std": sd}
    return out


def unnormalize(arr, params):
    """Inverse of :func:`normalize`."""
    out = params["arr_std"] * arr + params["arr_mean"]
    assert np.allclose(normalize(out, params=params), arr)
    return out


def take_finite_along_axis(arr: np.ndarray, axis: int = 0) -> np.ndarray:
    """Keep only the slices along ``axis`` that are entirely finite."""
    others = tuple(a for a in range(arr.ndim) if a != axis)
    keep = np.isfinite(arr).all(axis=others)
    shape = list(arr.shape)
    shape[axis] = -1
    return np.take(arr, np.flatnonzero(keep), axis).reshape(shape)


def mask_all_but_time_i(arr: np.ndarray, i: int) -> np.ndarray:
    """NaN everything except time step ``i``."""
    out = np.full_like(arr, np.nan)
    out[i] = arr[i]
    return out


def mask_all_but_time_i_vect(arr: np.ndarray, i: np.ndarray) -> np.ndarray:
    """Per-instance version: keep time ``i[j]`` for instance j."""
    assert len(i) == arr.shape[1]
    out = np.full_like(arr, np.nan)
    cols = np.arange(arr.shape[1])
    out[np.asarray(i), cols] = arr[np.asarray(i), cols]
    return out


def get_finite_length(arr: np.ndarray) -> np.ndarray:
    """Length of the fully finite prefix of each trajectory."""
    fin = np.isfinite(arr).all(axis=-1)  # (T, n)
    return np.where(fin.all(axis=0), fin.shape[0], np.argmin(fin, axis=0))


def take_final_finite(arr: np.ndarray) -> np.ndarray:
    """Last fully finite snapshot of each trajectory."""
    last = get_finite_length(arr) - 1
    assert np.all(last >= 0)
    return arr[last, np.arange(arr.shape[1])]


def add_constant_where_finite(arr: np.ndarray) -> np.ndarray:
    """Append a 1.0 column wherever any feature is finite, NaN elsewhere."""
    const = np.where(np.isfinite(arr).any(axis=-1)[..., None], 1.0, np.nan)
    return np.concatenate([arr, const], axis=-1)


def weighted_mean_and_covariance(values: np.ndarray, weights: np.ndarray):
    """NaN-aware weighted mean and covariance per time step, with per-cell
    finite-count denominators (``state_space.py:210``)."""
    assert (np.asarray(weights) >= 0).all()
    vals = np.nan_to_num(values)
    fin = np.isfinite(values).astype(float)
    num = np.einsum("tnd,n->td", vals, weights)
    den = np.einsum("tnd,n->td", fin, weights)
    mean = num / den
    centered = values - mean[:, None, :]
    cfin = np.isfinite(centered).astype(float)
    cnum = np.einsum(
        "tnd,n,tne->tde", np.nan_to_num(centered), weights, np.nan_to_num(centered)
    )
    cden = np.einsum("tnd,n,tne->tde", cfin, weights, cfin)
    return mean, cnum / cden
