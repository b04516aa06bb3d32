"""Hard-assignment EM for mixtures of LG-SSMs: the Markov fast path.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/em.py`` for
suffix-only missingness (variable-length, NaN-suffix-padded
trajectories): ``MixtureParams`` and the status codes (:93-118),
``counts_from_assign`` (:372), ``_unpack_markov_em_stats`` (:484),
``pack_markov_batch`` (:523), ``pack_markov_features`` (:540),
``markov_packed_ok`` (:573), ``_resolve_phi_store`` (:580),
``_markov_features`` (:614), ``emstep_markov`` (:705, the Φ branch),
``_em_termination`` (:1236) and ``train_em_markov`` (:1754).

The fit materializes the feature matrix Φ once (kernel K2), stores it
int16 under float32 compute, and runs every iteration as one Φ-reading
kernel (K1) followed by small per-cluster solves.  The JAX package traces
the loop into one ``while_loop``; here it is a Python loop that reads one
status scalar from the device per iteration.

Row-vector convention: ``z' = z A``, ``x = z H``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops

__all__ = [
    "MixtureParams",
    "STATUS_RUNNING",
    "STATUS_CONVERGED",
    "STATUS_EMPTY_CLUSTER",
    "STATUS_INIT_ABORT",
    "counts_from_assign",
    "emstep_markov",
    "markov_packed_ok",
    "mixture_params_from_numpy",
    "mixture_params_to_numpy",
    "pack_markov_batch",
    "pack_markov_features",
    "train_em_markov",
]

STATUS_RUNNING = 0
STATUS_CONVERGED = 1
STATUS_EMPTY_CLUSTER = 2
STATUS_INIT_ABORT = 3


class MixtureParams(NamedTuple):
    """Stacked per-cluster parameters (leading axis C): propensities π,
    initial state mean m / cov S, transition matrix A / cov G, measurement
    matrix H / cov L (``z' = z A``, ``x = z H``)."""

    pi: torch.Tensor  # (C,)
    m: torch.Tensor  # (C, d)
    S: torch.Tensor  # (C, d, d)
    A: torch.Tensor  # (C, d, d)
    G: torch.Tensor  # (C, d, d)
    H: torch.Tensor  # (C, d, l)
    L: torch.Tensor  # (C, l, l)

    @property
    def n_clusters(self) -> int:
        return self.pi.shape[0]


def mixture_params_from_numpy(params, *, device="cpu", dtype=None):
    """:class:`MixtureParams` on ``device`` from the seven fields (pi, m, S,
    A, G, H, L) as arrays — numpy, or anything ``np.asarray`` takes, such
    as the JAX package's ``MixtureParams``."""
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    return MixtureParams(
        *(torch.tensor(np.asarray(p), dtype=dt, device=dev) for p in params)
    )


def mixture_params_to_numpy(params: MixtureParams) -> tuple:
    """The seven fields of ``params`` as numpy arrays, in field order."""
    return tuple(p.detach().cpu().numpy() for p in params)


def counts_from_assign(assign: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Members per cluster, ``(C,)`` int32; labels outside ``[0, C)`` are
    not counted."""
    lanes = torch.arange(n_clusters, dtype=assign.dtype, device=assign.device)
    return (assign[:, None] == lanes[None, :]).sum(dim=0).to(torch.int32)


def _unpack_markov_em_stats(g: torch.Tensor, d: int, l: int):
    """Split the per-cluster g-layout sums ``g (F, C)`` into the
    transition and measurement :class:`RegressionStats` and the initial
    :class:`MomentStats`."""
    gT = g.T  # (C, F)
    C = gT.shape[0]
    dd = d * d
    sizes = [dd, dd, dd, l * l, d * l, dd, d, d, l, d, 1, 1]
    g1, g2, g3, g4, g5, g6, g7, g8, g9, g10, g11, g12 = torch.split(
        gT, sizes, dim=1
    )
    g1, g2, g3, g6 = (a.reshape(C, d, d) for a in (g1, g2, g3, g6))
    g4 = g4.reshape(C, l, l)
    g5 = g5.reshape(C, d, l)
    g11, g12 = g11[:, 0], g12[:, 0]  # Σ len, row count
    tstats = rops.RegressionStats(
        xtx=g2, xty=g3, yty=g1 - g6, sx=g7, sy=g8 - g10, count=g11 - g12
    )
    mstats = rops.RegressionStats(
        xtx=g1, xty=g5, yty=g4, sx=g8, sy=g9, count=g11
    )
    istats = rops.MomentStats(count=g12, s=g10, ss=g6)
    return tstats, mstats, istats


def pack_markov_batch(
    z_t: torch.Tensor, x_t: torch.Tensor, *, T: int, d: int, l: int
) -> torch.Tensor:
    """The packed batch ``u (T·s, n)`` from the transposed ``(T·d, n)`` and
    ``(T·l, n)`` batch (``[z_t; x_t; 0-pad]`` per step, NaN → 0)."""
    return mk.pack_markov_u(z_t, x_t, T=T, d=d, l=l)


def pack_markov_features(
    u: torch.Tensor, lens: torch.Tensor, *, T: int, d: int, l: int
) -> torch.Tensor:
    """The per-instance feature matrix Φ (Fc_pad, n) from the packed batch
    (kernel K2), once per fit."""
    return mk.markov_materialize_features(u, lens, T=T, d=d, l=l)


def markov_packed_ok(T: int, d: int, l: int) -> bool:
    """Whether the packed layout takes this shape (T·s ≤ 512); past it the
    JAX package switches to its long-T kernels, not yet ported."""
    return T * 8 * ((d + l + 7) // 8) <= 512


def _resolve_phi_store(dtype: torch.dtype) -> str:
    """Φ storage from ``MTM_MARKOV_PHI``: ``"i16"`` (int16 with per-row
    scales; the default for float32 compute) or ``"wide"`` (the compute
    dtype; the default otherwise)."""
    mode = os.environ.get("MTM_MARKOV_PHI", "").lower()
    if not mode:
        mode = (
            "bf16"
            if os.environ.get("MTM_MARKOV_PHI_BF16", "0") == "1"
            else "auto"
        )
    if mode == "auto":
        mode = "i16" if dtype == torch.float32 else "wide"
    if mode in ("wide", "f32", "f64", "off", "0"):
        return "wide"
    if mode == "i16":
        return "i16"
    if mode == "bf16":
        raise NotImplementedError(
            "bfloat16 Φ storage is not ported (ROADMAP Queue 2: only on a "
            "measured H100 need)"
        )
    raise ValueError(
        f"MTM_MARKOV_PHI={mode!r}: expected auto, i16, bf16 or wide"
    )


def _markov_features(
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int32
    *,
    phi_store: str = "env",
):
    """Φ for the fit (the packed branch of ``em.py:614``): pack the batch,
    materialize the compact Φ, and quantize it under ``phi_store="i16"``
    (``"env"`` resolves ``MTM_MARKOV_PHI``).  Returns a tensor or a
    :class:`~..ops.markov_kernels.PhiQuant`."""
    T, n, d = z.shape
    l = x.shape[-1]
    if not markov_packed_ok(T, d, l):
        raise NotImplementedError(
            f"T·s = {T * 8 * ((d + l + 7) // 8)} > 512 needs the long-T "
            "kernels (ROADMAP Queue 2, K5/K6)"
        )
    if phi_store == "env":
        phi_store = _resolve_phi_store(z.dtype)
    z_t = z.permute(0, 2, 1).reshape(T * d, n)
    x_t = x.permute(0, 2, 1).reshape(T * l, n)
    u = pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
    del z_t, x_t
    phi = pack_markov_features(u, lens, T=T, d=d, l=l)
    del u
    if phi_store == "i16":
        phi = mk.quantize_phi(phi)
    return phi


def emstep_markov(
    params: MixtureParams,
    lens: torch.Tensor,  # (n,) int32
    prev_assign: torch.Tensor,  # (n,) int32
    phi,  # (Fc_pad, n) tensor or PhiQuant (_markov_features)
    *,
    T: int,
    assign_mode: str = "argmax",
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
):
    """One EM iteration over Φ: ``(new_params, assign, counts,
    switches)``.  ``assign_mode="prev"`` is the initial M step (statistics
    under ``prev_assign``, no E step)."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    Wg = mops.markov_em_weights(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    Wg[:, -1] += torch.log(params.pi)
    assign, counts, switches, g, _obj = mk.markov_em_from_features(
        phi, prev_assign, Wg, T=T, d=d, l=l, assign_mode=assign_mode
    )
    tstats, mstats, istats = _unpack_markov_em_stats(g, d, l)
    n = lens.shape[0]
    pi = counts.to(Wg.dtype) / n
    m0, S0 = rops.mean_cov_from_stats(istats)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
    return MixtureParams(pi, m0, S0, A, G, H, L), assign, counts, switches


def _em_termination(switches, counts, status_else, *, min_members):
    """Per-step termination: ``converged`` = no switches, ``empty`` = some
    cluster at or below the member floor (convergence wins the tie),
    ``advance`` = take the new M parameters and keep running.  ``status``
    nests CONVERGED over EMPTY_CLUSTER over ``status_else``."""
    converged = switches == 0
    empty = (~converged) & (counts.amin(dim=-1) <= min_members)
    advance = (~converged) & (~empty)
    status = torch.where(
        converged,
        STATUS_CONVERGED,
        torch.where(empty, STATUS_EMPTY_CLUSTER, status_else),
    )
    return converged, empty, advance, status


def train_em_markov(
    params0: MixtureParams,
    assign0: torch.Tensor,  # (n,) int
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int32 observed prefix lengths
    *,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    precompute: bool = None,
):
    """Hard EM for suffix missingness through Φ: returns ``(params,
    assign, iterations, status)`` (Python ints for the last two).

    1. if some cluster of ``assign0`` has ≤ ``min_members`` members,
       return untouched (STATUS_INIT_ABORT);
    2. an M step from ``assign0``;
    3. up to ``n_steps``: E + M in one K1 pass; no switches → CONVERGED;
       a near-empty cluster → EMPTY_CLUSTER (assignment updated,
       parameters kept); else take the new parameters.

    ``precompute`` (default ``MTM_MARKOV_PRECOMP``, on) must be on: the
    per-iteration shift-product kernel that ``precompute=False`` selects
    is not ported."""
    if precompute is None:
        precompute = os.environ.get("MTM_MARKOV_PRECOMP", "1") == "1"
    if not precompute:
        raise NotImplementedError(
            "precompute=False (MTM_MARKOV_PRECOMP=0) needs the packed "
            "per-iteration kernel (ROADMAP Queue 2, K4)"
        )
    T = z.shape[0]
    C = params0.pi.shape[0]
    assign0 = assign0.to(torch.int32)
    lens = lens.to(torch.int32)
    if int(counts_from_assign(assign0, C).amin()) <= min_members:
        return params0, assign0, 0, STATUS_INIT_ABORT
    phi = _markov_features(z, x, lens)

    def step(params, prev, mode):
        return emstep_markov(
            params,
            lens,
            prev,
            phi,
            T=T,
            assign_mode=mode,
            reg_mode=reg_mode,
            alpha=alpha,
        )

    params = step(params0, assign0, "prev")[0]
    assign = assign0
    status = STATUS_RUNNING
    it = 0
    while status == STATUS_RUNNING and it < n_steps:
        new_params, assign, counts, switches = step(params, assign, "argmax")
        _conv, _empty, _advance, status_t = _em_termination(
            switches, counts, STATUS_RUNNING, min_members=min_members
        )
        status = int(status_t)  # the one device→host read per iteration
        if status == STATUS_RUNNING:
            params = new_params
        it += 1
    return params, assign, it, status
