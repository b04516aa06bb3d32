"""Hard-assignment EM for mixtures of LG-SSMs: the Markov fast path, for
one fit and for many starts, and the dense joint route.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/em.py``.  For
suffix-only missingness (variable-length, NaN-suffix-padded
trajectories): ``MixtureParams`` and the status codes (:93-118),
``counts_from_assign`` (:372), ``estep_assign_markov`` (:442),
``_unpack_markov_em_stats`` (:484), ``pack_markov_batch`` (:523),
``pack_markov_features`` (:540), ``markov_packed_ok`` (:573),
``_resolve_phi_store`` (:580), ``_markov_features`` (:614),
``emstep_markov`` (:705), ``complete_data_loglik_markov`` (:1066),
``suffix_logliks_markov`` (:1175, both forms), ``model_loglik_markov``
(:1209), ``_em_termination`` (:1236), ``train_em_markov`` (:1754), and
the multistart engine:
``_tree_select_rows`` (:2161), ``emstep_markov_multi`` (:2172),
``train_em_markov_multi`` (:2261), ``_pool_window_protocol`` (:2358),
``_pool_window`` (:2414), ``_run_slot_pool`` (:2464),
``train_em_markov_pool`` (:2587) and ``complete_data_loglik_markov_multi``
(:2704).  For any missingness, the dense joint route: ``pack_joint``
(:121), ``pack_observed`` (:138), ``cluster_joint_moments`` (:144),
``cluster_observed_moments`` (:157), ``estep_logliks`` (:171),
``estep_logliks_sorted`` (:203), ``observed_logliks`` (:232),
``observed_logliks_kalman`` (:251), ``assignments_from_logliks`` (:367),
``estep_assign_sorted`` (:382), ``mstep_sorted`` (:872), ``mstep``
(:920), ``complete_data_loglik``
(:1028), ``model_loglik`` (:1047), ``train_em`` (:1261),
``train_em_sorted`` (:1663) and ``train_em_multistart`` (:2762); and the
masked-filter route: ``masked_logliks_kalman`` (:320),
``complete_data_loglik_masked_kalman`` (:352), ``mstep_multi`` (:990),
``train_em_masked_kalman`` (:1329), ``emstep_masked_kalman_multi``
(:1445), ``_pool_window_masked_kalman`` (:1535) and
``train_em_masked_kalman_pool`` (:1585).

A Markov fit materializes the feature matrix Φ once (kernel K2; past
T·s = 512 the canonical Φ, K5), stores it int16 under float32 compute,
and runs every iteration as one Φ-reading kernel (K1; K3 for R restarts
at once) followed by small per-cluster solves; ``precompute=False``
rebuilds Φ from the packed batch in every iteration instead (K4a; K4b
for R restarts), or at long T from the raw transposed batch (K6).  The
multistart objectives come from K4a/K4b on the wide packed batch, or at
long T from K3 on a wide canonical Φ (the pool) or K6 (one candidate
after another).  The inference helpers score suffix data in O(T): the E
step from the raw batch (K10), the (C, n) log-likelihoods through K5's
Φ on the card.  The masked-filter route (any per-coordinate
missingness, any T) runs one masked Kalman filter pass per E step (K7)
and one masked M step through K15 on the batch in place (the masked
pool's M step for R restarts stays plain torch).  The dense route
evaluates every instance's masked joint Gaussian: ``train_em`` (the
log-likelihoods from K12 on the card, one grouped log-density per cluster
on the CPU; time-batched statistics in plain torch, or K15 under
``mstep(impl="pallas")``), and ``train_em_sorted`` over a batch sorted by
missingness pattern through one E-step kernel (K8; K14 on the row-major
batch) and one Gram kernel (K9) per iteration; K13 gives a sorted
batch's log-likelihoods.  The dense multistart ``train_em_multistart``
trains R restarts together: one K12 launch on the clusters of those still
running and one ``mstep_multi`` an iteration (``train_em`` is its
one-restart case).  The observed-only functions take the same
log-density of the observations alone (states marginalized): K12 on the
card, or past the dense size the O(T) filters.  The JAX
package traces each loop into one ``while_loop`` or ``fori_loop``; here a
single fit is a Python loop that reads one status scalar from the device
per iteration, and the slot pool runs ``sync_every`` passes per window
with one status read per window.

Row-vector convention: ``z' = z A``, ``x = z H``.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)
from multimodal_trajectory_modeling_tpu_torch.ops import estep_kernels as ek
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu_torch.ops import kalman as kops
from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk
from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels import markov_packed_ok
from multimodal_trajectory_modeling_tpu_torch.ops import moments as jmom
from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as msk
from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops

__all__ = [
    "MixtureParams",
    "PoolStats",
    "STATUS_RUNNING",
    "STATUS_CONVERGED",
    "STATUS_EMPTY_CLUSTER",
    "STATUS_INIT_ABORT",
    "assignments_from_logliks",
    "cluster_joint_moments",
    "cluster_observed_moments",
    "complete_data_loglik",
    "complete_data_loglik_markov",
    "complete_data_loglik_markov_multi",
    "complete_data_loglik_masked_kalman",
    "counts_from_assign",
    "emstep_markov",
    "emstep_markov_multi",
    "emstep_masked_kalman_multi",
    "estep_assign_markov",
    "estep_assign_sorted",
    "estep_logliks",
    "estep_logliks_sorted",
    "markov_packed_ok",
    "masked_logliks_kalman",
    "mixture_params_from_numpy",
    "mixture_params_to_numpy",
    "model_loglik",
    "model_loglik_markov",
    "mstep",
    "mstep_multi",
    "mstep_sorted",
    "observed_logliks",
    "observed_logliks_kalman",
    "pack_joint",
    "pack_markov_batch",
    "pack_markov_features",
    "pack_observed",
    "stack_params",
    "suffix_logliks_markov",
    "train_em",
    "train_em_markov",
    "train_em_markov_multi",
    "train_em_markov_pool",
    "train_em_masked_kalman",
    "train_em_masked_kalman_pool",
    "train_em_multistart",
    "train_em_sorted",
    "unstack_params",
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


def mixture_params_from_numpy(params, *, device="cuda", dtype=None):
    """:class:`MixtureParams` on ``device`` (the card unless the caller
    asks for the CPU) from the seven fields (pi, m, S, A, G, H, L) as
    arrays — numpy, or anything ``np.asarray`` takes, such as the JAX
    package's ``MixtureParams``."""
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
    u: torch.Tensor | None = None,
    precompute: bool | None = None,
    phi_store: str = "env",
    longT_always_phi: bool = False,
):
    """The Φ routing of every Markov trainer (``em.py:614``): returns
    ``(u, phi)``.  ``phi`` is a tensor or a
    :class:`~..ops.markov_kernels.PhiQuant`, quantized under
    ``phi_store="i16"`` (``"env"`` resolves ``MTM_MARKOV_PHI``).

    - packed shapes (:func:`markov_packed_ok`): the packed batch (``u``
      itself if given) and, under ``precompute`` (default
      ``MTM_MARKOV_PRECOMP``, on), the compact Φ (K2); else ``phi`` is
      None and every iteration rebuilds Φ from ``u``;
    - long T: the canonical Φ (K5), no packed batch.  Without
      ``precompute`` ``u`` is the transposed batch in its plan's row order
      (:class:`~..ops.markov_kernels.RawBatch`: the plan's permutation
      folded into the transposing copy) and ``phi`` None: every iteration
      of the single-restart trainer runs K6 on it.  The R-restart callers
      pass ``longT_always_phi`` (their kernels have no such mode)."""
    T, n, d = z.shape
    l = x.shape[-1]
    if precompute is None:
        precompute = os.environ.get("MTM_MARKOV_PRECOMP", "1") == "1"
    if phi_store == "env":
        phi_store = _resolve_phi_store(z.dtype)
    if not (markov_packed_ok(T, d, l) or precompute or longT_always_phi):
        return mk.plan_raw_batch(z, x, lens), None
    z_t = x_t = None
    if u is None or not markov_packed_ok(T, d, l):
        z_t = z.permute(0, 2, 1).reshape(T * d, n)
        x_t = x.permute(0, 2, 1).reshape(T * l, n)
    if markov_packed_ok(T, d, l):
        if u is None:
            u = pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
        del z_t, x_t
        if not precompute:
            return u, None
        phi = pack_markov_features(u, lens, T=T, d=d, l=l)
    else:
        phi = mk.markov_materialize_features_longT(z_t, x_t, lens, T=T, d=d, l=l)
        del z_t, x_t
        u = None
    if phi_store == "i16":
        phi = mk.quantize_phi(phi)
    return u, phi


def _weights(params: MixtureParams) -> torch.Tensor:
    """E-score weights ``Wg (C, F)`` with log π folded into the constant
    feature."""
    Wg = mops.markov_em_weights(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    Wg[:, -1] += torch.log(params.pi)
    return Wg


def _grouped_weights(params: MixtureParams):
    """The grouped weights ``(W1, W2, W3)`` of K6 and K10, log π folded
    into ``W3[:, -1]``."""
    W1, W2, W3 = mops.markov_cluster_weights_grouped(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    W3[:, -1] += torch.log(params.pi)
    return W1, W2, W3


def _msolve(g, counts, n, d, l, *, reg_mode, alpha) -> MixtureParams:
    """The M step from the per-cluster g-layout sums ``g (F, C)`` and the
    member counts ``(C,)``."""
    tstats, mstats, istats = _unpack_markov_em_stats(g, d, l)
    pi = counts.to(g.dtype) / n
    m0, S0 = rops.mean_cov_from_stats(istats)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
    return MixtureParams(pi, m0, S0, A, G, H, L)


def emstep_markov(
    params: MixtureParams,
    lens: torch.Tensor,  # (n,) int32
    prev_assign: torch.Tensor,  # (n,) int32
    phi=None,  # (Fc_pad, n) tensor or PhiQuant (_markov_features)
    *,
    T: int,
    u=None,  # (T·s, n) packed batch, or at long T a RawBatch
    assign_mode: str = "argmax",
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
):
    """One EM iteration: ``(new_params, assign, counts, switches)``, from
    Φ (K1) or, without Φ, from the packed batch ``u`` (K4a) or at long T
    from the planned transposed batch ``u`` (:func:`_markov_features`; K6,
    the grouped weights; ``em.py:794-815``), whose row order
    ``prev_assign`` and the returned assignment then follow.
    ``assign_mode="prev"`` is the initial M step (statistics under
    ``prev_assign``, no E step)."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    if phi is not None:
        assign, counts, switches, g, _obj = mk.markov_em_from_features(
            phi, prev_assign, _weights(params), T=T, d=d, l=l, assign_mode=assign_mode
        )
    elif isinstance(u, mk.RawBatch):
        assign, counts, switches, g, _obj = mk.markov_em_fused_longT(
            u.z_t, u.x_t, u.lens, prev_assign, *_grouped_weights(params), T=T, d=d, l=l,
            assign_mode=assign_mode, plan=u.plan,
        )
    elif u is not None:
        assign, counts, switches, g, _obj = mk.markov_em_fused_packed(
            u, lens, prev_assign, _weights(params), T=T, d=d, l=l, assign_mode=assign_mode
        )
    else:
        raise ValueError("emstep_markov needs phi or the packed batch u")
    new_params = _msolve(
        g, counts, lens.shape[0], d, l, reg_mode=reg_mode, alpha=alpha
    )
    return new_params, assign, counts, switches


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

    ``precompute`` (default ``MTM_MARKOV_PRECOMP``, on) materializes Φ
    once (K2; at long T the canonical Φ, K5) and runs every iteration
    from it (K1); off, every iteration rebuilds Φ from the packed batch
    (K4a), or at long T from the transposed batch in its plan's row
    order (K6; the assignment is permuted into that order once and back
    once).  Both give the same trajectory in float64."""
    T = z.shape[0]
    C = params0.pi.shape[0]
    assign0 = assign0.to(torch.int32)
    lens = lens.to(torch.int32)
    if int(counts_from_assign(assign0, C).amin()) <= min_members:
        return params0, assign0, 0, STATUS_INIT_ABORT
    u, phi = _markov_features(z, x, lens, precompute=precompute)
    if phi is not None:
        u = None  # Φ carries the iterations; free the packed batch
    rows = u.plan.rows.long() if isinstance(u, mk.RawBatch) else None
    if rows is not None:
        assign0 = assign0[rows]  # the plan's order inside the loop

    def step(params, prev, mode):
        return emstep_markov(
            params,
            lens,
            prev,
            phi,
            T=T,
            u=u,
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
    if rows is not None:
        assign = torch.empty_like(assign).index_copy_(0, rows, assign)
    return params, assign, it, status


def complete_data_loglik_markov(
    params: MixtureParams,
    z_t: torch.Tensor,  # (T·d, n) transposed latent batch
    x_t: torch.Tensor,  # (T·l, n) transposed observations
    lens: torch.Tensor,  # (n,) int32
    *,
    T: int,
) -> torch.Tensor:
    """The hard-assignment complete-data objective under a fresh E step,
    ``Σ_i max_c scores``, as a 0-d tensor (``em.py:1066``): one K4a pass
    over the packed batch, or past T·s = 512 one K6 pass over the
    transposed batch."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    prev = torch.zeros(lens.shape, dtype=torch.int32, device=lens.device)
    if not markov_packed_ok(T, d, l):
        return mk.markov_em_fused_longT(
            z_t, x_t, lens, prev, *_grouped_weights(params), T=T, d=d, l=l
        )[4]
    u = pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
    return mk.markov_em_fused_packed(u, lens, prev, _weights(params), T=T, d=d, l=l)[4]


def estep_assign_markov(
    params: MixtureParams,
    z_t: torch.Tensor,  # (T·d, n) transposed latent batch
    x_t: torch.Tensor,  # (T·l, n) transposed observations
    lens: torch.Tensor,  # (n,) int32 observed prefix lengths
    prev_assign: torch.Tensor,  # (n,) int32
    *,
    T: int,
):
    """The E step on suffix data from the raw batch, ``(assign, counts,
    switches)``, log π folded into the end weights: one K10 pass
    (``em.py:442``)."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    return mk.markov_assign_suffix(
        z_t, x_t, lens, prev_assign, *_grouped_weights(params), T=T, d=d, l=l
    )


def _suffix_logliks_markov_xla(params: MixtureParams, z, x, lens) -> torch.Tensor:
    """The slice-pair form of :func:`suffix_logliks_markov` (plain
    torch)."""
    W = mops.markov_cluster_weights(params.m, params.S, params.A, params.G, params.H, params.L)
    return mops.markov_suffix_logliks(z, x, lens, W)


def _suffix_logliks_markov_phi(params: MixtureParams, z, x, lens) -> torch.Tensor:
    """The Φ form of :func:`suffix_logliks_markov`: the canonical Φ (K5),
    then one full-precision ``(C, F_pad)·(F_pad, n)`` product."""
    T, n, d = z.shape
    l = x.shape[-1]
    z_t = z.permute(0, 2, 1).reshape(T * d, n)
    x_t = x.permute(0, 2, 1).reshape(T * l, n)
    phi = mk.markov_materialize_features_longT(z_t, x_t, lens.to(torch.int32), T=T, d=d, l=l)
    Wg = mops.markov_em_weights(params.m, params.S, params.A, params.G, params.H, params.L)
    wc = torch.zeros((Wg.shape[0], phi.shape[0]), dtype=Wg.dtype, device=Wg.device)
    wc[:, : Wg.shape[1]] = Wg  # the canonical rows are 0..F-1
    return wc @ phi


def suffix_logliks_markov(
    params: MixtureParams,
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int observed prefix lengths (1..T)
    *,
    via_phi: bool | None = None,
) -> torch.Tensor:
    """``(C, n)`` joint log-likelihoods under suffix missingness in O(T)
    (``em.py:1175``): through K5's canonical Φ and one weight product
    (``via_phi``, the default on the card), or through the slice-pair
    features (the default on the CPU).  The two agree to rounding."""
    if via_phi is None:
        via_phi = z.device.type == "cuda"
    if via_phi:
        return _suffix_logliks_markov_phi(params, z, x, lens)
    return _suffix_logliks_markov_xla(params, z, x, lens)


def model_loglik_markov(
    params: MixtureParams,
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int
) -> torch.Tensor:
    """:func:`model_loglik` in O(T) through the slice-pair features
    (``em.py:1209``), as a 0-d tensor."""
    ll = _suffix_logliks_markov_xla(params, z, x, lens)
    return torch.logsumexp(torch.log(params.pi)[:, None] + ll, dim=0).sum()


# ----------------------------------------------------------------------
# R restarts at once
# ----------------------------------------------------------------------


def stack_params(params_list) -> MixtureParams:
    """R :class:`MixtureParams` stacked on a new leading restart axis."""
    return MixtureParams(*(torch.stack(leaves) for leaves in zip(*params_list)))


def unstack_params(params: MixtureParams) -> list:
    """The R restarts of an R-stacked :class:`MixtureParams`, in order
    (views into the stacked tensors)."""
    return [MixtureParams(*leaves) for leaves in zip(*params)]


def _tree_select_rows(pred_r, on_true: MixtureParams, on_false: MixtureParams):
    """Per-restart select: restart r from ``on_true`` where ``pred_r[r]``,
    else from ``on_false`` (every leaf carries the leading R axis)."""

    def sel(a, b):
        return torch.where(pred_r.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    return MixtureParams(*(sel(a, b) for a, b in zip(on_true, on_false)))


def _stacked_weights(params: MixtureParams) -> torch.Tensor:
    """``Wg (R, C, F)`` of R-stacked parameters: the R·C clusters go
    through :func:`_weights` as one C-batch."""
    R, C = params.pi.shape
    flat = MixtureParams(*(p.reshape(R * C, *p.shape[2:]) for p in params))
    return _weights(flat).reshape(R, C, -1)


def emstep_markov_multi(
    params: MixtureParams,  # leading R axis on every leaf
    lens: torch.Tensor,  # (n,) int32 — shared by the restarts
    prev_assign: torch.Tensor,  # (R, n) int32
    u: torch.Tensor | None = None,  # (T·s, n) packed batch — shared
    *,
    T: int,
    assign_mode: str = "argmax",
    force_prev=None,  # (R,) — per-slot prev mode
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    phi=None,  # (Fc_pad, n) tensor or PhiQuant — shared
):
    """One EM iteration for R independent restarts over one batch:
    ``(new_params, assign (R, n), counts (R, C), switches (R,), obj
    (R,))``, from Φ (K3) or, without Φ, from the packed batch (K4b).
    ``force_prev`` puts single slots in prev mode for this pass (a pool
    insertion's initial M step).  The M solves of all R·C clusters run as
    one C-batched solve of R·C clusters (the JAX package ``vmap``s them)."""
    R, C = params.pi.shape
    d = params.m.shape[2]
    l = params.H.shape[3]
    Wg = _stacked_weights(params)
    if phi is not None:
        assign, counts, switches, g, obj = mk.markov_em_from_features_multi(
            phi, lens, prev_assign, Wg, T=T, d=d, l=l,
            assign_mode=assign_mode, force_prev=force_prev,
        )
    elif u is not None:
        assign, counts, switches, g, obj = mk.markov_em_fused_packed_multi(
            u, lens, prev_assign, Wg, T=T, d=d, l=l,
            assign_mode=assign_mode, force_prev=force_prev,
        )
    else:
        raise ValueError("emstep_markov_multi needs phi or the packed batch u")
    F = g.shape[1]
    flat = _msolve(
        g.permute(1, 0, 2).reshape(F, R * C), counts.reshape(R * C),
        lens.shape[0], d, l, reg_mode=reg_mode, alpha=alpha,
    )
    new_params = MixtureParams(*(p.reshape(R, C, *p.shape[1:]) for p in flat))
    return new_params, assign, counts, switches, obj


def _counts_rows(assign: torch.Tensor, C: int) -> torch.Tensor:
    """Members per cluster of every row of ``assign (R, n)``: ``(R, C)``."""
    lanes = torch.arange(C, dtype=assign.dtype, device=assign.device)
    return (assign[:, :, None] == lanes).sum(dim=1).to(torch.int32)


def train_em_markov_multi(
    params0: MixtureParams,  # leading R axis on every leaf
    assign0: torch.Tensor,  # (R, n) int
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded — shared
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int32
    *,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    u: torch.Tensor | None = None,
):
    """:func:`train_em_markov` for R restarts in fixed chunks: ``(params,
    assign (R, n), iters (R,), status (R,))``.  Each restart follows its
    standalone trajectory; the loop runs until every restart is terminal
    (or ``n_steps``), terminal restarts frozen, with one status read per
    iteration."""
    T = z.shape[0]
    C = params0.pi.shape[1]
    assign0 = assign0.to(torch.int32)
    lens = lens.to(torch.int32)
    u, phi = _markov_features(z, x, lens, u=u, longT_always_phi=True)

    def step(params, prev, mode):
        return emstep_markov_multi(
            params, lens, prev, u, T=T, assign_mode=mode, reg_mode=reg_mode,
            alpha=alpha, phi=phi,
        )

    init_abort = _counts_rows(assign0, C).amin(dim=1) <= min_members
    params = _tree_select_rows(init_abort, params0, step(params0, assign0, "prev")[0])
    status = torch.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING).to(torch.int32)
    iters = torch.zeros_like(status)
    assign = assign0
    it = 0
    while it < n_steps and bool((status == STATUS_RUNNING).any()):
        new_params, new_assign, counts, switches, _obj = step(params, assign, "argmax")
        running = status == STATUS_RUNNING
        _conv, _empty, advance, status_new = _em_termination(
            switches, counts, status, min_members=min_members
        )
        params = _tree_select_rows(running & advance, new_params, params)
        assign = torch.where(running[:, None], new_assign, assign)
        status = torch.where(running, status_new, status)
        iters = iters + running.to(torch.int32)
        it += 1
    return params, assign, iters, status


def _pool_window_protocol(emstep_fn, K, state0, *, n_steps, min_members):
    """K passes of the slot-pool protocol, with no device→host read: each
    pass runs ``emstep_fn(params, assigns, force) -> (new_params,
    new_assign, counts, switches)`` on every slot; terminal or capped
    slots stay frozen, a ``force`` slot takes its initial prev-M step on
    its first active pass (not counted as an iteration), and every other
    active slot takes one counted iteration under
    :func:`_em_termination`."""
    params, assigns, status, iters, force = state0
    for _ in range(K):
        new_params, new_assign, counts, switches = emstep_fn(params, assigns, force)
        fp = force > 0
        active = (status == STATUS_RUNNING) & (iters < n_steps)
        stepped = active & ~fp  # a counted argmax iteration
        _conv, _empty, advance, status_new = _em_termination(
            switches, counts, status, min_members=min_members
        )
        take_new = (active & fp) | (stepped & advance)  # prev-M or EM update
        params = _tree_select_rows(take_new, new_params, params)
        assigns = torch.where(active[:, None], new_assign, assigns)
        status = torch.where(stepped, status_new, status)
        iters = iters + stepped.to(torch.int32)
        force = torch.where(active & fp, 0, force)
    return params, assigns, status, iters, force


def _pool_window(
    params,  # R-stacked MixtureParams
    assigns,  # (R, n) int32
    status,  # (R,) int32
    iters,  # (R,) int32
    force,  # (R,) int32 — 1 ⇒ the slot's next pass is its initial M step
    lens,  # (n,) int32
    u,  # (T·s, n) packed batch (None when Φ carries the iterations)
    phi=None,  # Φ tensor or PhiQuant
    *,
    T: int,
    K: int,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
):
    """K multi-restart EM passes with per-slot freezing and insertion:
    one K3 (or K4b) pass each, no host read (the JAX package runs them as
    one ``fori_loop`` dispatch)."""

    def emstep_fn(params, assigns, force):
        return emstep_markov_multi(
            params, lens, assigns, u, T=T, force_prev=force,
            reg_mode=reg_mode, alpha=alpha, phi=phi,
        )[:4]

    return _pool_window_protocol(
        emstep_fn, K, (params, assigns, status, iters, force),
        n_steps=n_steps, min_members=min_members,
    )


def _run_slot_pool(
    window, params_list, assign_list, *, R, C, n, n_steps, min_members, device
):
    """The host scheduler of the slot pool: R device slots, each refilled
    with the next candidate the moment its occupant terminates or reaches
    ``n_steps``.  A candidate that fails the init guard is recorded at
    once (status 3, no iteration); refills go to the device as one batched
    update per state tensor; the host reads the slots' status and
    iterations once per window.  Returns ``(results, windows, reads)``:
    ``[(params, assign (n,), iters, status), ...]`` in candidate order,
    and the window and host-read counts."""
    n_cand = len(params_list)
    results = [None] * n_cand
    next_cand = 0

    def host_assign(a):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a.astype(np.int32)

    def take_next():
        nonlocal next_cand
        while next_cand < n_cand:
            i = next_cand
            next_cand += 1
            a0 = host_assign(assign_list[i])
            if np.bincount(a0, minlength=C).min() <= min_members:
                results[i] = (
                    params_list[i],
                    torch.as_tensor(a0, device=device),
                    0,
                    STATUS_INIT_ABORT,
                )
                continue
            return i, a0
        return None

    slot_cand = [-1] * R  # candidate index, -1 = drained
    stack = stack_params([params_list[0]] * R)
    assigns = torch.full((R, n), -1, dtype=torch.int32, device=device)
    status = torch.full((R,), STATUS_CONVERGED, dtype=torch.int32, device=device)
    iters = torch.zeros((R,), dtype=torch.int32, device=device)
    force = torch.zeros((R,), dtype=torch.int32, device=device)

    def refill(rows):
        """Insert the next candidates into ``rows`` (out of place: the
        results keep views of the old state)."""
        nonlocal stack, assigns, status, iters, force
        take_rows, take_params, take_assigns = [], [], []
        for r in rows:
            nxt = take_next()
            if nxt is None:
                slot_cand[r] = -1
                continue
            i, a0 = nxt
            slot_cand[r] = i
            take_rows.append(r)
            take_params.append(params_list[i])
            take_assigns.append(a0)
        if not take_rows:
            return
        rj = (torch.as_tensor(take_rows, device=device),)
        stack = MixtureParams(
            *(s.index_put(rj, p) for s, p in zip(stack, stack_params(take_params)))
        )
        assigns = assigns.index_put(rj, torch.as_tensor(np.stack(take_assigns), device=device))
        status = status.index_put(rj, torch.tensor(STATUS_RUNNING, dtype=torch.int32, device=device))
        iters = iters.index_put(rj, torch.tensor(0, dtype=torch.int32, device=device))
        force = force.index_put(rj, torch.tensor(1, dtype=torch.int32, device=device))

    refill(list(range(R)))
    windows = reads = 0
    while any(c >= 0 for c in slot_cand):
        stack, assigns, status, iters, force = window(stack, assigns, status, iters, force)
        status_h, iters_h = torch.stack([status, iters]).cpu().numpy()
        windows += 1
        reads += 1
        done_rows = []
        slots = unstack_params(stack)
        for r in range(R):
            if slot_cand[r] < 0:
                continue
            terminal = status_h[r] != STATUS_RUNNING
            capped = status_h[r] == STATUS_RUNNING and iters_h[r] >= n_steps
            if not (terminal or capped):
                continue
            results[slot_cand[r]] = (slots[r], assigns[r], int(iters_h[r]), int(status_h[r]))
            done_rows.append(r)
        if done_rows:
            refill(done_rows)
    return results, windows, reads


class PoolStats(NamedTuple):
    """What one slot-pool run did: the windows of ``sync_every`` passes,
    the device→host status reads, and the seconds from the first window's
    launch (after the device finished the set-up) to the last read."""

    windows: int
    status_reads: int
    seconds: float


def train_em_markov_pool(
    params_list,  # per-candidate MixtureParams on the batch's device
    assign_list,  # per-candidate (n,) int assignments (numpy or tensors)
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded — shared
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int32
    *,
    R: int = 32,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    sync_every: int = 8,
    u: torch.Tensor | None = None,
    mesh=None,
) -> tuple[list, PoolStats]:
    """Slot-pool multistart: every candidate trains through R kernel
    slots, and a slot is refilled the moment its occupant terminates.  A
    new candidate's initial M step rides the others' next pass
    (``force_prev``); the host reads the slots' status once per window of
    ``sync_every`` passes.  Each candidate's trajectory, iteration count
    and status are those of a standalone :func:`train_em_markov` run, and
    the results come back in candidate order: ``([(params, assign (n,)
    int32 tensor, iters, status), ...], PoolStats)``.  Φ is materialized
    once for the pool (``MTM_MARKOV_PRECOMP`` as in
    :func:`train_em_markov`; at long T always, in the canonical layout)."""
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel pool (mesh=) is not ported (ROADMAP Queue 1, "
            "item 9)"
        )
    T, n = z.shape[0], z.shape[1]
    C = params_list[0].pi.shape[0]
    R = max(1, min(R, len(params_list)))
    K = max(1, int(sync_every))
    lens = lens.to(torch.int32)
    u, phi = _markov_features(z, x, lens, u=u, longT_always_phi=True)
    if phi is not None:
        u = None  # Φ carries the passes

    def window(*state):
        return _pool_window(
            *state, lens, u, phi, T=T, K=K, n_steps=n_steps,
            reg_mode=reg_mode, alpha=float(alpha), min_members=min_members,
        )

    if z.device.type == "cuda":
        torch.cuda.synchronize(z.device)
    t0 = time.perf_counter()
    # the last window's status read waits for the device, so the clock
    # stops with the pool's work done
    results, windows, reads = _run_slot_pool(
        window, params_list, assign_list, R=R, C=C, n=n, n_steps=n_steps,
        min_members=min_members, device=z.device,
    )
    return results, PoolStats(windows, reads, time.perf_counter() - t0)


def complete_data_loglik_markov_multi(
    params: MixtureParams,  # leading R axis on every leaf
    lens: torch.Tensor,  # (n,) int32
    u: torch.Tensor | None,  # (T·s, n) packed batch (None under phi)
    *,
    T: int,
    phi=None,  # Φ tensor or PhiQuant
) -> torch.Tensor:
    """Per-restart objectives ``Σ_i max_c scores`` ``(R,)`` in one kernel
    pass: K4b over the packed batch, or K3 over Φ (``em.py:2704``; the
    only route at long T, from the canonical Φ)."""
    R = params.pi.shape[0]
    d = params.m.shape[2]
    l = params.H.shape[3]
    Wg = _stacked_weights(params)
    prev = torch.zeros((R, lens.shape[0]), dtype=torch.int32, device=lens.device)
    if phi is not None:
        return mk.markov_em_from_features_multi(
            phi, lens, prev, Wg, T=T, d=d, l=l
        )[4]
    return mk.markov_em_fused_packed_multi(u, lens, prev, Wg, T=T, d=d, l=l)[4]


# ----------------------------------------------------------------------
# The dense joint route
# ----------------------------------------------------------------------


def pack_joint(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(T, n, d)`` states and ``(T, n, l)`` observations in the joint
    layout ``[z_1..z_T, x_1..x_T]`` per instance: ``(n, T·(d+l))``."""
    T, n, d = z.shape
    l = x.shape[-1]
    return torch.cat(
        [z.permute(1, 0, 2).reshape(n, T * d), x.permute(1, 0, 2).reshape(n, T * l)],
        dim=1,
    )


def pack_observed(x: torch.Tensor) -> torch.Tensor:
    """``(T, n, l)`` observations alone in the layout ``[x_1..x_T]`` per
    instance: ``(n, T·l)`` (the observed-only family)."""
    T, n, l = x.shape
    return x.permute(1, 0, 2).reshape(n, T * l)


def cluster_joint_moments(params: MixtureParams, T: int):
    """Per-cluster joint ``(mean (C, D), cov (C, D, D))``."""
    return (
        jmom.joint_mean(T, params.m, params.A, params.H),
        jmom.joint_cov(T, params.S, params.A, params.G, params.H, params.L),
    )


def cluster_observed_moments(params: MixtureParams, T: int):
    """Per-cluster ``(mean (C, T·l), cov (C, T·l, T·l))`` of the
    observations alone, the hidden states marginalized."""
    return (
        jmom.observed_mean(T, params.m, params.A, params.H),
        jmom.observed_cov(T, params.S, params.A, params.G, params.H, params.L),
    )


def _masked_logliks(means, covs, v, patterns, pattern_id, method):
    """``(C, n)`` masked Gaussian log-densities of the rows of ``v`` under
    each cluster's ``(mean, cov)``.  ``"pallas"``, and ``"auto"`` on the
    card, take kernel K12 (:func:`..ops.estep_kernels.estep_logliks_fused`,
    each row under its own pattern); ``"solve"``, ``"inverse"``,
    ``"bucketed"``, and ``"auto"`` on the CPU, the grouped form per
    cluster (:func:`..ops.gaussian.masked_mvn_logpdf_grouped`), K12's plain
    twin and the JAX package's default."""
    if method == "pallas" or (method == "auto" and v.device.type == "cuda"):
        return ek.estep_logliks_fused(means, covs, v, patterns, pattern_id)
    return torch.stack([
        gops.masked_mvn_logpdf_grouped(v, mu, cov, patterns, pattern_id, method=method)
        for mu, cov in zip(means, covs)
    ])


def estep_logliks(
    params: MixtureParams,
    v: torch.Tensor,  # (n, D) packed joint rows
    patterns: torch.Tensor,  # (P, D) bool
    pattern_id: torch.Tensor,  # (n,) int
    *,
    T: int,
    method: str = "auto",
) -> torch.Tensor:
    """``(C, n)`` per-cluster log-likelihoods of every instance, NaN
    coordinates marginalized (``em.py:171``): K12 on the card, the grouped
    form on the CPU (``method`` as :func:`_masked_logliks` takes it)."""
    means, covs = cluster_joint_moments(params, T)
    return _masked_logliks(means, covs, v, patterns, pattern_id, method)


def estep_logliks_sorted(
    params: MixtureParams,
    v_sorted: torch.Tensor,  # (n, D) rows grouped by pattern
    patterns: torch.Tensor,  # (P, D) bool
    *,
    sizes: tuple,
    T: int,
) -> torch.Tensor:
    """``(C, n)`` log-likelihoods of a batch sorted by pattern, in its row
    order, through kernel K13 (``em.py:203``): :func:`estep_logliks`'s
    values, permuted."""
    means, covs = cluster_joint_moments(params, T)
    minv, const = ek.precompute_cluster_pattern_inverses(means, covs, patterns)
    return ek.estep_logliks_pattern_sorted(v_sorted, means, minv, const, sizes=sizes)


def observed_logliks(
    params: MixtureParams,
    vx: torch.Tensor,  # (n, T·l) pack_observed rows
    patterns: torch.Tensor,  # (P, T·l) bool
    pattern_id: torch.Tensor,  # (n,) int
    *,
    T: int,
    method: str = "auto",
) -> torch.Tensor:
    """``(C, n)`` log-likelihoods of the observations alone, the hidden
    states marginalized (``em.py:232``): :func:`estep_logliks`'s dispatch
    on the observed moments (K12 on the card)."""
    means, covs = cluster_observed_moments(params, T)
    return _masked_logliks(means, covs, vx, patterns, pattern_id, method)


def observed_logliks_kalman(
    params: MixtureParams,
    x: torch.Tensor,  # (T, n, l) NaN-suffix-padded observations
    lens: torch.Tensor,  # (n,) int observed prefix lengths
) -> torch.Tensor:
    """``(C, n)`` observation-marginal log-likelihoods in O(T)
    (``em.py:251``): up to T = 128 the suffix Kalman filter
    (:func:`..ops.kalman.kalman_observed_logliks`), past it the masked
    filter with an all-NaN state block (:func:`masked_logliks_kalman`,
    kernel K7 on the card), as the JAX package routes it."""
    T = x.shape[0]
    if T > 128:
        z_none = torch.full((T, x.shape[1], params.m.shape[1]), torch.nan, dtype=x.dtype, device=x.device)
        return masked_logliks_kalman(params, z_none, x)
    return kops.kalman_observed_logliks(
        x, lens, params.m, params.S, params.A, params.G, params.H, params.L
    )


def assignments_from_logliks(pi: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """Hard assignment ``argmax_c (log π_c + ll_c)``, ``(n,)`` int32: the
    first maximum, and a NaN wins (``jnp.argmax``)."""
    return mk._argmax_first(torch.log(pi)[:, None] + ll)[1]


def mstep(
    z: torch.Tensor,  # (T, n, d)
    x: torch.Tensor,  # (T, n, l)
    assign: torch.Tensor,  # (n,) int
    *,
    n_clusters: int,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    impl: str = "xla",
) -> MixtureParams:
    """Closed-form M step for all clusters: π from the memberships, the
    initial moments from the finite first states, the transition and
    measurement regressions over every finite pair.  ``impl="xla"`` takes
    the time-batched statistics, ``impl="gram"`` their one-Gram form,
    ``impl="pallas"`` kernel K15 on ``z`` and ``x`` in place (never
    packed; ``msk.mstep_stats_zx``) with π from :func:`counts_from_assign`
    (``em.py:943-965``); equal in float64."""
    if impl == "pallas":
        n, d, l = z.shape[1], z.shape[2], x.shape[2]
        stats = msk.mstep_stats_zx(z, x, assign.to(torch.int32).contiguous(), n_clusters=n_clusters)
        tstats, mstats, istats = msk.unpack_mstep_stats(stats, d, l, n_clusters)
        pi = counts_from_assign(assign, n_clusters).to(z.dtype) / n
        m0, S0 = rops.mean_cov_from_stats(istats)
        A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
        H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
        return MixtureParams(pi, m0, S0, A, G, H, L)
    if impl not in ("xla", "gram"):
        raise ValueError(f"unknown impl {impl!r}")
    lanes = torch.arange(n_clusters, dtype=assign.dtype, device=assign.device)
    W = (assign[:, None] == lanes).to(z.dtype)  # (n, C); labels out of range → 0
    stats_fn = (
        rops.weighted_regression_stats_gram
        if impl == "gram"
        else rops.weighted_regression_stats_timebatched
    )
    pi = W.mean(0)
    m0, S0 = rops.masked_mean_and_cov(z[0], W)
    A, G = rops.solve_regression(stats_fn(z[:-1], z[1:], W), mode=reg_mode, alpha=alpha)
    H, L = rops.solve_regression(stats_fn(z, x, W), mode=reg_mode, alpha=alpha)
    return MixtureParams(pi, m0, S0, A, G, H, L)


def _hard_objective(pi: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """``Σ_i (log π_a + ll_a)`` under the fresh assignment ``a`` of the
    ``(C, n)`` log-likelihoods ``ll``, as a 0-d tensor."""
    a = assignments_from_logliks(pi, ll).long()
    return torch.log(pi)[a].sum() + ll.gather(0, a[None])[0].sum()


def _hard_estep(pi: torch.Tensor, ll: torch.Tensor, prev: torch.Tensor, C: int):
    """``(assign, counts, switches)`` of the dense trainers' E step from
    the ``(C, n)`` log-likelihoods."""
    a = assignments_from_logliks(pi, ll)
    return a, counts_from_assign(a, C), (a != prev).sum()


def complete_data_loglik(
    params: MixtureParams, v, patterns, pattern_id, *, T: int, method: str = "auto"
) -> torch.Tensor:
    """The hard-assignment complete-data objective under a fresh E step,
    ``Σ_i (log π_a + ll_a)``, as a 0-d tensor (``em.py:1028``)."""
    return _hard_objective(
        params.pi, estep_logliks(params, v, patterns, pattern_id, T=T, method=method)
    )


def model_loglik(
    params: MixtureParams, v, patterns, pattern_id, *, T: int, method: str = "auto"
) -> torch.Tensor:
    """The mixture's marginal log-likelihood ``Σ_i log Σ_c π_c L_ci``
    (logsumexp), as a 0-d tensor (``em.py:1047``)."""
    ll = estep_logliks(params, v, patterns, pattern_id, T=T, method=method)
    return torch.logsumexp(torch.log(params.pi)[:, None] + ll, dim=0).sum()


def _dense_loop(params0, assign0, C, estep_fn, mstep_fn, *, n_steps, min_members):
    """The status protocol of the sorted and masked trainers
    (``train_em``, ``em.py:1261``): an init guard, an M step from
    ``assign0``, then E and M up to ``n_steps``, one device→host status
    read per iteration.  ``estep_fn(params, prev) -> (assign, counts,
    switches)``.  :func:`_stacked_dense_loop` is the same protocol on R
    restarts; a change to one is a change to both."""
    assign0 = assign0.to(torch.int32)
    if int(counts_from_assign(assign0, C).amin()) <= min_members:
        return params0, assign0, 0, STATUS_INIT_ABORT
    params = mstep_fn(assign0)
    assign = assign0
    status = STATUS_RUNNING
    it = 0
    while status == STATUS_RUNNING and it < n_steps:
        assign, counts, switches = estep_fn(params, assign)
        status = int(
            _em_termination(switches, counts, STATUS_RUNNING, min_members=min_members)[3]
        )
        if status == STATUS_RUNNING:
            params = mstep_fn(assign)
        it += 1
    return params, assign, it, status


def _stacked_logliks(params: MixtureParams, v, patterns, pattern_id, *, T: int, method: str):
    """``(R, C, n)`` log-likelihoods of R-stacked parameters: the joint
    moments of the R·C clusters, then one :func:`_masked_logliks` call on
    them (one K12 launch on the card)."""
    R, C = params.pi.shape
    flat = MixtureParams(*(p.reshape(R * C, *p.shape[2:]) for p in params))
    means, covs = cluster_joint_moments(flat, T)
    return _masked_logliks(means, covs, v, patterns, pattern_id, method).reshape(R, C, -1)


def _stacked_assign(pi: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """Each restart's hard assignment ``(R, n)`` int32 from ``pi (R, C)``
    and ``ll (R, C, n)``: the first maximum of ``log π + ll`` over its own
    C lanes, a NaN winning (:func:`assignments_from_logliks` per restart)."""
    R, C, n = ll.shape
    scores = torch.log(pi)[:, :, None] + ll
    return mk._argmax_first(scores.permute(1, 0, 2).reshape(C, R * n))[1].reshape(R, n)


def _stacked_objective(pi: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """:func:`_hard_objective` of each restart: ``(R,)``."""
    a = _stacked_assign(pi, ll).long()
    return torch.log(pi).gather(1, a).sum(1) + ll.gather(1, a[:, None])[:, 0].sum(1)


def _stacked_dense_loop(
    params0, assign0, z, x, v, patterns, pattern_id, *, n_steps, reg_mode, alpha, method, min_members
):
    """:func:`_dense_loop`'s protocol on R restarts trained together:
    ``(params, assign (R, n), iters (R,), status (R,))``.

    Each restart: the init guard (``STATUS_INIT_ABORT``, its ``params0``,
    0 iterations), one M step from ``assign0``, then E and M up to
    ``n_steps``.  An iteration reads which restarts still run (its one
    device→host read) and works on those alone: the joint moments of
    their clusters, one :func:`_masked_logliks` call on them (one K12
    launch on the card), each one's assignment over its own C lanes, its
    counts and switches, and :func:`mstep_multi` on their assignments.  A
    restart that has stopped keeps its parameters, assignment, iterations
    and status."""
    T = z.shape[0]
    C = params0.pi.shape[1]
    assign = assign0.to(torch.int32)

    def mstep_fn(a):
        return mstep_multi(z, x, a, n_clusters=C, reg_mode=reg_mode, alpha=alpha)

    init_abort = _counts_rows(assign, C).amin(dim=1) <= min_members
    # an aborted restart's lanes may be empty (NaN solves): selected away
    params = _tree_select_rows(init_abort, params0, mstep_fn(assign))
    status = torch.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING).to(torch.int32)
    iters = torch.zeros_like(status)
    for _ in range(n_steps):
        rows = (status == STATUS_RUNNING).nonzero()[:, 0]
        if rows.numel() == 0:
            break
        run = MixtureParams(*(p[rows] for p in params))
        new = _stacked_assign(
            run.pi, _stacked_logliks(run, v, patterns, pattern_id, T=T, method=method)
        )
        _conv, _empty, advance, status_new = _em_termination(
            (new != assign[rows]).sum(1), _counts_rows(new, C), status[rows],
            min_members=min_members,
        )
        run = _tree_select_rows(advance, mstep_fn(new), run)
        params = MixtureParams(*(p.index_copy(0, rows, q) for p, q in zip(params, run)))
        assign = assign.index_copy(0, rows, new)
        status = status.index_copy(0, rows, status_new.to(torch.int32))
        iters = iters.index_add(0, rows, torch.ones_like(rows, dtype=torch.int32))
    return params, assign, iters, status


def train_em(
    params0: MixtureParams,
    assign0: torch.Tensor,  # (n,) int
    z: torch.Tensor,  # (T, n, d)
    x: torch.Tensor,  # (T, n, l)
    v: torch.Tensor,  # (n, D) pack_joint(z, x)
    patterns: torch.Tensor,  # (P, D) bool
    pattern_id: torch.Tensor,  # (n,) int
    *,
    n_steps: int = 1000,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
):
    """Hard EM on the dense joint, the bit-parity route: ``(params,
    assign, iterations, status)`` (Python ints for the last two); the
    one-restart case of :func:`_stacked_dense_loop`.

    1. if some cluster of ``assign0`` has ≤ ``min_members`` members,
       return untouched (STATUS_INIT_ABORT);
    2. an M step from ``assign0``;
    3. up to ``n_steps``: E; no switches → CONVERGED; a near-empty cluster
       → EMPTY_CLUSTER (assignment updated, parameters kept); else M."""
    params, assign, iters, status = _stacked_dense_loop(
        stack_params([params0]), assign0[None], z, x, v, patterns, pattern_id,
        n_steps=n_steps, reg_mode=reg_mode, alpha=alpha, method=method, min_members=min_members,
    )
    return MixtureParams(*(p[0] for p in params)), assign[0], int(iters[0]), int(status[0])


def train_em_multistart(
    params0: MixtureParams,  # leading R axis on every leaf
    assign0: torch.Tensor,  # (R, n) int
    z, x, v, patterns, pattern_id,
    *,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
):
    """R dense fits trained together (:func:`_stacked_dense_loop`), each
    with its objective under a fresh E step: ``(params, assign (R, n),
    iters (R,), status (R,), obj (R,))``, restart r as a standalone
    :func:`train_em` run gives it (the JAX package ``vmap``s
    ``train_em``, ``em.py:2762``).  The objectives take one more
    :func:`_masked_logliks` call, on all R·C clusters."""
    params, assign, iters, status = _stacked_dense_loop(
        params0, assign0, z, x, v, patterns, pattern_id,
        n_steps=n_steps, reg_mode=reg_mode, alpha=alpha, method=method, min_members=min_members,
    )
    T = z.shape[0]
    obj = _stacked_objective(
        params.pi, _stacked_logliks(params, v, patterns, pattern_id, T=T, method=method)
    )
    return params, assign, iters, status, obj


def estep_assign_sorted(
    params: MixtureParams,
    v_sorted: torch.Tensor,  # (n, D) rows grouped by pattern
    patterns: torch.Tensor,  # (P, D) bool
    prev_assign: torch.Tensor,  # (n,) int32
    *,
    sizes: tuple,
    T: int,
    bf16: bool = False,
    v_sorted_t: torch.Tensor | None = None,  # (D, n), the transposed copy
):
    """The E step over a pattern-sorted batch, ``(assign, counts,
    switches)``, from the per-(cluster, pattern) inverses (``em.py:382``);
    the (C, n) log-likelihoods never reach device memory.  With
    ``v_sorted_t``, the transposed copy that the trainers make once,
    kernel K8; without it kernel K14 on the row-major batch.  ``bf16``
    changes nothing (:func:`..ops.estep_kernels.estep_assign_pattern_sorted`)."""
    means, covs = cluster_joint_moments(params, T)
    minv, const = ek.precompute_cluster_pattern_inverses(means, covs, patterns)
    args = (prev_assign, means, minv, const, torch.log(params.pi), patterns)
    if v_sorted_t is not None:
        return ek.estep_assign_pattern_sorted_t(v_sorted_t, *args, sizes=sizes)
    return ek.estep_assign_pattern_sorted(v_sorted, *args, sizes=sizes, bf16=bf16)


def mstep_sorted(
    v_sorted: torch.Tensor,  # (n, D) rows grouped by pattern
    assign: torch.Tensor,  # (n,) int32
    patterns: torch.Tensor,  # (P, D) bool
    *,
    sizes: tuple,
    T: int,
    d: int,
    l: int,
    n_clusters: int,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
) -> MixtureParams:
    """The M step of a pattern-sorted batch from kernel K9's per-segment
    Grams, π from their counts (``em.py:872``)."""
    tstats, mstats, istats, counts = msk.mstep_stats_gram_sorted(
        v_sorted, assign, patterns, sizes=sizes, T=T, d=d, l=l, n_clusters=n_clusters
    )
    pi = counts / v_sorted.shape[0]
    m0, S0 = rops.mean_cov_from_stats(istats)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
    return MixtureParams(pi, m0, S0, A, G, H, L)


def train_em_sorted(
    params0: MixtureParams,
    assign0: torch.Tensor,  # (n,) int, in sorted order
    z: torch.Tensor,  # (T, n, d), rows in sorted order
    x: torch.Tensor,  # (T, n, l)
    v: torch.Tensor,  # (n, D) pack_joint(z, x), sorted by pattern
    patterns: torch.Tensor,  # (P, D) bool
    *,
    sizes: tuple,
    n_steps: int = 1000,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
):
    """:func:`train_em` over a batch sorted by missingness pattern
    (``np.argsort(pattern_id, kind="stable")``, segment sizes ``sizes``):
    one K8 launch per E step, one K9 launch per M step.  The assignment
    comes back in sorted order.  The same trajectory as :func:`train_em`
    in float64; in float32 up to reassociation."""
    T, d, l = z.shape[0], z.shape[-1], x.shape[-1]
    C = params0.pi.shape[0]
    sizes = tuple(int(s) for s in sizes)
    v_t = v.T.contiguous()  # the E step's layout, made once

    def estep_fn(params, prev):
        return estep_assign_sorted(
            params, v, patterns, prev, sizes=sizes, T=T, v_sorted_t=v_t
        )

    def mstep_fn(a):
        return mstep_sorted(
            v, a, patterns, sizes=sizes, T=T, d=d, l=l, n_clusters=C,
            reg_mode=reg_mode, alpha=alpha,
        )

    return _dense_loop(
        params0, assign0, C, estep_fn, mstep_fn, n_steps=n_steps, min_members=min_members
    )


# ----------------------------------------------------------------------
# The masked-filter route
# ----------------------------------------------------------------------


def _filter_logliks(params: MixtureParams, packed: kk.MaskedBatch) -> torch.Tensor:
    """``(C, n)`` masked-filter log-densities of the packed batch (K7), in
    the caller's row order."""
    return kk.kalman_masked_logliks_packed(
        packed.zp, packed.xp, params.m, params.S, params.A, params.G, params.H, params.L,
        plan=packed.plan,
    )


def masked_logliks_kalman(
    params: MixtureParams,
    z: torch.Tensor,  # (T, n, d) arbitrary per-coordinate NaNs
    x: torch.Tensor,  # (T, n, l)
) -> torch.Tensor:
    """``(C, n)`` log-likelihoods of the observed entries under arbitrary
    missingness through the O(T) masked filter (``em.py:320``): kernel K7
    for CUDA tensors, its plain version for CPU tensors.  The batch is
    packed and planned for this call."""
    return _filter_logliks(params, kk.plan_masked_batch(z, x))


def complete_data_loglik_masked_kalman(
    params: MixtureParams,
    z: torch.Tensor,  # (T, n, d)
    x: torch.Tensor,  # (T, n, l)
    *,
    packed=None,  # kk.MaskedBatch from plan_masked_batch, to skip the packing
) -> torch.Tensor:
    """The hard-assignment complete-data objective under a fresh E step
    through the masked filter, as a 0-d tensor (``em.py:352``)."""
    if packed is None:
        packed = kk.plan_masked_batch(z, x)
    return _hard_objective(params.pi, _filter_logliks(params, packed))


def train_em_masked_kalman(
    params0: MixtureParams,
    assign0: torch.Tensor,  # (n,) int
    z: torch.Tensor,  # (T, n, d) arbitrary per-coordinate NaNs
    x: torch.Tensor,  # (T, n, l)
    *,
    n_steps: int = 1000,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    packed=None,  # kk.MaskedBatch from plan_masked_batch, to skip the packing
):
    """Hard EM under arbitrary per-coordinate missingness with an O(T) E
    step (``em.py:1329``): ``(params, assign, iterations, status)``.  The
    batch is packed and planned for K7 once per fit; each iteration is
    one K7 pass, the assignment, counts and switches, one status read, and
    the masked M step :func:`mstep` through kernel K15 on ``z`` and ``x``
    in place (``impl="pallas"``: one launch an M step, the initial one
    included; its plain version on the CPU).  JAX's trainer takes the
    einsum form; the two are equal in float64, and K15 sums in its own
    order, in float64.  The status protocol is :func:`train_em`'s; on
    suffix missingness the trajectory is :func:`train_em`'s too (the
    filter marginal is the joint marginal)."""
    C = params0.pi.shape[0]
    if packed is None:
        packed = kk.plan_masked_batch(z, x)

    def estep_fn(params, prev):
        return _hard_estep(params.pi, _filter_logliks(params, packed), prev, C)

    def mstep_fn(a):
        return mstep(z, x, a, n_clusters=C, reg_mode=reg_mode, alpha=alpha, impl="pallas")

    return _dense_loop(
        params0, assign0, C, estep_fn, mstep_fn, n_steps=n_steps, min_members=min_members
    )


def mstep_multi(
    z: torch.Tensor,  # (T, n, d)
    x: torch.Tensor,  # (T, n, l)
    assign: torch.Tensor,  # (R, n) int — one hard assignment per restart
    *,
    n_clusters: int,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
) -> MixtureParams:
    """:func:`mstep` for R assignments in one read of the batch
    (``em.py:990``): the per-restart memberships concatenate on the
    cluster axis ``(n, R·C)`` and the solves run on R·C clusters.  Rows
    assigned ``-1`` (idle pool slots) count in no cluster."""
    R, n = assign.shape
    C = n_clusters
    lanes = torch.arange(C, dtype=assign.dtype, device=assign.device)
    W = (assign[:, :, None] == lanes).to(z.dtype)  # (R, n, C)
    W = W.permute(1, 0, 2).reshape(n, R * C)
    pi = W.mean(0).reshape(R, C)
    m0, S0 = rops.masked_mean_and_cov(z[0], W)
    A, G = rops.solve_regression(
        rops.weighted_regression_stats_timebatched(z[:-1], z[1:], W), mode=reg_mode, alpha=alpha
    )
    H, L = rops.solve_regression(
        rops.weighted_regression_stats_timebatched(z, x, W), mode=reg_mode, alpha=alpha
    )
    return MixtureParams(pi, *(a.reshape(R, C, *a.shape[1:]) for a in (m0, S0, A, G, H, L)))


def emstep_masked_kalman_multi(
    params: MixtureParams,  # leading R axis on every leaf
    z: torch.Tensor,  # (T, n, d) — shared
    x: torch.Tensor,  # (T, n, l)
    prev: torch.Tensor,  # (R, n) int32
    *,
    force_prev=None,  # (R,) — 1 ⇒ the slot keeps prev (its initial M step)
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    packed=None,  # kk.MaskedBatch from plan_masked_batch — shared
):
    """One masked-filter EM iteration for R restarts over one batch
    (``em.py:1445``): ``(new_params, assign (R, n), counts (R, C),
    switches (R,))``.  The R·C parameter rows go through one K7 pass; the
    M steps of all restarts through :func:`mstep_multi`."""
    R, C = params.pi.shape
    n = z.shape[1]
    if packed is None:
        packed = kk.plan_masked_batch(z, x)
    flat = MixtureParams(*(p.reshape(R * C, *p.shape[2:]) for p in params))
    e_assign = _stacked_assign(params.pi, _filter_logliks(flat, packed).reshape(R, C, n))
    if force_prev is not None:
        e_assign = torch.where((force_prev > 0)[:, None], prev, e_assign)
    switches = (e_assign != prev).sum(1)
    counts = _counts_rows(e_assign, C)
    new_params = mstep_multi(z, x, e_assign, n_clusters=C, reg_mode=reg_mode, alpha=alpha)
    return new_params, e_assign, counts, switches


def _pool_window_masked_kalman(
    params,  # R-stacked MixtureParams
    assigns,  # (R, n) int32
    status,  # (R,) int32
    iters,  # (R,) int32
    force,  # (R,) int32
    z,
    x,
    packed,
    *,
    K: int,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
):
    """K masked-filter pool passes (``em.py:1535``): the
    :func:`_pool_window_protocol` of the Markov pool on
    :func:`emstep_masked_kalman_multi`."""

    def emstep_fn(params, assigns, force):
        return emstep_masked_kalman_multi(
            params, z, x, assigns, force_prev=force, reg_mode=reg_mode, alpha=alpha,
            packed=packed,
        )

    return _pool_window_protocol(
        emstep_fn, K, (params, assigns, status, iters, force),
        n_steps=n_steps, min_members=min_members,
    )


def train_em_masked_kalman_pool(
    params_list,  # per-candidate MixtureParams on the batch's device
    assign_list,  # per-candidate (n,) int assignments (numpy or tensors)
    z: torch.Tensor,  # (T, n, d) arbitrary per-coordinate NaNs — shared
    x: torch.Tensor,  # (T, n, l)
    *,
    R: int = 8,
    n_steps: int = 1000,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    sync_every: int = 8,
    packed=None,  # kk.MaskedBatch from plan_masked_batch
) -> tuple[list, PoolStats]:
    """Slot-pool multistart on the masked-filter trainer (``em.py:1585``;
    opt-in, ``MTM_MASKED_POOL=1``): the scheduler of
    :func:`train_em_markov_pool`, R slots sharing one K7 pass of R·C
    parameter rows per iteration.  Each candidate's result equals a
    standalone :func:`train_em_masked_kalman` run; returns ``([(params,
    assign (n,), iters, status), ...], PoolStats)`` in candidate order."""
    n = z.shape[1]
    C = params_list[0].pi.shape[0]
    R = max(1, min(R, len(params_list)))
    K = max(1, int(sync_every))
    if packed is None:
        packed = kk.plan_masked_batch(z, x)

    def window(*state):
        return _pool_window_masked_kalman(
            *state, z, x, packed, K=K, n_steps=n_steps, reg_mode=reg_mode,
            alpha=float(alpha), min_members=min_members,
        )

    if z.device.type == "cuda":
        torch.cuda.synchronize(z.device)
    t0 = time.perf_counter()
    results, windows, reads = _run_slot_pool(
        window, params_list, assign_list, R=R, C=C, n=n, n_steps=n_steps,
        min_members=min_members, device=z.device,
    )
    return results, PoolStats(windows, reads, time.perf_counter() - t0)
