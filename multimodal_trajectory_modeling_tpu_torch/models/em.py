"""Hard-assignment EM for mixtures of LG-SSMs: the Markov fast path, for
one fit and for many starts.

Counterpart of ``multimodal_trajectory_modeling_tpu/models/em.py`` for
suffix-only missingness (variable-length, NaN-suffix-padded
trajectories): ``MixtureParams`` and the status codes (:93-118),
``counts_from_assign`` (:372), ``_unpack_markov_em_stats`` (:484),
``pack_markov_batch`` (:523), ``pack_markov_features`` (:540),
``markov_packed_ok`` (:573), ``_resolve_phi_store`` (:580),
``_markov_features`` (:614, packed shapes), ``emstep_markov`` (:705),
``complete_data_loglik_markov`` (:1066), ``_em_termination`` (:1236),
``train_em_markov`` (:1754), and the multistart engine:
``_tree_select_rows`` (:2161), ``emstep_markov_multi`` (:2172),
``train_em_markov_multi`` (:2261), ``_pool_window_protocol`` (:2358),
``_pool_window`` (:2414), ``_run_slot_pool`` (:2464),
``train_em_markov_pool`` (:2587) and ``complete_data_loglik_markov_multi``
(:2704).

A fit materializes the feature matrix Φ once (kernel K2), stores it int16
under float32 compute, and runs every iteration as one Φ-reading kernel
(K1; K3 for R restarts at once) followed by small per-cluster solves;
``precompute=False`` rebuilds Φ from the packed batch in every iteration
instead (K4a; K4b for R restarts).  The multistart objectives come from
K4a/K4b on the wide packed batch.  The JAX package traces each loop into
one ``while_loop`` or ``fori_loop``; here a single fit is a Python loop
that reads one status scalar from the device per iteration, and the slot
pool runs ``sync_every`` passes per window with one status read per
window.

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
from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops

__all__ = [
    "MixtureParams",
    "PoolStats",
    "STATUS_RUNNING",
    "STATUS_CONVERGED",
    "STATUS_EMPTY_CLUSTER",
    "STATUS_INIT_ABORT",
    "complete_data_loglik_markov",
    "complete_data_loglik_markov_multi",
    "counts_from_assign",
    "emstep_markov",
    "emstep_markov_multi",
    "markov_packed_ok",
    "mixture_params_from_numpy",
    "mixture_params_to_numpy",
    "pack_markov_batch",
    "pack_markov_features",
    "stack_params",
    "train_em_markov",
    "train_em_markov_multi",
    "train_em_markov_pool",
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
    u: torch.Tensor | None = None,
    precompute: bool | None = None,
    phi_store: str = "env",
):
    """The Φ routing of every Markov trainer (the packed branch of
    ``em.py:614``): returns ``(u, phi)``, the packed batch (``u`` itself
    if given) and, under ``precompute`` (default ``MTM_MARKOV_PRECOMP``,
    on), the compact Φ, quantized under ``phi_store="i16"`` (``"env"``
    resolves ``MTM_MARKOV_PHI``); else ``phi`` is None and every
    iteration rebuilds Φ from ``u``.  ``phi`` is a tensor or a
    :class:`~..ops.markov_kernels.PhiQuant`."""
    T, n, d = z.shape
    l = x.shape[-1]
    if not markov_packed_ok(T, d, l):
        raise NotImplementedError(
            f"T·s = {T * 8 * ((d + l + 7) // 8)} > 512 needs the long-T "
            "kernels (ROADMAP Queue 2, K5/K6)"
        )
    if precompute is None:
        precompute = os.environ.get("MTM_MARKOV_PRECOMP", "1") == "1"
    if phi_store == "env":
        phi_store = _resolve_phi_store(z.dtype)
    if u is None:
        z_t = z.permute(0, 2, 1).reshape(T * d, n)
        x_t = x.permute(0, 2, 1).reshape(T * l, n)
        u = pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
        del z_t, x_t
    if not precompute:
        return u, None
    phi = pack_markov_features(u, lens, T=T, d=d, l=l)
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
    u: torch.Tensor | None = None,  # (T·s, n) packed batch
    assign_mode: str = "argmax",
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
):
    """One EM iteration: ``(new_params, assign, counts, switches)``, from
    Φ (K1) or, without Φ, from the packed batch ``u`` (K4a).
    ``assign_mode="prev"`` is the initial M step (statistics under
    ``prev_assign``, no E step)."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    Wg = _weights(params)
    if phi is not None:
        assign, counts, switches, g, _obj = mk.markov_em_from_features(
            phi, prev_assign, Wg, T=T, d=d, l=l, assign_mode=assign_mode
        )
    elif u is not None:
        assign, counts, switches, g, _obj = mk.markov_em_fused_packed(
            u, lens, prev_assign, Wg, T=T, d=d, l=l, assign_mode=assign_mode
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
    once (K2) and runs every iteration from it (K1); off, every iteration
    rebuilds Φ from the packed batch (K4a).  Both give the same
    trajectory in float64."""
    T = z.shape[0]
    C = params0.pi.shape[0]
    assign0 = assign0.to(torch.int32)
    lens = lens.to(torch.int32)
    if int(counts_from_assign(assign0, C).amin()) <= min_members:
        return params0, assign0, 0, STATUS_INIT_ABORT
    u, phi = _markov_features(z, x, lens, precompute=precompute)
    if phi is not None:
        u = None  # Φ carries the iterations; free the packed batch

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
    ``Σ_i max_c scores``, as a 0-d tensor: one K4a pass over the packed
    batch (``em.py:1066``)."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    if not markov_packed_ok(T, d, l):
        raise NotImplementedError(
            "the long-T objective needs the grid-over-T kernels (ROADMAP "
            "Queue 2, K5/K6)"
        )
    u = pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
    prev = torch.zeros(lens.shape, dtype=torch.int32, device=lens.device)
    return mk.markov_em_fused_packed(u, lens, prev, _weights(params), T=T, d=d, l=l)[4]


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
    u, phi = _markov_features(z, x, lens, u=u)

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
    :func:`train_em_markov`)."""
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
    u, phi = _markov_features(z, x, lens, u=u)
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
    pass: K4b over the packed batch, or K3 over Φ (``em.py:2704``)."""
    R = params.pi.shape[0]
    d = params.m.shape[2]
    l = params.H.shape[3]
    Wg = _stacked_weights(params)
    prev = torch.zeros((R, lens.shape[0]), dtype=torch.int32, device=lens.device)
    if phi is not None:
        return mk.markov_em_from_features_multi(phi, lens, prev, Wg, T=T, d=d, l=l)[4]
    return mk.markov_em_fused_packed_multi(u, lens, prev, Wg, T=T, d=d, l=l)[4]
