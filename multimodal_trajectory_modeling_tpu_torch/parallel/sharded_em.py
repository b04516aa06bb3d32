"""Data-parallel and restart-parallel hard EM on ``torch.distributed``.

Counterpart of ``multimodal_trajectory_modeling_tpu/parallel/sharded_em.py``.
Each trainer is one SPMD function that every rank of a
:class:`..parallel.mesh.Mesh` calls with the same global arrays (on the
rank's device), as the JAX package's callers pass global arrays to its
``shard_map`` trainers.  Each rank takes its contiguous block of the
trajectory axis; every ``lax.psum`` of the JAX package is an
``all_reduce(SUM)`` here (the (F, C) statistics, counts, switches, the
masked M statistics), ``_quantize_phi_global``'s ``pmax`` an
``all_reduce(MAX)``.  Parameters come back replicated and assignments
gathered to every rank.  The loops read one status from the device an
iteration (the same, replicated, on every rank, so the ranks stay in
step), where the JAX package runs a ``while_loop``.

- :func:`train_em_markov_shardmap`: per rank K2 then K1 an iteration
  (``MTM_MARKOV_PRECOMP=0``: K4a; at long T K5 then K1);
- :func:`train_em_masked_kalman_shardmap`: K7 per rank and E step;
- :func:`train_em_markov_multi_shardmap`: K3 (K4b without Φ) for R
  restarts;
- :func:`pool_window_for_mesh`: the slot pool's window, behind
  ``em.train_em_markov_pool(mesh=)``;
- the dense routes :func:`train_em_shardmap` and
  :func:`train_em_data_parallel` (one loop here: JAX's second is its
  auto-partitioned ``em.train_em``), :func:`train_em_multistart_sharded`
  (restarts over the ranks, no communication but the final gather) and
  :func:`train_em_multistart_2d` (restart × data subgroups).

With two ranks a reduction of two partials is order-free; with more it
reassociates the sums (float64 ≈ 1e-12 relative).  Where ``shard_map``
needs the sharded axis to divide over the devices, these raise on the
same condition (the pool pads its lanes instead, as the JAX pool does).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from multimodal_trajectory_modeling_tpu_torch.models import em
from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops
from multimodal_trajectory_modeling_tpu_torch.parallel import mesh as mesh_lib
from multimodal_trajectory_modeling_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce

__all__ = [
    "pool_window_for_mesh",
    "train_em_data_parallel",
    "train_em_markov_multi_shardmap",
    "train_em_markov_shardmap",
    "train_em_masked_kalman_shardmap",
    "train_em_multistart_2d",
    "train_em_multistart_sharded",
    "train_em_shardmap",
]


def _local(mesh: Mesh):
    """A rank's block of the ``data`` axis, for (T, n, ·) and (n,) arrays."""
    return mesh_lib.data_sharding(mesh, 3, 1), mesh_lib.data_sharding(mesh, 1, 0)


def _psum_stats(mesh: Mesh):
    """``reduce`` of :func:`..models.em.emstep_markov`: all-reduce the
    statistics, counts and switches over the ``data`` axis."""
    return lambda g, counts, switches: tuple(all_reduce(t, mesh) for t in (g, counts, switches))


def _local_mstep_stats(z_l, x_l, assign_l, C):
    """A rank's masked M-step statistics ``(counts, initial moments,
    transition stats, measurement stats)``: all additive, so their sums
    over the ranks are the global statistics (labels outside ``[0, C)``
    count nowhere)."""
    lanes = torch.arange(C, dtype=assign_l.dtype, device=assign_l.device)
    W = (assign_l[:, None] == lanes).to(z_l.dtype)
    return (
        W.sum(0),
        rops.masked_moment_stats(z_l[0], W),
        rops.weighted_regression_stats_timebatched(z_l[:-1], z_l[1:], W),
        rops.weighted_regression_stats_timebatched(z_l, x_l, W),
    )


def _params_from_global_stats(counts, init_stats, tstats, mstats, n_total, *, reg_mode, alpha):
    """The per-cluster solves from the summed statistics, on every rank."""
    m0, S0 = rops.mean_cov_from_stats(init_stats)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
    return em.MixtureParams(counts / n_total, m0, S0, A, G, H, L)


def _global_mstep(mesh, z_l, x_l, C, n_total, *, reg_mode, alpha):
    """The M step of a rank's block with its statistics all-reduced."""

    def mstep(assign_l):
        counts, istats, tstats, mstats = _local_mstep_stats(z_l, x_l, assign_l, C)
        return _params_from_global_stats(
            all_reduce(counts, mesh),
            rops.MomentStats(*(all_reduce(a, mesh) for a in istats)),
            rops.RegressionStats(*(all_reduce(a, mesh) for a in tstats)),
            rops.RegressionStats(*(all_reduce(a, mesh) for a in mstats)),
            n_total, reg_mode=reg_mode, alpha=alpha,
        )

    return mstep


def _shard_loop(params0, assign_l, C, estep_l, mstep, *, mesh, n_steps, min_members):
    """The status protocol of ``em.train_em`` over the data axis: the init
    guard on the all-reduced counts, an M step from the assignment, then
    E (``estep_l(params) -> assign_l``, a rank's block) and M up
    to ``n_steps``, with switches and counts all-reduced and one
    (replicated) status read an iteration.  Returns ``(params, assign_l,
    iters, status)``."""
    if int(all_reduce(em.counts_from_assign(assign_l, C), mesh).amin()) <= min_members:
        return params0, assign_l, 0, em.STATUS_INIT_ABORT
    params = mstep(assign_l)
    status, it = em.STATUS_RUNNING, 0
    while status == em.STATUS_RUNNING and it < n_steps:
        new = estep_l(params)
        switches = all_reduce((new != assign_l).sum(), mesh)
        counts = all_reduce(em.counts_from_assign(new, C), mesh)
        status = int(em._em_termination(switches, counts, em.STATUS_RUNNING, min_members=min_members)[3])
        assign_l = new
        if status == em.STATUS_RUNNING:
            params = mstep(assign_l)
        it += 1
    return params, assign_l, it, status


def _dense_fit(params0, assign0, z, x, v, patterns, pattern_id, *, mesh, n_steps, reg_mode,
               alpha, method, min_members):
    """One restart's dense fit over the ``data`` axis: ``(params, assign
    (n,) gathered, iters, status)``."""
    T, n = z.shape[0], z.shape[1]
    C = params0.pi.shape[0]
    z_l, x_l, v_l, patterns, pid_l = mesh_lib.shard_trajectories(mesh, z, x, v, patterns, pattern_id)
    assign_l = mesh_lib.data_sharding(mesh, 1, 0)(assign0.to(torch.int32))

    def estep_l(params):
        means, covs = em.cluster_joint_moments(params, T)
        ll = em._masked_logliks(means, covs, v_l, patterns, pid_l, method)
        return em.assignments_from_logliks(params.pi, ll)

    mstep = _global_mstep(mesh, z_l, x_l, C, n, reg_mode=reg_mode, alpha=alpha)
    params, assign_l, it, status = _shard_loop(
        params0, assign_l, C, estep_l, mstep, mesh=mesh, n_steps=n_steps,
        min_members=min_members,
    )
    return params, all_gather(assign_l, mesh), it, status


def train_em_shardmap(
    params0: em.MixtureParams,
    assign0: torch.Tensor,  # (n,) int
    z, x, v, patterns, pattern_id,
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
):
    """The dense EM loop over the ``data`` axis (``sharded_em.py:124``):
    ``(params, assign (n,), iters, status)``.  An iteration's
    communication is the all-reduce of the counts, the switch count, the
    initial-moment statistics and both regression statistics; the small
    per-cluster solves run on every rank.  The E step is a rank's block
    of rows through ``em._masked_logliks`` (K12 on the card)."""
    return _dense_fit(
        params0, assign0, z, x, v, patterns, pattern_id, mesh=mesh, n_steps=n_steps,
        reg_mode=reg_mode, alpha=alpha, method=method, min_members=min_members,
    )


def train_em_data_parallel(params0, assign0, z, x, v, patterns, pattern_id, *, mesh: Mesh, **train_kwargs):
    """The JAX package's auto-partitioned route (``sharded_em.py:89``:
    ``em.train_em`` on sharded arrays, ``n_steps`` 1000 by default).
    Under ``torch.distributed`` there is no partitioner, so it is
    :func:`train_em_shardmap`'s loop with ``em.train_em``'s defaults."""
    return train_em_shardmap(
        params0, assign0, z, x, v, patterns, pattern_id, mesh=mesh, **{"n_steps": 1000, **train_kwargs}
    )


def train_em_multistart_sharded(
    params0, assign0, z, x, v, patterns, pattern_id, *, mesh: Mesh, axis: str = "start", **train_kwargs
):
    """Restart-parallel multistart (``sharded_em.py:47``): the leading
    restart axis of ``params0``/``assign0`` is split over the ranks of
    axis ``axis``, each rank trains its restarts with
    ``em.train_em_multistart`` on the whole (replicated) data, and the
    results ``(params, assign (R, n), iters, status, obj)`` are gathered
    to every rank, in restart order."""
    params_l = em.MixtureParams(*(mesh_lib.data_sharding(mesh, p.ndim, 0, axis)(p) for p in params0))
    assign_l = mesh_lib.data_sharding(mesh, 2, 0, axis)(assign0)
    params, assign, iters, status, obj = em.train_em_multistart(
        params_l, assign_l, z, x, v, patterns, pattern_id, **train_kwargs
    )
    return (
        em.MixtureParams(*(all_gather(p, mesh, axis) for p in params)),
        all_gather(assign, mesh, axis),
        all_gather(iters, mesh, axis),
        all_gather(status, mesh, axis),
        all_gather(obj, mesh, axis),
    )


def train_em_multistart_2d(
    params0,
    assign0,
    z, x, v, patterns, pattern_id,
    *,
    mesh: Mesh,
    n_restarts: int | None = None,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
    seed: int = 0,
):
    """Multistart on a 2-D ``("restart", "data")`` mesh
    (``sharded_em.py:311``; :func:`..parallel.mesh.make_mesh` with
    ``shape=``): each restart row of the mesh trains its block of the
    restarts one after another with the data-parallel loop of
    :func:`train_em_shardmap` over its row's ``data`` subgroup; the
    ``restart`` axis communicates only in the final gather.  ``assign0``
    is ``(R, n)`` (restart r equals :func:`train_em_shardmap` from
    ``assign0[r]``) or ``(n,)``, and then ``n_restarts - 1`` more are drawn
    uniformly from a ``torch.Generator`` seeded with ``seed`` (not JAX's
    draws).  Returns ``(params (R, ...), assign (R, n), iters (R,),
    status (R,))`` on every rank."""
    C = params0.pi.shape[0]
    dev = z.device
    if assign0.ndim == 1:
        if n_restarts is None:
            raise ValueError("n_restarts required when assign0 is 1-D")
        gen = torch.Generator().manual_seed(seed)
        extra = torch.randint(0, C, (n_restarts - 1, assign0.shape[0]), generator=gen, dtype=torch.int32)
        assign0 = torch.cat([assign0[None].to(torch.int32), extra.to(dev)])
    rows = mesh_lib.data_sharding(mesh, 2, 0, "restart")(assign0)
    fits = [
        _dense_fit(params0, a0, z, x, v, patterns, pattern_id, mesh=mesh, n_steps=n_steps,
                   reg_mode=reg_mode, alpha=alpha, method=method, min_members=min_members)
        for a0 in rows
    ]
    params = em.stack_params([f[0] for f in fits])
    assign = torch.stack([f[1] for f in fits])
    iters = torch.tensor([f[2] for f in fits], dtype=torch.int32, device=dev)
    status = torch.tensor([f[3] for f in fits], dtype=torch.int32, device=dev)
    return (
        em.MixtureParams(*(all_gather(p, mesh, "restart") for p in params)),
        all_gather(assign, mesh, "restart"),
        all_gather(iters, mesh, "restart"),
        all_gather(status, mesh, "restart"),
    )


def _quantize_phi_global(phi: torch.Tensor, mesh: Mesh) -> mk.PhiQuant:
    """Quantize a rank's Φ block with scales from the row absmax
    all-reduced (MAX) over the ranks (``sharded_em.py:424``): every rank
    uses the global per-row max, so the int16 payload and scales are a
    one-rank ``quantize_phi`` of the whole Φ bit for bit."""
    amax = all_reduce(phi.abs().amax(dim=1), mesh, op=dist.ReduceOp.MAX)
    return mk.quantize_phi(phi, mk.phi_scale_from_absmax(amax, phi.dtype))


def _local_markov_route(z_l, x_l, lens_l, *, mesh, precompute, phi_store, u=None):
    """A rank's Φ routing (``sharded_em.py:438``): ``(u, phi)`` as
    ``em._markov_features`` with ``longT_always_phi`` (at packed shapes
    K2, or without ``precompute`` the packed batch for K4a/K4b; at long T
    always K5's canonical Φ), quantized under ``phi_store="i16"`` with
    global scales."""
    u, phi = em._markov_features(
        z_l, x_l, lens_l, u=u, precompute=precompute, phi_store="wide", longT_always_phi=True
    )
    if phi is not None:
        u = None  # Φ carries the iterations
        if phi_store == "i16":
            phi = _quantize_phi_global(phi, mesh)
    return u, phi


def _env_route(dtype):
    return os.environ.get("MTM_MARKOV_PRECOMP", "1") == "1", em._resolve_phi_store(dtype)


def train_em_markov_shardmap(
    params0: em.MixtureParams,
    assign0: torch.Tensor,  # (n,) int
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
):
    """Data-parallel Markov EM (``sharded_em.py:492``): ``(params, assign
    (n,), iters, status)``.  Each rank builds its block's Φ once (K2; at
    long T K5; int16 with global scales under ``MTM_MARKOV_PHI=i16``, the
    float32 default) and runs one K1 pass an iteration (K4a under
    ``MTM_MARKOV_PRECOMP=0`` at packed shapes); the only traffic is the
    all-reduce of the (F, C) statistics, the counts and the switch count.
    :func:`..models.em.train_em_markov`'s trajectory up to the
    reduction's summation order."""
    T, n = z.shape[0], z.shape[1]
    C = params0.pi.shape[0]
    precompute, phi_store = _env_route(z.dtype)
    blk3, blk1 = _local(mesh)
    z_l, x_l, lens_l = blk3(z), blk3(x), blk1(lens.to(torch.int32))
    assign_l = blk1(assign0.to(torch.int32))
    if int(all_reduce(em.counts_from_assign(assign_l, C), mesh).amin()) <= min_members:
        return params0, assign0.to(torch.int32), 0, em.STATUS_INIT_ABORT
    u_l, phi_l = _local_markov_route(z_l, x_l, lens_l, mesh=mesh, precompute=precompute, phi_store=phi_store)
    reduce = _psum_stats(mesh)

    def step(params, prev, mode):
        return em.emstep_markov(
            params, lens_l, prev, phi_l, T=T, u=u_l, assign_mode=mode, reg_mode=reg_mode,
            alpha=alpha, reduce=reduce, n_total=n,
        )

    params = step(params0, assign_l, "prev")[0]
    status, it = em.STATUS_RUNNING, 0
    while status == em.STATUS_RUNNING and it < n_steps:
        new_params, assign_l, counts, switches = step(params, assign_l, "argmax")
        status = int(em._em_termination(switches, counts, em.STATUS_RUNNING, min_members=min_members)[3])
        if status == em.STATUS_RUNNING:
            params = new_params
        it += 1
    return params, all_gather(assign_l, mesh), it, status


def train_em_masked_kalman_shardmap(
    params0: em.MixtureParams,
    assign0: torch.Tensor,  # (n,) int
    z: torch.Tensor,  # (T, n, d) arbitrary per-coordinate NaNs
    x: torch.Tensor,  # (T, n, l)
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
):
    """Data-parallel EM under arbitrary missingness (``sharded_em.py:690``):
    ``(params, assign (n,), iters, status)``.  Each rank packs and plans
    its block for K7 once and runs one K7 pass an E step; the traffic is
    the all-reduce of the counts, the switch count and the masked M
    statistics (the einsum form, as the JAX trainer's).
    :func:`..models.em.train_em_masked_kalman`'s trajectory up to the
    summation order (that trainer's M step is K15: equal in float64)."""
    n = z.shape[1]
    C = params0.pi.shape[0]
    blk3, blk1 = _local(mesh)
    z_l, x_l = blk3(z), blk3(x)
    assign_l = blk1(assign0.to(torch.int32))
    packed = kk.plan_masked_batch(z_l, x_l)

    def estep_l(params):
        return em.assignments_from_logliks(params.pi, em._filter_logliks(params, packed))

    mstep = _global_mstep(mesh, z_l, x_l, C, n, reg_mode=reg_mode, alpha=alpha)
    params, assign_l, it, status = _shard_loop(
        params0, assign_l, C, estep_l, mstep, mesh=mesh, n_steps=n_steps,
        min_members=min_members,
    )
    return params, all_gather(assign_l, mesh), it, status


def train_em_markov_multi_shardmap(
    params0: em.MixtureParams,  # leading R axis on every leaf — replicated
    assign0: torch.Tensor,  # (R, n) int
    z: torch.Tensor,
    x: torch.Tensor,
    lens: torch.Tensor,
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
):
    """Data-parallel fixed-chunk multistart Markov EM
    (``sharded_em.py:848``): every rank holds all R restarts' parameters
    and its block of the data, an iteration is one K3 pass a rank (K4b
    under ``MTM_MARKOV_PRECOMP=0``) and the all-reduce of ``g (R, F, C)``,
    the counts ``(R, C)`` and switches ``(R,)``.  Returns ``(params (R,
    ...), assign (R, n), iters (R,), status (R,))``, each restart
    :func:`..models.em.train_em_markov_multi`'s."""
    T, n = z.shape[0], z.shape[1]
    C = params0.pi.shape[1]
    precompute, phi_store = _env_route(z.dtype)
    blk3, blk1 = _local(mesh)
    z_l, x_l, lens_l = blk3(z), blk3(x), blk1(lens.to(torch.int32))
    assign_l = mesh_lib.data_sharding(mesh, 2, 1)(assign0.to(torch.int32)).contiguous()
    u_l, phi_l = _local_markov_route(z_l, x_l, lens_l, mesh=mesh, precompute=precompute, phi_store=phi_store)
    reduce = _psum_stats(mesh)

    def step(params, prev, mode):
        return em.emstep_markov_multi(
            params, lens_l, prev, u_l, T=T, assign_mode=mode, reg_mode=reg_mode, alpha=alpha,
            phi=phi_l, reduce=reduce, n_total=n,
        )

    init_abort = all_reduce(em._counts_rows(assign_l, C), mesh).amin(dim=1) <= min_members
    params = em._tree_select_rows(init_abort, params0, step(params0, assign_l, "prev")[0])
    status = torch.where(init_abort, em.STATUS_INIT_ABORT, em.STATUS_RUNNING).to(torch.int32)
    iters = torch.zeros_like(status)
    it = 0
    while it < n_steps and bool((status == em.STATUS_RUNNING).any()):
        new_params, new_assign, counts, switches, _obj = step(params, assign_l, "argmax")
        running = status == em.STATUS_RUNNING
        _conv, _empty, advance, status_new = em._em_termination(
            switches, counts, status, min_members=min_members
        )
        params = em._tree_select_rows(running & advance, new_params, params)
        assign_l = torch.where(running[:, None], new_assign, assign_l)
        status = torch.where(running, status_new, status)
        iters = iters + running.to(torch.int32)
        it += 1
    return params, all_gather(assign_l, mesh, dim=1), iters, status


def pool_window_for_mesh(
    z: torch.Tensor,  # (T, n, d) NaN-suffix-padded
    x: torch.Tensor,  # (T, n, l)
    lens: torch.Tensor,  # (n,) int32
    *,
    mesh: Mesh,
    K: int,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
    u: torch.Tensor | None = None,
):
    """The data-parallel slot-pool window of
    ``em.train_em_markov_pool(mesh=)`` (``sharded_em.py:1245``, the
    window itself ``:1100``): returns ``(window, n_state)``.

    The lanes are padded to a multiple of the ranks (the port's kernels
    need no wider block; JAX pads to its TPU kernel's 2048-lane quantum):
    pad lanes carry a zero batch, length 0 and ``prev = -1``, and the
    window's assignment mask keeps them -1.  Each rank builds its block's
    Φ once (K2; at long T K5; int16 with global scales) and
    ``window(stack, assigns (R, n_state), status, iters, force)`` runs K
    passes of the pool protocol on its block (one K3 pass each, K4b
    without Φ; the statistics, counts and switches all-reduced), then
    gathers the assignments to every rank."""
    T, n, d = z.shape
    l = x.shape[-1]
    _group, index, size = mesh.axis("data")
    n_state = -(-n // size) * size
    w = n_state // size
    lo, hi = min(index * w, n), min((index + 1) * w, n)
    pad = w - (hi - lo)

    def lanes(a, axis):
        part = a.narrow(axis, lo, hi - lo)
        if pad:
            shape = list(part.shape)
            shape[axis] = pad
            part = torch.cat([part, part.new_zeros(shape)], dim=axis)
        return part

    z_l, x_l, lens_l = lanes(z, 1), lanes(x, 1), lanes(lens.to(torch.int32), 0)
    u_l = lanes(u, 1) if u is not None and mk.markov_packed_ok(T, d, l) else None
    precompute, phi_store = _env_route(z.dtype)
    u_l, phi_l = _local_markov_route(
        z_l, x_l, lens_l, mesh=mesh, precompute=precompute, phi_store=phi_store, u=u_l
    )
    valid = torch.arange(index * w, (index + 1) * w, device=z.device) < n
    reduce = _psum_stats(mesh)

    def emstep_fn(params, assigns_l, force):
        return em.emstep_markov_multi(
            params, lens_l, assigns_l, u_l, T=T, force_prev=force, reg_mode=reg_mode, alpha=alpha,
            phi=phi_l, reduce=reduce, n_total=n,
        )[:4]

    def window(stack, assigns, status, iters, force):
        state = (stack, assigns[:, index * w : (index + 1) * w].contiguous(), status, iters, force)
        stack, assigns_l, status, iters, force = em._pool_window_protocol(
            emstep_fn, K, state, n_steps=n_steps, min_members=min_members, assign_mask=valid
        )
        return stack, all_gather(assigns_l, mesh, dim=1), status, iters, force

    return window, n_state
