"""The dense route's M-step statistics kernels: K9 and K15.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/pallas_mstep.py``:
K15 ``mstep_stats_pallas`` (:142) → ``csrc/mstep_stats.cu``,
``unpack_mstep_stats`` (:379), and K9 ``mstep_stats_gram_sorted`` (:247)
→ ``csrc/mstep_gram.cu``.

K15 takes the packed joint batch (:func:`mstep_stats_pallas`) or the
states and observations as ``(T, n, ·)`` tensors (:func:`mstep_stats_zx`,
the masked M step's form), rows in any order, and sums, per cluster, the
Khatri-Rao statistics of ``em.mstep``: the transition pairs
``U = [z_t, z_{t+1}, 1]`` (t < T−1), the measurement pairs
``U = [z_t, x_t, 1]`` and the first state ``U = [z_1, 1]``, each step
counted where every coordinate of its pair is finite, as ``Σ U Uᵀ`` in
the JAX layout ``(u, C·u)``.  On the card both forms are one kernel that
reads the batch in place by strides (the packed batch through views) and
sums in float64, each output rounded once to the input type.

K9 takes a batch sorted by pattern.  With ``U = [v(NaN→0), 1]``
(``u = D + 1``), it sums per segment p and cluster c the Gram
``G[p, c] = Σ U Uᵀ`` over the segment's rows of that cluster.  Within a
segment the validity of every time step is constant, so the M step's
any-NaN pair drops become a selection of the valid (t, t′) blocks of
``G`` afterwards, in plain torch, as in JAX (``pallas_mstep.py:326-376``).
The counts come from the ones column, exact in float32 while n ≤ 2²⁴.
On the card it first lists the rows of each (segment, cluster) in row
order and cuts each list into pieces of at most ``R`` rows (the piece
plan, :func:`gram_plan`), then sums one piece a block and adds each
(segment, cluster)'s pieces in piece order.

Both kernels sum in a fixed order, so two calls give the same bits.  The
wrappers take their plain versions for CPU tensors only; for CUDA tensors
they launch the kernel or raise, and count their launches in
``.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops
from multimodal_trajectory_modeling_tpu_torch.ops.estep_kernels import (
    segment_table,
)
from multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels import (
    _device_index,
)

__all__ = [
    "gram_plan",
    "gram_plan_plain",
    "mstep_stats_gram_sorted",
    "mstep_stats_gram_sorted_plain",
    "mstep_stats_pallas",
    "mstep_stats_pallas_plain",
    "mstep_stats_zx",
    "mstep_stats_zx_plain",
    "unpack_mstep_stats",
]

_KINDS = {torch.float32: 0, torch.float64: 1}
# K9: rows a chunk of the row-list pass (one warp a chunk), rows a piece
# (one block a piece), and a cap on the pieces' partials: longer pieces
# at large D
_CHUNK = 1024
_PIECE_ROWS = 1024
_PART_BYTES = 512 * 2**20


def _check_args(v, assign, patterns, sizes, T, d, l):
    n, D = v.shape
    if D != T * (d + l):
        raise ValueError(f"v must be (n, T·(d+l)) = (n, {T * (d + l)}), got {tuple(v.shape)}")
    if assign.shape != (n,) or patterns.shape != (len(sizes), D):
        raise ValueError(
            f"assign {tuple(assign.shape)} and patterns {tuple(patterns.shape)} "
            f"do not fit v {tuple(v.shape)} and {len(sizes)} segments"
        )
    if sum(sizes) != n:
        raise ValueError(f"segment sizes sum to {sum(sizes)}, not n={n}")
    if not (v.device == assign.device == patterns.device):
        raise ValueError("v, assign and patterns must be on one device")


def _grams_plain(v, assign, sizes, C):
    """``G (P, C, u, u)``: per segment and cluster, ``Σ U Uᵀ``."""
    n, D = v.shape
    vm = torch.where(torch.isfinite(v), v, 0.0)
    U = torch.cat([vm, torch.ones((n, 1), dtype=v.dtype, device=v.device)], 1)
    clusters = torch.arange(C, dtype=assign.dtype, device=assign.device)
    grams = []
    off = 0
    for s in sizes:
        Up = U[off : off + s]
        W = (assign[off : off + s, None] == clusters).to(v.dtype)  # (s, C)
        grams.append(torch.einsum("nc,ni,nj->cij", W, Up, Up))
        off += s
    return torch.stack(grams)


def _max_pieces(n, P, C, rows):
    """The most pieces of at most ``rows`` rows that n rows in P·C lists
    make: the Gram kernel's grid."""
    return -(-n // rows) + P * C


def _plan_workspace(assign, sizes, C):
    """The chunks of the row-list pass (``segment_table``, cached per set of
    sizes) and the plan's int32 workspace: ``(table, first, work)``."""
    table, first = segment_table(tuple(sizes), _CHUNK, assign.device)
    P = len(sizes)
    size = 2 * table.shape[0] * C + 2 * (P * C + 1) + assign.shape[0]
    return table, first, torch.empty(size, dtype=torch.int32, device=assign.device)


def _plan_views(work, n, P, C, chunks):
    """``(idx, list_start, piece_start)`` in the plan's int32 workspace:
    counts and bases (chunks, C) each, then ``list_start`` and
    ``piece_start`` (P·C + 1) each, then ``idx`` (n)."""
    o = 2 * chunks * C
    pc = P * C + 1
    return work[o + 2 * pc :], work[o : o + pc], work[o + pc : o + 2 * pc]


def gram_plan_plain(assign, sizes, n_clusters, rows):
    """Plain torch version of :func:`gram_plan`: a stable sort of the rows
    with an assignment in ``[0, C)`` by ``segment·C + assign``."""
    n = assign.shape[0]
    P, C = len(sizes), n_clusters
    dev = assign.device
    seg = torch.repeat_interleave(
        torch.arange(P, device=dev), torch.as_tensor(sizes, device=dev)
    )
    a = assign.long()
    ok = (a >= 0) & (a < C)
    key = (seg * C + a)[ok]
    order = torch.argsort(key, stable=True)
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    idx[: order.shape[0]] = torch.nonzero(ok).squeeze(1)[order].to(torch.int32)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    lens = torch.bincount(key, minlength=P * C)
    list_start = torch.cat([zero, torch.cumsum(lens, 0)]).to(torch.int32)
    pieces = (lens + rows - 1) // rows
    piece_start = torch.cat([zero, torch.cumsum(pieces, 0)]).to(torch.int32)
    return idx, list_start, piece_start


def gram_plan(assign, sizes, n_clusters, rows=_PIECE_ROWS):
    """K9's piece plan: ``(idx (n,), list_start (P·C+1,), piece_start
    (P·C+1,))`` int32.  The rows of segment p with assignment c, in row
    order, are ``idx[list_start[pc] : list_start[pc + 1]]`` (``pc =
    p·C + c``); the first ``list_start[-1]`` entries of ``idx`` are
    defined.  The list of ``pc`` is cut into pieces of ``rows`` rows (the
    last shorter), numbered from ``piece_start[pc]``.  CUDA tensors run the
    kernel's own plan (``mtm_mstep_gram_plan``), CPU tensors the plain
    version."""
    if sum(sizes) != assign.shape[0]:
        raise ValueError(f"segment sizes sum to {sum(sizes)}, not n={assign.shape[0]}")
    if assign.device.type == "cpu":
        return gram_plan_plain(assign, sizes, n_clusters, rows)
    if assign.dtype != torch.int32 or not assign.is_contiguous():
        raise ValueError("assign must be contiguous int32")
    table, first, work = _plan_workspace(assign, sizes, n_clusters)
    rc = _build.library().mtm_mstep_gram_plan(
        _device_index(assign), assign.data_ptr(), table.data_ptr(), first.data_ptr(),
        work.data_ptr(), len(sizes), n_clusters, table.shape[0], rows,
        torch.cuda.current_stream(assign.device).cuda_stream,
    )
    _build.check(rc, "gram_plan")
    return _plan_views(work, assign.shape[0], len(sizes), n_clusters, table.shape[0])


def _grams_kernel(v, assign, sizes, C):
    n, D = v.shape
    P = len(sizes)
    lib = _build.library()
    per_piece = lib.mtm_mstep_gram_part(D)
    rows = _PIECE_ROWS
    while rows < n and _max_pieces(n, P, C, rows) * per_piece * v.element_size() > _PART_BYTES:
        rows *= 2
    pieces = _max_pieces(n, P, C, rows)
    table, first, work = _plan_workspace(assign, sizes, C)
    part = torch.empty(pieces * per_piece, dtype=v.dtype, device=v.device)
    G = torch.empty((P, C, D + 1, D + 1), dtype=v.dtype, device=v.device)
    rc = lib.mtm_mstep_gram(
        _device_index(v),
        _KINDS[v.dtype],
        v.data_ptr(),
        assign.data_ptr(),
        table.data_ptr(),
        first.data_ptr(),
        work.data_ptr(),
        part.data_ptr(),
        G.data_ptr(),
        D,
        P,
        C,
        table.shape[0],
        rows,
        pieces,
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(rc, "mstep_stats_gram_sorted")
    return G


def _select_stats_plain(G, patterns, T, d, l):
    """The statistics of the valid (t, t′) blocks of ``G``: ``(tstats,
    mstats, istats, pi_counts)``.  A block counts where the segment's
    pattern observes every coordinate of its steps (a where-select), and
    the sums run over segments and steps at once, block by block: the
    plain version of :func:`_select_stats`."""
    P, C = G.shape[:2]
    Td = T * d
    one = G.shape[-1] - 1  # the ones column
    zv = patterns[:, :Td].reshape(P, T, d).all(-1)  # (P, T)
    xv = patterns[:, Td:].reshape(P, T, l).all(-1)
    pv = zv[:, :-1] & zv[:, 1:]  # transition pairs
    mv = zv & xv  # measurement pairs
    iv = zv[:, :1]  # the first state
    # the (t, t) and (t, t+1) blocks, step last: (P, C, rows, cols, T)
    Gzz = G[:, :, :Td, :Td].reshape(P, C, T, d, T, d)
    zz = torch.diagonal(Gzz, dim1=2, dim2=4)
    zz1 = torch.diagonal(Gzz, offset=1, dim1=2, dim2=4)
    zx = torch.diagonal(G[:, :, :Td, Td:one].reshape(P, C, T, d, T, l), dim1=2, dim2=4)
    xx = torch.diagonal(G[:, :, Td:one, Td:one].reshape(P, C, T, l, T, l), dim1=2, dim2=4)
    sz = G[:, :, one, :Td].reshape(P, C, T, d)  # Σ z_t
    sx = G[:, :, one, Td:one].reshape(P, C, T, l)  # Σ x_t
    nseg = G[:, :, one, one]  # (P, C) rows per (segment, cluster)

    def blocks(w, b):  # Σ_p Σ_t over the valid (p, t)
        return torch.where(w[:, None, None, None, :], b, 0.0).sum((0, 4))

    def vecs(w, b):
        return torch.where(w[:, None, :, None], b, 0.0).sum((0, 2))

    def count(w):
        return torch.where(w[:, None, :], nseg[:, :, None], 0.0).sum((0, 2))

    tstats = rops.RegressionStats(
        xtx=blocks(pv, zz[..., :-1]),
        xty=blocks(pv, zz1),
        yty=blocks(pv, zz[..., 1:]),
        sx=vecs(pv, sz[:, :, :-1]),
        sy=vecs(pv, sz[:, :, 1:]),
        count=count(pv),
    )
    mstats = rops.RegressionStats(
        xtx=blocks(mv, zz),
        xty=blocks(mv, zx),
        yty=blocks(mv, xx),
        sx=vecs(mv, sz),
        sy=vecs(mv, sx),
        count=count(mv),
    )
    istats = rops.MomentStats(
        count=count(iv), s=vecs(iv, sz[:, :, :1]), ss=blocks(iv, zz[..., :1])
    )
    return tstats, mstats, istats, nseg.sum(0)


@functools.lru_cache(maxsize=16)
def _selection(T: int, d: int, l: int, device: torch.device):
    """Where the statistics sit in ``G`` (u = T(d+l) + 1): ``(index (K, T)
    of flat u·u positions, kind (K,), shapes)``.  Entry k of the fields
    below (``shapes``, in order: the transition, measurement and first
    state statistics) takes, at step t, the entry ``index[k, t]`` of its
    segment's Gram where the step is valid for its kind: 0 the pair
    (z_t, z_{t+1}), t < T−1; 1 the pair (z_t, x_t); 2 the first state,
    t = 0.  Invalid steps point at entry 0."""
    u = T * (d + l) + 1
    one = u - 1
    t = np.arange(T)
    t1 = np.minimum(t + 1, T - 1)

    def z(s):  # (steps, d) rows of z_s in G
        return s[:, None] * d + np.arange(d)

    def x(s):
        return T * d + s[:, None] * l + np.arange(l)

    ones = np.full((T, 1), one)

    def block(rows, cols):  # (rows, cols, T) flat positions
        return (rows[:, :, None] * u + cols[:, None, :]).transpose(1, 2, 0)

    def vec(cols):  # the ones row: (cols, T)
        return (one * u + cols).T

    fields = [
        (0, block(z(t), z(t))), (0, block(z(t), z(t1))), (0, block(z(t1), z(t1))),
        (0, vec(z(t))), (0, vec(z(t1))), (0, vec(ones)[0]),
        (1, block(z(t), z(t))), (1, block(z(t), x(t))), (1, block(x(t), x(t))),
        (1, vec(z(t))), (1, vec(x(t))), (1, vec(ones)[0]),
        (2, vec(ones)[0]), (2, vec(z(t))), (2, block(z(t), z(t))),
    ]
    index = np.concatenate([f.reshape(-1, T) for _k, f in fields])
    kind = np.concatenate([np.full(f.size // T, k) for k, f in fields])
    valid = np.stack([t < T - 1, np.ones(T, bool), t == 0])[kind]
    index = np.where(valid, index, 0)
    shapes = [f.shape[:-1] for _k, f in fields]
    return (torch.as_tensor(index, device=device), torch.as_tensor(kind, device=device), shapes)


def _select_stats(G, patterns, T, d, l):
    """The kernel wrapper's selection: :func:`_select_stats_plain`'s
    statistics, with every statistic's entries gathered from ``G`` at once
    (``_selection``) and summed over segments and steps, in ~14 launches
    where the plain version takes ~37."""
    P, C, u = G.shape[0], G.shape[1], G.shape[-1]
    Td = T * d
    index, kind, shapes = _selection(T, d, l, G.device)
    zv = patterns[:, :Td].reshape(P, T, d).all(-1)  # (P, T)
    xv = patterns[:, Td:].reshape(P, T, l).all(-1)
    off = torch.zeros_like(zv[:, :1])
    pv = torch.cat([zv[:, :-1] & zv[:, 1:], off], 1)  # transition pairs
    iv = torch.cat([zv[:, :1], off.expand(P, T - 1)], 1)  # the first state
    valid = torch.stack([pv, zv & xv, iv])[kind].transpose(0, 1)  # (P, K, T)
    g = G.reshape(P, C, u * u)[:, :, index]  # (P, C, K, T)
    sums = torch.where(valid[:, None], g, 0.0).sum((0, 3))  # (C, K)
    out, k = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(sums[:, k : k + n].reshape(C, *shape))
        k += n
    tstats = rops.RegressionStats(*out[:6])
    mstats = rops.RegressionStats(*out[6:12])
    istats = rops.MomentStats(*out[12:])
    return tstats, mstats, istats, G[:, :, u - 1, u - 1].sum(0)


def mstep_stats_gram_sorted_plain(
    v, assign, patterns, *, sizes, T, d, l, n_clusters
):
    """Plain torch version of :func:`mstep_stats_gram_sorted`."""
    _check_args(v, assign, patterns, sizes, T, d, l)
    G = _grams_plain(v, assign, sizes, n_clusters)
    return _select_stats_plain(G, patterns, T, d, l)


def mstep_stats_gram_sorted(
    v: torch.Tensor,  # (n, T·(d+l)) packed rows grouped by pattern
    assign: torch.Tensor,  # (n,) int32
    patterns: torch.Tensor,  # (P, T·(d+l)) bool
    *,
    sizes: tuple,
    T: int,
    d: int,
    l: int,
    n_clusters: int,
):
    """K9: the M-step statistics of a pattern-sorted batch, ``(tstats,
    mstats, istats, pi_counts)`` (``pallas_mstep.py:247``).  CUDA tensors
    launch ``csrc/mstep_gram.cu`` (float32 or float64 ``v``, int32
    ``assign``, both contiguous); CPU tensors take the plain version."""
    _check_args(v, assign, patterns, sizes, T, d, l)
    if v.device.type == "cpu":
        return mstep_stats_gram_sorted_plain(
            v, assign, patterns, sizes=sizes, T=T, d=d, l=l, n_clusters=n_clusters
        )
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.dtype not in _KINDS:
        raise ValueError(f"v must be float32 or float64, got {v.dtype}")
    if assign.dtype != torch.int32:
        raise ValueError(f"assign must be int32, got {assign.dtype}")
    if not (v.is_contiguous() and assign.is_contiguous()):
        raise ValueError("v and assign must be contiguous")
    if v.shape[0] == 0:
        raise ValueError("empty batch")
    G = _grams_kernel(v, assign, sizes, n_clusters)
    mstep_stats_gram_sorted.launches += 1
    return _select_stats(G, patterns, T, d, l)


mstep_stats_gram_sorted.launches = 0


# ----------------------------------------------------------------------
# K15: the Khatri-Rao statistics of the packed joint batch
# ----------------------------------------------------------------------


def _stats_widths(d, l):
    """The widths u of the three sets: ``[z_t, z_{t+1}, 1]``,
    ``[z_t, x_t, 1]``, ``[z_1, 1]``."""
    return 2 * d + 1, d + l + 1, d + 1


def _check_stats_args(v, assign, T, d, l):
    n, D = v.shape
    if D != T * (d + l):
        raise ValueError(f"v must be (n, T·(d+l)) = (n, {T * (d + l)}), got {tuple(v.shape)}")
    if assign.shape != (n,):
        raise ValueError(f"assign must be ({n},), got {tuple(assign.shape)}")
    if v.device != assign.device:
        raise ValueError("v and assign must be on one device")


def mstep_stats_pallas_plain(v, assign, *, T, d, l, n_clusters):
    """Plain torch version of :func:`mstep_stats_pallas`, step by step as
    ``_mstep_kernel`` (``pallas_mstep.py:68``): per step the masked pair,
    its weight block ``B[i, c·u + k] = w_ic U_ik`` and ``S += Uᵀ B``."""
    _check_stats_args(v, assign, T, d, l)
    n = v.shape[0]
    C = n_clusters
    ones = torch.ones((n, 1), dtype=v.dtype, device=v.device)
    clusters = torch.arange(C, dtype=assign.dtype, device=assign.device)
    W = (assign[:, None] == clusters).to(v.dtype)  # (n, C); outside [0, C) → 0

    def z_at(t):
        return v[:, t * d : (t + 1) * d]

    def x_at(t):
        return v[:, T * d + t * l : T * d + (t + 1) * l]

    def zeroed(a):
        return torch.where(torch.isfinite(a), a, 0.0)

    def khatri(U, ok):
        u = U.shape[1]
        B = ((W * ok[:, None])[:, :, None] * U[:, None, :]).reshape(n, C * u)
        return U.T @ B

    def masked_pair(a, b):
        ok = (torch.isfinite(a).all(1) & torch.isfinite(b).all(1)).to(v.dtype)
        return torch.cat([zeroed(a), zeroed(b), ones], 1), ok

    u_t, u_m, u_i = _stats_widths(d, l)
    S_t = v.new_zeros((u_t, C * u_t))
    for t in range(T - 1):
        S_t += khatri(*masked_pair(z_at(t), z_at(t + 1)))
    S_m = v.new_zeros((u_m, C * u_m))
    for t in range(T):
        S_m += khatri(*masked_pair(z_at(t), x_at(t)))
    z0 = z_at(0)
    S_i = khatri(torch.cat([zeroed(z0), ones], 1), torch.isfinite(z0).all(1).to(v.dtype))
    return S_t, S_m, S_i


@functools.lru_cache(maxsize=16)
def _stats_entries(d: int, l: int, device: torch.device) -> torch.Tensor:
    """K15's entry table ``(E, 3)`` int32, one row per upper-triangle entry
    (j ≤ k, row by row) of the three sets in turn: the set (0 transition,
    1 measurement, 2 first state), j and k."""
    rows = [
        (s, j, k) for s, u in enumerate(_stats_widths(d, l)) for j in range(u) for k in range(j, u)
    ]
    return torch.tensor(rows, dtype=torch.int32, device=device)


# K15's bodies: "auto" the fast body where d and l have one ((5, 3), (2, 4),
# (2, 3)), else the general body, which takes any d and l
_BODIES = {"auto": -1, "fast": 0, "general": 1}


def _time_major(a: torch.Tensor) -> bool:
    """Whether a ``(T, n, w)`` view holds each step's rows contiguous."""
    return a.stride(1) == a.shape[2] or a.shape[1] == 1


def _stats_layout(a: torch.Tensor) -> torch.Tensor:
    """``a (T, n, w)`` as the kernel reads it (unit inner stride, each
    step's rows contiguous or each row's steps contiguous), copied only
    where it is neither."""
    T, n, w = a.shape
    if a.stride(2) == 1 and (_time_major(a) or a.stride(0) == w or T == 1):
        return a
    return a.contiguous()


@functools.lru_cache(maxsize=64)
def _stats_plan(device: int, kind: int, body: int, z_tmaj: bool, x_tmaj: bool, T: int, d: int, l: int,
                C: int, n: int) -> tuple:
    """K15's plan (``mtm_mstep_stats_plan``): ``(body, threads, steps a
    chunk, clusters a group, blocks, shared memory)``, as an int32 array
    on the host and its values."""
    import ctypes

    plan = (ctypes.c_int * 6)()
    rc = _build.library().mtm_mstep_stats_plan(
        device, kind, body, int(z_tmaj), int(x_tmaj), T, d, l, C, n, plan
    )
    if rc == -1:
        raise _build.KernelArgumentError(
            f"K15 has no plan for T={T}, d={d}, l={l}, C={C} "
            f"({'the fast body has no such shape' if body == 0 else 'the statistics do not fit'})"
        )
    _build.check(rc, "mstep_stats plan")
    return plan, tuple(plan)


def _stats_kernel(z, x, assign, C, body="auto"):
    """K15 on ``z (T, n, d)`` and ``x (T, n, l)`` CUDA views: the three
    statistics, one launch of ``csrc/mstep_stats.cu`` (its body and its
    reduce), counted in ``mstep_stats_pallas.launches``.  ``body`` (a key
    of ``_BODIES``) forces a body, for tests and tools."""
    if z.dtype not in _KINDS or x.dtype != z.dtype:
        raise ValueError(f"z and x must both be float32 or float64, got {z.dtype} and {x.dtype}")
    if assign.dtype != torch.int32:
        raise ValueError(f"assign must be int32, got {assign.dtype}")
    if not assign.is_contiguous():
        raise ValueError("assign must be contiguous")
    T, n, d = z.shape
    l = x.shape[2]
    if n == 0:
        raise ValueError("empty batch")
    z, x = _stats_layout(z), _stats_layout(x)
    kind = _KINDS[z.dtype]
    dev = _device_index(z)
    plan, (_body, _threads, _ts, _cg, blocks, _smem) = _stats_plan(
        dev, kind, _BODIES[body], _time_major(z), _time_major(x), T, d, l, C, n
    )
    entries = _stats_entries(d, l, z.device)
    part = torch.empty(blocks * C * entries.shape[0], dtype=torch.float64, device=z.device)
    outs = tuple(torch.empty((u, C * u), dtype=z.dtype, device=z.device) for u in _stats_widths(d, l))
    rc = _build.library().mtm_mstep_stats(
        dev, kind, plan, z.data_ptr(), z.stride(0), z.stride(1), x.data_ptr(), x.stride(0), x.stride(1),
        assign.data_ptr(), entries.data_ptr(), part.data_ptr(), *(o.data_ptr() for o in outs),
        n, T, d, l, C, torch.cuda.current_stream(z.device).cuda_stream,
    )
    _build.check(rc, "mstep_stats_pallas")
    mstep_stats_pallas.launches += 1
    return outs


def _joint_views(v, T, d, l):
    """The states and observations of the packed joint batch as ``(T, n,
    d)`` and ``(T, n, l)`` views (no copy)."""
    n = v.shape[0]
    z = v[:, : T * d].view(n, T, d).transpose(0, 1)
    x = v[:, T * d :].view(n, T, l).transpose(0, 1)
    return z, x


def mstep_stats_pallas(
    v: torch.Tensor,  # (n, T·(d+l)) packed joint rows, any order
    assign: torch.Tensor,  # (n,) int32; outside [0, C) counts nowhere
    *,
    T: int,
    d: int,
    l: int,
    n_clusters: int,
):
    """K15: the per-cluster statistics of the packed batch, ``(S_trans
    (u_t, C·u_t), S_meas (u_m, C·u_m), S_init (u_i, C·u_i))`` with
    ``u = 2d+1, d+l+1, d+1`` (``pallas_mstep.py:142``).  CUDA tensors
    launch ``csrc/mstep_stats.cu`` on views of ``v`` (float32 or float64
    ``v``, int32 ``assign``, both contiguous); CPU tensors take the plain
    version."""
    _check_stats_args(v, assign, T, d, l)
    if v.device.type == "cpu":
        return mstep_stats_pallas_plain(v, assign, T=T, d=d, l=l, n_clusters=n_clusters)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.dtype not in _KINDS:
        raise ValueError(f"v must be float32 or float64, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    return _stats_kernel(*_joint_views(v, T, d, l), assign, n_clusters)


mstep_stats_pallas.launches = 0


def _check_zx_args(z, x, assign):
    if z.ndim != 3 or x.ndim != 3 or z.shape[:2] != x.shape[:2]:
        raise ValueError(f"z (T, n, d) and x (T, n, l) do not fit: {tuple(z.shape)}, {tuple(x.shape)}")
    if assign.shape != (z.shape[1],):
        raise ValueError(f"assign must be ({z.shape[1]},), got {tuple(assign.shape)}")
    if not (z.device == x.device == assign.device):
        raise ValueError("z, x and assign must be on one device")


def mstep_stats_zx_plain(z, x, assign, *, n_clusters):
    """Plain torch version of :func:`mstep_stats_zx`: the packed batch's
    :func:`mstep_stats_pallas_plain`."""
    _check_zx_args(z, x, assign)
    T, n, d = z.shape
    v = torch.cat([z.permute(1, 0, 2).reshape(n, -1), x.permute(1, 0, 2).reshape(n, -1)], dim=1)
    return mstep_stats_pallas_plain(v, assign, T=T, d=d, l=x.shape[2], n_clusters=n_clusters)


def mstep_stats_zx(
    z: torch.Tensor,  # (T, n, d) states, any strides with a unit inner one
    x: torch.Tensor,  # (T, n, l) observations
    assign: torch.Tensor,  # (n,) int32; outside [0, C) counts nowhere
    *,
    n_clusters: int,
):
    """K15 on the states and observations as the masked trainer holds them:
    :func:`mstep_stats_pallas`'s statistics of ``pack_joint(z, x)``, the
    batch read in place by strides (never packed).  CUDA tensors launch
    ``csrc/mstep_stats.cu`` (float32 or float64, int32 contiguous
    ``assign``; the fast body where d and l have one, else the general
    body), counted in ``mstep_stats_pallas.launches``; CPU tensors take the
    plain version.  The strided and the packed forms of one batch give the
    same bits."""
    _check_zx_args(z, x, assign)
    if z.device.type == "cpu":
        return mstep_stats_zx_plain(z, x, assign, n_clusters=n_clusters)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    return _stats_kernel(z, x, assign, n_clusters)


def unpack_mstep_stats(stats, d: int, l: int, n_clusters: int):
    """Split :func:`mstep_stats_pallas`'s matrices into ``(tstats, mstats,
    istats)`` (:class:`~.regression.RegressionStats` twice,
    :class:`~.regression.MomentStats`), as ``pallas_mstep.py:379``."""
    S_t, S_m, S_i = stats
    C = n_clusters
    u_t, u_m, u_i = _stats_widths(d, l)

    def blocks(S, u):  # (u, C·u) → (C, u, u)
        return S.reshape(u, C, u).permute(1, 0, 2)

    Bt = blocks(S_t, u_t)
    tstats = rops.RegressionStats(
        xtx=Bt[:, :d, :d], xty=Bt[:, :d, d : 2 * d], yty=Bt[:, d : 2 * d, d : 2 * d],
        sx=Bt[:, 2 * d, :d], sy=Bt[:, 2 * d, d : 2 * d], count=Bt[:, 2 * d, 2 * d],
    )
    Bm = blocks(S_m, u_m)
    mstats = rops.RegressionStats(
        xtx=Bm[:, :d, :d], xty=Bm[:, :d, d : d + l], yty=Bm[:, d : d + l, d : d + l],
        sx=Bm[:, d + l, :d], sy=Bm[:, d + l, d : d + l], count=Bm[:, d + l, d + l],
    )
    Bi = blocks(S_i, u_i)
    istats = rops.MomentStats(count=Bi[:, d, d], s=Bi[:, d, :d], ss=Bi[:, :d, :d])
    return tstats, mstats, istats
