"""The M-step statistics of the pattern-sorted dense trainer: kernel K9.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/pallas_mstep.py``:
K9 ``mstep_stats_gram_sorted`` (:247) → ``csrc/mstep_gram.cu``.

With ``U = [v(NaN→0), 1]`` (``u = D + 1``), the kernel sums per segment p
and cluster c the Gram ``G[p, c] = Σ U Uᵀ`` over the segment's rows of
that cluster.  Within a segment the validity of every time step is
constant, so the M step's any-NaN pair drops become a selection of the
valid (t, t′) blocks of ``G`` afterwards, in plain torch, as in JAX
(``pallas_mstep.py:326-376``).  The counts come from the ones column,
exact in float32 while n ≤ 2²⁴.

The wrapper takes its plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises, and counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import regression as rops
from multimodal_trajectory_modeling_tpu_torch.ops.estep_kernels import (
    segment_table,
)
from multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels import (
    _device_index,
)

__all__ = ["mstep_stats_gram_sorted", "mstep_stats_gram_sorted_plain"]

_KINDS = {torch.float32: 0, torch.float64: 1}
# rows per chunk of the kernel's per-chunk partials, and a cap on their
# bytes: long chunks at large D
_CHUNK = 16384
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


def _grams_kernel(v, assign, sizes, C):
    n, D = v.shape
    P = len(sizes)
    lib = _build.library()
    up = lib.mtm_mstep_gram_padded(D)
    esize = v.element_size()
    chunk = _CHUNK
    while chunk < n and (n // chunk + P) * C * up * up * esize > _PART_BYTES:
        chunk *= 2
    table, first = segment_table(tuple(sizes), chunk, v.device)
    part = torch.empty(
        (table.shape[0], C, up, up), dtype=v.dtype, device=v.device
    )
    G = torch.empty((P, C, D + 1, D + 1), dtype=v.dtype, device=v.device)
    rc = lib.mtm_mstep_gram(
        _device_index(v),
        _KINDS[v.dtype],
        v.data_ptr(),
        assign.data_ptr(),
        table.data_ptr(),
        first.data_ptr(),
        part.data_ptr(),
        G.data_ptr(),
        D,
        P,
        C,
        table.shape[0],
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(rc, "mstep_stats_gram_sorted")
    return G


def _select_stats(G, patterns, T, d, l):
    """The statistics of the valid (t, t′) blocks of ``G``: ``(tstats,
    mstats, istats, pi_counts)``.  A block counts where the segment's
    pattern observes every coordinate of its steps (a where-select), and
    the sums run over segments and steps at once."""
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


def mstep_stats_gram_sorted_plain(
    v, assign, patterns, *, sizes, T, d, l, n_clusters
):
    """Plain torch version of :func:`mstep_stats_gram_sorted`."""
    _check_args(v, assign, patterns, sizes, T, d, l)
    G = _grams_plain(v, assign, sizes, n_clusters)
    return _select_stats(G, patterns, T, d, l)


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
