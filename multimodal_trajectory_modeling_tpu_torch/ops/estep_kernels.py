"""The E step of the pattern-sorted dense trainer: kernel K8.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/pallas_estep.py``:
``precompute_cluster_pattern_inverses`` (:53) in plain torch, and K8
``estep_assign_pattern_sorted_t`` (:463) → ``csrc/estep_assign.cu``.

The batch is sorted by missingness pattern, so every row of a segment
shares its pattern p.  Per row i and cluster c the score is

    log π_c + const_{c,p} − ½ rᵀ M_{c,p} r,   r = f_p ⊙ (v_i − m_c)

with ``M_{c,p}`` the inverse of the identity-padded covariance and
``const_{c,p} = −½(k_p log 2π + logdet)``: the masked Gaussian log-density
of :func:`..gaussian.masked_mvn_logpdf_grouped` (method ``"inverse"``).
The JAX kernel expands the quadratic form as ``vᵀMv − 2vᵀMm + mᵀMm``,
which cancels on unstandardized float32 data; both versions here take the
residual form.  The assignment is the first maximum (a NaN score wins, as
in ``jnp.argmax``), ``C`` where ``prev < 0``; counts and switches are over
the rows with ``prev ≥ 0``.

JAX launches one ``pallas_call`` per segment, each padded to its block;
here one launch covers every segment through a per-block table (pattern,
first row, rows) that is built once per set of segment sizes, and the
kernel masks each segment's ragged edge.  The wrapper takes its plain
version for CPU tensors only; for CUDA tensors it launches the kernel or
raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels import (
    _argmax_first,
    _device_index,
)

__all__ = [
    "estep_assign_pattern_sorted_t",
    "estep_assign_pattern_sorted_t_plain",
    "precompute_cluster_pattern_inverses",
    "segment_table",
    "sorted_scores",
]

_LOG_2PI = math.log(2.0 * math.pi)


def precompute_cluster_pattern_inverses(
    means: torch.Tensor,  # (C, D)
    covs: torch.Tensor,  # (C, D, D)
    patterns: torch.Tensor,  # (P, D) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(cluster, pattern) identity-padded inverse and the constant
    ``−½(k·log 2π + logdet Σ')``: ``(Minv (C, P, D, D), const (C, P))``.
    A failed factorization gives NaN."""
    f = patterns.to(covs.dtype)  # (P, D)
    Lc = gops.cholesky_nan(gops.masked_identity_pad(covs[:, None], f[None]))
    logdet = 2.0 * torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1)
    D = covs.shape[-1]
    eye = torch.eye(D, dtype=covs.dtype, device=covs.device)
    # contiguous for the kernel (the solve may return column-major batches)
    inv = torch.cholesky_solve(eye.expand(Lc.shape), Lc).contiguous()
    const = -0.5 * (f.sum(-1)[None, :] * _LOG_2PI + logdet)
    return inv, const


@functools.lru_cache(maxsize=64)
def segment_table(sizes: tuple, rows: int, device: torch.device):
    """Blocks of at most ``rows`` consecutive rows, none crossing a
    segment: ``(table (blocks, 3) int32: pattern, first row, rows;
    first (P+1,) int32: the first block of each segment)``, on
    ``device``.  Built once per set of segment sizes."""
    ent = []
    first = []
    off = 0
    for p, s in enumerate(sizes):
        first.append(len(ent))
        ent += [(p, off + r, min(rows, s - r)) for r in range(0, s, rows)]
        off += s
    first.append(len(ent))
    table = np.asarray(ent, dtype=np.int32).reshape(-1, 3)
    return (
        torch.as_tensor(table, device=device),
        torch.as_tensor(np.asarray(first, dtype=np.int32), device=device),
    )


def _check_args(v_t, prev, means, minv, const, logpi, patterns, sizes):
    D, n = v_t.shape
    C, P = const.shape
    if prev.shape != (n,) or means.shape != (C, D) or logpi.shape != (C,):
        raise ValueError(
            f"v_t (D, n) = {tuple(v_t.shape)}, prev {tuple(prev.shape)}, "
            f"means {tuple(means.shape)} and logpi {tuple(logpi.shape)} disagree"
        )
    if minv.shape != (C, P, D, D) or patterns.shape != (P, D):
        raise ValueError(
            f"minv must be {(C, P, D, D)} and patterns {(P, D)}, got "
            f"{tuple(minv.shape)} and {tuple(patterns.shape)}"
        )
    if len(sizes) != P or sum(sizes) != n:
        raise ValueError(f"sizes must be P={P} segment sizes summing to n={n}")
    tensors = (v_t, prev, means, minv, const, logpi, patterns)
    if any(t.device != v_t.device for t in tensors):
        raise ValueError("every input must be on one device")


def _masked_means(means, patterns):
    """``mp (P, C, D)``: each cluster's mean, 0 where the pattern is
    missing (a multiply, as in JAX: a NaN mean stays NaN)."""
    return means[None, :, :] * patterns.to(means.dtype)[:, None, :]


def sorted_scores(v_t, means, minv, const, logpi, patterns, *, sizes):
    """K8's scores ``log π_c + const_{c,p} − ½ rᵀ M_{c,p} r`` of every row
    of the sorted batch, ``(C, n)``, in plain torch (residual form)."""
    vm = torch.where(torch.isfinite(v_t), v_t, 0.0)
    mp = _masked_means(means, patterns)
    scores = []
    off = 0
    for p, s in enumerate(sizes):
        r = vm[None, :, off : off + s] - mp[p][:, :, None]  # (C, D, s)
        q = torch.einsum("cds,cde,ces->cs", r, minv[:, p], r)
        scores.append((logpi + const[:, p])[:, None] - 0.5 * q)
        off += s
    return torch.cat(scores, dim=1)


def estep_assign_pattern_sorted_t_plain(
    v_t, prev, means, minv, const, logpi, patterns, *, sizes
):
    """Plain torch version of :func:`estep_assign_pattern_sorted_t`."""
    _check_args(v_t, prev, means, minv, const, logpi, patterns, sizes)
    C = const.shape[0]
    na = _argmax_first(
        sorted_scores(v_t, means, minv, const, logpi, patterns, sizes=sizes)
    )[1]
    valid = prev >= 0
    clusters = torch.arange(C, dtype=na.dtype, device=na.device)
    counts = ((na[None, :] == clusters[:, None]) & valid).sum(1).to(torch.int32)
    switches = ((na != prev) & valid).sum().to(torch.int32)
    return torch.where(valid, na, C).to(torch.int32), counts, switches


_KINDS = {torch.float32: 0, torch.float64: 1}


def estep_assign_pattern_sorted_t(
    v_t: torch.Tensor,  # (D, n) transposed batch, rows grouped by pattern
    prev: torch.Tensor,  # (n,) int32; < 0 marks rows to leave out
    means: torch.Tensor,  # (C, D)
    minv: torch.Tensor,  # (C, P, D, D) identity-padded inverses
    const: torch.Tensor,  # (C, P)
    logpi: torch.Tensor,  # (C,)
    patterns: torch.Tensor,  # (P, D) bool
    *,
    sizes: tuple,
):
    """K8: the E step over a pattern-sorted batch, ``(assign (n,) int32,
    counts (C,) int32, switches () int32)`` (``pallas_estep.py:463``).
    CUDA tensors launch ``csrc/estep_assign.cu`` (float32 or float64,
    contiguous, int32 ``prev``, any D up to the kernel's shared memory:
    512 in both types); CPU tensors take the plain version."""
    _check_args(v_t, prev, means, minv, const, logpi, patterns, sizes)
    if v_t.device.type == "cpu":
        return estep_assign_pattern_sorted_t_plain(
            v_t, prev, means, minv, const, logpi, patterns, sizes=sizes
        )
    if v_t.device.type != "cuda":
        raise ValueError(f"unsupported device {v_t.device}")
    if v_t.dtype not in _KINDS or any(
        t.dtype != v_t.dtype for t in (means, minv, const, logpi)
    ):
        raise ValueError("v_t, means, minv, const and logpi must share float32 or float64")
    if prev.dtype != torch.int32:
        raise ValueError(f"prev must be int32, got {prev.dtype}")
    if not (v_t.is_contiguous() and prev.is_contiguous() and minv.is_contiguous()):
        raise ValueError("v_t, prev and minv must be contiguous")
    D, n = v_t.shape
    C, P = const.shape
    if n == 0:
        raise ValueError("empty batch")
    lib = _build.library()
    kind = _KINDS[v_t.dtype]
    block = lib.mtm_estep_assign_block(kind, D, C)
    if block <= 0:
        raise ValueError(
            f"D={D}: the E-step kernel's shared memory does not take this "
            "row width"
        )
    table, _first = segment_table(tuple(sizes), block, v_t.device)
    mp = _masked_means(means, patterns).contiguous()
    c0 = (logpi[:, None] + const).contiguous()
    assign = torch.empty((n,), dtype=torch.int32, device=v_t.device)
    counts = torch.zeros((C,), dtype=torch.int32, device=v_t.device)
    switches = torch.zeros((), dtype=torch.int32, device=v_t.device)
    rc = lib.mtm_estep_assign(
        _device_index(v_t),
        kind,
        v_t.data_ptr(),
        prev.data_ptr(),
        mp.data_ptr(),
        minv.data_ptr(),
        c0.data_ptr(),
        table.data_ptr(),
        assign.data_ptr(),
        counts.data_ptr(),
        switches.data_ptr(),
        n,
        D,
        P,
        C,
        table.shape[0],
        block,
        torch.cuda.current_stream(v_t.device).cuda_stream,
    )
    _build.check(rc, "estep_assign_pattern_sorted_t")
    estep_assign_pattern_sorted_t.launches += 1
    return assign, counts, switches


estep_assign_pattern_sorted_t.launches = 0
