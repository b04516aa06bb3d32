"""The dense route's E-step kernels: K8, K12, K13 and K14.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/pallas_estep.py``:
``precompute_cluster_pattern_inverses`` (:53) in plain torch, K12
``estep_logliks_pallas`` (:106), K13 ``estep_logliks_pattern_sorted``
(:167) → ``csrc/estep_logliks.cu``, K14 ``estep_assign_pattern_sorted``
(:301) and K8 ``estep_assign_pattern_sorted_t`` (:463) →
``csrc/estep_assign.cu``, and ``estep_logliks_fused`` (:557).

Per row i of pattern p and cluster c the masked Gaussian log-density is

    const_{c,p} − ½ rᵀ M_{c,p} r,   r = where(isfinite(v_i), v_i − m_c, 0)

with ``M_{c,p}`` the inverse of the identity-padded covariance and
``const_{c,p} = −½(k_p log 2π + logdet)``: the function of
:func:`..gaussian.masked_mvn_logpdf_grouped` (method ``"inverse"``).  K12
and K13 write it as a ``(C, n)`` matrix: K13 on a batch sorted by
pattern, K12 on rows in any order, each under its own pattern only (the
JAX kernel computes all C·P forms of a row and selects one).  K8 and K14
take the E step from it without writing it: the score ``log π_c +`` the
log-density with the residual ``f_p ⊙ (v_i − m_c)``, the assignment the
first maximum (a NaN score wins, as in ``jnp.argmax``), ``C`` where
``prev < 0``, and counts and switches over the rows with ``prev ≥ 0``;
K8 on the transposed batch ``(D, n)``, K14 on the row-major ``(n, D)``.
The JAX kernels of K8 and K14 expand the quadratic form as
``vᵀMv − 2vᵀMm + mᵀMm``, which cancels on unstandardized float32 data;
both versions here take the residual form.

JAX launches one ``pallas_call`` per segment (K13, K14, K8), each padded
to its block; here one launch covers every segment through a per-block
table (pattern, first row, rows) that is built once per set of segment
sizes, and the kernel masks each segment's ragged edge.  K12 sorts the
row indices by pattern and gathers the rows through them.  Each wrapper
takes its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and counts its launches in ``.launches``.
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
    "estep_assign_pattern_sorted",
    "estep_assign_pattern_sorted_plain",
    "estep_assign_pattern_sorted_t",
    "estep_assign_pattern_sorted_t_plain",
    "estep_logliks_fused",
    "estep_logliks_pallas",
    "estep_logliks_pallas_plain",
    "estep_logliks_pattern_sorted",
    "estep_logliks_pattern_sorted_plain",
    "precompute_cluster_pattern_inverses",
    "segment_table",
    "sorted_scores",
]

_LOG_2PI = math.log(2.0 * math.pi)
# the most bytes of (C, P, D, D) inverses that one chunk of patterns of
# estep_logliks_fused holds (41 GB in float32 at P=1e5, C=16, D=80)
_INVERSE_BYTES = 1 << 30


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


def _cuda_checks(what, v, floats, ints):
    """Device, type and layout checks of a CUDA launch: ``v`` and
    ``floats`` share float32 or float64, ``ints`` are int32, all
    contiguous; the batch is not empty."""
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.dtype not in _KINDS or any(t.dtype != v.dtype for t in floats):
        raise ValueError(f"{what}: the batch and its float operands must share float32 or float64")
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: index arguments must be int32, got {t.dtype}")
    if not all(t.is_contiguous() for t in (v, *floats, *ints)):
        raise ValueError(f"{what}: every tensor argument must be contiguous")
    if v.numel() == 0:
        raise ValueError(f"{what}: empty batch")


def _assign_launch(fn, what, v, prev, means, minv, const, logpi, patterns, sizes):
    """One launch of K8 (``fn`` = ``mtm_estep_assign``, ``v`` the (D, n)
    batch) or K14 (``mtm_estep_assign_rows``, ``v`` (n, D))."""
    C, P = const.shape
    D = means.shape[1]
    n = prev.shape[0]
    lib = _build.library()
    kind = _KINDS[v.dtype]
    block = lib.mtm_estep_assign_block(kind, D, C)
    if block <= 0:
        raise ValueError(f"D={D}: the E-step kernel's shared memory does not take this row width")
    table, _first = segment_table(tuple(sizes), block, v.device)
    mp = _masked_means(means, patterns).contiguous()
    c0 = (logpi[:, None] + const).contiguous()
    assign = torch.empty((n,), dtype=torch.int32, device=v.device)
    counts = torch.zeros((C,), dtype=torch.int32, device=v.device)
    switches = torch.zeros((), dtype=torch.int32, device=v.device)
    rc = getattr(lib, fn)(
        _device_index(v), kind, v.data_ptr(), prev.data_ptr(), mp.data_ptr(),
        minv.data_ptr(), c0.data_ptr(), table.data_ptr(), assign.data_ptr(),
        counts.data_ptr(), switches.data_ptr(), n, D, P, C, table.shape[0], block,
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(rc, what)
    return assign, counts, switches


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
    CUDA tensors launch ``csrc/estep_assign.cu`` (float32 on the TF32
    tensor cores with a three-term split, float64 on the CUDA cores;
    contiguous, int32 ``prev``, any D up to the kernel's shared memory:
    512 in both types); CPU tensors take the plain version."""
    _check_args(v_t, prev, means, minv, const, logpi, patterns, sizes)
    if v_t.device.type == "cpu":
        return estep_assign_pattern_sorted_t_plain(
            v_t, prev, means, minv, const, logpi, patterns, sizes=sizes
        )
    _cuda_checks("estep_assign_pattern_sorted_t", v_t, (means, minv, const, logpi), (prev,))
    out = _assign_launch("mtm_estep_assign", "estep_assign_pattern_sorted_t",
                         v_t, prev, means, minv, const, logpi, patterns, sizes)
    estep_assign_pattern_sorted_t.launches += 1
    return out


estep_assign_pattern_sorted_t.launches = 0


def estep_assign_pattern_sorted_plain(
    v, prev, means, minv, const, logpi, patterns, *, sizes, bf16=False
):
    """Plain torch version of :func:`estep_assign_pattern_sorted`: K8's
    on the transposed view."""
    return estep_assign_pattern_sorted_t_plain(
        v.T, prev, means, minv, const, logpi, patterns, sizes=sizes
    )


def estep_assign_pattern_sorted(
    v: torch.Tensor,  # (n, D) rows grouped by pattern
    prev: torch.Tensor,  # (n,) int32; < 0 marks rows to leave out
    means: torch.Tensor,  # (C, D)
    minv: torch.Tensor,  # (C, P, D, D)
    const: torch.Tensor,  # (C, P)
    logpi: torch.Tensor,  # (C,)
    patterns: torch.Tensor,  # (P, D) bool
    *,
    sizes: tuple,
    bf16: bool = False,
):
    """K14: :func:`estep_assign_pattern_sorted_t` on the row-major batch,
    ``(assign, counts, switches)`` (``pallas_estep.py:301``).  CUDA
    tensors launch ``csrc/estep_assign.cu``'s row-major entry (K8's body,
    the block's rows read coalesced and transposed into its tile); CPU
    tensors take the plain version.

    ``bf16=True`` computes exactly what ``bf16=False`` does.  The JAX
    kernel's flag asks for bfloat16 GEMM operands, and its own docstring
    records that the TPU toolchain promotes those casts back to float32,
    with bit-identical output; here the kernel's arithmetic is fixed by
    the input type either way (float32: each operand split into two TF32
    parts on the tensor cores; float64: IEEE multiply-adds), so the flag
    is accepted and changes nothing."""
    del bf16  # the same function either way (see above)
    _check_args(v.T, prev, means, minv, const, logpi, patterns, sizes)
    if v.device.type == "cpu":
        return estep_assign_pattern_sorted_plain(
            v, prev, means, minv, const, logpi, patterns, sizes=sizes
        )
    _cuda_checks("estep_assign_pattern_sorted", v, (means, minv, const, logpi), (prev,))
    out = _assign_launch("mtm_estep_assign_rows", "estep_assign_pattern_sorted",
                         v, prev, means, minv, const, logpi, patterns, sizes)
    estep_assign_pattern_sorted.launches += 1
    return out


estep_assign_pattern_sorted.launches = 0


# ----------------------------------------------------------------------
# K12 and K13: the (C, n) log-likelihoods
# ----------------------------------------------------------------------


def _check_logliks_args(v, means, minv, const, pattern_id=None):
    n, D = v.shape
    C, P = const.shape
    if means.shape != (C, D) or minv.shape != (C, P, D, D):
        raise ValueError(
            f"v {tuple(v.shape)}, means {tuple(means.shape)}, minv "
            f"{tuple(minv.shape)} and const {tuple(const.shape)} disagree"
        )
    tensors = (means, minv, const)
    if pattern_id is not None:
        if pattern_id.shape != (n,):
            raise ValueError(f"pattern_id must be ({n},), got {tuple(pattern_id.shape)}")
        tensors += (pattern_id,)
    if any(t.device != v.device for t in tensors):
        raise ValueError("every input must be on one device")


def estep_logliks_pattern_sorted_plain(v, means, minv, const, *, sizes):
    """Plain torch version of :func:`estep_logliks_pattern_sorted`: per
    segment and cluster, the residual and its quadratic form
    (``_estep_kernel_single_pattern``, ``pallas_estep.py:147``)."""
    C, P = const.shape
    if len(sizes) != P or sum(sizes) != v.shape[0]:
        raise ValueError(f"sizes must be P={P} segment sizes summing to n={v.shape[0]}")
    finite = torch.isfinite(v)
    out = torch.empty((C, v.shape[0]), dtype=v.dtype, device=v.device)
    off = 0
    for p, s in enumerate(sizes):
        vp, fp = v[off : off + s], finite[off : off + s]
        for c in range(C):
            r = torch.where(fp, vp - means[c], 0.0)  # (s, D)
            out[c, off : off + s] = const[c, p] - 0.5 * ((r @ minv[c, p]) * r).sum(1)
        off += s
    return out


def _logliks_launch(what, v, rows, means, minv, const, sizes):
    """One launch of ``csrc/estep_logliks.cu``: K13 (``rows`` None) or K12
    (``rows`` the (n,) int64 row indices in pattern order)."""
    n, D = v.shape
    C, P = const.shape
    lib = _build.library()
    kind = _KINDS[v.dtype]
    block = lib.mtm_estep_logliks_block(kind, D)
    if block <= 0:
        raise ValueError(f"D={D}: the log-likelihood kernel's shared memory does not take this row width")
    table, _first = segment_table(tuple(sizes), block, v.device)
    out = torch.empty((C, n), dtype=v.dtype, device=v.device)
    rc = lib.mtm_estep_logliks(
        _device_index(v), kind, v.data_ptr(), None if rows is None else rows.data_ptr(),
        means.data_ptr(), minv.data_ptr(), const.data_ptr(), table.data_ptr(), out.data_ptr(),
        n, D, P, C, table.shape[0], block, torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(rc, what)
    return out


def estep_logliks_pattern_sorted(
    v: torch.Tensor,  # (n, D) rows grouped by pattern (ascending)
    means: torch.Tensor,  # (C, D)
    minv: torch.Tensor,  # (C, P, D, D)
    const: torch.Tensor,  # (C, P)
    *,
    sizes: tuple,  # per-pattern segment lengths, summing to n
) -> torch.Tensor:
    """K13: the ``(C, n)`` log-likelihoods of a batch sorted by pattern, in
    its row order (``pallas_estep.py:167``).  CUDA tensors launch
    ``csrc/estep_logliks.cu`` once over every segment (float32 or float64,
    contiguous); CPU tensors take the plain version."""
    sizes = tuple(int(s) for s in sizes)
    _check_logliks_args(v, means, minv, const)
    if len(sizes) != const.shape[1] or sum(sizes) != v.shape[0]:
        raise ValueError(f"sizes must be P={const.shape[1]} segment sizes summing to n={v.shape[0]}")
    if v.device.type == "cpu":
        return estep_logliks_pattern_sorted_plain(v, means, minv, const, sizes=sizes)
    _cuda_checks("estep_logliks_pattern_sorted", v, (means, minv, const), ())
    out = _logliks_launch("estep_logliks_pattern_sorted", v, None, means, minv, const, sizes)
    estep_logliks_pattern_sorted.launches += 1
    return out


estep_logliks_pattern_sorted.launches = 0


def _pattern_order(pattern_id, P):
    """``(order (n,) int64, sizes)``: the rows sorted by pattern (stable)
    and the P segment sizes, read to the host."""
    counts = torch.bincount(pattern_id.long(), minlength=P)
    if counts.shape[0] != P:
        raise ValueError(f"pattern_id has values outside [0, {P})")
    return torch.argsort(pattern_id, stable=True), tuple(counts.tolist())


def estep_logliks_pallas_plain(v, pattern_id, means, minv, const):
    """Plain torch version of :func:`estep_logliks_pallas`: the rows sorted
    by pattern, K13's plain version, the columns put back."""
    _check_logliks_args(v, means, minv, const, pattern_id)
    if (pattern_id < 0).any():
        raise ValueError("pattern_id has negative values")
    order, sizes = _pattern_order(pattern_id, const.shape[1])
    out = torch.empty((const.shape[0], v.shape[0]), dtype=v.dtype, device=v.device)
    out[:, order] = estep_logliks_pattern_sorted_plain(v[order], means, minv, const, sizes=sizes)
    return out


def estep_logliks_pallas(
    v: torch.Tensor,  # (n, D)
    pattern_id: torch.Tensor,  # (n,) int
    means: torch.Tensor,  # (C, D)
    minv: torch.Tensor,  # (C, P, D, D)
    const: torch.Tensor,  # (C, P)
) -> torch.Tensor:
    """K12: the ``(C, n)`` log-likelihoods of rows in any order, each
    under its own pattern ``pattern_id[i]`` (``pallas_estep.py:106``).
    CUDA tensors sort the row indices by pattern (one device sort and one
    read of the P segment sizes) and launch ``csrc/estep_logliks.cu``
    once, gathering the rows and writing each column in place (float32 or
    float64, contiguous); CPU tensors take the plain version."""
    if v.device.type == "cpu":
        return estep_logliks_pallas_plain(v, pattern_id, means, minv, const)
    _check_logliks_args(v, means, minv, const, pattern_id)
    _cuda_checks("estep_logliks_pallas", v, (means, minv, const), ())
    order, sizes = _pattern_order(pattern_id, const.shape[1])
    out = _logliks_launch("estep_logliks_pallas", v, order, means, minv, const, sizes)
    estep_logliks_pallas.launches += 1
    return out


estep_logliks_pallas.launches = 0


def estep_logliks_fused(
    means: torch.Tensor,  # (C, D)
    covs: torch.Tensor,  # (C, D, D)
    v: torch.Tensor,  # (n, D)
    patterns: torch.Tensor,  # (P, D) bool
    pattern_id: torch.Tensor,  # (n,) int
) -> torch.Tensor:
    """``(C, n)`` log-likelihoods from the moments: the inverses, then K12
    (``pallas_estep.py:557``).  The (C, P, D, D) inverses grow with the
    pattern count (41 GB in float32 at P=1e5, C=16, D=80), so the
    patterns go in chunks whose inverses hold at most ``_INVERSE_BYTES``;
    each chunk's rows are gathered and go through one K12 launch.  The
    chunking is the same on every device."""
    C, D = means.shape
    P = patterns.shape[0]
    per = max(1, _INVERSE_BYTES // (C * D * D * means.element_size()))
    if P <= per:
        minv, const = precompute_cluster_pattern_inverses(means, covs, patterns)
        return estep_logliks_pallas(v, pattern_id, means, minv, const)
    order = torch.argsort(pattern_id, stable=True)
    starts = torch.arange(0, P + per, per, device=v.device).clamp_max(P)
    bounds = torch.searchsorted(pattern_id[order].contiguous(), starts.to(pattern_id.dtype)).tolist()
    out = torch.empty((C, v.shape[0]), dtype=v.dtype, device=v.device)
    for k, p0 in enumerate(range(0, P, per)):
        rows = order[bounds[k] : bounds[k + 1]]
        if rows.numel() == 0:
            continue
        minv, const = precompute_cluster_pattern_inverses(means, covs, patterns[p0 : p0 + per])
        out[:, rows] = estep_logliks_pallas(
            v[rows], (pattern_id[rows] - p0).contiguous(), means, minv, const
        )
    return out
